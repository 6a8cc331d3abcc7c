"""Truncated-quadratic colour modes (truncquad_modes.cxx) as array programs.

The reference (imrender/ojw/truncquad_modes.cxx) finds, per pixel, the colour
modes of a library of L sampled colours at each of M depths: every pair of
library vectors closer than 4·thresh seeds a mean-shift iteration under the
truncated quadratic kernel; converged clusters with >=2 inliers are deduped
by converged energy and kept only if no nearby depth (within search_width)
gives the centre a lower energy.  The C code is a per-pixel sequential loop
with data-dependent cluster counts.

Redesign: all L(L-1)/2 pair seeds at all M depths iterate mean-shift *in
parallel* as one dense program (masked fixed-point iteration), dedupe and the
depth-mode test are dense comparisons, and the variable-length output becomes
a fixed-capacity top-`max_modes` selection per pixel (energy-ascending, +inf
padded) — the shape every downstream table solver needs anyway.  The
`seen_before` pair-skipping of the reference is a pure time optimization
whose surviving output set equals energy-dedupe (the reference itself dedupes
by exact energy equality); the parallel version therefore reproduces the
reference's mode set, pinned in tests/test_render_modes.py against a literal
numpy transcription.

use_variance follows the m-file convention (truncquad_modes.m): 0 = sum cost
over all vectors (default); 1 = inlier cost / n_inliers; 2 = inlier cost /
(n_inliers - 1).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

BIG = jnp.inf


def _pair_indices(L: int):
    p1, p2 = np.triu_indices(L, k=1)
    return jnp.asarray(p1), jnp.asarray(p2)


def _cluster_energy(I, centre, thresh):
    """I: [..., C, L]; centre: [..., C].  Returns (energy, dist2 [..., L])."""
    d2 = jnp.sum((I - centre[..., :, None]) ** 2, axis=-2)  # [..., L]
    e = jnp.sum(jnp.minimum(d2, thresh), axis=-1)
    return e, d2


@functools.partial(jax.jit,
                   static_argnames=("use_variance", "search_width",
                                    "max_modes", "max_iters"))
def truncquad_modes(I, thresh, use_variance: int = 0,
                    search_width: int | None = None, max_modes: int = 8,
                    max_iters: int = 64):
    """Colour modes of I: [..., C, L, M] (C channels, L library vectors, M
    depths; leading axes batch over pixels).

    Returns a dict of dense per-pixel mode tables, energy-ascending:
      modes   [..., max_modes, C]   cluster centres,
      depth   [..., max_modes]      int32 depth index (0-based; -1 = pad),
      energy  [..., max_modes]      converged cost / L (reference
                                    normalizer), +inf at pads,
      inliers [..., max_modes, L]   bool inlier sets,
      count   [...]                 number of valid modes (may exceed
                                    max_modes; excess lowest-priority modes
                                    are dropped).
    """
    I = jnp.asarray(I)
    *batch, C, L, M = I.shape
    uv = int(use_variance) - 1  # internal convention of the C code
    sw = M if search_width is None else int(search_width)
    p1, p2 = _pair_indices(L)
    P = p1.shape[0]

    # ----------------------------------------------------- seeds [.., M, P]
    Im = jnp.moveaxis(I, -1, -3)  # [..., M, C, L]
    a = jnp.take(Im, p1, axis=-1)  # [..., M, C, P]
    b = jnp.take(Im, p2, axis=-1)
    pair_ok = jnp.sum((a - b) ** 2, axis=-2) <= 4.0 * thresh  # [..., M, P]
    centre = jnp.moveaxis((a + b) * 0.5, -1, -2)  # [..., M, P, C]

    lib = Im[..., None, :, :]  # [..., M, 1, C, L]

    # ------------------------------------- masked mean-shift to fixed point
    # do { e_up = e; e = update_energy(...) } while (e_up != e): each
    # iteration evaluates the energy/inliers at the current centre and moves
    # the centre to the inlier mean; converged seeds freeze under the mask.
    def body(state):
        centre, e_prev, done, _, it = state
        e, d2 = _cluster_energy(lib, centre, thresh)  # e [.., M, P]
        inl = d2 <= thresh  # [..., M, P, L]
        n = jnp.sum(inl, axis=-1)
        mean = jnp.sum(jnp.where(inl[..., None, :], lib, 0.0), axis=-1) / (
            jnp.maximum(n, 1)[..., None])
        new_done = done | (e == e_prev)
        centre = jnp.where(new_done[..., None], centre, mean)
        return centre, e, new_done, inl, it + 1

    def cond(state):
        return (~jnp.all(state[2])) & (state[4] < max_iters)

    e0 = jnp.full(centre.shape[:-1], -1.0, I.dtype)
    done0 = jnp.zeros(centre.shape[:-1], bool)
    inl0 = jnp.zeros(centre.shape[:-1] + (L,), bool)
    state = (centre, e0, done0, inl0, jnp.zeros((), jnp.int32))
    centre, e_curr, _, inliers, _ = jax.lax.while_loop(cond, body, state)
    n_inl = jnp.sum(inliers, axis=-1)  # [..., M, P]

    valid_cluster = pair_ok & (n_inl >= 2)

    # ------------------------------ dedupe by converged energy within depth
    # candidate i is a duplicate if an earlier valid cluster at the same
    # depth converged to exactly the same energy (truncquad_modes.cxx:112).
    eq = (e_curr[..., :, None] == e_curr[..., None, :])  # [..., M, P, P]
    earlier = jnp.tril(jnp.ones((P, P), bool), k=-1)
    dup = jnp.any(eq & earlier & valid_cluster[..., None, :], axis=-1)
    valid = valid_cluster & ~dup

    # --------------------------------------- depth-mode test within +/- sw
    # energy of each centre against every other depth's library
    d2_all = jnp.sum(
        (Im[..., :, None, None, :, :] - centre[..., None, :, :, :, None])
        ** 2, axis=-2)  # [..., M(d2), M(d), P, L]
    if uv < 0:
        e_other = jnp.sum(jnp.minimum(d2_all, thresh), axis=-1)
        e_ref = e_curr
    else:
        inl_o = d2_all <= thresh
        n_o = jnp.sum(inl_o, axis=-1)
        e_o = jnp.sum(jnp.where(inl_o, d2_all, 0.0), axis=-1)
        e_other = jnp.where(n_o >= 2, e_o / jnp.maximum(n_o - uv, 1), BIG)
        e_ref = (e_curr - thresh * (L - n_inl)) / jnp.maximum(
            n_inl - uv, 1)
    # reference window (truncquad_modes.cxx:124-150): upward d2 in
    # [d+1, d+sw-1] (strict < lim), downward d2 in [d-sw, d-1] (>= lim)
    d_idx = jnp.arange(M)
    delta = d_idx[:, None] - d_idx[None, :]  # d2 - d
    in_win = ((delta >= 1) & (delta <= sw - 1)) | (
        (delta <= -1) & (delta >= -sw))
    beats = e_other < e_ref[..., None, :, :]  # [..., M(d2), M(d), P]
    beaten = jnp.any(beats & in_win[:, :, None], axis=-3)  # [..., M, P]
    valid = valid & ~beaten

    # ----------------------------------------- top-max_modes by energy
    e_flat = jnp.where(valid, e_curr, BIG).reshape(*batch, M * P)
    order = jnp.argsort(e_flat, axis=-1)[..., :max_modes]
    gather = lambda x: jnp.take_along_axis(x.reshape(*batch, M * P, -1),
                                           order[..., None], axis=-2)
    modes = gather(centre)  # [..., max_modes, C]
    inl_out = gather(inliers)
    e_out = jnp.take_along_axis(e_flat, order, axis=-1)
    depth = jnp.take_along_axis(
        jnp.broadcast_to(jnp.repeat(d_idx, P), (*batch, M * P)), order,
        axis=-1).astype(jnp.int32)
    ok = jnp.isfinite(e_out)
    return {
        "modes": jnp.where(ok[..., None], modes, 0.0),
        "depth": jnp.where(ok, depth, -1),
        "energy": jnp.where(ok, e_out / L, BIG),
        "inliers": inl_out & ok[..., None],
        "count": jnp.sum(valid.reshape(*batch, -1), axis=-1),
    }
