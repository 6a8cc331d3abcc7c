"""Banded (2-D blocked) wavefront TRW-S: short exact sweeps on the device.

The raster-order wavefront (solvers/wavefront.py) executes the reference's
sequential TRW-S (cpp/trw-s/minimize.cpp:31-116) in T = H + W - 1 anti-diagonal
steps per pass; each step carries a fixed launch overhead that dominates the
sweep wall-clock at small diagonal widths.

This module shortens the critical path by changing the *node ordering*, not
the algorithm: partition the grid into Bh x Bw blocks and order nodes by

    t(p) = yb + xb            (within-block anti-diagonal index),

ties broken arbitrarily.  For Bh, Bw >= 2 no two 4-neighbors share a t, so
this is a valid TRW-S total order: every block's wavefront advances in
lockstep and one pass takes only T = Bh + Bw - 1 steps, with Gy*Gx*~min(Bh,Bw)
lanes of parallel work per step instead of ~min(H, W).

This is *exact* TRW-S under that order (pinned per-iteration against
tests/oracles.SequentialTRWS with the banded order): the lower bound is a
valid dual value and is non-decreasing, exactly as for any other ordering
(treeProbabilities.cpp:12-47 gammas, minimize.cpp:67-94 bound).  What changes
is mixing: monotonic chains span single blocks, so information crosses the
image in ~#blocks-per-axis passes instead of one — Bh/Bw trade per-sweep cost
against sweeps-to-convergence (Gy = Gx = 1 recovers the raster wavefront
bitwise).

Seam edges (block boundaries) flip their forward/backward role: for the pair
(pL at xb = Bw-1 | pR at xb = 0 of the next block), t(pR) = yb < t(pL) =
yb + Bw - 1, so pR precedes pL even though it sits to the *right* — and
similarly for y-seams.  The four per-direction message buffers of seam edges
are therefore kept out of the skewed column arrays and stored in four small
dense side arrays (one K-vector per seam node), updated with masked sends at
the step that processes their sequentially-correct endpoint:

  forward pass, step t:
    F-head: M[LT]@(.,yb=t,xb=0)     and M[UP]@(.,0,xb=t)      (head-sends)
    F-tail: M[RT]@(.,t,Bw-1) <- its right-block source (.,t,0)   and
            M[DN]@(.,Bh-1,t) <- its down-block source (.,0,t)   (tail-sends)
  backward pass, step t: the mirror four, accumulating their bound terms.

Layouts.  Columns are [K, L] with lane = yb * nb + b (b = gy*Gx + gx,
nb = Gy*Gx), so within-block vertical neighbors are +-nb lanes and whole
yb-groups are contiguous.  Sx* seam arrays share that lane layout (their
nodes have fixed xb); Sy* arrays use lane2 = xb * nb + b.  All seam access
is masked group-compare + lane rolls — no gathers.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
from jax import lax

from stereo_tpu.energy import truncated_kernel
from stereo_tpu.geometry import take_plane
from stereo_tpu.solvers.trws import TRWSResult
from stereo_tpu.solvers.wavefront import _send_head, _send_tail, skew, unskew

__all__ = ["solve_banded", "banded_order", "BandedSpec"]


@dataclass(frozen=True)
class BandedSpec:
    H: int
    W: int
    Bh: int
    Bw: int

    @property
    def Gy(self):
        return -(-self.H // self.Bh)

    @property
    def Gx(self):
        return -(-self.W // self.Bw)

    @property
    def nb(self):
        return self.Gy * self.Gx

    @property
    def L(self):
        return self.Bh * self.nb

    @property
    def L2(self):
        return self.Bw * self.nb

    @property
    def Lp(self):
        return max(self.L, self.L2)

    @property
    def T(self):
        return self.Bh + self.Bw - 1

    @property
    def Hp(self):
        return self.Gy * self.Bh

    @property
    def Wp(self):
        return self.Gx * self.Bw

    def __post_init__(self):
        if self.Bh < 2 or self.Bw < 2:
            raise ValueError("banded order needs Bh, Bw >= 2 "
                             "(adjacent nodes must not tie)")


def banded_order(H, W, Bh, Bw):
    """Total order (row-major node ids) matching the parallel sweeps: sort by
    t = yb + xb, ties by (block, yb) — any tie order is equivalent because no
    two nodes of one step are adjacent or share a message buffer."""
    spec = BandedSpec(H, W, Bh, Bw)
    keyed = []
    for y in range(H):
        for x in range(W):
            gy, yb = divmod(y, Bh)
            gx, xb = divmod(x, Bw)
            b = gy * spec.Gx + gx
            keyed.append((yb + xb, b, yb, y * W + x))
    keyed.sort()
    return [k[-1] for k in keyed]


# ------------------------------------------------------------------ layouts
def _to_blocks(a, spec):
    """[..., H, W] -> [..., nb, Bh, Bw] (zero-padded image)."""
    lead = a.shape[:-2]
    pad = [(0, 0)] * len(lead) + [(0, spec.Hp - spec.H), (0, spec.Wp - spec.W)]
    ap = jnp.pad(a, pad)
    r = ap.reshape(lead + (spec.Gy, spec.Bh, spec.Gx, spec.Bw))
    r = jnp.moveaxis(r, -2, -3)  # [..., Gy, Gx, Bh, Bw]
    return r.reshape(lead + (spec.nb, spec.Bh, spec.Bw))


def _from_blocks(r, spec):
    """Inverse of _to_blocks (crops padding)."""
    lead = r.shape[:-3]
    r = r.reshape(lead + (spec.Gy, spec.Gx, spec.Bh, spec.Bw))
    r = jnp.moveaxis(r, -3, -2)  # [..., Gy, Bh, Gx, Bw]
    a = r.reshape(lead + (spec.Hp, spec.Wp))
    return a[..., : spec.H, : spec.W]


def to_cols(a, spec):
    """[..., H, W] -> [T+2, ..., L] skewed, t-leading, lane = yb*nb + b."""
    r = _to_blocks(a, spec)  # [..., nb, Bh, Bw]
    s = skew(r, spec.Bw)  # [..., nb, Bh, T]
    s = jnp.moveaxis(s, -1, 0)  # [T, ..., nb, Bh]
    s = jnp.swapaxes(s, -1, -2)  # [T, ..., Bh, nb]
    s = s.reshape(s.shape[:-2] + (spec.L,))
    return jnp.pad(s, [(1, 1)] + [(0, 0)] * (s.ndim - 1))


def from_cols(cols, spec):
    """[T+2, ..., L] -> [..., H, W]."""
    s = cols[1:-1]
    s = s.reshape(s.shape[:-1] + (spec.Bh, spec.nb))
    s = jnp.swapaxes(s, -1, -2)  # [T, ..., nb, Bh]
    s = jnp.moveaxis(s, 0, -1)  # [..., nb, Bh, T]
    r = unskew(s, spec.Bw)  # [..., nb, Bh, Bw]
    return _from_blocks(r, spec)


def _x_lanes(a, spec, xb):
    """[..., H, W] -> [..., L]: values at within-block column xb, lane layout
    (yb, b) — the Sx side-array layout."""
    r = _to_blocks(a, spec)[..., xb]  # [..., nb, Bh]
    r = jnp.swapaxes(r, -1, -2)  # [..., Bh, nb]
    return r.reshape(r.shape[:-2] + (spec.L,))


def _y_lanes(a, spec, yb):
    """[..., H, W] -> [..., Lp]: values at within-block row yb, lane2 layout
    (xb, b) — the Sy side-array layout (zero-padded L2 -> Lp)."""
    r = _to_blocks(a, spec)[..., yb, :]  # [..., nb, Bw]
    r = jnp.swapaxes(r, -1, -2).reshape(r.shape[:-2] + (spec.L2,))
    pad = [(0, 0)] * (r.ndim - 1) + [(0, spec.Lp - spec.L2)]
    return jnp.pad(r, pad)


def _x_lanes_back(v, spec, xb):
    """[..., L] -> [..., H, W]: scatter Sx-layout lanes back to column xb."""
    lead = v.shape[:-1]
    r = v.reshape(lead + (spec.Bh, spec.nb))
    r = jnp.swapaxes(r, -1, -2)  # [..., nb, Bh]
    full = jnp.zeros(lead + (spec.nb, spec.Bh, spec.Bw), v.dtype)
    full = full.at[..., xb].set(r)
    return _from_blocks(full, spec)


def _y_lanes_back(v, spec, yb):
    """[..., Lp] -> [..., H, W]: scatter Sy-layout lanes back to row yb."""
    lead = v.shape[:-1]
    r = v[..., : spec.L2].reshape(lead + (spec.Bw, spec.nb))
    r = jnp.swapaxes(r, -1, -2)  # [..., nb, Bw]
    full = jnp.zeros(lead + (spec.nb, spec.Bh, spec.Bw), v.dtype)
    full = full.at[..., yb, :].set(r)
    return _from_blocks(full, spec)


def banded_gamma(spec, dtype=jnp.float32, row0=0, Himg=None):
    """gamma = 1/max(nFwd, nBwd) under the banded order, [H, W].

    Each neighbor pair carries two directed edges, so n* = 2 * #neighbors on
    that side; seam neighbors swap sides relative to raster order.

    ``row0``/``Himg`` place the spec's rows inside a taller image (the
    gy-stripe decomposition of solvers/banded_dist.py): neighbor existence is
    judged against global row indices ``row0 + y`` in an ``Himg``-row image,
    so a stripe's gammas equal the matching rows of the full-image gammas
    bitwise.  ``row0`` may be a traced scalar (shard_map axis_index)."""
    H, W, Bh, Bw = spec.H, spec.W, spec.Bh, spec.Bw
    if Himg is None:
        Himg = H
    ys = jnp.arange(H)[:, None] * jnp.ones((1, W), jnp.int32) + row0
    xs = jnp.ones((H, 1), jnp.int32) * jnp.arange(W)[None, :]
    yb = ys % Bh
    xb = xs % Bw
    has_l = xs >= 1
    has_r = xs <= W - 2
    has_u = ys >= 1
    has_d = ys <= Himg - 2
    # later neighbors: interior right/down, seam left/up
    n_f = ((has_r & (xb < Bw - 1)).astype(dtype)
           + (has_d & (yb < Bh - 1)).astype(dtype)
           + (has_l & (xb == 0)).astype(dtype)
           + (has_u & (yb == 0)).astype(dtype))
    # earlier neighbors: interior left/up, seam right/down
    n_b = ((has_l & (xb > 0)).astype(dtype)
           + (has_u & (yb > 0)).astype(dtype)
           + (has_r & (xb == Bw - 1)).astype(dtype)
           + (has_d & (yb == Bh - 1)).astype(dtype))
    return 1.0 / jnp.maximum(jnp.maximum(2 * n_f, 2 * n_b), 1.0)


# message buffer/direction bookkeeping (solvers/trws.py convention):
# M[d][k] at p = message on edge E(p, d) = (tail = p + DIRS[d] -> head p).
LT, RT, UP, DN = 0, 1, 2, 3
GROUP_A = (RT, DN)  # in-buffers head-sent on the forward pass (interior)
GROUP_B = (LT, UP)


class _BandedProblem:
    """Skewed, t-leading problem data + static masks for the banded order.

    ``stripe=(row0, Himg, has_above, has_below)`` builds the problem as one
    gy-stripe of a taller ``Himg``-row image starting at global row ``row0``
    (solvers/banded_dist.py): validity/seam masks and gammas are judged
    against global row indices, and the stripe-border y-seam edges (to the
    stripes above/below) become live side-array entries.  ``row0`` and the
    has_* flags may be traced scalars (shard_map axis_index); default None
    reproduces the single-device problem exactly."""

    def __init__(self, theta, D0, Q, alphas, spec: BandedSpec, kernel, tol,
                 stripe=None):
        K, H, W = theta.shape
        dtype = theta.dtype
        self.spec = spec
        self.K, self.kernel, self.tol = K, kernel, tol
        self.dtype = dtype
        if stripe is None:
            row0, Himg = 0, H
            has_above = has_below = jnp.zeros((), bool)
        else:
            row0, Himg, has_above, has_below = stripe
        self.stripe = stripe
        Bh, Bw, Gy, Gx, nb = spec.Bh, spec.Bw, spec.Gy, spec.Gx, spec.nb

        tc = lambda a: to_cols(a, spec)
        self.theta = tc(theta)  # [T+2, K, L]
        self.D0 = tc(D0)
        self.QA = tc(jnp.stack([Q[d] for d in GROUP_A], 0))  # [T+2, 2, K, L]
        self.QB = tc(jnp.stack([Q[d] for d in GROUP_B], 0))
        self.aA = tc(jnp.stack([alphas[d] for d in GROUP_A], 0))
        self.aB = tc(jnp.stack([alphas[d] for d in GROUP_B], 0))

        ys = jnp.arange(H)[:, None] * jnp.ones((1, W), jnp.int32) + row0
        xs = jnp.ones((H, 1), jnp.int32) * jnp.arange(W)[None, :]
        yb, xb = ys % Bh, xs % Bw
        inim = ys < Himg  # [H, W] (stripe pad rows masked; else all-true)
        # interior (non-seam) directed-edge validity, image space
        vLT = (xs >= 1) & (xb > 0) & inim
        vRT = (xs <= W - 2) & (xb < Bw - 1) & inim
        vUP = (ys >= 1) & (yb > 0) & inim
        vDN = (ys <= Himg - 2) & (yb < Bh - 1) & inim
        self.vA = tc(jnp.stack([vRT, vDN], 0).astype(dtype))
        self.vB = tc(jnp.stack([vLT, vUP], 0).astype(dtype))
        self.pix = tc(inim.astype(dtype))  # [T+2, L]
        self.gamma = tc(banded_gamma(spec, dtype, row0=row0, Himg=Himg))

        # ---- static seam data (side-array layouts) ----
        xl = lambda a, x: _x_lanes(a, spec, x)
        yl = lambda a, y: _y_lanes(a, spec, y)
        # x-seam pair: pL = (., yb, Bw-1) | pR = (., yb, 0) of the next block.
        # M[LT]@pR needs (Q[LT], D0, alpha[LT]) at pR; M[RT]@pL at pL.
        self.PxL_q = xl(Q[LT], 0)  # [K, L]
        self.PxL_d0 = xl(D0, 0)
        self.PxL_a = xl(alphas[LT], 0)  # [L]
        self.PxR_q = xl(Q[RT], Bw - 1)
        self.PxR_d0 = xl(D0, Bw - 1)
        self.PxR_a = xl(alphas[RT], Bw - 1)
        # y-seam pair: pU = (., Bh-1, xb) | pD = (., 0, xb) of the block below.
        self.PyU_q = yl(Q[UP], 0)  # [K, Lp]
        self.PyU_d0 = yl(D0, 0)
        self.PyU_a = yl(alphas[UP], 0)
        self.PyD_q = yl(Q[DN], Bh - 1)
        self.PyD_d0 = yl(D0, Bh - 1)
        self.PyD_a = yl(alphas[DN], Bh - 1)

        # static lane index fields & seam validity masks
        lane = jnp.arange(spec.L)
        self.lane_yb = (lane // nb).astype(jnp.int32)  # [L]
        lane_b = lane % nb
        lane_gy = lane_b // Gx
        lane_gx = lane_b % Gx
        yimg = row0 + lane_gy * Bh + self.lane_yb  # image row of lane's node
        # [L] whether the lane's node has a real neighbor across the y-seam
        # above/below (stripe borders live when a neighbor stripe exists)
        self.has_up = (lane_gy > 0) | ((lane_gy == 0) & has_above)
        self.has_dn = ((lane_gy < Gy - 1)
                       | ((lane_gy == Gy - 1) & has_below))
        # node-level static validity of the seam edge buffers (lane layout)
        self.vSxL = (lane_gx > 0) & (yimg < Himg) & (lane_gx * Bw < W)
        self.vSxR = ((lane_gx < Gx - 1) & (yimg < Himg)
                     & ((lane_gx + 1) * Bw < W))
        lane2 = jnp.arange(spec.Lp)
        l2_xb = (lane2 // nb).astype(jnp.int32)
        l2_b = lane2 % nb
        l2_gy = l2_b // Gx
        l2_gx = l2_b % Gx
        ximg2 = l2_gx * Bw + l2_xb
        in2 = (lane2 < spec.L2) & (ximg2 < W)
        self.l2_grp = l2_xb
        # seam-edge validity: the pair's lower node pD must be a real pixel
        # (every block-row holds >= 1 real row, so a live neighbor stripe
        # implies pD's row < Himg at the stripe border)
        self.vSyU = (in2 & ((l2_gy > 0) | has_above)
                     & (row0 + l2_gy * Bh < Himg))
        self.vSyD = (in2 & ((l2_gy < Gy - 1) | ((l2_gy == Gy - 1) & has_below))
                     & (row0 + (l2_gy + 1) * Bh < Himg))

    def col(self, a, c):
        return lax.dynamic_index_in_dim(a, c, axis=0, keepdims=False)

    # array fields, for passing a problem through a jit boundary explicitly
    # (embedding them as closure constants ships hundreds of MB with every
    # remote compile request)
    _ARRAY_FIELDS = (
        "theta", "D0", "QA", "QB", "aA", "aB", "vA", "vB", "pix", "gamma",
        "PxL_q", "PxL_d0", "PxL_a", "PxR_q", "PxR_d0", "PxR_a",
        "PyU_q", "PyU_d0", "PyU_a", "PyD_q", "PyD_d0", "PyD_a",
        "lane_yb", "has_up", "has_dn", "vSxL", "vSxR",
        "l2_grp", "vSyU", "vSyD",
    )

    def tree(self):
        """Dict of all device arrays (a pytree for jit arguments)."""
        return {f: getattr(self, f) for f in self._ARRAY_FIELDS}

    def with_tree(self, tree):
        """Shallow copy with the array fields replaced (e.g. by tracers)."""
        import copy

        bp = copy.copy(self)
        for f, v in tree.items():
            setattr(bp, f, v)
        return bp


def _sdownb(v, nb):
    """v[..., lane] -> v[..., lane - nb] (row yb reads yb-1), zero at yb=0."""
    pads = [(0, 0)] * (v.ndim - 1) + [(nb, 0)]
    return jnp.pad(v, pads)[..., : v.shape[-1]]


def _supb(v, nb):
    """v[..., lane] -> v[..., lane + nb], zero at yb = Bh-1."""
    pads = [(0, 0)] * (v.ndim - 1) + [(0, nb)]
    return jnp.pad(v, pads)[..., nb:]


def _padLp(v, Lp):
    pads = [(0, 0)] * (v.ndim - 1) + [(0, Lp - v.shape[-1])]
    return jnp.pad(v, pads)


def _set_col(M, c, value):
    return lax.dynamic_update_index_in_dim(M, value, c, axis=0)


def _seam_views(bp: _BandedProblem, S, t):
    """Column-space views of the seam buffers touched at step t.

    Returns (syu0, syd0, sydT, syuT): [K, L] tensors whose
      group 0 lanes   hold SyU[(t, b)]        / SyD[(t, b - Gx)]
      group Bh-1 lanes hold SyD[(t-Bh+1, b)]  / SyU[(t-Bh+1, b + Gx)].
    Junk outside those groups; callers mask."""
    spec = bp.spec
    nb, Gx, Bh, L = spec.nb, spec.Gx, spec.Bh, spec.L
    SxL, SxR, SyU, SyD = S
    syu0 = jnp.roll(SyU, -t * nb, axis=-1)[..., :L]
    syd0 = jnp.roll(SyD, -t * nb + Gx, axis=-1)[..., :L]
    sydT = jnp.roll(SyD, (2 * Bh - 2 - t) * nb, axis=-1)[..., :L]
    syuT = jnp.roll(SyU, (2 * Bh - 2 - t) * nb - Gx, axis=-1)[..., :L]
    return syu0, syd0, sydT, syuT


def _beliefs(bp: _BandedProblem, MA, MB, c, t, S, views):
    """Node beliefs of padded column c (step t): theta + all 8 incident
    message buffers, seams included.  [K, L]."""
    spec = bp.spec
    nb, Bh, Bw = spec.nb, spec.Bh, spec.Bw
    SxL, SxR, _, _ = S
    syu0, syd0, sydT, syuT = views
    Ac = bp.col(MA, c)
    Bc = bp.col(MB, c)
    Acm1 = bp.col(MA, c - 1)
    Bcp1 = bp.col(MB, c + 1)
    D = bp.col(bp.theta, c) + Ac[0] + Ac[1] + Bc[0] + Bc[1]
    D = D + Acm1[0] + _sdownb(Acm1[1], nb)
    D = D + Bcp1[0] + _supb(Bcp1[1], nb)
    # seam contributions (in-buffer + the partner buffer stored at the nbr)
    pix_c = bp.col(bp.pix, c)
    mx0 = (bp.lane_yb == t) & bp.vSxL
    mxW = (bp.lane_yb == t - (Bw - 1)) & bp.vSxR
    D = D + jnp.where(mx0, SxL + jnp.roll(SxR, 1, axis=-1), 0.0)
    D = D + jnp.where(mxW, SxR + jnp.roll(SxL, -1, axis=-1), 0.0)
    my0 = (bp.lane_yb == 0) & bp.has_up & (pix_c > 0)
    myT = (bp.lane_yb == Bh - 1) & bp.has_dn & (pix_c > 0)
    D = D + jnp.where(my0, syu0 + syd0, 0.0)
    D = D + jnp.where(myT, sydT + syuT, 0.0)
    return D, (Ac, Bc, Acm1, Bcp1), (mx0, mxW, my0, myT)

def _acc_t(bp):
    return jnp.promote_types(bp.dtype, jnp.float32)


def _fwd_col(bp: _BandedProblem, state, t):
    """One forward step: process all nodes of (real) column t."""
    spec = bp.spec
    nb, Gx, Lp = spec.nb, spec.Gx, spec.Lp
    ktol = (bp.kernel, bp.tol)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    c = t + 1
    views = _seam_views(bp, S, t)
    D, (Ac, _, _, Bcp1), masks = _beliefs(bp, MA, MB, c, t, S, views)
    mx0, mxW, my0, myT = masks
    gD = bp.col(bp.gamma, c)[None, :] * D  # [K, L]

    # interior head-sends, group A (RT, DN) at column c
    mh, _ = _send_head(gD[None], Ac, bp.col(bp.QA, c),
                       bp.col(bp.D0, c)[None], bp.col(bp.aA, c), *ktol)
    vh = bp.col(bp.vA, c)
    MA = _set_col(MA, c, jnp.where(vh[:, None, :] > 0, mh, Ac))

    # interior tail-sends, group B (LT, UP) into column c+1
    gDt = jnp.stack([gD, _sdownb(gD, nb)], 0)
    mt, _ = _send_tail(gDt, Bcp1, bp.col(bp.QB, c + 1),
                       bp.col(bp.D0, c + 1)[None],
                       bp.col(bp.aB, c + 1), *ktol)
    vt = bp.col(bp.vB, c + 1)
    MB = _set_col(MB, c + 1, jnp.where(vt[:, None, :] > 0, mt, Bcp1))

    QB_c = bp.col(bp.QB, c)
    D0_c = bp.col(bp.D0, c)
    aB_c = bp.col(bp.aB, c)
    # F-head x: M[LT]@(., t, 0), stored in SxL at group t
    mlt, _ = _send_head(gD, SxL, QB_c[0], D0_c, aB_c[0], *ktol)
    SxL = jnp.where(mx0, mlt, SxL)
    # F-head y: M[UP]@(., 0, t), SyU group t (computed at group-0 lanes)
    mup, _ = _send_head(gD, views[0], QB_c[1], D0_c, aB_c[1], *ktol)
    upd = jnp.roll(_padLp(jnp.where(my0, mup, 0.0), Lp), t * nb, axis=-1)
    wy = (bp.l2_grp == t) & bp.vSyU
    SyU = jnp.where(wy, upd, SyU)
    # F-tail x: M[RT]@(., t, Bw-1) <- source (b+1, t, 0)
    mrt, _ = _send_tail(jnp.roll(gD, -1, axis=-1), SxR,
                        bp.PxR_q, bp.PxR_d0, bp.PxR_a, *ktol)
    wx = (bp.lane_yb == t) & bp.vSxR
    SxR = jnp.where(wx, mrt, SxR)
    # F-tail y: M[DN]@(., Bh-1, t) <- source (b+Gx down-block, 0, t)
    gDp = _padLp(gD, Lp)
    mdn, _ = _send_tail(jnp.roll(gDp, t * nb - Gx, axis=-1), SyD,
                        bp.PyD_q, bp.PyD_d0, bp.PyD_a, *ktol)
    wy2 = (bp.l2_grp == t) & bp.vSyD
    SyD = jnp.where(wy2, mdn, SyD)
    return (MA, MB, (SxL, SxR, SyU, SyD)), None


def _bwd_col(bp: _BandedProblem, state, t):
    """One backward step with lower-bound accumulation."""
    spec = bp.spec
    nb, Gx, Lp = spec.nb, spec.Gx, spec.Lp
    ktol = (bp.kernel, bp.tol)
    acc_t = _acc_t(bp)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S
    c = t + 1
    views = _seam_views(bp, S, t)
    D, (_, Bc, Acm1, _), masks = _beliefs(bp, MA, MB, c, t, S, views)
    mx0, mxW, my0, myT = masks
    pix_c = bp.col(bp.pix, c)
    vminD = jnp.min(D, axis=0)
    lb = jnp.sum(jnp.where(pix_c > 0, vminD, 0.0), dtype=acc_t)
    gD = bp.col(bp.gamma, c)[None, :] * (D - vminD[None, :])

    # interior head-sends, group B (LT, UP) at column c
    mh, vminh = _send_head(gD[None], Bc, bp.col(bp.QB, c),
                           bp.col(bp.D0, c)[None], bp.col(bp.aB, c),
                           *ktol)
    vh = bp.col(bp.vB, c)
    lb += jnp.sum(jnp.where(vh > 0, vminh, 0.0), dtype=acc_t)
    MB = _set_col(MB, c, jnp.where(vh[:, None, :] > 0, mh, Bc))

    # interior tail-sends, group A (RT, DN) into column c-1
    gDt = jnp.stack([gD, _supb(gD, nb)], 0)
    mt, vmint = _send_tail(gDt, Acm1, bp.col(bp.QA, c - 1),
                           bp.col(bp.D0, c - 1)[None],
                           bp.col(bp.aA, c - 1), *ktol)
    vt = bp.col(bp.vA, c - 1)
    lb += jnp.sum(jnp.where(vt > 0, vmint, 0.0), dtype=acc_t)
    MA = _set_col(MA, c - 1, jnp.where(vt[:, None, :] > 0, mt, Acm1))

    QA_c = bp.col(bp.QA, c)
    D0_c = bp.col(bp.D0, c)
    aA_c = bp.col(bp.aA, c)
    # B-head x: M[RT]@(., t-Bw+1, Bw-1), SxR at group t-Bw+1
    mrt, vrt = _send_head(gD, SxR, QA_c[0], D0_c, aA_c[0], *ktol)
    SxR = jnp.where(mxW, mrt, SxR)
    lb += jnp.sum(jnp.where(mxW, vrt, 0.0), dtype=acc_t)
    # B-head y: M[DN]@(., Bh-1, t-Bh+1), computed at group Bh-1 lanes
    mdn, vdn = _send_head(gD, views[2], QA_c[1], D0_c, aA_c[1], *ktol)
    lb += jnp.sum(jnp.where(myT, vdn, 0.0), dtype=acc_t)
    upd = jnp.roll(_padLp(jnp.where(myT, mdn, 0.0), Lp),
                   -(2 * spec.Bh - 2 - t) * nb, axis=-1)
    wyd = (bp.l2_grp == t - (spec.Bh - 1)) & bp.vSyD
    SyD = jnp.where(wyd, upd, SyD)
    # B-tail x: M[LT]@(., t-Bw+1, 0) <- source (b-1, t-Bw+1, Bw-1)
    mlt, vlt = _send_tail(jnp.roll(gD, 1, axis=-1), SxL,
                          bp.PxL_q, bp.PxL_d0, bp.PxL_a, *ktol)
    wxl = (bp.lane_yb == t - (spec.Bw - 1)) & bp.vSxL
    SxL = jnp.where(wxl, mlt, SxL)
    lb += jnp.sum(jnp.where(wxl, vlt, 0.0), dtype=acc_t)
    # B-tail y: M[UP]@(., 0, t-Bh+1) <- source (b, Bh-1, t-Bh+1),
    # target SyU at lane2 (t-Bh+1, b+Gx)
    gDp = _padLp(gD, Lp)
    src = jnp.roll(gDp, (t - 2 * spec.Bh + 2) * nb + Gx, axis=-1)
    mup, vup = _send_tail(src, SyU, bp.PyU_q, bp.PyU_d0, bp.PyU_a, *ktol)
    wyu = (bp.l2_grp == t - (spec.Bh - 1)) & bp.vSyU
    SyU = jnp.where(wyu, mup, SyU)
    lb += jnp.sum(jnp.where(wyu, vup, 0.0), dtype=acc_t)
    return (MA, MB, (SxL, SxR, SyU, SyD)), lb


def _sweep_scan(bp: _BandedProblem, state):
    """One full (fwd + bwd) pass via lax.scan over columns. -> (state, lb)."""
    T = bp.spec.T
    state, _ = lax.scan(lambda s, t: _fwd_col(bp, s, t), state,
                        jnp.arange(T))
    state, lbs = lax.scan(lambda s, t: _bwd_col(bp, s, t), state,
                          jnp.arange(T - 1, -1, -1))
    return state, jnp.sum(lbs, dtype=_acc_t(bp))


def _decode_state(bp: _BandedProblem, state):
    """Greedy conditioned decode in banded order + exact energy.

    Mirrors ComputeSolutionAndEnergy (minimize.cpp:223-264) under the banded
    order: each node conditions on its *earlier* neighbors' solutions
    (interior left/up + seam right/down) and adds the messages of its later
    edges."""
    spec = bp.spec
    T, nb, Gx, L, Lp = spec.T, spec.nb, spec.Gx, spec.L, spec.Lp
    Bh, Bw = spec.Bh, spec.Bw
    kernel, tol = bp.kernel, bp.tol
    acc_t = _acc_t(bp)
    MA, MB, S = state
    SxL, SxR, SyU, SyD = S

    def step(carry, t):
        sols, E = carry  # sols: [T+2, L] labels of processed columns
        c = t + 1
        views = _seam_views(bp, S, t)
        syu0, syd0, sydT, syuT = views
        pix_c = bp.col(bp.pix, c)
        th = bp.col(bp.theta, c)
        D0c = bp.col(bp.D0, c)
        QB_c = bp.col(bp.QB, c)
        aB_c = bp.col(bp.aB, c)
        vB_c = bp.col(bp.vB, c)
        QA_c = bp.col(bp.QA, c)
        aA_c = bp.col(bp.aA, c)
        QA_p = bp.col(bp.QA, c - 1)
        aA_p = bp.col(bp.aA, c - 1)
        vA_p = bp.col(bp.vA, c - 1)
        D0p = bp.col(bp.D0, c - 1)
        sol_prev = bp.col(sols, c - 1)

        mx0 = (bp.lane_yb == t) & bp.vSxL
        mxW = (bp.lane_yb == t - (Bw - 1)) & bp.vSxR
        my0 = (bp.lane_yb == 0) & bp.has_up & (pix_c > 0)
        myT = (bp.lane_yb == Bh - 1) & bp.has_dn & (pix_c > 0)

        Db = th
        # conditioned on interior earlier nbrs (left, up)
        sol_l = sol_prev
        sol_u = _sdownb(sol_prev, nb)
        Q_sel = take_plane(QB_c[0], sol_l)
        Db = Db + aB_c[0][None, :] * truncated_kernel(
            Q_sel[None, :] - D0c, kernel, tol) * vB_c[0][None, :]
        Q_sel = take_plane(QB_c[1], sol_u)
        Db = Db + aB_c[1][None, :] * truncated_kernel(
            Q_sel[None, :] - D0c, kernel, tol) * vB_c[1][None, :]
        # out-edges at interior earlier nbrs: E(ln, RT), E(un, DN)
        D0_sel = take_plane(D0p, sol_l)
        Db = Db + aA_p[0][None, :] * truncated_kernel(
            QA_p[0] - D0_sel[None, :], kernel, tol) * vA_p[0][None, :]
        D0_un = take_plane(D0p, sol_prev)
        t_un = aA_p[1][None, :] * truncated_kernel(
            QA_p[1] - D0_un[None, :], kernel, tol) * vA_p[1][None, :]
        Db = Db + _sdownb(t_un, nb)
        # conditioned on seam earlier nbrs: right (xb = Bw-1 nodes)
        sol_r = jnp.roll(bp.col(sols, c - (Bw - 1)), -1, axis=-1)
        Q_sel = take_plane(QA_c[0], sol_r)
        Db = Db + jnp.where(
            mxW, aA_c[0] * truncated_kernel(Q_sel[None] - D0c, kernel,
                                            tol), 0.0)
        qln = jnp.roll(bp.PxL_q, -1, axis=-1)
        d0ln = take_plane(jnp.roll(bp.PxL_d0, -1, axis=-1), sol_r)
        aln = jnp.roll(bp.PxL_a, -1, axis=-1)
        Db = Db + jnp.where(
            mxW, aln * truncated_kernel(qln - d0ln[None], kernel, tol),
            0.0)
        # conditioned on seam earlier nbrs: down (yb = Bh-1 nodes)
        sol_d = jnp.roll(_padLp(bp.col(sols, c - (Bh - 1)), Lp),
                         (Bh - 1) * nb - Gx, axis=-1)[..., :L]
        Q_sel = take_plane(QA_c[1], sol_d)
        Db = Db + jnp.where(
            myT, aA_c[1] * truncated_kernel(Q_sel[None] - D0c, kernel,
                                            tol), 0.0)
        sh = (2 * Bh - 2 - t) * nb - Gx
        qdn = jnp.roll(bp.PyU_q, sh, axis=-1)[..., :L]
        d0dn_full = jnp.roll(bp.PyU_d0, sh, axis=-1)[..., :L]
        adn = jnp.roll(bp.PyU_a, sh, axis=-1)[..., :L]
        d0dn = take_plane(d0dn_full, sol_d)
        Db = Db + jnp.where(
            myT, adn * truncated_kernel(qdn - d0dn[None], kernel, tol),
            0.0)

        # messages on later edges
        Ac = bp.col(MA, c)
        Bn = bp.col(MB, c + 1)
        Di = Db + Ac[0] + Ac[1] + Bn[0] + _supb(Bn[1], nb)
        Di = Di + jnp.where(mx0, SxL + jnp.roll(SxR, 1, axis=-1), 0.0)
        Di = Di + jnp.where(my0, syu0 + syd0, 0.0)

        sol = jnp.argmin(Di, axis=0).astype(jnp.int32)
        E = E + jnp.sum(
            jnp.where(pix_c > 0, take_plane(Db, sol), 0.0), dtype=acc_t)
        sols = _set_col(sols, c, sol)
        return (sols, E), None

    sols0 = jnp.zeros((T + 2, spec.L), jnp.int32)
    (sols, E), _ = lax.scan(step, (sols0, jnp.zeros((), acc_t)),
                            jnp.arange(T))
    labels = from_cols(sols.astype(bp.dtype), spec).astype(jnp.int32)
    return labels, E


def solve_banded(
    unary: jax.Array,  # [K, H, W]
    positions: jax.Array,  # D0 [K, H, W]
    nbr_positions: jax.Array,  # Q [4, K, H, W]
    alphas: jax.Array,  # [4, H, W]
    *,
    kernel: int,
    tol,
    Bh: int,
    Bw: int,
    maxiter: int = 1000,
    max_relgap: float = 1e-4,
    messages: jax.Array | None = None,  # [4, K, H, W] warm start
    check_every: int = 1,
) -> TRWSResult:
    """Banded-order TRW-S; drop-in for trws.solve / wavefront.solve_wavefront.

    Bh x Bw is the block size: T = Bh + Bw - 1 parallel steps per pass.
    Bh = H, Bw = W reproduces the raster wavefront exactly.

    For repeated chunked solves of one problem (races, pooled drivers) use
    BandedRun, which packs the problem once instead of per call."""
    K, H, W = unary.shape
    dtype = unary.dtype
    spec = BandedSpec(H, W, Bh, Bw)
    bp = _BandedProblem(unary, positions, nbr_positions, alphas, spec,
                        kernel, tol)
    acc_t = _acc_t(bp)

    def sweep_fn(state):
        return _sweep_scan(bp, state)

    if messages is None:
        messages = jnp.zeros((4, K, H, W), dtype)
    state0 = messages_to_state(messages, bp)

    def one_check(state):
        state, lbs = lax.scan(lambda s, _: sweep_fn(s), state,
                              jnp.arange(check_every))
        lb = lbs[-1]
        labels, energy = _decode_state(bp, state)
        return state, energy, lb, labels

    def cond(full):
        _, it, energy, lb, _ = full
        relgap = jnp.where(energy != 0, (energy - lb) / energy, 0.0)
        return jnp.logical_and(
            it < maxiter, jnp.logical_or(it == 0, relgap >= max_relgap))

    def body(full):
        state, it, _, _, _ = full
        state, energy, lb, labels = one_check(state)
        return (state, it + check_every, energy, lb, labels)

    zero = jnp.zeros((), acc_t)
    full0 = (state0, jnp.zeros((), jnp.int32), zero, zero,
             jnp.zeros((H, W), jnp.int32))
    state, iters, energy, lb, labels = lax.while_loop(cond, body, full0)
    return TRWSResult(labels, energy, lb, iters,
                      state_to_messages(state, bp))


class BandedRun:
    """Prepared banded solver: pack the problem once, sweep in jitted chunks.

    solve_banded re-skews/re-packs the problem inside every call — fine for
    one solve, wasteful for chunked driving.  BandedRun hoists
    _BandedProblem out of the hot path; `run(state, n)` compiles once per
    distinct n and then costs n sweeps + one decode.

    Usage:
        r = BandedRun(unary, D0, Q, alphas, kernel=1, tol=2.0, Bh=64, Bw=64)
        state = r.init_state()
        state, energy, lb, labels = r.run(state, 100)   # chunk of 100 sweeps
        msgs = r.messages(state)                         # [4, K, H, W]
    """

    def __init__(self, unary, positions, nbr_positions, alphas, *, kernel,
                 tol, Bh, Bw, decode: str = "banded"):
        K, H, W = unary.shape
        self.spec = BandedSpec(H, W, Bh, Bw)
        self.bp = _BandedProblem(unary, positions, nbr_positions, alphas,
                                 self.spec, kernel, tol)
        # decode="raster": greedy decode under the *raster* order on this
        # state's messages (wavefront.decode_raster).  Measured (round 4) to
        # be systematically WORSE than the banded-order decode — on baby2
        # B=128 it plateaus ~8% above the host energy where the banded
        # decode + incumbent reaches it in 900 sweeps, and on small problems
        # it stays 0.3-2% above at convergence for every block size: the
        # greedy conditioned decode is only meaningful under the ordering
        # whose messages it reads (ComputeSolutionAndEnergy conditions on
        # *this order's* forward messages, minimize.cpp:223-264).  Kept as
        # the recorded refutation of ROADMAP's raster-decode candidate; the
        # production oscillation fix is BandedRun's incumbent tracking.
        if decode not in ("banded", "raster"):
            raise ValueError(f"unknown decode {decode!r}")
        self.decode = decode
        self._inputs = (unary, positions, nbr_positions, alphas)
        self._sk = None
        self._chunk_cache = {}
        self.K, self.H, self.W = K, H, W
        self.dtype = unary.dtype

    def init_state(self, messages=None):
        if messages is None:
            messages = jnp.zeros((4, self.K, self.H, self.W), self.dtype)
        return messages_to_state(messages, self.bp)

    def run(self, state, sweeps: int, decode_every: int | None = None):
        """sweeps passes, decoding every `decode_every` sweeps (default:
        once at the end) and keeping the best labeling seen — the TRW-S
        greedy decode oscillates around convergence (ROADMAP.md: banded
        findings), so frequent cheap decodes + an incumbent reach a target
        energy in fewer sweeps.  -> (state, best_energy, lb, best_labels)."""
        if decode_every is None or decode_every >= sweeps:
            decode_every = sweeps
        sweeps = (sweeps // decode_every) * decode_every
        key = (sweeps, decode_every, self.decode)
        fn = self._chunk_cache.get(key)
        if fn is None:
            spec, K, kernel, tol = (self.spec, self.K, self.bp.kernel,
                                    self.bp.tol)
            n_seg = sweeps // decode_every
            W = self.W

            def chunk(tree, sk_tree, state):
                bp = self.bp.with_tree(tree)

                def sweep(s):
                    return _sweep_scan(bp, s)

                def decode_fn(state):
                    if sk_tree is None:
                        return _decode_state(bp, state)
                    from stereo_tpu.solvers import wavefront as wf

                    sk = self._sk.with_tree(sk_tree)
                    msgs = state_to_messages(state, bp)
                    return wf.decode_raster(
                        sk, wf.messages_to_groups(msgs, W))

                def segment(carry, _):
                    state, bestE, bestL = carry
                    state, lbs = lax.scan(lambda s, _: sweep(s), state,
                                          jnp.arange(decode_every))
                    labels, energy = decode_fn(state)
                    better = energy < bestE
                    bestE = jnp.where(better, energy, bestE)
                    bestL = jnp.where(better, labels, bestL)
                    return (state, bestE, bestL), lbs[-1]

                big = jnp.asarray(jnp.inf, _acc_t(bp))
                lab0 = jnp.zeros((spec.H, spec.W), jnp.int32)
                (state, bestE, bestL), lbs = lax.scan(
                    segment, (state, big, lab0), jnp.arange(n_seg))
                return state, bestE, lbs[-1], bestL

            fn = jax.jit(chunk, donate_argnums=2)
            self._chunk_cache[key] = fn
        sk_tree = None
        if self.decode == "raster":
            if self._sk is None:
                from stereo_tpu.solvers import wavefront as wf

                self._sk = wf._Skewed(*self._inputs, self.bp.kernel,
                                      self.bp.tol)
            sk_tree = self._sk.tree()
        return fn(self.bp.tree(), sk_tree, state)

    def messages(self, state):
        return state_to_messages(state, self.bp)


def messages_to_state(messages: jax.Array, bp: _BandedProblem):
    """[4, K, H, W] -> (MA, MB, (SxL, SxR, SyU, SyD)).

    Interior entries go to the skewed column arrays (seam positions zeroed by
    the interior masks on first use); seam entries to the side arrays."""
    spec = bp.spec
    MA = to_cols(jnp.stack([messages[d] for d in GROUP_A], 0), spec)
    MB = to_cols(jnp.stack([messages[d] for d in GROUP_B], 0), spec)
    SxL = jnp.where(bp.vSxL, _x_lanes(messages[LT], spec, 0), 0.0)
    SxR = jnp.where(bp.vSxR, _x_lanes(messages[RT], spec, spec.Bw - 1), 0.0)
    SyU = jnp.where(bp.vSyU, _y_lanes(messages[UP], spec, 0), 0.0)
    SyD = jnp.where(bp.vSyD, _y_lanes(messages[DN], spec, spec.Bh - 1), 0.0)
    # zero the seam positions inside the column arrays so interior reads of
    # untouched columns never double-count (interior sends keep them zero)
    vA = bp.vA
    vB = bp.vB
    MA = MA * (vA[:, :, None, :] > 0)
    MB = MB * (vB[:, :, None, :] > 0)
    return MA, MB, (SxL, SxR, SyU, SyD)


def state_to_messages(state, bp: _BandedProblem) -> jax.Array:
    """Inverse of messages_to_state: reassemble [4, K, H, W]."""
    spec = bp.spec
    MA, MB, (SxL, SxR, SyU, SyD) = state
    A = from_cols(MA, spec)  # [2, K, H, W]
    B = from_cols(MB, spec)
    m_lt = B[0] + _x_lanes_back(jnp.where(bp.vSxL, SxL, 0.0), spec, 0)
    m_rt = A[0] + _x_lanes_back(jnp.where(bp.vSxR, SxR, 0.0), spec,
                                spec.Bw - 1)
    m_up = B[1] + _y_lanes_back(jnp.where(bp.vSyU, SyU, 0.0), spec, 0)
    m_dn = A[1] + _y_lanes_back(jnp.where(bp.vSyD, SyD, 0.0), spec,
                                spec.Bh - 1)
    return jnp.stack([m_lt, m_rt, m_up, m_dn], 0)
