"""Edge-modes new-view renderer (ibr_edgemodes.m — Woodford et al. CVPR'07,
"Efficient New-view Synthesis using Pairwise Dictionary Priors").

Pipeline (reference: imrender/ojw/ibr_edgemodes.m):
  1. for every output pixel and disparity, project into each input view and
     sample colours (vgg_interp2, oobv = -1000);
  2. per pixel: truncated-quadratic colour modes over the (input x depth)
     library (truncquad_modes) — the label set;
  3. per 4-neighbour edge: pairwise dictionary costs between the two pixels'
     mode sets (truncquad_edges with thresh = 1e100, weight = lambda);
  4. choose one mode per pixel with TRW-S over explicit tables
     (vgg_trw_bp -> solvers/trws_tables), or the per-pixel argmin when
     lambda = 0 (slice_cell_image's no-labelling branch);
  5. assemble the rendered image from the selected modes.

Array shape: the reference loops column-by-column with cell arrays of
variable-size mode sets; here every stage is one dense device program over
[H, W] with a fixed per-pixel mode capacity `max_modes` (+BIG unary padding),
which is also what the table solver needs.  The reference's 8-connect option
adds diagonal edges the checkerboard table solver does not carry —
connect=4 only (recorded in COVERAGE.md).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from stereo_tpu import geometry
from stereo_tpu.ops import interp
from stereo_tpu.render import edges as edges_mod
from stereo_tpu.render import modes as modes_mod
from stereo_tpu.solvers import trws_tables

OOBV = -1000.0
PAD_UNARY = 1e9


def sample_depth_colors(images, P, disps, sz) -> jax.Array:
    """Project every output pixel at every disparity into each input view and
    sample colours.  images: list of [Hin, Win, C]; P: [N, 3, 4] projections
    relative to the output view (columns act on [x, y, 1, d]); disps: [M].
    Returns [N, M, H, W, C] samples (OOBV outside)."""
    H, W = sz
    dtype = jnp.asarray(images[0]).dtype
    xs, ys = jnp.meshgrid(jnp.arange(1, W + 1, dtype=dtype),
                          jnp.arange(1, H + 1, dtype=dtype))
    base = jnp.stack([xs, ys, jnp.ones_like(xs)], 0)  # [3, H, W]
    disps = jnp.asarray(disps, dtype)
    out = []
    for a in range(len(images)):
        Pa = jnp.asarray(P[a], dtype)
        T = jnp.tensordot(Pa[:, :3], base, axes=1)  # [3, H, W]
        p3 = Pa[:, 3]
        uvw = T[None] + disps[:, None, None, None] * p3[None, :, None, None]
        z = 1.0 / uvw[:, 2]
        u = uvw[:, 0] * z
        v = uvw[:, 1] * z
        out.append(interp.interp2(jnp.asarray(images[a], dtype), u, v,
                                  oobv=OOBV))  # [M, H, W, C]
    return jnp.stack(out, 0)


@dataclasses.dataclass
class RenderResult:
    image: jax.Array  # [H, W, C]
    depth: jax.Array  # [H, W] selected disparity values
    energy: float | None
    lower_bound: float | None


def render_edgemodes(images, P, disps, sz, *, lam: float = 20.0,
                     thresh: float = 30.0, max_modes: int = 8,
                     maxiter: int = 100, max_relgap: float = 1e-4,
                     mode: str = "trws") -> RenderResult:
    """Render the output view (see module docstring).

    thresh is the per-channel colour threshold; the working threshold is
    colors * thresh**2 (ibr_edgemodes.m:33)."""
    H, W = sz
    I = sample_depth_colors(images, P, disps, sz)  # [N, M, H, W, C]
    N, M = I.shape[:2]
    C = I.shape[-1]
    work_thresh = C * float(thresh) ** 2

    lib = jnp.transpose(I, (2, 3, 4, 0, 1))  # [H, W, C, N(L), M]
    md = modes_mod.truncquad_modes(lib, work_thresh, use_variance=0,
                                   search_width=10_000,
                                   max_modes=max_modes)
    unary = jnp.where(jnp.isfinite(md["energy"]), md["energy"], PAD_UNARY)
    unary = jnp.moveaxis(unary, -1, 0)  # [K, H, W]
    disps = jnp.asarray(disps, I.dtype)
    depth_of_mode = md["depth"]  # [H, W, K]

    if lam > 0:
        # per-pixel libraries flattened over (input, depth) sample pairs
        lib_flat = lib.reshape(H, W, C, N * M)
        tables = []
        for d in range(geometry.NUM_DIRS):
            dy, dx = geometry.DIRS[d]
            shift = lambda a: jnp.roll(a, (-dy, -dx), axis=(0, 1))
            t = edges_mod.truncquad_edges(
                shift(lib_flat), lib_flat, shift(md["modes"]), md["modes"],
                1e100, lam)  # [H, W, K_tail, K_head]
            tables.append(jnp.transpose(t, (2, 3, 0, 1)))
        tables = jnp.stack(tables, 0)  # [4, K, K, H, W]
        res = trws_tables.solve_tables(unary, tables, maxiter=maxiter,
                                       max_relgap=max_relgap, mode=mode)
        labels = res.labels
        energy, lower_bound = float(res.energy), float(res.lower_bound)
    else:
        labels = jnp.argmin(unary, axis=0)
        energy = float(jnp.sum(jnp.min(unary, axis=0)))
        lower_bound = None

    sel = labels[..., None]  # [H, W, 1]
    image = jnp.take_along_axis(md["modes"], sel[..., None], axis=-2)[..., 0, :]
    depth_idx = jnp.take_along_axis(depth_of_mode, sel, axis=-1)[..., 0]
    depth = jnp.where(depth_idx >= 0,
                      disps[jnp.clip(depth_idx, 0, M - 1)], jnp.nan)
    return RenderResult(image=image, depth=depth, energy=energy,
                        lower_bound=lower_bound)
