"""Coarse-to-fine warm starting for the checkerboard TRW-S solver.

The checkerboard schedule propagates information one pixel per sweep; on
large grids the dual variables need many sweeps to carry long-range context.
Classic multigrid fix: build a pyramid of coarsened problems (2x2 pixel
blocks; labels are global proposals so the label set is unchanged), run the
solver coarse-to-fine, and upsample the converged messages as the warm start
of the next level.  The warm start is *only* an initializer — any message
state is a valid dual point — so the fine-level bound and stopping rule keep
their exact TRW-S semantics.

STATUS: EXPERIMENTAL — no regime where the pyramid pays has been found.
On baby2-scale workloads the checkerboard solver reaches its LP plateau
within a few thousand cheap sweeps without it.  A purpose-built long-range
instance (round 5: 256x512, informative unaries only at the left/right
border columns, strong smoothness carrying the split across 500+ pixels —
the best case for coarse-grid information transport) was measured and the
pyramid LOST: at ~50 fine-equivalent sweeps the warm-started fine level
decodes E=113k vs the cold solver's 90k at 30 sweeps; at ~133 equivalents
124k-49.5k vs cold's 47k at 100.  The upsampled coarse messages bias the
fine dual toward block-constant splits that the fine schedule must first
undo.  Correctness is unaffected (any message state is a valid dual
point); kept as a recorded experiment, not a production path.

Coarsening rules: unaries are summed over each block (a block acts as one
pixel taking one label), positions are averaged, directed-edge weights sum
the parallel boundary edges of the block pair.  Messages upsample by
replication scaled by 1/2 per parallel-edge split so dual magnitudes stay
balanced.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from stereo_tpu.solvers import trws
from stereo_tpu.solvers.trws import TRWSResult


def _pool_sum(x, f):
    """Sum over f x f blocks of the last two axes (shape must divide)."""
    shape = x.shape[:-2] + (x.shape[-2] // f, f, x.shape[-1] // f, f)
    return x.reshape(shape).sum(axis=(-3, -1))


def _crop_to_multiple(x, f):
    H, W = x.shape[-2:]
    return x[..., : H - H % f, : W - W % f]


def coarsen(unary, D0, Q, alphas, f: int = 2):
    """One pyramid level: [K, H, W] fields -> [K, H//f, W//f]."""
    unary_c = _pool_sum(_crop_to_multiple(unary, f), f)
    D0_c = _pool_sum(_crop_to_multiple(D0, f), f) / (f * f)
    Q_c = _pool_sum(_crop_to_multiple(Q, f), f) / (f * f)
    alphas_c = _pool_sum(_crop_to_multiple(alphas, f), f) / f
    # zero the coarse border in-edges that no longer exist
    from stereo_tpu import geometry

    Hc, Wc = unary_c.shape[-2:]
    valid = jnp.stack(
        [geometry.valid_mask(Hc, Wc, d, dtype=unary.dtype) for d in range(4)], 0
    )
    return unary_c, D0_c, Q_c, alphas_c * valid


def upsample_messages(messages, target_hw, f: int = 2):
    """[4, K, Hc, Wc] -> [4, K, H, W] by replication, halved per split edge."""
    up = jnp.repeat(jnp.repeat(messages, f, axis=-2), f, axis=-1) / f
    H, W = target_hw
    pad_h = H - up.shape[-2]
    pad_w = W - up.shape[-1]
    if pad_h or pad_w:
        up = jnp.pad(up, [(0, 0)] * (up.ndim - 2) + [(0, pad_h), (0, pad_w)])
    return up


def solve_hierarchical(
    unary, D0, Q, alphas, *, kernel, tol, maxiter=1000, max_relgap=1e-4,
    levels: int = 3, coarse_sweeps: int = 300, check_every: int = 8,
) -> TRWSResult:
    """Pyramid warm start + exact fine-level solve (same contract as
    trws.solve)."""
    # build pyramid
    pyramid = [(unary, D0, Q, alphas)]
    for _ in range(levels - 1):
        u, d0, q, al = pyramid[-1]
        if min(u.shape[-2:]) < 16:
            break
        pyramid.append(coarsen(u, d0, q, al))

    messages = None
    for lvl in range(len(pyramid) - 1, 0, -1):
        u, d0, q, al = pyramid[lvl]
        res = trws.solve(
            u, d0, q, al, kernel=kernel, tol=tol, maxiter=coarse_sweeps,
            max_relgap=max_relgap, messages=messages,
            check_every=check_every,
        )
        target_hw = pyramid[lvl - 1][0].shape[-2:]
        messages = upsample_messages(res.messages, target_hw)

    u, d0, q, al = pyramid[0]
    return trws.solve(
        u, d0, q, al, kernel=kernel, tol=tol, maxiter=maxiter,
        max_relgap=max_relgap, messages=messages, check_every=check_every,
    )


def wavefront_warm_start(
    unary, D0, Q, alphas, *, kernel, tol, levels: int = 3,
    coarse_sweeps: int = 200,
):
    """Coarse-to-fine warm start for the *wavefront* (raster-order) solver:
    solve the coarsened pyramid with wavefront sweeps and return upsampled
    fine-level messages [4, K, H, W].

    The raster schedule already mixes along whole rows/columns per sweep, so
    it needs far fewer sweeps than the checkerboard — but each fine sweep is
    expensive (T sequential diagonals); a few cheap quarter-size coarse
    sweeps replace most of them.  Like solve_hierarchical, the result is only
    an initializer: the fine solve keeps exact TRW-S semantics and bounds.
    """
    from stereo_tpu.solvers import wavefront

    pyramid = [(unary, D0, Q, alphas)]
    for _ in range(levels - 1):
        u, d0, q, al = pyramid[-1]
        if min(u.shape[-2:]) < 16:
            break
        pyramid.append(coarsen(u, d0, q, al))

    messages = None
    for lvl in range(len(pyramid) - 1, 0, -1):
        u, d0, q, al = pyramid[lvl]
        res = wavefront.solve_wavefront(
            u, d0, q, al, kernel=kernel, tol=tol, maxiter=coarse_sweeps,
            max_relgap=1e-12, messages=messages, check_every=coarse_sweeps,
        )
        target_hw = pyramid[lvl - 1][0].shape[-2:]
        messages = upsample_messages(res.messages, target_hw)
    return messages
