"""Plane-proposal generators: fronto-parallel ladders and point-cloud fits.

Equivalents of the reference's fronto-parallel sweep (example_ncc.m:34-41) and
fit_plane_to_points (dispmap_ncc.m:67-92).  The IRLS loop reproduces the
reference literally — including its unusual reweighting w = sqrt(|r|) (which
*up*-weights large residuals; a textbook L1 IRLS would use 1/sqrt(|r|)) — so
proposal streams match the reference's behavior.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereo_tpu import geometry

# float32 products stay float32 on GPUs too (no TF32 rounding)
HIGHEST = jax.lax.Precision.HIGHEST


def fronto_parallel_ladder(H: int, W: int, disparities, dtype=jnp.float32):
    """One constant-disparity proposal per value. Returns [N, 4, H, W]."""
    return jnp.stack(
        [geometry.fronto_parallel(H, W, float(d), dtype) for d in disparities],
        axis=0,
    )


def fit_plane_to_points(xs, ys, disps, mask, *, l1: bool, irls_iters: int = 20):
    """Fit plane (a, b, c, d), c normalized to 1, to masked 3D points.

    Mirrors fit_plane_to_points (dispmap_ncc.m:67-92): center the points, find
    the normal as the smallest right singular vector (optionally IRLS-weighted
    for the L1 kernel), then d = -n . centroid and divide by the z component.

    xs, ys, disps, mask: [H, W] (mask bool).  Masked-out rows are replaced by
    the centroid so they contribute zero to the covariance — equivalent to
    dropping them, but shape-static for jit.
    """
    m = mask.astype(disps.dtype)
    n_pts = jnp.maximum(jnp.sum(m), 1.0)
    pts = jnp.stack([xs.ravel(), ys.ravel(), disps.ravel()], axis=1)  # [N, 3]
    w_mask = m.ravel()[:, None]
    c = jnp.sum(pts * w_mask, axis=0) / n_pts
    cost = -(pts - c) * w_mask  # masked rows -> zero rows

    def smallest_sv(mat):
        # smallest right singular vector via the 3x3 gram matrix — equivalent
        # to the reference's svd(...,'econ') V(:,end) (dispmap_ncc.m:81-82)
        # but O(N) instead of an [N,3] SVD
        gram = jnp.matmul(mat.T, mat, precision=HIGHEST)
        _, vecs = jnp.linalg.eigh(gram)
        return vecs[:, 0]  # eigh returns ascending eigenvalues

    if l1:
        # literal 20-iteration IRLS (dispmap_ncc.m:78-84): the first pass uses
        # unit weights, the returned normal comes from the final pass
        w = jnp.ones(cost.shape[0], cost.dtype)
        v = None
        for _ in range(max(irls_iters, 1)):
            v = smallest_sv(w[:, None] * cost)
            w = jnp.sqrt(jnp.abs(jnp.matmul(cost, v, precision=HIGHEST)))
    else:
        v = smallest_sv(cost)

    d = -jnp.dot(v, c, precision=HIGHEST)
    p = jnp.concatenate([v, d[None]])
    return p / p[2]
