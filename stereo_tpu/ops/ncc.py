"""Normalized-cross-correlation cost volume and continuous-disparity sampling.

Array-program re-design of dispmap_ncc.m:116-276: the reference builds the NCC
volume with per-disparity MATLAB conv2 calls inside a parfor over levels; here
the disparity axis is the leading batch axis of one vectorized program — the
windowed statistics are zero-padded box sums (XLA reduce_window) over
channel-summed products, and the per-level warp is a single batched bilinear
sample.

Conventions follow the reference exactly:
- 5x5 patch (patchsize 2), statistics summed over RGB (dispmap_ncc.m:125-141);
- warp of the second image at level d resamples columns ceil(d)+1..W from
  x' = linspace(1, W-d, W-ceil(d)) (dispmap_ncc.m:146-153) — a pure shift for
  integer d;
- non-finite NCC values and columns x < round(d)+1 are zeroed
  (dispmap_ncc.m:190-191);
- continuous-d sampling fits a quadratic through the 3 volume samples around
  the nearest grid disparity (interpolate_ncc, dispmap_ncc.m:250-276), with
  nearest-index ties resolved upward like the reference's <=-scan
  (dispmap_ncc.m:230-236), clamped to the raw volume value at the grid ends
  and -1e6 outside the disparity range (dispmap_ncc.m:243-248).

The O(D) per-pixel nearest scan of the reference becomes a searchsorted on the
(static, sorted) disparity grid.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from stereo_tpu.ops.filters import box_sum
from stereo_tpu.geometry import take_plane
from stereo_tpu.ops.interp import interp2

LARGEVAL = 1e6


def _stats(im_dhwc, k2c):
    """(mean, box(sum_c .), norm) per dispmap_ncc.m:125-141; im: [..., H, W, C]."""
    s1 = box_sum(jnp.sum(im_dhwc, axis=-1), 2)  # box(sum_c I)
    s2 = box_sum(jnp.sum(im_dhwc * im_dhwc, axis=-1), 2)  # box(sum_c I^2)
    mean = s1 / k2c
    norm = jnp.sqrt(s2 - 2.0 * mean * s1 + k2c * mean * mean)
    return mean, s1, norm


def warp_grid(W: int, disparities: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Static per-level sample columns [D, W] (1-based) + validity mask [D, W].

    Column x (1-based) of level d samples the linspace(1, W-d, W-ceil(d))
    value; columns x <= ceil(d) are invalid (left filled with zeros).
    """
    D = len(disparities)
    xs = np.ones((D, W), dtype=np.float64)
    valid = np.zeros((D, W), dtype=bool)
    for l, d in enumerate(disparities):
        start = int(np.ceil(d + 1))  # first valid 1-based column
        n = W - start + 1
        if n <= 0:
            continue
        if n == 1:
            xs[l, start - 1:] = 1.0
        else:
            xs[l, start - 1:] = np.linspace(1.0, W - d, n)
        valid[l, start - 1:] = True
    return xs, valid


def compute_ncc(
    im0: jax.Array,  # reference image [H, W, C]
    im1: jax.Array,  # second image [H, W, C]
    disparities,  # static, ascending sequence of D disparities
    patch_radius: int = 2,
) -> jax.Array:
    """NCC volume [D, H, W] (dispmap_ncc.m:116-198)."""
    assert patch_radius == 2, "reference uses a fixed 5x5 patch"
    disparities = np.asarray(disparities, dtype=np.float64)
    H, W, C = im0.shape
    dtype = im0.dtype
    k2c = float((2 * patch_radius + 1) ** 2 * C)

    mean_r, s1_r, norm_r = _stats(im0, k2c)

    xs_np, valid_np = warp_grid(W, disparities)
    ys_full = jnp.broadcast_to(
        jnp.arange(1, H + 1, dtype=dtype)[:, None], (H, W)
    )
    col = jnp.arange(1, W + 1, dtype=dtype)[None, :]
    # first valid 1-based column: MATLAB round(d+1) rounds half away from zero
    starts_np = np.floor(disparities + 1.5)

    def level(args):
        xs_row, valid_row, start = args
        xs_full = jnp.broadcast_to(xs_row[None, :], (H, W))
        imtr = interp2(im1.astype(dtype), xs_full, ys_full, oobv=0.0)
        imtr = imtr * valid_row[None, :, None]
        mean_t, s1_t, norm_t = _stats(imtr, k2c)
        cross = box_sum(jnp.sum(im0 * imtr, axis=-1), 2)
        ncc_l = (
            cross - mean_r * s1_t - mean_t * s1_r + k2c * mean_t * mean_r
        ) / (norm_r * norm_t)
        ncc_l = jnp.where(jnp.isfinite(ncc_l), ncc_l, 0.0)
        # zero columns left of round(d)+1 (dispmap_ncc.m:144-146, 191)
        return jnp.where(col >= start, ncc_l, 0.0)

    # disparity levels as a chunked batch axis: peak memory ~8 warped images
    return jax.lax.map(
        level,
        (
            jnp.asarray(xs_np, dtype),
            jnp.asarray(valid_np, dtype),
            jnp.asarray(starts_np, dtype)[:, None, None],
        ),
        batch_size=8,
    )


def _parabola_coeffs(ncc, disparities, t2, y2, ok):
    """Quadratic r*d^2 + p*d + q through the 3 samples around index t2
    (interpolate_ncc, dispmap_ncc.m:250-276).  t2: [H, W] int32 0-based."""
    d = jnp.asarray(disparities, ncc.dtype)
    t1 = jnp.where(ok, t2 - 1, t2)
    t3 = jnp.where(ok, t2 + 1, t2)
    # one-hot selections (take_plane) instead of per-pixel gathers
    D = ncc.shape[0]
    db = jnp.broadcast_to(d[:, None, None], (D,) + t2.shape)
    d1 = take_plane(db, t1)
    d2 = take_plane(db, t2)
    d3 = take_plane(db, t3)
    y1 = take_plane(ncc, t1)
    y3 = take_plane(ncc, t3)

    safe = lambda den: jnp.where(ok, den, 1.0)
    a = y1 / safe((d1 - d2) * (d1 - d3))
    b = y2 / safe((d2 - d1) * (d2 - d3))
    c = y3 / safe((d3 - d1) * (d3 - d2))
    r = a + b + c
    p = -(a * (d2 + d3) + b * (d1 + d3) + c * (d1 + d2))
    q = a * d2 * d3 + b * d1 * d3 + c * d1 * d2
    return r, p, q, d2


def best_disparity(ncc: jax.Array, disparities) -> jax.Array:
    """WTA disparity with sub-sample parabola refinement
    (best_disp_from_ncc, dispmap_ncc.m:208-221)."""
    D = ncc.shape[0]
    t2 = jnp.argmax(ncc, axis=0).astype(jnp.int32)  # first max, as MATLAB max
    y2 = jnp.max(ncc, axis=0)
    ok = (t2 > 0) & (t2 < D - 1)
    r, p, q, d2 = _parabola_coeffs(ncc, disparities, t2, y2, ok)
    vertex = -p / (2.0 * jnp.where(r == 0, 1.0, r))
    return jnp.where(ok & (r != 0), vertex, d2)


def nearest_index(disparities, disp: jax.Array) -> jax.Array:
    """Index of the closest grid disparity, ties toward the larger index —
    matching the reference's <=-scan (dispmap_ncc.m:227-236)."""
    d = jnp.asarray(disparities, disp.dtype)
    D = d.shape[0]
    db = jnp.broadcast_to(d.reshape((D,) + (1,) * disp.ndim),
                          (D,) + disp.shape)
    # rank of disp in the ascending grid (= searchsorted 'left'), computed as
    # a full comparison sweep of D vectorized compares instead of log(D)
    # binary-search gathers
    j = jnp.sum((db < disp[None]).astype(jnp.int32), axis=0)
    j = jnp.clip(j, 0, D - 1)
    jm = jnp.clip(j - 1, 0, D - 1)
    pick_j = jnp.abs(disp - take_plane(db, j)) <= jnp.abs(
        disp - take_plane(db, jm))
    return jnp.where(pick_j, j, jm)


def sample_at(ncc: jax.Array, disparities, disp: jax.Array) -> jax.Array:
    """NCC value at continuous disparities (sample_ncc_from_disp,
    dispmap_ncc.m:222-249).  ``disparities`` may be a (traced) jax array —
    the grid is ascending by construction."""
    d = jnp.asarray(disparities, disp.dtype)
    D = ncc.shape[0]
    t2 = nearest_index(d, disp)
    y2 = take_plane(ncc, t2)
    ok = (t2 > 0) & (t2 < D - 1)
    r, p, q, _ = _parabola_coeffs(ncc, d, t2, y2, ok)
    val = r * disp * disp + p * disp + q
    val = jnp.where(t2 == 0, ncc[0], val)
    val = jnp.where(t2 == D - 1, ncc[D - 1], val)
    good = (disp >= d[0]) & (disp <= d[-1])
    return jnp.where(good, val, -LARGEVAL)
