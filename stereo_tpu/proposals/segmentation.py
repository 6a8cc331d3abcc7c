"""Image segmentation for smoothness weights and SegPln proposals.

Two backends mirroring the reference's pair (dispmap_globalstereo.m:121-134):

- ``felzenszwalb``: graph-based segmentation, entirely in the native C++
  runtime (the vgg_segment_gb equivalent).
- ``mean_shift``: EDISON-style mean-shift segmentation (the vgg_segment_ms
  equivalent): the *filtering* stage — iterating every pixel's (x, y, L, u, v)
  feature to its mode under uniform kernels — runs on device as a windowed
  vectorized jax program; the merge stage (mode connection, transitive region
  fusion, small-region pruning) is host-side union-find in the native library.

Pinned to the transcription oracle in tests/oracle_meanshift.py: the filter
per-pixel against a serial numpy transcription of NewNonOptimizedFilter
(bit-identical outside summation-association knife edges —
tests/test_segmentation_parity.py), the merge label-map-exact against a
transcription of Connect/TransitiveClosure/Prune including the reference's
wrap-around Fill offsets.  The reference mex calls Segment(...,
HIGH_SPEEDUP) (vgg_segment_ms.cxx:74) — NewOptimizedFilter2, a
basin-of-attraction approximation layer over this exact filter; the merge
phases are identical under every speedup level.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import jax
import jax.numpy as jnp

from stereo_tpu import native


# --------------------------------------------------------------------- LUV

# EDISON's exact conversion constants (seg_ms/msImageProcessor.h:61-73):
# whitepoint (Xn, Yn, Zn) = (0.9505, 1, 1.0887) with u'/v' hardcoded to
# higher precision than the whitepoint derivation.
_RGB2XYZ = np.array(
    [
        [0.4125, 0.3576, 0.1804],
        [0.2125, 0.7154, 0.0721],
        [0.0193, 0.1192, 0.9502],
    ],
    dtype=np.float64,
)
_YN = 1.0
_UN = 0.19784977571475
_VN = 0.46834507665248


def rgb_to_luv(im: jax.Array) -> jax.Array:
    """[H, W, 3] RGB in [0, 255] -> CIE LUV.

    Matches EDISON's RGBtoLUV (seg_ms/msImageProcessor.cpp:835-875): XYZ from
    0..255 RGB, L* from y/(255*Yn) with the 903.3 linear branch below
    Lt = 0.008856, u*/v* against the hardcoded u'/v' whitepoint.  The
    denom == 0 branch (EDISON pins u' = 4, v' = 0.6) is irrelevant: it only
    fires for pure black where L = 0 makes u* = v* = 0 either way.
    """
    rgb = im / 255.0
    xyz = jnp.einsum("hwc,dc->hwd", rgb, jnp.asarray(_RGB2XYZ, im.dtype),
                     precision=jax.lax.Precision.HIGHEST)
    X, Y, Z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    y_ratio = Y / _YN
    L = jnp.where(
        y_ratio > 0.008856,
        116.0 * jnp.cbrt(y_ratio) - 16.0,
        903.3 * y_ratio,
    )
    denom = X + 15.0 * Y + 3.0 * Z
    denom = jnp.where(denom == 0, 1.0, denom)
    u_p = 4.0 * X / denom
    v_p = 9.0 * Y / denom
    u = 13.0 * L * (u_p - _UN)
    v = 13.0 * L * (v_p - _VN)
    return jnp.stack([L, u, v], axis=-1)


# ---------------------------------------------------------- mean-shift filter


_MS_EPSILON = 0.01  # EDISON's mode-convergence threshold (ms.h:106)
_MS_LIMIT = 100     # EDISON's per-pixel iteration cap (ms.h:111)


def mean_shift_filter(
    luv: jax.Array,  # [H, W, 3]
    h_s: int,
    h_r: float,
    max_iters: int = _MS_LIMIT,
) -> jax.Array:
    """Filter each pixel's joint feature (x, y, L, u, v) to its mode —
    EDISON's exact non-optimized lattice filter (NewNonOptimizedFilter,
    seg_ms/msImageProcessor.cpp:4305-4630), run for all pixels in lockstep
    with per-pixel freezing instead of EDISON's serial per-pixel loop:

    - joint space scaled by (h_s, h_r); uniform kernel = spatial distance^2
      < 1 AND range distance^2 < 1, both strict, tested separately;
    - the L-channel difference counts 4x when the current (scaled) L exceeds
      80/h_r (the ``hiLTr`` half-bandwidth quirk, :4484-4487);
    - convergence when the mean-shift vector's magnitude^2 drops below
      EPSILON = 0.01 — in *scaled* units for the first test, *unscaled*
      units thereafter (:4609-4613, faithfully including the asymmetry) —
      or after LIMIT = 100 steps; the final vector is applied once more
      after the loop exits (:4619-4620).

    The neighborhood is gathered around the rounded current position with a
    static window of radius ceil(h_s + sqrt(1/2)) pixels, a superset of
    EDISON's 3^3 bucket search at cell width h_s.

    The strict window tests are knife-edge at integer h_s: the first
    iteration evaluates lattice points at spatial distance exactly h_s,
    where ``dsp < 1.0`` is decided by the last bit of
    ``(x+h_s)/h_s - x/h_s``.  XLA:CPU strengthens division by a constant
    into multiplication by its reciprocal, which changes that bit vs the
    reference's plain IEEE division — so every constant-divisor scaling
    (lattice coordinates, luv/h_r) is computed host-side with numpy and
    the kernel only gathers from the exact tables; the distance sums are
    additionally assembled across ``lax.optimization_barrier`` against FMA
    contraction.  Verified per-pixel against the serial transcription in
    tests/oracle_meanshift.py.
    """
    luv = np.asarray(luv)
    sval = np.asarray(luv / np.asarray(luv.dtype.type(h_r)), luv.dtype)
    return _mean_shift_filter_scaled(jnp.asarray(sval), int(h_s),
                                     float(h_r), int(max_iters))


@functools.partial(jax.jit, static_argnames=("h_s", "h_r", "max_iters"))
def _mean_shift_filter_scaled(sval, h_s, h_r, max_iters):
    H, W, _ = sval.shape
    dtype = sval.dtype
    sS = float(h_s)
    sR = float(h_r)
    # exact host-side IEEE divisions, embedded as constant gather tables
    rows_np = (np.arange(H) / np.asarray(sS, np.dtype(dtype))).astype(dtype)
    cols_np = (np.arange(W) / np.asarray(sS, np.dtype(dtype))).astype(dtype)
    rows = jnp.asarray(rows_np)
    cols = jnp.asarray(cols_np)
    ys0 = jnp.broadcast_to(rows[:, None], (H, W))
    xs0 = jnp.broadcast_to(cols[None, :], (H, W))
    hiLTr = 80.0 / sR

    # |pixel - round(pos)| <= |pixel - pos| + |pos - round(pos)| and the
    # per-coordinate rounding error of 0.5 is sqrt(1/2) in Euclidean norm,
    # so radius h_s + sqrt(1/2) bounds the offsets that can ever pass the
    # dsp < 1 test (h_s + 0.5 misses lattice points when both coordinates
    # round near half-integers)
    slack = float(np.sqrt(0.5)) + 1e-9
    R = int(np.ceil(sS + slack))
    offs = [(dy, dx) for dy in range(-R, R + 1) for dx in range(-R, R + 1)
            if dy * dy + dx * dx <= (sS + slack) ** 2]
    offs_np = np.array(offs, dtype=np.int32)  # [M, 2]

    def ms_vector(pos_y, pos_x, val):
        """EDISON's LatticeMSVector: mean of in-window points minus yk."""
        cy = jnp.clip(jnp.round(pos_y * sS).astype(jnp.int32), 0, H - 1)
        cx = jnp.clip(jnp.round(pos_x * sS).astype(jnp.int32), 0, W - 1)
        acc_y = jnp.zeros((H, W), dtype)
        acc_x = jnp.zeros((H, W), dtype)
        acc_v = jnp.zeros((H, W, 3), dtype)
        acc_n = jnp.zeros((H, W), dtype)
        quad = jnp.where(val[..., 0] > hiLTr, 4.0, 1.0).astype(dtype)
        for m in range(len(offs_np)):
            dy, dx = int(offs_np[m, 0]), int(offs_np[m, 1])
            ny = cy + dy
            nx = cx + dx
            inb = (ny >= 0) & (ny < H) & (nx >= 0) & (nx < W)
            nyc = jnp.clip(ny, 0, H - 1)
            nxc = jnp.clip(nx, 0, W - 1)
            nval = sval[nyc, nxc]  # [H, W, 3] scaled
            nyf = rows[nyc]
            nxf = cols[nxc]
            bar = jax.lax.optimization_barrier
            dsp = bar((nyf - pos_y) ** 2) + bar((nxf - pos_x) ** 2)
            dL = nval[..., 0] - val[..., 0]
            dr = (bar(quad * dL * dL)
                  + bar((nval[..., 1] - val[..., 1]) ** 2)
                  + bar((nval[..., 2] - val[..., 2]) ** 2))
            w = (inb & (dsp < 1.0) & (dr < 1.0)).astype(dtype)
            acc_y = acc_y + w * nyf
            acc_x = acc_x + w * nxf
            acc_v = acc_v + w[..., None] * nval
            acc_n = acc_n + w
        has = acc_n > 0
        n = jnp.maximum(acc_n, 1.0)
        mh_y = jnp.where(has, acc_y / n - pos_y, 0.0)
        mh_x = jnp.where(has, acc_x / n - pos_x, 0.0)
        mh_v = jnp.where(has[..., None], acc_v / n[..., None] - val, 0.0)
        return mh_y, mh_x, mh_v

    mh_y0, mh_x0, mh_v0 = ms_vector(ys0, xs0, sval)
    # first magnitude test is in scaled units (:4520-4523)
    mv0 = mh_y0 ** 2 + mh_x0 ** 2 + jnp.sum(mh_v0 ** 2, axis=-1)

    def cond(state):
        it, _, _, _, _, _, _, mv = state
        return jnp.logical_and(it < max_iters, jnp.max(mv) >= _MS_EPSILON)

    def step(state):
        it, py, px, val, my, mx, mv_, mv = state
        active = mv >= _MS_EPSILON
        py = jnp.where(active, py + my, py)
        px = jnp.where(active, px + mx, px)
        val = jnp.where(active[..., None], val + mv_, val)
        ny_, nx_, nv_ = ms_vector(py, px, val)
        my = jnp.where(active, ny_, my)
        mx = jnp.where(active, nx_, mx)
        mv_ = jnp.where(active[..., None], nv_, mv_)
        # subsequent tests use unscaled magnitudes (:4609-4613)
        mv_new = ((my ** 2 + mx ** 2) * (sS * sS)
                  + jnp.sum(mv_ ** 2, axis=-1) * (sR * sR))
        mv = jnp.where(active, mv_new, mv)
        return it + 1, py, px, val, my, mx, mv_, mv

    state = (jnp.ones((), jnp.int32), ys0, xs0, sval, mh_y0, mh_x0, mh_v0,
             mv0)
    _, _, _, val, _, _, mh_v, _ = jax.lax.while_loop(cond, step, state)
    # the final shift is applied on every exit path (:4619-4620)
    return (val + mh_v) * sR


# ------------------------------------------------------------ public wrappers


def mean_shift(im_rgb, h_s: int, h_r: float, min_region: int,
               max_iters: int = _MS_LIMIT) -> np.ndarray:
    """EDISON-style segmentation -> uint32 labels [H, W], 1-based.

    The vgg_segment_ms(A, h_s, h_r, min_sz) equivalent.
    """
    im = jnp.asarray(np.asarray(im_rgb), jnp.float32)
    luv = rgb_to_luv(im)
    modes = np.asarray(mean_shift_filter(luv, int(h_s), float(h_r),
                                         max_iters), dtype=np.float32)
    return connect_modes(modes, h_r, min_region)


def connect_modes(modes: np.ndarray, h_r: float,
                  min_region: int) -> np.ndarray:
    """The merge stage on filtered [H, W, 3] LUV modes (native union-find:
    mode connection, transitive closure, small-region pruning) -> uint32
    labels [H, W], 1-based."""
    modes = np.ascontiguousarray(modes, dtype=np.float32)
    H, W, _ = modes.shape
    labels = np.zeros((H, W), dtype=np.uint32)
    L = native.lib()
    L.connect_modes(
        modes.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, ctypes.c_float(float(h_r)), int(min_region),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return labels


def felzenszwalb(im_rgb, sigma: float, k: float, min_size: int) -> np.ndarray:
    """Graph-based segmentation -> uint32 labels [H, W], 1-based.

    The vgg_segment_gb(A, sigma, k, min_sz, 1) equivalent.
    """
    im = np.ascontiguousarray(np.asarray(im_rgb), dtype=np.float32)
    H, W = im.shape[:2]
    labels = np.zeros((H, W), dtype=np.uint32)
    L = native.lib()
    L.felzenszwalb(
        im.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, ctypes.c_float(float(sigma)), ctypes.c_float(float(k)),
        int(min_size),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return labels
