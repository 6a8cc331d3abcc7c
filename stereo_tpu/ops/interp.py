"""Bilinear image sampling — the vgg_interp2 equivalent.

Semantics match imrender/vgg/vgg_interp2.cxx (linear path, :246-323):
1-based coordinates, a point is in bounds iff 1 <= x <= W and 1 <= y <= H
(boundary inclusive: the floor index is clamped to W-1/H-1 so x == W
degenerates to exact edge interpolation, as the mex's explicit boundary
branches do); out-of-bounds points get the scalar ``oobv``.

This lowers to vectorized dynamic gathers; the sampling grids of the
cost-volume builders are affine in the pixel index, so XLA turns most uses
into shifted dense reads.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def interp2(im: jax.Array, x: jax.Array, y: jax.Array, oobv=jnp.nan) -> jax.Array:
    """Sample ``im`` at 1-based continuous coordinates.

    im: [H, W] or [H, W, C]; x, y: any (equal) shape S.
    Returns S or S + (C,) matching im's trailing channels.
    """
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    H, W, C = im.shape
    compute_dtype = jnp.promote_types(im.dtype, x.dtype)
    imf = im.astype(compute_dtype)

    valid = (x >= 1) & (x <= W) & (y >= 1) & (y <= H)

    x0 = jnp.clip(jnp.floor(x), 1, max(W - 1, 1))
    y0 = jnp.clip(jnp.floor(y), 1, max(H - 1, 1))
    u = (x - x0).astype(compute_dtype)[..., None]
    v = (y - y0).astype(compute_dtype)[..., None]
    xi = x0.astype(jnp.int32) - 1  # 0-based
    yi = y0.astype(jnp.int32) - 1
    # clip for safety on invalid points (result discarded via `valid`)
    xi = jnp.clip(xi, 0, W - 2 if W > 1 else 0)
    yi = jnp.clip(yi, 0, H - 2 if H > 1 else 0)

    a = imf[yi, xi]
    b = imf[yi, xi + 1]
    c = imf[yi + 1, xi]
    d = imf[yi + 1, xi + 1]
    top = a + (b - a) * u
    bot = c + (d - c) * u
    out = top + (bot - top) * v

    out = jnp.where(valid[..., None], out, jnp.asarray(oobv, compute_dtype))
    if squeeze:
        out = out[..., 0]
    return out


def interp2_cubic(im: jax.Array, x: jax.Array, y: jax.Array, oobv=jnp.nan) -> jax.Array:
    """Cubic-hermite sampling with the mex's exact weight polynomial and
    in-bounds window [2, W-1) x [2, H-1) (vgg_interp2.cxx:325-368)."""
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    H, W, C = im.shape
    compute_dtype = jnp.promote_types(im.dtype, x.dtype)
    imf = im.astype(compute_dtype)

    valid = (x >= 2) & (x < W - 1) & (y >= 2) & (y < H - 1)
    x0 = jnp.clip(jnp.floor(x), 2, max(W - 2, 2)).astype(jnp.int32)
    y0 = jnp.clip(jnp.floor(y), 2, max(H - 2, 2)).astype(jnp.int32)
    u = (x - x0).astype(compute_dtype)[..., None]
    v = (y - y0).astype(compute_dtype)[..., None]

    def col_interp(cs, t):
        c0, c1, c2, c3 = cs
        a = (c3 + c1) - (c2 + c0)
        return t**3 * a + t**2 * ((c0 - c1) - a) + t * (c2 - c0) + c1

    rows = []
    for m in range(4):
        xi = jnp.clip(x0 - 2 + m, 0, W - 1)
        cs = [imf[jnp.clip(y0 - 2 + n, 0, H - 1), xi] for n in range(4)]
        rows.append(col_interp(cs, v))
    out = col_interp(rows, u)
    out = jnp.where(valid[..., None], out, jnp.asarray(oobv, compute_dtype))
    if squeeze:
        out = out[..., 0]
    return out


def interp2_nearest(im: jax.Array, x: jax.Array, y: jax.Array, oobv=jnp.nan) -> jax.Array:
    """Nearest-neighbor sampling; in-bounds window [0.5, W+0.5) as the mex
    (vgg_interp2.cxx:218-243)."""
    squeeze = im.ndim == 2
    if squeeze:
        im = im[..., None]
    H, W, C = im.shape
    valid = (x >= 0.5) & (x < W + 0.5) & (y >= 0.5) & (y < H + 0.5)
    xi = jnp.clip(jnp.round(x).astype(jnp.int32) - 1, 0, W - 1)
    yi = jnp.clip(jnp.round(y).astype(jnp.int32) - 1, 0, H - 1)
    out = im[yi, xi]
    out = jnp.where(valid[..., None], out, jnp.asarray(oobv, im.dtype))
    if squeeze:
        out = out[..., 0]
    return out
