"""Checkerboard compaction along H: one array per color, half the rows.

The checkerboard TRW-S phases (solvers/trws.py) update every edge's message
from its phase-color endpoint; the straightforward dense formulation computes
*both* update variants for every pixel and selects by the color mask — a
clean 2x compute waste.  Compacting each color's pixels into their own
``[..., Hc, W]`` array (Hc = ceil(H/2)) removes the waste: each variant is
computed once, on the half-grid where it is selected.

Layout.  Pixel (y, x) has color ``(y + x) % 2``.  Compacting along H keeps
the minor (W) axis contiguous, so the flattened half-grid is still dense rows
of W pixels:

    V_c[..., yc, x] = V[..., 2*yc + (c + x) % 2, x]

i.e. column x of color c holds full rows ``(c+x) % 2, (c+x) % 2 + 2, ...``.
Within-color neighbor access is then:

  - horizontal neighbors (same compact row, lane +-1): the tail's column
    parity bit equals the head's, so ``yc`` is unchanged;
  - vertical neighbors: ``yc + bit`` (down) / ``yc + bit - 1`` (up) where
    ``bit = (c + x) % 2`` — a per-lane select between the array and its
    row-shifted copy.

For odd H the last compact row of the ``(c + x) % 2 == 1`` columns is
padding; consumers mask it with the compacted validity/pixel masks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from stereo_tpu.geometry import DIRS


def compact_h(a: jax.Array, color: int) -> jax.Array:
    """[..., H, W] -> [..., Hc, W]: keep only color-``color`` pixels.

    Pad cells (odd H) are zero."""
    H, W = a.shape[-2:]
    He = H + (H % 2)
    if He != H:
        a = jnp.pad(a, [(0, 0)] * (a.ndim - 2) + [(0, He - H), (0, 0)])
    even = a[..., 0::2, :]
    odd = a[..., 1::2, :]
    bit = (color + jnp.arange(W)) % 2  # [W]
    return jnp.where(bit == 1, odd, even)


def expand_h(v0: jax.Array, v1: jax.Array, H: int) -> jax.Array:
    """Inverse of compact_h: (color-0, color-1 arrays) -> [..., H, W]."""
    Hc, W = v0.shape[-2:]
    xpar = jnp.arange(W) % 2
    evens = jnp.where(xpar == 0, v0, v1)  # full row 2*yc: color = x % 2
    odds = jnp.where(xpar == 0, v1, v0)  # full row 2*yc+1: color = 1 - x % 2
    out = jnp.stack([evens, odds], axis=-2)  # [..., Hc, 2, W]
    out = out.reshape(v0.shape[:-2] + (2 * Hc, W))
    return out[..., :H, :]


def _rowshift(v: jax.Array, r: int) -> jax.Array:
    """out[..., yc, :] = v[..., yc + r, :], zero-filled (r in {-1, +1})."""
    pads = [(0, 0)] * (v.ndim - 2)
    if r == 1:
        return jnp.pad(v[..., 1:, :], pads + [(0, 1), (0, 0)])
    return jnp.pad(v[..., :-1, :], pads + [(1, 0), (0, 0)])


def cshift(v: jax.Array, d: int, c_to: int, H: int) -> jax.Array:
    """Compact analog of geometry.shift_from_neighbor.

    ``v`` holds values at color ``1 - c_to`` pixels (compact layout); returns,
    in color-``c_to`` layout, each pixel's direction-``d`` neighbor value,
    zero when the neighbor is out of bounds (4-neighbors always have the
    opposite color)."""
    dy, dx = DIRS[d]
    Hc, W = v.shape[-2:]
    x = jnp.arange(W)
    bit = ((c_to + x) % 2)[None, :]  # [1, W]
    y_full = 2 * jnp.arange(Hc)[:, None] + bit  # [Hc, W]
    if dy == 0:
        out = jnp.roll(v, -dx, axis=-1)
        ok = (x[None, :] + dx >= 0) & (x[None, :] + dx <= W - 1)
    else:
        if dy == 1:
            out = jnp.where(bit == 1, _rowshift(v, 1), v)
        else:
            out = jnp.where(bit == 1, v, _rowshift(v, -1))
        ok = (y_full + dy >= 0) & (y_full + dy <= H - 1)
    ok = ok & (y_full <= H - 1)
    return jnp.where(ok, out, jnp.zeros((), v.dtype))
