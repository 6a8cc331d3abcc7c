"""Plane-label algebra on dense pixel grids.

The reference (johannesu/stereo) represents each pixel's label as a 3D plane
``(a, b, c, d)`` and converts a label field to a disparity map via
``disp = -(a*x + b*y + d) / c`` (dispmap_super.m:318-328).  The reference keeps
flat ``4 x N`` arrays plus explicit edge lists (dispmap_super.m:279-302); here
the pixel grid IS the array: a plane field is ``[..., 4, H, W]`` and the
4-neighborhood is expressed with static shifts, which XLA maps onto tiled
vector ops with no gathers.

Coordinate convention: 1-based pixel coordinates (x = column index + 1,
y = row index + 1), matching the reference's MATLAB meshgrid points
(dispmap_super.m:275-278) so that energies computed on identical inputs agree
exactly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Neighbor offsets (dy, dx): a direction ``d`` denotes the in-edge from the
# neighbor at ``(y + dy, x + dx)`` into pixel ``(y, x)``.  Order: left, right,
# up, down.
DIRS: tuple[tuple[int, int], ...] = ((0, -1), (0, 1), (-1, 0), (1, 0))
NUM_DIRS = len(DIRS)
# OPP[d] = index of the opposite direction.
OPP: tuple[int, ...] = (1, 0, 3, 2)



def take_plane(X: jax.Array, idx: jax.Array) -> jax.Array:
    """X[idx[s], s] for every site s: X [K, *S], idx [*S] int -> [*S].

    One-hot masked sum instead of jnp.take_along_axis over a leading
    (label/level) axis: K masked plane passes that XLA fuses into one.
    """
    K = X.shape[0]
    iota = jnp.arange(K, dtype=jnp.int32).reshape((K,) + (1,) * idx.ndim)
    onehot = idx[None].astype(jnp.int32) == iota
    return jnp.sum(jnp.where(onehot, X, 0), axis=0)

def grid_points(H: int, W: int, dtype=jnp.float32) -> tuple[jax.Array, jax.Array]:
    """1-based pixel coordinates ``(xs, ys)``, each of shape [H, W].

    Mirrors ``meshgrid(1:W, 1:H)`` in dispmap_super.m:275-278.
    """
    ys = jnp.arange(1, H + 1, dtype=dtype)[:, None] * jnp.ones((1, W), dtype)
    xs = jnp.ones((H, 1), dtype) * jnp.arange(1, W + 1, dtype=dtype)[None, :]
    return xs, ys


def plane_disparity(planes: jax.Array, xs: jax.Array, ys: jax.Array) -> jax.Array:
    """Evaluate plane labels at points: ``-(a*x + b*y + d) / c``.

    planes: [..., 4, H, W]; xs, ys: broadcastable to [H, W].
    Returns [..., H, W].  (dispmap_super.m:318-328.)
    """
    a = planes[..., 0, :, :]
    b = planes[..., 1, :, :]
    c = planes[..., 2, :, :]
    d = planes[..., 3, :, :]
    return -(a * xs + b * ys + d) / c


def own_disparity(planes: jax.Array) -> jax.Array:
    """Disparity of each pixel's own plane at its own point. [..., 4, H, W] -> [..., H, W]."""
    H, W = planes.shape[-2:]
    xs, ys = grid_points(H, W, dtype=planes.dtype)
    return plane_disparity(planes, xs, ys)


def shift_from_neighbor(field: jax.Array, d: int, fill=0.0) -> jax.Array:
    """Bring each pixel's neighbor value (direction ``d``) to the pixel.

    out[..., y, x] = field[..., y + dy, x + dx] where (dy, dx) = DIRS[d];
    out-of-bounds entries are ``fill``.  Static-shape roll + mask, which XLA
    lowers to cheap slice/pad — no dynamic gathers.
    """
    dy, dx = DIRS[d]
    out = jnp.roll(field, shift=(-dy, -dx), axis=(-2, -1))
    return mask_valid(out, d, fill)


def mask_valid(field: jax.Array, d: int, fill=0.0) -> jax.Array:
    """Replace entries whose direction-``d`` neighbor is out of bounds with fill."""
    H, W = field.shape[-2:]
    dy, dx = DIRS[d]
    ys = jnp.arange(H)[:, None]
    xs = jnp.arange(W)[None, :]
    ok = jnp.ones((H, W), dtype=bool)
    if dy == -1:
        ok = ys >= 1
    elif dy == 1:
        ok = ys <= H - 2
    if dx == -1:
        ok = ok & (xs >= 1)
    elif dx == 1:
        ok = ok & (xs <= W - 2)
    return jnp.where(ok, field, jnp.asarray(fill, field.dtype))


def valid_mask(H: int, W: int, d: int, dtype=bool) -> jax.Array:
    """[H, W] mask: True where the direction-``d`` neighbor exists."""
    ones = jnp.ones((H, W), dtype=jnp.float32)
    return mask_valid(ones, d, 0.0).astype(dtype)


def neighbor_plane_disparity(planes: jax.Array, d: int, fill=jnp.inf) -> jax.Array:
    """Disparity of the direction-``d`` *neighbor's* plane evaluated at the
    pixel's *own* point — the quantity the reference calls ``qprim``
    (dispmap_super.m:243-244: neighbor's plane, head's point).

    planes: [..., 4, H, W] -> [..., H, W]; invalid borders get ``fill``.
    """
    H, W = planes.shape[-2:]
    xs, ys = grid_points(H, W, dtype=planes.dtype)
    shifted = shift_from_neighbor(planes, d, fill=1.0)  # fill keeps c != 0
    disp = plane_disparity(shifted, xs, ys)
    return mask_valid(disp, d, fill)


def fronto_parallel(H: int, W: int, disparity, dtype=jnp.float32) -> jax.Array:
    """Constant-disparity plane field: (0, 0, 1, -disparity). [4, H, W]."""
    disparity = jnp.asarray(disparity, dtype)
    zeros = jnp.zeros((H, W), dtype)
    ones = jnp.ones((H, W), dtype)
    return jnp.stack([zeros, zeros, ones, -disparity * ones], axis=0)


def plane_field_from_disparity(disp: jax.Array) -> jax.Array:
    """Per-pixel fronto-parallel field from a disparity map [H, W] -> [4, H, W].

    Mirrors set_disparity (dispmap_super.m:303-307).
    """
    zeros = jnp.zeros_like(disp)
    ones = jnp.ones_like(disp)
    return jnp.stack([zeros, zeros, ones, -disp], axis=0)
