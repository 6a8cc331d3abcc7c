"""Windowed filters: zero-padded box sums / means (the conv2 'same' of the
reference's cost-volume builders) expressed as XLA reduce_window ops, which
XLA fuses and vectorizes."""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def box_sum(x: jax.Array, radius: int, axes=(-2, -1)) -> jax.Array:
    """Sum over a (2r+1)^2 window, zero padding — conv2(x, ones, 'same').

    x: [..., H, W].
    """
    k = 2 * radius + 1
    window = [1] * x.ndim
    strides = [1] * x.ndim
    padding = [(0, 0)] * x.ndim
    for ax in axes:
        a = ax % x.ndim
        window[a] = k
        padding[a] = (radius, radius)
    return lax.reduce_window(x, jnp.zeros((), x.dtype), lax.add, window, strides, padding)


def box_mean(x: jax.Array, radius: int, axes=(-2, -1)) -> jax.Array:
    """Mean with *constant* divisor (2r+1)^2 — identical to the reference's
    conv2 with a constant averaging patch (zero padding, no renormalization;
    dispmap_ncc.m:125)."""
    k = 2 * radius + 1
    return box_sum(x, radius, axes) / (k * k)


def separable_average_1d(x: jax.Array, radius: int, axis: int) -> jax.Array:
    """1-D moving average of width 2r+1 (fspecial('average',[1 w]) conv),
    zero-padded 'same'."""
    k = 2 * radius + 1
    window = [1] * x.ndim
    strides = [1] * x.ndim
    padding = [(0, 0)] * x.ndim
    a = axis % x.ndim
    window[a] = k
    padding[a] = (radius, radius)
    s = lax.reduce_window(x, jnp.zeros((), x.dtype), lax.add, window, strides, padding)
    return s / k


def valid_average_2d(x: jax.Array, radius: int) -> jax.Array:
    """Separable (2r+1) x (2r+1) average with 'valid' extent:
    conv2(filt, filt', x, 'valid') of ojw_segpln.m:101 / dispmap_globalstereo.m:101.
    x: [..., H, W] -> [..., H-2r, W-2r].
    """
    k = 2 * radius + 1
    window = [1] * x.ndim
    strides = [1] * x.ndim
    padding = [(0, 0)] * x.ndim
    for ax in (-2, -1):
        a = ax % x.ndim
        window[a] = k
    s = lax.reduce_window(x, jnp.zeros((), x.dtype), lax.add, window, strides, padding)
    return s / (k * k)
