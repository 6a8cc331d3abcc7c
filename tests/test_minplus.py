"""Min-plus message updates against numpy brute force.

The pair update (ops/minplus.minplus_pair_xla), the banded/wavefront sends
(solvers/wavefront._send_head/_send_tail) and the checkerboard phase
(solvers/trws._phase) are all the same dense K x K min-plus per pixel; each is
pinned here to a float64 numpy evaluation of that table."""

import numpy as np
import jax.numpy as jnp
import pytest

from stereo_tpu import geometry
from stereo_tpu.ops import minplus
from stereo_tpu.solvers import trws, wavefront


def _tr(x, kernel, tol):
    return np.minimum(np.abs(x) if kernel == 1 else x * x, tol)


def _check_pair(K, H, W, kernel, seed):
    rng = np.random.default_rng(seed)
    H_A, H_B = rng.normal(0, 3, (2, K, H, W))
    P, R = rng.normal(0, 2, (2, K, H, W))
    alpha = rng.uniform(0, 2, (H, W))
    tol = 1.3
    a, b = minplus.minplus_pair_xla(
        *(jnp.asarray(x) for x in (H_A, H_B, P, R, alpha)), kernel, tol)
    # C[i, j] = alpha * TR(P_i - R_j) per pixel
    C = alpha * _tr(P[:, None] - R[None, :], kernel, tol)
    np.testing.assert_allclose(np.asarray(a), (H_A[:, None] + C).min(0),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(np.asarray(b), (H_B[None, :] + C).min(1),
                               rtol=1e-12, atol=1e-12)


def _check_send(K, L, kernel, seed, fn):
    rng = np.random.default_rng(seed)
    gD, M = rng.normal(0, 3, (2, 2, K, L))
    Q = rng.normal(0, 5, (2, K, L))
    D0 = rng.normal(0, 5, (1, K, L))
    alpha = rng.random((2, L))
    tol = 2.0
    msg, vmin = getattr(wavefront, fn)(
        *(jnp.asarray(x) for x in (gD, M, Q, D0, alpha)), kernel, tol)
    h = gD - M
    if fn == "_send_head":  # msg[t] = min_h h[h] + a TR(Q[t] - D0[h])
        C = _tr(Q[:, :, None] - D0[:, None, :], kernel, tol)
    else:  # msg[h] = min_t h[t] + a TR(Q[t] - D0[h])
        C = _tr(Q[:, None, :] - D0[:, :, None], kernel, tol)
    want = np.min(h[:, None] + alpha[:, None, None] * C, axis=2)
    want_min = want.min(axis=1)
    np.testing.assert_allclose(np.asarray(vmin), want_min, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(np.asarray(msg), want - want_min[:, None],
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("case", [
    ("pair", 4, 3, 3, 1),
    ("pair", 3, 5, 7, 1), ("pair", 3, 5, 7, 2),
    ("pair", 15, 9, 130, 1), ("pair", 15, 9, 130, 2),
    ("pair", 2, 8, 512, 1), ("pair", 2, 8, 512, 2),
    ("_send_head", 7, 130, None, 1), ("_send_tail", 7, 130, None, 1),
    ("_send_head", 26, 384, None, 1), ("_send_tail", 26, 384, None, 1),
    ("_send_head", 33, 200, None, 2), ("_send_tail", 33, 200, None, 2),
], ids=lambda c: "-".join(str(v) for v in c if v is not None))
def test_variants_are_transposes_of_same_table(case):
    """msgA/msgB (and the one-variant sends) are row/column reductions of
    the same per-pixel cost table, computed here by brute force."""
    fn, K, a, b, kernel = case
    if fn == "pair":
        _check_pair(K, a, b, kernel, seed=K + a)
    else:
        _check_send(K, a, kernel, seed=K, fn=fn)


def _phase_oracle(theta, M, D0, Q, alphas, valid, gamma, color, kernel, tol):
    """Per-direction numpy evaluation of one checkerboard half-iteration."""
    K, H, W = theta.shape
    Mf = M.astype(np.float64)
    D = theta + Mf.sum(0)
    for d in range(4):
        D = D + np.asarray(geometry.shift_from_neighbor(
            jnp.asarray(Mf[geometry.OPP[d]]), d, fill=0.0))
    D = D - D.min(0)[None]
    gD = gamma[None] * D
    cb = (np.add.outer(np.arange(H), np.arange(W)) % 2) == color
    out = np.empty((4, K, H, W))
    for d in range(4):
        gDn = np.asarray(geometry.shift_from_neighbor(jnp.asarray(gD), d,
                                                      fill=0.0))
        C = alphas[d] * _tr(Q[d][:, None] - D0[None, :], kernel, tol)
        msgA = np.min((gDn - Mf[d])[:, None] + C, axis=0)  # tail is source
        msgB = np.min((gD - Mf[d])[None, :] + C, axis=1)  # head is source
        msg = np.where(cb[None], msgB, msgA)
        out[d] = (msg - msg.min(0)[None]) * valid[d][None]
    return out


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_phase_matches_numpy_oracle(storage):
    """The XLA checkerboard phase (solvers/trws._phase) in float32, with
    messages stored in float32 or bfloat16, against the float64 oracle on
    the same (rounded) inputs; the output keeps the storage dtype."""
    rng = np.random.default_rng(5)
    K, H, W, kernel, tol = 4, 6, 9, 1, 1.1
    f = jnp.float32
    theta = rng.uniform(0, 4, (K, H, W)).astype(np.float32)
    D0 = rng.normal(0, 2, (K, H, W)).astype(np.float32)
    Q = rng.normal(0, 2, (4, K, H, W)).astype(np.float32)
    valid = np.stack([np.asarray(geometry.valid_mask(H, W, d, dtype=f))
                      for d in range(4)])
    alphas = (rng.uniform(0.5, 2, (4, H, W)) * valid).astype(np.float32)
    M = np.asarray(jnp.asarray(rng.normal(0, 1, (4, K, H, W)),
                               jnp.dtype(storage)))
    gamma = np.asarray(trws.node_gamma(H, W, f))
    cb = trws.checkerboard(H, W)
    for color in (0, 1):
        got, _, _ = trws._phase(
            jnp.asarray(theta), jnp.asarray(M), jnp.asarray(D0),
            jnp.asarray(Q), jnp.asarray(alphas), jnp.asarray(valid),
            jnp.asarray(gamma), cb, color, kernel, tol, accumulate_lb=True)
        assert got.dtype == jnp.dtype(storage)
        want = _phase_oracle(theta, np.asarray(M, np.float64), D0, Q,
                             alphas, valid, gamma, color, kernel, tol)
        # float32 arithmetic, then one rounding to the storage dtype
        rtol = 1e-5 if storage == "float32" else 2 ** -8
        np.testing.assert_allclose(np.asarray(got, np.float64), want,
                                   rtol=rtol, atol=rtol * 8)
