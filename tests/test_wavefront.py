"""Wavefront TRW-S: exact parity with the raster-order sequential oracle.

The wavefront solver claims to BE serial raster TRW-S (minimize.cpp:31-116
with the row-major ordering) executed one anti-diagonal at a time; these
tests pin that claim to fp roundoff, iteration by iteration, plus the
solver invariants (monotone LB, LB <= E) and label agreement.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from stereo_tpu.solvers import trws, wavefront

import oracles


def per_iteration_trace(theta, D0, Q, alphas, kernel, tol, n_iters):
    out = []
    msgs = None
    for _ in range(n_iters):
        res = wavefront.solve_wavefront(
            jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas), kernel=kernel, tol=tol, maxiter=1,
            max_relgap=0.0, messages=msgs,
        )
        msgs = res.messages
        out.append((float(res.energy), float(res.lower_bound),
                    np.asarray(res.labels)))
    return out


def raster_order(H, W):
    return list(range(H * W))


def test_skew_roundtrip():
    rng = np.random.default_rng(0)
    a = rng.random((3, 5, 7))
    s = wavefront.skew(jnp.asarray(a), 7)
    assert s.shape == (3, 5, 11)
    back = np.asarray(wavefront.unskew(s, 7))
    np.testing.assert_array_equal(back, a)
    # skewed anti-diagonals are columns: S[y, t] = A[y, t-y]
    s_np = np.asarray(s)
    for y in range(5):
        for x in range(7):
            assert s_np[0, y, x + y] == a[0, y, x]


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("seed,H,W,K", [(0, 4, 5, 3), (1, 3, 6, 4),
                                        (2, 5, 5, 2), (3, 1, 6, 3),
                                        (4, 6, 1, 3), (5, 6, 9, 3),
                                        (12, 7, 6, 4)])
def test_matches_sequential_raster_oracle(kernel, seed, H, W, K):
    """Wavefront == sequential raster TRW-S: energies, bounds AND labels
    match the oracle to fp roundoff, every iteration.  Iterations after the
    first are warm-started solves (messages in)."""
    rng = np.random.default_rng(seed)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K, kernel=kernel)
    tol = 1.0

    theta_flat, edges = oracles.grid_edges_for_oracle(theta, D0, Q, alphas)
    oracle = oracles.SequentialTRWS(theta_flat, edges, raster_order(H, W),
                                    kernel, tol)

    trace = per_iteration_trace(theta, D0, Q, alphas, kernel, tol, 5)
    for it in range(5):
        oE, oLB, oLab = oracle.iterate()
        dE, dLB, dLab = trace[it]
        assert dLB == pytest.approx(oLB, rel=1e-10, abs=1e-10), f"iter {it}"
        assert dE == pytest.approx(oE, rel=1e-10, abs=1e-10), f"iter {it}"
        np.testing.assert_array_equal(dLab.ravel(), oLab, f"iter {it}")


def test_invariants_and_vs_checkerboard():
    """Monotone LB, LB <= E; on a smooth problem the raster ordering's bound
    after N sweeps dominates the checkerboard bound (the mixing claim)."""
    rng = np.random.default_rng(7)
    H, W, K = 12, 16, 4
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    tol = 1.0
    args = (jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas))

    lbs = []
    msgs = None
    for _ in range(8):
        res = wavefront.solve_wavefront(*args, kernel=1, tol=tol, maxiter=1,
                                        max_relgap=0.0, messages=msgs)
        msgs = res.messages
        lbs.append(float(res.lower_bound))
        assert float(res.lower_bound) <= float(res.energy) + 1e-9
    for a, b in zip(lbs, lbs[1:]):
        assert b >= a - 1e-9, f"LB decreased: {a} -> {b}"

    cb = trws.solve(*args, kernel=1, tol=tol, maxiter=8, max_relgap=0.0)
    assert lbs[-1] >= float(cb.lower_bound) - 1e-9


def test_warm_start_continuation():
    """maxiter=2 equals two chained maxiter=1 solves through `messages`."""
    rng = np.random.default_rng(3)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, 5, 6, 3)
    args = (jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas))
    a = wavefront.solve_wavefront(*args, kernel=1, tol=1.0, maxiter=2,
                                  max_relgap=0.0)
    r1 = wavefront.solve_wavefront(*args, kernel=1, tol=1.0, maxiter=1,
                                   max_relgap=0.0)
    r2 = wavefront.solve_wavefront(*args, kernel=1, tol=1.0, maxiter=1,
                                   max_relgap=0.0, messages=r1.messages)
    assert float(a.energy) == pytest.approx(float(r2.energy), rel=1e-12)
    assert float(a.lower_bound) == pytest.approx(float(r2.lower_bound),
                                                 rel=1e-12)
    np.testing.assert_array_equal(np.asarray(a.labels), np.asarray(r2.labels))
