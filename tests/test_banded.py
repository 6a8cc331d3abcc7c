"""Banded wavefront TRW-S: exact parity with the sequential oracle under the
banded total order.

solvers/banded.py claims to BE sequential TRW-S (minimize.cpp:31-116) under
the block-anti-diagonal ordering t = yb + xb; these tests pin energies,
bounds AND labels per iteration against tests/oracles.SequentialTRWS run with
that order, plus the solver invariants and the raster-degeneration identity
(one block == solvers/wavefront.py bitwise).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from stereo_tpu.solvers import banded, wavefront

import oracles


def per_iteration_trace(theta, D0, Q, alphas, kernel, tol, Bh, Bw, n_iters):
    out = []
    msgs = None
    for _ in range(n_iters):
        res = banded.solve_banded(
            jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas), kernel=kernel, tol=tol, Bh=Bh, Bw=Bw,
            maxiter=1, max_relgap=0.0, messages=msgs,
        )
        msgs = res.messages
        out.append((float(res.energy), float(res.lower_bound),
                    np.asarray(res.labels)))
    return out


def test_order_is_valid():
    """No two 4-neighbors share a position in the banded order."""
    H, W, Bh, Bw = 7, 9, 3, 4
    order = banded.banded_order(H, W, Bh, Bw)
    pos = np.empty(H * W, int)
    pos[order] = np.arange(H * W)
    # t-values of same-step nodes must differ between any adjacent pair
    t = np.empty(H * W, int)
    for y in range(H):
        for x in range(W):
            t[y * W + x] = (y % Bh) + (x % Bw)
    for y in range(H):
        for x in range(W):
            for dy, dx in ((0, 1), (1, 0)):
                ny, nx = y + dy, x + dx
                if ny < H and nx < W:
                    assert t[y * W + x] != t[ny * W + nx]


def test_cols_roundtrip():
    rng = np.random.default_rng(0)
    spec = banded.BandedSpec(7, 9, 3, 4)
    a = jnp.asarray(rng.random((2, 3, 7, 9)))
    cols = banded.to_cols(a, spec)
    assert cols.shape == (spec.T + 2, 2, 3, spec.L)
    back = np.asarray(banded.from_cols(cols, spec))
    np.testing.assert_array_equal(back, np.asarray(a))


def test_message_state_roundtrip():
    rng = np.random.default_rng(1)
    H, W, K = 6, 7, 3
    spec = banded.BandedSpec(H, W, 3, 3)
    theta = jnp.asarray(rng.random((K, H, W)), jnp.float32)
    D0 = jnp.asarray(rng.random((K, H, W)), jnp.float32)
    Q = jnp.asarray(rng.random((4, K, H, W)), jnp.float32)
    alphas = jnp.asarray(rng.random((4, H, W)), jnp.float32)
    bp = banded._BandedProblem(theta, D0, Q, alphas, spec, 1, 1.0)
    # messages that are zero exactly where no directed edge exists
    M = jnp.asarray(rng.random((4, K, H, W)), jnp.float32)
    from stereo_tpu import geometry
    valid = jnp.stack([geometry.valid_mask(H, W, d, dtype=jnp.float32)
                       for d in range(4)], 0)
    M = M * valid[:, None]
    state = banded.messages_to_state(M, bp)
    back = np.asarray(banded.state_to_messages(state, bp))
    np.testing.assert_allclose(back, np.asarray(M), atol=1e-7)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("seed,H,W,K,Bh,Bw", [
    (0, 6, 6, 3, 3, 3),      # even split, square blocks
    (1, 7, 9, 3, 3, 4),      # padding in both axes, rectangular blocks
    (2, 5, 8, 2, 2, 4),      # minimal Bh
    (3, 6, 5, 4, 6, 5),      # single block == raster
    (4, 9, 4, 3, 4, 4),      # Gy=3, Gx=1 (no x-seams)
    (5, 4, 9, 3, 4, 3),      # Gy=1, Gx=3 (no y-seams)
    (6, 8, 10, 3, 4, 5),     # padding-free 2x2 blocks
    (7, 9, 8, 4, 4, 4),      # padded rows, square blocks
    (8, 10, 11, 3, 5, 4),    # padded cols
    (12, 48, 40, 3, 8, 8),   # > 128 lanes (Gy*Gx*Bh = 240)
    (11, 40, 47, 2, 8, 8),   # > 128 lanes, padded cols
])
def test_matches_sequential_banded_oracle(kernel, seed, H, W, K, Bh, Bw):
    """Banded sweeps == sequential TRW-S under the banded order: energies,
    bounds AND labels match the oracle to fp roundoff, every iteration.
    Iterations after the first are warm-started solves (messages in)."""
    rng = np.random.default_rng(seed)
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K,
                                                    kernel=kernel)
    tol = 1.0

    theta_flat, edges = oracles.grid_edges_for_oracle(theta, D0, Q, alphas)
    order = banded.banded_order(H, W, Bh, Bw)
    oracle = oracles.SequentialTRWS(theta_flat, edges, order, kernel, tol)

    trace = per_iteration_trace(theta, D0, Q, alphas, kernel, tol, Bh, Bw, 4)
    for it in range(4):
        oE, oLB, oLab = oracle.iterate()
        dE, dLB, dLab = trace[it]
        assert dLB == pytest.approx(oLB, rel=1e-9, abs=1e-9), f"iter {it}"
        assert dE == pytest.approx(oE, rel=1e-9, abs=1e-9), f"iter {it}"
        np.testing.assert_array_equal(dLab.ravel(), oLab, f"iter {it}")


def test_single_block_equals_wavefront():
    """Bh = H, Bw = W has no seams: banded == raster wavefront exactly."""
    rng = np.random.default_rng(11)
    H, W, K = 6, 8, 3
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    args = (jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas))
    b = banded.solve_banded(*args, kernel=1, tol=1.0, Bh=H, Bw=W,
                            maxiter=3, max_relgap=0.0, check_every=3)
    w = wavefront.solve_wavefront(*args, kernel=1, tol=1.0, maxiter=3,
                                  max_relgap=0.0, check_every=3)
    assert float(b.energy) == pytest.approx(float(w.energy), rel=1e-12)
    assert float(b.lower_bound) == pytest.approx(float(w.lower_bound),
                                                 rel=1e-12)
    np.testing.assert_array_equal(np.asarray(b.labels), np.asarray(w.labels))
    np.testing.assert_allclose(np.asarray(b.messages),
                               np.asarray(w.messages), atol=1e-6)


def test_invariants_and_warm_start():
    """Monotone LB, LB <= E; maxiter=2 == two chained maxiter=1 solves."""
    rng = np.random.default_rng(7)
    H, W, K, Bh, Bw = 10, 12, 4, 4, 4
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    args = (jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas))
    kw = dict(kernel=1, tol=1.0, Bh=Bh, Bw=Bw, max_relgap=0.0)

    lbs = []
    msgs = None
    for _ in range(8):
        res = banded.solve_banded(*args, maxiter=1, messages=msgs, **kw)
        msgs = res.messages
        lbs.append(float(res.lower_bound))
        assert float(res.lower_bound) <= float(res.energy) + 1e-9
    for a, b in zip(lbs, lbs[1:]):
        assert b >= a - 1e-9, f"LB decreased: {a} -> {b}"

    a2 = banded.solve_banded(*args, maxiter=2, check_every=2, **kw)
    r1 = banded.solve_banded(*args, maxiter=1, **kw)
    r2 = banded.solve_banded(*args, maxiter=1, messages=r1.messages, **kw)
    assert float(a2.energy) == pytest.approx(float(r2.energy), rel=1e-12)
    assert float(a2.lower_bound) == pytest.approx(float(r2.lower_bound),
                                                  rel=1e-12)
    np.testing.assert_array_equal(np.asarray(a2.labels),
                                  np.asarray(r2.labels))


def test_banded_run_matches_solve():
    """BandedRun chunked driving == solve_banded, chunk by chunk."""
    rng = np.random.default_rng(9)
    H, W, K, Bh, Bw = 9, 11, 3, 4, 4
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    args = (jnp.asarray(theta), jnp.asarray(D0), jnp.asarray(Q),
            jnp.asarray(alphas))
    run = banded.BandedRun(*args, kernel=1, tol=1.0, Bh=Bh, Bw=Bw)
    state = run.init_state()
    msgs = None
    for _ in range(3):
        state, e, lb, labels = run.run(state, 2)
        ref = banded.solve_banded(*args, kernel=1, tol=1.0, Bh=Bh, Bw=Bw,
                                  maxiter=2, max_relgap=0.0, check_every=2,
                                  messages=msgs)
        msgs = ref.messages
        assert float(e) == pytest.approx(float(ref.energy), rel=1e-9)
        assert float(lb) == pytest.approx(float(ref.lower_bound), rel=1e-9)
        np.testing.assert_array_equal(np.asarray(labels),
                                      np.asarray(ref.labels))
    np.testing.assert_allclose(np.asarray(run.messages(state)),
                               np.asarray(msgs), rtol=1e-7, atol=1e-7)


def test_banded_run_raster_decode():
    """BandedRun(decode='raster'): the raster-order greedy decode on the
    banded message state.  With one block the banded order IS the raster
    order, so both decodes must agree bitwise; generically the returned
    energy must be the true energy of the returned labels."""
    from stereo_tpu.solvers import trws as trws_mod

    rng = np.random.default_rng(2)
    H, W, K = 14, 11, 4
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    args = tuple(jnp.asarray(x) for x in (theta, D0, Q, alphas))

    # degenerate single block: raster == banded order
    rb = banded.BandedRun(*args, kernel=1, tol=1.0, Bh=H, Bw=W)
    rr = banded.BandedRun(*args, kernel=1, tol=1.0, Bh=H, Bw=W, decode="raster")
    _, eb, lbb, Lb = rb.run(rb.init_state(), 4, 2)
    _, er, lbr, Lr = rr.run(rr.init_state(), 4, 2)
    np.testing.assert_array_equal(np.asarray(Lb), np.asarray(Lr))
    assert float(eb) == pytest.approx(float(er), rel=1e-12)
    assert float(lbb) == pytest.approx(float(lbr), rel=1e-12)

    # generic blocks: decode energy == true energy of the decoded labels
    rg = banded.BandedRun(*args, kernel=1, tol=1.0, Bh=4, Bw=3, decode="raster")
    _, eg, lbg, Lg = rg.run(rg.init_state(), 6, 3)
    e_true = trws_mod.labeling_energy(jnp.asarray(np.asarray(Lg)), *args,
                                      kernel=1, tol=1.0)
    assert float(eg) == pytest.approx(float(e_true), rel=1e-10)
    assert float(lbg) <= float(eg) + 1e-9
