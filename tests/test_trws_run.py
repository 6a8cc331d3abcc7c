"""TRWSRun: the pack-once checkerboard API matches trws.solve exactly."""

import numpy as np
import jax.numpy as jnp
import pytest

from stereo_tpu.solvers import trws
from stereo_tpu.solvers.trws import TRWSRun

import oracles


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(2)
    H, W, K = 14, 18, 5
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    return tuple(jnp.asarray(x) for x in (theta, D0, Q, alphas))


@pytest.mark.parametrize("compact", [False, True])
def test_run_matches_solve_fixed_budget(inputs, compact):
    """Fixed 6-sweep budget, single end decode: messages bitwise and labels
    equal to trws.solve at the same budget and compact setting."""
    theta, D0, Q, alphas = inputs
    ref = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.0, maxiter=6,
                     max_relgap=0.0, check_every=6,
                     compact=compact)
    r = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0,
                compact=compact)
    state, e, lb, labels = r.run(r.init_state(), 6)
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(ref.labels))
    np.testing.assert_array_equal(np.asarray(r.messages(state)),
                                  np.asarray(ref.messages))
    assert float(e) == pytest.approx(float(ref.energy), rel=1e-12)
    assert float(lb) == pytest.approx(float(ref.lower_bound), rel=1e-12)


def test_chunked_continuation_matches_one_shot(inputs):
    """3 + 3 sweeps across two run() calls == 6 sweeps in one call (state
    donation/warm-start carries the exact trajectory)."""
    theta, D0, Q, alphas = inputs
    r = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0)
    s1, _, _, _ = r.run(r.init_state(), 3)
    s1, e1, lb1, lab1 = r.run(s1, 3)

    r2 = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0)
    s2, e2, lb2, lab2 = r2.run(r2.init_state(), 6)
    np.testing.assert_array_equal(np.asarray(r.messages(s1)),
                                  np.asarray(r2.messages(s2)))
    np.testing.assert_array_equal(np.asarray(lab1), np.asarray(lab2))
    assert float(e1) == pytest.approx(float(e2), rel=1e-12)


def test_warm_start_roundtrip(inputs):
    """init_state(messages) -> messages() is the identity (storage layout
    round-trips), and warm-starting reproduces the cold trajectory tail."""
    theta, D0, Q, alphas = inputs
    r = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0,
                compact=True)
    s, _, _, _ = r.run(r.init_state(), 4)
    m = r.messages(s)
    np.testing.assert_array_equal(np.asarray(r.messages(r.init_state(m))),
                                  np.asarray(m))


def test_incumbent_semantics(inputs):
    """Frequent decodes keep the best labeling: run(…, decode_every=2) over
    8 sweeps returns an energy <= the end-only decode's."""
    theta, D0, Q, alphas = inputs
    r = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0)
    _, e_end, _, _ = r.run(r.init_state(), 8)
    _, e_inc, _, _ = r.run(r.init_state(), 8, decode_every=2)
    assert float(e_inc) <= float(e_end) + 1e-12


def test_solve_stopping_rule(inputs):
    """solve() reaches the relgap stopping rule and agrees with trws.solve's
    converged energy to the incumbent-vs-last decode difference."""
    theta, D0, Q, alphas = inputs
    ref = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.0, maxiter=400,
                     max_relgap=1e-4, check_every=8)
    r = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0)
    res = r.solve(maxiter=400, max_relgap=1e-4, check_every=8)
    assert float(res.lower_bound) <= float(res.energy) + 1e-9
    # incumbent can only improve on the last decode
    assert float(res.energy) <= float(ref.energy) + 1e-9
    assert int(res.iterations) >= int(ref.iterations)


def test_bp_mode(inputs):
    """mode='bp' (gamma = 1, no lower bound) runs and matches solve."""
    theta, D0, Q, alphas = inputs
    ref = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.0, maxiter=4,
                     max_relgap=0.0, check_every=4,
                     mode="bp")
    r = TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.0,
                mode="bp")
    state, e, lb, labels = r.run(r.init_state(), 4)
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(ref.labels))
    np.testing.assert_array_equal(np.asarray(r.messages(state)),
                                  np.asarray(ref.messages))
    assert float(lb) == 0.0
