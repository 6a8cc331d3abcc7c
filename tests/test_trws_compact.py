"""Checkerboard H-compaction parity: compact sweeps == standard sweeps.

The compact path (solvers/trws._phase_compact over the ops/checker.py layout)
must reproduce the standard checkerboard TRW-S exactly — same messages, same
bound, same decode — since the standard path is itself pinned per-iteration
to the sequential oracle (tests/test_trws.py)."""

import jax.numpy as jnp
import numpy as np
import pytest

from stereo_tpu import geometry
from stereo_tpu.ops import checker
from stereo_tpu.solvers import trws


def _problem(K, H, W, seed=0, dtype=jnp.float64):
    rng = np.random.default_rng(seed)
    theta = jnp.asarray(rng.uniform(0, 5, (K, H, W)), dtype)
    D0 = jnp.asarray(rng.uniform(0, 10, (K, H, W)), dtype)
    Q = jnp.asarray(
        np.expand_dims(np.asarray(D0), 0) + rng.normal(0, 0.4, (4, K, H, W)),
        dtype)
    valid = jnp.stack(
        [geometry.valid_mask(H, W, d, dtype=dtype) for d in range(4)], 0)
    alphas = jnp.asarray(rng.uniform(0.5, 2.0, (4, H, W)), dtype) * valid
    return theta, D0, Q, alphas


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W", [(4, 9, 10), (3, 8, 11), (5, 7, 7)])
@pytest.mark.parametrize("mode", ["trws", "bp"])
def test_compact_solve_matches_standard(kernel, K, H, W, mode):
    theta, D0, Q, alphas = _problem(K, H, W, seed=K + H)
    tol = 1.7
    kw = dict(kernel=kernel, tol=tol, maxiter=6, max_relgap=0.0,
              check_every=2, mode=mode)
    ref = trws.solve(theta, D0, Q, alphas, **kw, compact=False)
    got = trws.solve(theta, D0, Q, alphas, **kw, compact=True)
    np.testing.assert_allclose(float(got.energy), float(ref.energy),
                               rtol=1e-12)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(ref.lower_bound), rtol=1e-12)
    np.testing.assert_array_equal(np.asarray(got.labels),
                                  np.asarray(ref.labels))
    np.testing.assert_allclose(np.asarray(got.messages),
                               np.asarray(ref.messages), rtol=1e-12,
                               atol=1e-12)
    assert int(got.iterations) == int(ref.iterations)


@pytest.fixture
def kernel_path(monkeypatch):
    """Route trws' compacted phase through the Triton kernel, run by the
    Pallas interpreter (the path a GPU takes, minus the compiler)."""
    from stereo_tpu.ops import phase_kernel

    orig = phase_kernel.phase_messages_compact
    monkeypatch.setattr(
        phase_kernel, "phase_messages_compact",
        lambda *a, interpret=False: orig(*a, interpret=True))
    monkeypatch.setattr(trws, "_phase_kernel_enabled", lambda: True)


@pytest.mark.parametrize("K,H,W", [(4, 9, 10), (3, 16, 21)])
def test_compact_padded_layout_bitwise(K, H, W, kernel_path, monkeypatch):
    """The Triton kernel's layout — the flattened half-grid cut into
    power-of-two pixel blocks with a masked ragged tail, targets in
    power-of-two row tiles with masked padding rows — reproduces the XLA
    compacted solve through trws.solve, TRWSRun and a warm start: labels
    bitwise, messages/energy/bound to float64 roundoff (the two programs
    contract h + a*TR into FMAs differently)."""
    theta, D0, Q, alphas = _problem(K, H, W, seed=K + W)
    kw = dict(kernel=1, tol=1.3, maxiter=5, max_relgap=0.0, check_every=1,
              compact=True)
    got = trws.solve(theta, D0, Q, alphas, **kw)
    r = trws.TRWSRun(theta, D0, Q, alphas, kernel=1, tol=1.3, compact=True)
    st, e, lb, labels = r.run(r.init_state(), 5, 5)
    run_msgs = r.messages(st)
    got2 = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.3, maxiter=2,
                      max_relgap=0.0, check_every=1, compact=True,
                      messages=got.messages)

    monkeypatch.setattr(trws, "_phase_kernel_enabled", lambda: False)
    ref = trws.solve(theta, D0, Q, alphas, **kw)
    close = dict(rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(float(got.energy), float(ref.energy), **close)
    np.testing.assert_allclose(float(got.lower_bound),
                               float(ref.lower_bound), **close)
    np.testing.assert_array_equal(np.asarray(got.labels),
                                  np.asarray(ref.labels))
    np.testing.assert_allclose(np.asarray(got.messages),
                               np.asarray(ref.messages), **close)
    np.testing.assert_allclose(np.asarray(run_msgs),
                               np.asarray(ref.messages), **close)
    np.testing.assert_array_equal(np.asarray(labels), np.asarray(ref.labels))
    ref2 = trws.solve(theta, D0, Q, alphas, kernel=1, tol=1.3, maxiter=2,
                      max_relgap=0.0, check_every=1, compact=True,
                      messages=ref.messages)
    np.testing.assert_allclose(np.asarray(got2.messages),
                               np.asarray(ref2.messages), **close)


def test_compact_warm_start_parity():
    theta, D0, Q, alphas = _problem(3, 8, 9, seed=7)
    kw = dict(kernel=1, tol=0.9, max_relgap=0.0)
    warm = trws.solve(theta, D0, Q, alphas, maxiter=2, check_every=2,
                      compact=True, **kw)
    ref = trws.solve(theta, D0, Q, alphas, maxiter=3, check_every=3,
                     compact=False, **kw)
    got = trws.solve(theta, D0, Q, alphas, maxiter=1, check_every=1,
                     compact=True, messages=warm.messages, **kw)
    np.testing.assert_allclose(float(got.energy), float(ref.energy),
                               rtol=1e-12)
    np.testing.assert_allclose(np.asarray(got.messages),
                               np.asarray(ref.messages), rtol=1e-12,
                               atol=1e-12)


@pytest.mark.parametrize("kernel", [1, 2])
@pytest.mark.parametrize("K,H,W,storage", [
    (4, 10, 9, "float32"),    # K < one target tile
    (5, 7, 13, "float32"),    # ragged pixel tail, K not a power of two
    (17, 6, 11, "float32"),   # two target tiles, the second mostly padding
    (79, 3, 5, "float32"),    # teddy's K: five target tiles
    (15, 8, 12, "bfloat16"),  # narrowed message storage
])
def test_compact_phase_pallas_interpret(kernel, K, H, W, storage):
    """The Triton phase kernel (interpret mode) == the XLA compacted phase:
    messages within float32 FMA-contraction noise, minima likewise, output
    in the storage dtype."""
    f = jnp.float32
    theta, D0, Q, alphas = _problem(K, H, W, seed=3, dtype=f)
    rng = np.random.default_rng(11)
    M = jnp.asarray(rng.normal(0, 1, (4, K, H, W)), jnp.dtype(storage))
    gamma = trws.node_gamma(H, W, f)
    valid = jnp.stack(
        [geometry.valid_mask(H, W, d, dtype=f) for d in range(4)], 0)
    tol = 1.1

    from stereo_tpu.ops import phase_kernel

    ch = lambda a: (checker.compact_h(a, 0), checker.compact_h(a, 1))
    theta2, D02, Q2, alphas2, valid2, gamma2 = map(
        ch, (theta, D0, Q, alphas, valid, gamma))
    pix = jnp.ones((H, W), f)
    pix2 = (checker.compact_h(pix, 0), checker.compact_h(pix, 1), H)
    M2 = ch(M)

    for s in (0, 1):
        args, _ = trws._compact_phase_args(
            theta2, M2, D02, Q2, alphas2, valid2, gamma2, pix2, s, kernel,
            tol, accumulate_lb=True)
        want = trws._compact_messages_xla(*args)
        got = phase_kernel.phase_messages_compact(*args, interpret=True)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_allclose(np.asarray(g, np.float64),
                                       np.asarray(w, np.float64),
                                       rtol=1e-6, atol=1e-5)
