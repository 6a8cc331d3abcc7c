"""Two-process jax.distributed validation: multi-host sharded solve equals
the single-process result (labels exactly; scalars to f32 reduction noise)."""

import os
import re
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest

import oracles

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def single_process_reference():
    from stereo_tpu.solvers import trws

    rng = np.random.default_rng(0)
    H, W, K = 16, 32, 5
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    res = trws.solve(
        jnp.asarray(theta, jnp.float32), jnp.asarray(D0, jnp.float32),
        jnp.asarray(Q, jnp.float32), jnp.asarray(alphas, jnp.float32),
        kernel=1, tol=1.0, maxiter=8, max_relgap=0.0,
    )
    labels = np.asarray(res.labels)
    return (float(res.energy), float(res.lower_bound), int(res.iterations),
            int(labels.astype(np.int64).sum()))


def test_two_process_solve_matches_single():
    # NB: no pytest-timeout in this image — the real guards are the
    # subprocess.run(timeout=240) below and the kill-on-timeout in finally.
    e1, lb1, it1, ck1 = single_process_reference()

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    driver = os.path.join(REPO, "tests", "multihost", "run_pair.py")
    port = 9950 + os.getpid() % 40
    coord = f"127.0.0.1:{port}"
    p1 = subprocess.Popen([sys.executable, driver, "1", "2", coord], env=env,
                          stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        out = subprocess.run(
            [sys.executable, driver, "0", "2", coord], env=env,
            capture_output=True, text=True, timeout=240,
        )
    finally:
        try:
            p1.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p1.kill()  # exact PID — never mask the primary assertion
            p1.wait()
    m = re.search(r"MULTIHOST ([-\d.]+) ([-\d.]+) (\d+) (-?\d+)", out.stdout)
    assert m, f"no result line; stdout={out.stdout!r} stderr={out.stderr[-500:]!r}"
    e2, lb2, it2, ck2 = (float(m.group(1)), float(m.group(2)),
                         int(m.group(3)), int(m.group(4)))
    assert it2 == it1
    assert ck2 == ck1  # identical labelings
    assert e2 == pytest.approx(e1, rel=1e-5)
    assert lb2 == pytest.approx(lb1, rel=1e-5)


def test_two_process_banded_matches_single():
    """Distributed banded over two jax.distributed processes (gy stripes
    spanning the process boundary — per-step seam ppermutes cross DCN):
    labels match the single-process BandedRun exactly."""
    from stereo_tpu.solvers import banded

    rng = np.random.default_rng(0)
    H, W, K = 16, 32, 5
    theta, D0, Q, alphas = oracles.grid_trws_inputs(rng, H, W, K)
    run = banded.BandedRun(
        jnp.asarray(theta, jnp.float32), jnp.asarray(D0, jnp.float32),
        jnp.asarray(Q, jnp.float32), jnp.asarray(alphas, jnp.float32),
        kernel=1, tol=1.0, Bh=2, Bw=4)
    _, e1, lb1, L1 = run.run(run.init_state(), 4, 2)
    ck1 = int(np.asarray(L1).astype(np.int64).sum())

    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    driver = os.path.join(REPO, "tests", "multihost", "run_pair_banded.py")
    port = 9991 + os.getpid() % 40
    coord = f"127.0.0.1:{port}"
    p1 = subprocess.Popen([sys.executable, driver, "1", "2", coord], env=env,
                          stdout=subprocess.DEVNULL,
                          stderr=subprocess.DEVNULL)
    try:
        out = subprocess.run(
            [sys.executable, driver, "0", "2", coord], env=env,
            capture_output=True, text=True, timeout=240,
        )
    finally:
        try:
            p1.wait(timeout=60)
        except subprocess.TimeoutExpired:
            p1.kill()
            p1.wait()
    m = re.search(r"MULTIHOST_BANDED ([-\d.]+) ([-\d.]+) (-?\d+)", out.stdout)
    assert m, (f"no result line; stdout={out.stdout!r} "
               f"stderr={out.stderr[-600:]!r}")
    e2, lb2, ck2 = float(m.group(1)), float(m.group(2)), int(m.group(3))
    assert ck2 == ck1  # identical labelings
    assert e2 == pytest.approx(float(e1), rel=1e-5)
    assert lb2 == pytest.approx(float(lb1), rel=1e-4)
