"""On-card checks: the compiled Triton phase kernel and the banded send
formulation against their plain references, with the same check functions
as chip_smoke.py's ``kernels`` phase.  Marked ``gpu``; they skip elsewhere
(see tests/conftest.py for the command that runs them on a GPU)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke  # noqa: E402


@pytest.mark.gpu
@pytest.mark.parametrize("K,H,W", [(15, 370, 413), (79, 375, 450)],
                         ids=["baby2-K15", "teddy-K79"])
def test_phase_kernel_compiled(gpu, K, H, W):
    r = chip_smoke.check_phase_kernel(K, H, W)
    assert r["ok"], r


@pytest.mark.gpu
def test_send_formulation(gpu):
    for name, r in chip_smoke.check_send(79, 1536).items():
        assert r["ok"], (name, r)


@pytest.mark.gpu
def test_repeated_move_identical(gpu):
    import numpy as np
    import jax.numpy as jnp

    from stereo_tpu.solvers import binary

    rng = np.random.default_rng(3)
    H, W = 375, 450
    z = jnp.asarray(rng.random((H, W)) < 0.5)
    t0 = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
    t1 = jnp.asarray(rng.normal(0, 1, (H, W)), jnp.float32)
    V = jnp.asarray(rng.normal(0, 1, (4, 2, 2, H, W)), jnp.float32)
    a = np.asarray(binary.accept_components(z, t0, t1, V))
    b = np.asarray(binary.accept_components(z, t0, t1, V))
    np.testing.assert_array_equal(a, b)
