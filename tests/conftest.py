"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-chip sharding is validated on a virtual CPU mesh
(xla_force_host_platform_device_count); numerical parity tests against serial
oracles run in float64.  The platform is overridden (not setdefault) and also
set in the in-process config; backends initialize lazily, so this takes
effect as long as no jax computation ran before conftest import.

Tests that need a GPU carry the ``gpu`` marker and skip, through the ``gpu``
fixture, unless the first device is one.  They run on a GPU machine with

    STEREO_TPU_GPU_TESTS=1 python -m pytest -m gpu tests/

where the variable leaves JAX's platform and float width at their defaults.
"""

import os

_GPU_RUN = os.environ.get("STEREO_TPU_GPU_TESTS") == "1"
if not _GPU_RUN:
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _GPU_RUN:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)


def pytest_report_header(config):
    return f"jax backend: {jax.default_backend()}, devices: {len(jax.devices())}"


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Cap in-process compile-cache growth: the full suite compiles hundreds
    of distinct programs and XLA:CPU has segfaulted deep into a late-suite
    compile with all of them still resident (threads show
    backend_compile_and_load; test passes in isolation)."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu():
    """The first JAX device, when it is a GPU; skips the test otherwise."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU (first device is {dev.platform})")
    return dev


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: >60s parametrization (run `-m 'not slow'` for the quick "
        "suite; CI runs everything)")
    config.addinivalue_line(
        "markers",
        "gpu: compiles for and runs on a GPU (see the module docstring)")
