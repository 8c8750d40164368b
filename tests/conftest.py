"""Test config.

The suite runs on the CPU: `pytest_configure` forces the `cpu` platform
(with an 8-device virtual mesh, so the sharding tests run without
cards) and `highest` matmul precision before any backend starts.

Tests marked `gpu` need a card.  They decide inside a fixture whether
one is present and skip here; on a machine with a GPU, run them with

    python -m pytest -m gpu tests/

which leaves JAX on its default (GPU) platform and precision.
"""

import os

import jax
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; run with `python -m pytest -m gpu`"
    )
    if config.getoption("markexpr", "") == "gpu":
        return
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    # cli.main turns the persistent cache on; tests stay hermetic.
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Release compiled executables after each test module.

    The full suite compiles hundreds of XLA programs in one process;
    near the end of the run the CPU backend segfaulted inside
    backend_compile_and_load on a trivial program (seen round 4 at
    ~138 tests, reproducibly) — consistent with executable-mapping
    exhaustion, not any individual test.  Dropping dead caches between
    modules keeps the live-executable count bounded; modules rarely
    share jitted shapes, so re-compilation cost is negligible."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_devices():
    """The GPU devices, or skip: decided here, at test time."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs
