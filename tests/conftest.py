"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding paths are validated here without accelerators.
Must set env BEFORE jax import.  Tests that need a GPU carry the
``chip`` marker and skip here (see the ``gpu`` fixture).
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from amps_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# the persistent cache makes re-runs of the suite cheap
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a GPU; skips on the CPU test mesh")


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(553)


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU — decided when the
    test runs, never at import, so every test worker collects the same
    tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devs[0].platform}")
    return devs
