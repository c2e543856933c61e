"""Test configuration: run everything on a virtual 8-device CPU mesh.

Must set the env vars before jax initializes its backends; unit tests are
CPU-deterministic, and sharding tests get 8 virtual devices.

Tests marked `gpu` need the card and skip elsewhere (the `gpu` fixture).
On a machine with a GPU they run with

    SRSRAN_TEST_GPU=1 python -m pytest tests -m gpu

which leaves JAX on its default (GPU) backend.
"""

import os
import sys

ON_GPU = os.environ.get("SRSRAN_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"  # unit tests are CPU-deterministic
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

from srsran_project_tpu.support import platform  # noqa: E402

# Persistent XLA compilation cache: repeated test runs skip recompiles.
platform.configure_compile_cache(min_compile_time_secs=0.5)


import pytest  # noqa: E402


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (SRSRAN_TEST_GPU=1 on the card)")


@pytest.fixture(autouse=True, scope="module")
def _bound_jit_executable_memory():
    """Drop compiled executables between test modules.

    A full-suite run accumulates ~500 tests' worth of jitted CPU
    executables; past ~90% of the suite the XLA CPU client has segfaulted
    inside compilation under that load.  The persistent compilation cache
    makes re-tracing cheap, so per-module clearing costs seconds and keeps
    the process footprint flat.
    """
    yield
    import jax

    jax.clear_caches()
