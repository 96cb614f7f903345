"""Test harness setup: force CPU with 8 virtual devices so multi-device
sharding paths can be exercised without a GPU (the analogue of the
reference's `mpirun -n 4` single-machine MPI testing, wscript:543-551).

The CPU is pinned with jax.config.update after import (backends initialize
lazily), whatever JAX_PLATFORMS says; MLSGPU_TPU_TEST_BACKEND=gpu leaves
JAX's default backend in place."""

import os
import tempfile

# Isolate the persistent caps cache (pipeline/reconstruct.py) per test
# session: caps grown by GPU/bench runs must not leak into CPU test
# programs (bigger static shapes -> slower compiles, cross-run coupling).
os.environ.setdefault(
    "MLSGPU_TPU_CACHE_DIR",
    tempfile.mkdtemp(prefix="mlsgpu_tpu_test_cache."))

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if os.environ.get("MLSGPU_TPU_TEST_BACKEND", "cpu") == "cpu":
    jax.config.update("jax_platforms", "cpu")

# NOTE: do not enable the persistent compilation cache here — serializing
# CPU executables segfaults in this jaxlib (zstandard path). The CLI enables
# it for accelerator runs only (cli.enable_compile_cache).

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches():
    """XLA-CPU compilation in this jaxlib segfaults sporadically once a
    process accumulates many large compiled executables; dropping them
    between test modules keeps the suite stable."""
    yield
    jax.clear_caches()
