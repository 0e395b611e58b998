"""Test configuration: an 8-device virtual CPU mesh.

The suite runs on the CPU backend: Pallas kernels in interpret mode, the
sharded paths on JAX's host-platform devices (SURVEY.md §4: the
JAX-native equivalent of the reference's offline fixture pattern).
``jax.config.update`` works any time before the backend initializes.

Tests marked ``gpu`` need the card; they skip here through the
``gpu_device`` fixture, which decides at run time, never at import.
"""

import os
import sys

import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from a_nice_rag_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent XLA compilation cache: the suite is compile-bound, so cache
# every lowered program across runs. The key includes the jaxlib version
# and flags, so stale entries are never reused.
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips without one."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (run through chip_smoke.py)")
    return gpus[0]
