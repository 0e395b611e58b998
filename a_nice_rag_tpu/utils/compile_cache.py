"""Where JAX keeps its persistent compilation cache.

One rule for every entry point (``chip_smoke.py``, ``bench.py``,
``serve_cli``, ``__graft_entry__`` and the test suite): when
``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here overrides it; otherwise the cache lives at ``<repo>/.cache/jax``, a
fixed path, because the path is part of the cache key.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(REPO_ROOT, ".cache", "jax")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
