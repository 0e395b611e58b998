"""Numerical debugging and determinism controls.

The reference has no sanitizers (SURVEY.md §5: only a lock on DB caches);
the JAX equivalents are its debug flags. ``enable_debug`` turns on
NaN/Inf trapping (jax_debug_nans/jax_debug_infs — any kernel producing
non-finite values raises at the offending primitive) and optional x64 for
numerics triage; ``deterministic_mode`` sets XLA's GPU
deterministic-reduction flag so repeated runs bit-match.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger(__name__)


def enable_debug(nans: bool = True, infs: bool = False, x64: bool = False) -> None:
    import jax

    if nans:
        jax.config.update("jax_debug_nans", True)
    if infs:
        jax.config.update("jax_debug_infs", True)
    if x64:
        jax.config.update("jax_enable_x64", True)
    logger.info("debug flags: nans=%s infs=%s x64=%s", nans, infs, x64)


def disable_debug() -> None:
    import jax

    jax.config.update("jax_debug_nans", False)
    jax.config.update("jax_debug_infs", False)


def deterministic_mode() -> None:
    """Best-effort bitwise determinism for repeated runs: deterministic
    XLA reductions (set before backend init to take effect)."""
    flags = os.environ.get("XLA_FLAGS", "")
    if "--xla_gpu_deterministic_ops" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_gpu_deterministic_ops=true"
        ).strip()
    logger.info("deterministic mode requested (effective on next backend init)")
