"""Device timing helpers. Every sample ends in ``block_until_ready``:
JAX returns before the device finishes, so a timing without it measures
only the enqueue."""

from __future__ import annotations

import time

import jax


def chained_dispatch_ms(fn, n: int = 8, trials: int = 1) -> float:
    """Best-of-``trials`` mean latency of ``fn()`` over ``n`` chained
    dispatches, in milliseconds."""
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(max(1, trials)):
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = fn()
        jax.block_until_ready(out)
        best = min(best, (time.perf_counter() - t0) / n * 1e3)
    return best


def true_device_ms(
    make_call, q, *args, n_loop: int = 30, trials: int = 3
) -> float:
    """Dispatch-free device latency of ``make_call(q_perturbed, *args)``.

    Pass every large array through ``*args``: closing over one embeds it
    in the compiled program as a constant.

    Runs the program ``n_loop`` times inside ONE jitted loop, threading
    the loop carry into the q operand (runtime +0.0) so XLA cannot hoist
    the call. The trip count is a runtime argument, so the SAME compiled
    program measures a zero-iteration run: T(0) is the per-call dispatch
    overhead, and (T(n) - T(0)) / n is the device time.

    The perturbation must be ADDED (``q + isnan(x).astype(dtype)``):
    multiplying by zero is foldable and re-enables hoisting.
    """
    import jax.numpy as jnp

    @jax.jit
    def loop(n, x0, qq, *a):
        def body(i, x):
            dq = qq + jnp.isnan(x).astype(qq.dtype)
            out = make_call(dq, *a)
            # Fold EVERY output leaf into the carry: a single leaf can
            # be input-independent (WRRF fused VALUES are pure rank
            # sums — only the ids vary with the query) and XLA then
            # removes the whole call from the loop. make_call must still
            # return at least one data-dependent output.
            acc = jnp.float32(0)
            for leaf in jax.tree_util.tree_leaves(out):
                acc = acc + leaf.reshape(-1)[0].astype(jnp.float32)
            return x + 0.0 * acc

        return jax.lax.fori_loop(0, n, body, x0)

    def run(n) -> float:
        t0 = time.perf_counter()
        jax.block_until_ready(loop(jnp.int32(n), jnp.zeros(()), q, *args))
        return time.perf_counter() - t0

    run(n_loop)  # compile
    base = min(run(0) for _ in range(max(2, trials)))
    full = min(run(n_loop) for _ in range(max(1, trials)))
    return max(full - base, 0.0) / n_loop * 1e3
