"""Host-visible generation serving throughput on the device.

bench_decoder.py measures the pure device decode loop (one jit, no
dispatches). This measures what a CLIENT sees, dispatch latency and
per-token host loop included:

1. generate_stream tok/s at chunk=1 (one dispatch per token — the
   naive serving loop) vs chunk=8/32 (lax.scan moves the loop on
   device; dispatches drop by the chunk factor);
2. GenerationServer aggregate tok/s: S slots x chunk tokens per
   dispatch, concurrent requests continuously batched.

Usage: python scripts/bench_genserver.py [layers=4] [hidden=512] [slots=8]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.models.decoder import (
    DecoderLM,
    generate_stream,
    init_caches,
)
from a_nice_rag_tpu.models.qwen3 import Qwen3Config
from a_nice_rag_tpu.serving.genserver import GenerationServer

P = 64      # prompt tokens
N_NEW = 64  # tokens per request


def main():
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    hidden = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    slots = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    cfg = Qwen3Config(
        vocab_size=32_000, hidden_size=hidden, num_layers=layers,
        num_heads=8, num_kv_heads=4, head_dim=64,
        intermediate_size=2 * hidden, dtype=jnp.bfloat16,
    )
    model = DecoderLM(cfg)
    print("platform:", jax.devices()[0].platform)
    smax = 256
    kc0, vc0 = init_caches(cfg, 1, smax)
    params = jax.jit(
        lambda key: model.init(
            key, jnp.zeros((1, 1), jnp.int32), kc0, vc0, jnp.int32(0)
        )
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    prompt = list(range(2, 2 + P))

    # --- single stream, varying chunk -------------------------------
    for chunk in (1, 8, 32):
        # warm (compile)
        n = sum(1 for _ in generate_stream(
            model, params, prompt, max_new_tokens=N_NEW, chunk=chunk,
            eos_id=-1, max_len=smax))
        t0 = time.perf_counter()
        n = sum(1 for _ in generate_stream(
            model, params, prompt, max_new_tokens=N_NEW, chunk=chunk,
            eos_id=-1, max_len=smax))
        dt = time.perf_counter() - t0
        print(f"stream chunk={chunk:3d}: {n} tok in {dt * 1e3:8.1f} ms "
              f"-> {n / dt:7.1f} tok/s host-visible")

    # --- continuous batching: slots x chunk per dispatch -------------
    srv = GenerationServer(model, params, slots=slots, max_len=smax,
                           chunk=8, eos_id=-1)
    reqs = [srv.submit(prompt, N_NEW) for _ in range(slots)]
    srv.drain()  # warm/compile + first batch
    for r in reqs:
        while not r.out.empty():
            r.out.get_nowait()
    n_req = 2 * slots
    t0 = time.perf_counter()
    reqs = [srv.submit(prompt, N_NEW) for _ in range(n_req)]
    srv.drain()
    dt = time.perf_counter() - t0
    total = n_req * N_NEW
    print(f"genserver slots={slots} chunk=8: {n_req} reqs x {N_NEW} tok "
          f"in {dt * 1e3:8.1f} ms -> {total / dt:7.1f} tok/s aggregate")


if __name__ == "__main__":
    main()
