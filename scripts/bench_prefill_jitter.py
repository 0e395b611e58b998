"""Admission-stall (inter-token jitter) of the generation server,
measured host-visible on the device.

Continuous batching has a classic tail-latency problem: admitting a
long prompt runs its whole prefill inside one tick, stalling every
active stream for the prompt's full forward. ``prefill_chunk=C``
bounds that stall to one C-token chunk per tick (the chunked-prefill
refinement of the vLLM/Sarathi serving pattern, built on the same
partial-row machinery as prefix caching).

Measures, for an active stream decoding while one LONG prompt is
admitted: the maximum inter-token gap (the stall) and total wall time,
with whole-prompt admission vs chunked admission.

Usage: python scripts/bench_prefill_jitter.py [layers=4] [hidden=512]
           [prompt=1024] [chunkC=64]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.models.decoder import DecoderLM, init_caches
from a_nice_rag_tpu.models.qwen3 import Qwen3Config
from a_nice_rag_tpu.serving.genserver import GenerationServer


def run(model, params, smax, long_prompt, prefill_chunk):
    srv = GenerationServer(model, params, slots=2, max_len=smax,
                           chunk=4, eos_id=-1,
                           prefill_chunk=prefill_chunk)
    # Warm every program: short stream + one long admission.
    r = srv.submit([2, 3, 4], 8)
    srv.drain()
    r = srv.submit(long_prompt, 4)
    srv.drain()
    while not r.out.empty():
        r.out.get_nowait()

    active = srv.submit([5, 6, 7], 160)
    srv.tick()  # active stream admitted + decoding
    gaps = []
    t_last = time.perf_counter()
    late = srv.submit(long_prompt, 4)  # the disruptive admission
    seen = 0
    t0 = time.perf_counter()
    for _ in range(200):
        srv.tick()
        now = time.perf_counter()
        n_new = active.out.qsize() - seen
        if n_new > 0:
            gaps.append((now - t_last, n_new))
            seen += n_new
            t_last = now
        if late.emitted >= 4:
            break
    dt = time.perf_counter() - t0
    max_gap = max(g for g, _ in gaps) if gaps else float("nan")
    return max_gap * 1e3, dt * 1e3


def main():
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    hidden = int(sys.argv[2]) if len(sys.argv) > 2 else 512
    plen = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    chunk_c = int(sys.argv[4]) if len(sys.argv) > 4 else 64
    print("platform:", jax.devices()[0].platform, flush=True)
    cfg = Qwen3Config(
        vocab_size=32_000, hidden_size=hidden, num_layers=layers,
        num_heads=8, num_kv_heads=4, head_dim=64,
        intermediate_size=2 * hidden, dtype=jnp.bfloat16,
    )
    model = DecoderLM(cfg)
    smax = plen + 256
    kc0, vc0 = init_caches(cfg, 1, smax)
    params = jax.jit(
        lambda key: model.init(
            key, jnp.zeros((1, 1), jnp.int32), kc0, vc0, jnp.int32(0)
        )
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    long_prompt = list(range(2, 2 + plen))

    for label, pc in (("whole-prompt", None), (f"chunk={chunk_c}", chunk_c)):
        max_gap, dt = run(model, params, smax, long_prompt, pc)
        print(f"admission {label:>12}: max inter-token gap "
              f"{max_gap:7.1f} ms on the active stream "
              f"(long-prompt TTFT window {dt:7.1f} ms)", flush=True)


if __name__ == "__main__":
    main()
