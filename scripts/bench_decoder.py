"""Decode throughput of the on-device LM (models/decoder.py).

Autoregressive decode is memory-bound: every step reads all weights
once, so the per-token floor is params_bytes / memory bandwidth (0.36 ms
for 0.6B bf16 params at the H100's published 3.35 TB/s). Measures,
dispatch-free (whole decode loop inside ONE jitted lax.scan):

* prefill latency for a P-token prompt,
* per-token decode latency and tokens/s at batch 1 and batch B
  (weight reads amortize across the batch — the usual serving win).

Usage: python scripts/bench_decoder.py [layers=28] [hidden=1024] [B=8]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.models.decoder import DecoderLM, init_caches
from a_nice_rag_tpu.models.qwen3 import Qwen3Config

P = 256  # prompt tokens
N_NEW = 32  # decoded tokens per measured call


def build(layers: int, hidden: int):
    cfg = Qwen3Config(
        vocab_size=151_936, hidden_size=hidden, num_layers=layers,
        num_heads=16, num_kv_heads=8, head_dim=128,
        intermediate_size=3072, dtype=jnp.bfloat16,
    )
    model = DecoderLM(cfg)
    return cfg, model


def param_bytes(params) -> int:
    return sum(
        leaf.size * leaf.dtype.itemsize
        for leaf in jax.tree_util.tree_leaves(params)
    )


def main():
    layers = int(sys.argv[1]) if len(sys.argv) > 1 else 28
    hidden = int(sys.argv[2]) if len(sys.argv) > 2 else 1024
    batch = int(sys.argv[3]) if len(sys.argv) > 3 else 8
    cfg, model = build(layers, hidden)
    smax = P + N_NEW + 1
    print("platform:", jax.devices()[0].platform)

    kc0, vc0 = init_caches(cfg, 1, smax)
    params = jax.jit(
        lambda key: model.init(
            key, jnp.zeros((1, 1), jnp.int32), kc0, vc0, jnp.int32(0)
        )
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    gb = param_bytes(params) / 1e9
    print(f"model: {layers}L x {hidden}h, {gb:.2f} GB params (bf16)")

    def bench(b: int):
        ids = jnp.ones((b, P), jnp.int32)
        kc, vc = init_caches(cfg, b, smax)

        @jax.jit
        def prefill(p, ids, kc, vc):
            logits, kc, vc = model.apply(p, ids, kc, vc, jnp.int32(0))
            return jnp.argmax(logits[:, -1], -1).astype(jnp.int32), kc, vc

        @jax.jit
        def decode_n(p, tok, kc, vc):
            def body(carry, i):
                tok, kc, vc = carry
                logits, kc, vc = model.apply(
                    p, tok[:, None], kc, vc, P + i
                )
                tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
                return (tok, kc, vc), tok

            (tok, _, _), _ = jax.lax.scan(
                body, (tok, kc, vc), jnp.arange(N_NEW, dtype=jnp.int32)
            )
            return tok

        tok, kc, vc = prefill(params, ids, kc, vc)
        float(np.asarray(tok[0]))  # force
        t0 = time.perf_counter()
        for _ in range(8):
            tok2, kc2, vc2 = prefill(params, ids, kc, vc)
        float(np.asarray(tok2[0]))
        prefill_ms = (time.perf_counter() - t0) / 8 * 1e3

        out = decode_n(params, tok, kc, vc)
        float(np.asarray(out[0]))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out = decode_n(params, tok, kc, vc)
            float(np.asarray(out[0]))
            best = min(best, time.perf_counter() - t0)
        ms_tok = best / N_NEW * 1e3
        # Params are stored f32 but computed bf16; XLA hoists the
        # f32->bf16 convert out of the scan, so each step streams the
        # BF16 weight bytes — that is the per-token floor.
        floor_ms = (gb / 2) / 0.819 * 1e3 / 1e3
        print(f"B={b:3d}: prefill({P} tok) {prefill_ms:7.2f} ms | "
              f"decode {ms_tok:6.2f} ms/step | "
              f"{b / ms_tok * 1e3:8.0f} tok/s | "
              f"bf16 weight-read floor {floor_ms:5.2f} ms/step")

    bench(1)
    if batch > 1:
        bench(batch)


if __name__ == "__main__":
    main()
