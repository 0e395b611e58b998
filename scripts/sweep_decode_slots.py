"""Decode batch-scaling curve on the Qwen3-0.6B architecture.

If decode at small batch is occupancy/dispatch-bound rather than bound
by the weight stream, aggregate tok/s grows near-linearly as the slot
matrix widens. This sweep measures the curve: slots in {8, 16, 32, 64,
128}, one GenerationServer per point, all slots admitted in one wave,
aggregate tok/s + device ms/step.

Writes results/decode_slot_scaling.csv.

Usage: python scripts/sweep_decode_slots.py [n_new] [out_csv]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.models.decoder import DecoderLM, init_caches
from a_nice_rag_tpu.models.qwen3 import Qwen3Config
from a_nice_rag_tpu.serving.genserver import GenerationServer

SLOTS = (8, 16, 32, 64, 128)


def main():
    n_new = int(sys.argv[1]) if len(sys.argv) > 1 else 128
    out_csv = sys.argv[2] if len(sys.argv) > 2 else os.path.join(
        os.path.dirname(__file__), "..", "results",
        "decode_slot_scaling.csv",
    )
    print(f"platform: {jax.devices()[0].platform}")
    cfg = Qwen3Config(
        vocab_size=151_936, hidden_size=1024, num_layers=28,
        num_heads=16, num_kv_heads=8, head_dim=128,
        intermediate_size=3072, dtype=jnp.bfloat16,
    )
    model = DecoderLM(cfg)
    smax = 256
    prompt = list(range(2, 66))
    kc0, vc0 = init_caches(cfg, 1, smax)
    params = jax.jit(
        lambda key: model.init(
            key, jnp.zeros((1, 1), jnp.int32), kc0, vc0, jnp.int32(0)
        )
    )(jax.random.PRNGKey(0))
    jax.block_until_ready(params)
    # Weight bytes streamed per decode step (the floor's numerator).
    wbytes = sum(
        x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(params)
    )
    print(f"weights: {wbytes / 1e9:.2f} GB/step floor stream")

    rows = []
    for slots in SLOTS:
        chunk = 16
        srv = GenerationServer(model, params, slots=slots, max_len=smax,
                               chunk=chunk, eos_id=-1)
        try:
            # Warm: full slot matrix compiles once.
            reqs = [srv.submit(prompt, 8) for _ in range(slots)]
            srv.drain()
            for r in reqs:
                while not r.out.empty():
                    r.out.get_nowait()
            t0 = time.perf_counter()
            reqs = [srv.submit(prompt, n_new) for _ in range(slots)]
            srv.drain()
            wall = time.perf_counter() - t0
        finally:
            srv.stop()
        tok_s = slots * n_new / wall
        rows.append(dict(
            slots=slots, chunk=chunk, n_new=n_new,
            agg_tok_s=round(tok_s, 1),
            ms_per_step=round(wall / n_new * 1e3, 3),
            weight_stream_gb_s=round(wbytes * n_new / wall / 1e9, 1),
            tok_s_per_slot=round(tok_s / slots, 1),
        ))
        print(rows[-1], flush=True)

    os.makedirs(os.path.dirname(out_csv), exist_ok=True)
    cols = list(rows[0].keys())
    with open(out_csv, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join(str(r[c]) for c in cols) + "\n")
    best = max(rows, key=lambda r: r["agg_tok_s"])
    print(f"wrote {out_csv}; best {best['agg_tok_s']} tok/s "
          f"at {best['slots']} slots")


if __name__ == "__main__":
    main()
