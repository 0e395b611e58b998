"""Guided-decoding overhead in the continuous-batching server,
measured host-visible on the device.

The constrained decode program adds, per step: one [S, V] row gather
from the stacked [NC, Sm, V] table, one compare+select over the
logits, and one scalar gather per slot for the state advance. This
script measures what that costs at a serving-ish config by comparing
aggregate decode throughput at equal concurrency:

* plain GenerationServer (dynamic program, no tables),
* constraints registered but every request UNCONSTRAINED (identity
  row — isolates the table-gather overhead),
* every request in JSON mode (grammar-masked sampling).

Usage: python scripts/bench_constrained.py [layers=16] [hidden=1024]
           [slots=8] [chunk=8] [reqs=16] [new=96] [depth=4]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

from a_nice_rag_tpu.models.decoder import init_decoder, small_lm_config
from a_nice_rag_tpu.serving.genserver import GenerationServer

ARGS = dict(a.split("=") for a in sys.argv[1:] if "=" in a)
LAYERS = int(ARGS.get("layers", 16))
HIDDEN = int(ARGS.get("hidden", 1024))
SLOTS = int(ARGS.get("slots", 8))
CHUNK = int(ARGS.get("chunk", 8))
N_REQ = int(ARGS.get("reqs", 16))
N_NEW = int(ARGS.get("new", 96))
DEPTH = int(ARGS.get("depth", 4))


def run(srv, constraint=None, temperature=None):
    prompts = [[256] + [(13 * i + j) % 200 + 1 for j in range(12)]
               for i in range(N_REQ)]
    reqs = [srv.submit(p, N_NEW, constraint=constraint,
                       temperature=temperature)
            for p in prompts]
    t0 = time.perf_counter()
    ticks = 0
    while any(not r.finished for r in reqs):
        srv.tick()
        ticks += 1
        if ticks > 100_000:
            raise RuntimeError("did not converge")
    dt = time.perf_counter() - t0
    emitted = sum(r.emitted for r in reqs)
    return emitted / dt, ticks, emitted


def tick_latency(srv, n_ticks=12, constraint=None, temperature=None):
    """Steady-state decode-tick latency at FULL occupancy: every slot
    holds a stream whose budget (and, if constrained, grammar) cannot
    complete within the measured ticks, so every tick advances
    slots x chunk tokens. This isolates per-tick cost from early-stop
    and prefill effects that distort tok/s comparisons (a JSON value
    completes in ~8 tokens and retires its slot)."""
    reqs = [
        srv.submit([256] + [(7 * i + j) % 200 + 1 for j in range(12)],
                   (n_ticks + 4) * srv.chunk, constraint=constraint,
                   temperature=temperature)
        for i in range(srv.slots)
    ]
    srv.tick()  # admission + first dispatch (warm shapes)
    t0 = time.perf_counter()
    for _ in range(n_ticks):
        srv.tick()
    dt = (time.perf_counter() - t0) / n_ticks
    # Retired rows don't change tick cost (the decode program is
    # static-shape over all S rows) — but if EVERY slot sampled EOS,
    # later ticks were no-ops and the number is junk.
    if srv.n_active == 0:
        print("  WARNING: all slots retired mid-measurement")
    for r in reqs:
        srv.cancel(r)
    return dt


def main():
    import jax

    from a_nice_rag_tpu.models.constrain import json_dfa

    print(f"devices: {jax.devices()}")
    cfg = small_lm_config(num_layers=LAYERS, hidden=HIDDEN,
                          mlp_hidden=4 * HIDDEN, num_heads=8,
                          num_kv_heads=4)
    max_len = max(256, (16 + 4) * CHUNK + 32)
    model, params = init_decoder(cfg, max_len=max_len)
    common = dict(slots=SLOTS, max_len=max_len, chunk=CHUNK)

    plain = GenerationServer(model, params, **common)
    tick_latency(plain, 2)  # warm compile
    lat_p = tick_latency(plain)
    print(f"plain tick:            {1e3 * lat_p:7.2f} ms "
          f"({SLOTS * CHUNK / lat_p:8.1f} tok/s aggregate)")

    guided = GenerationServer(
        model, params, **common,
        constraints={
            "json": json_dfa(max_depth=DEPTH),
            # A grammar that cannot complete inside the measurement
            # window: full-occupancy constrained ticks.
            "long": r"[0-9]{4000,}",
        },
    )
    tick_latency(guided, 2)
    lat_u = tick_latency(guided)
    print(f"tables, unconstrained: {1e3 * lat_u:7.2f} ms  "
          f"{lat_u / lat_p:.3f}x of plain")
    tick_latency(guided, 2, constraint="long", temperature=1.0)
    lat_c = tick_latency(guided, constraint="long", temperature=1.0)
    print(f"regex-constrained:     {1e3 * lat_c:7.2f} ms  "
          f"{lat_c / lat_p:.3f}x of plain")

    # End-to-end JSON-mode demo (early stop expected: a complete JSON
    # value retires its slot) — completion latency, not throughput.
    tps_c, ticks_c, em_c = run(guided, constraint="json",
                               temperature=1.0)
    print(f"json-mode completions: {em_c} tokens over {ticks_c} ticks "
          f"({N_REQ} requests, all valid-by-construction)")
    st = guided._ctables.shape
    print(f"table: NC={st[0]} Sm={st[1]} V={st[2]} "
          f"({4 * st[0] * st[1] * st[2] / 1e6:.1f} MB)")


if __name__ == "__main__":
    main()
