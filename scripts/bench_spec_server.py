"""Batched speculative decoding in the continuous-batching server,
measured host-visible on the device.

scripts/bench_speculative.py measures single-stream speculation; this
measures the SERVER form (serving/genserver.py with draft_model=):
every slot runs one draft-propose/target-verify round per dispatch at
its own cache offset, so each tick advances S slots by 1..gamma+1
tokens each. Speedup needs a draft that agrees with the target, so
both are fitted in-process on the same text (memorization — real
acceptance dynamics without downloadable checkpoints). Compares, at
equal slot count and concurrency:

* plain GenerationServer (chunk tokens/slot/dispatch, target only),
* speculative GenerationServer (gamma proposals + verify per
  dispatch), draft ~10x smaller than the target.

Usage: python scripts/bench_spec_server.py [gamma=4] [layers=16]
           [hidden=1024] [slots=8] [chunk=8]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.models.decoder import (
    ByteTokenizer,
    init_decoder,
    small_lm_config,
    train_lm_steps,
)
from a_nice_rag_tpu.serving.genserver import _END, GenerationServer

N_NEW = 96   # tokens per request
N_REQ = 16   # concurrent requests


def fit(cfg, text, seed, steps=150, lr=3e-3):
    tok = ByteTokenizer()
    ids = tok.encode(text)
    model, params = init_decoder(cfg, seed=seed, max_len=len(ids))
    batch = jnp.asarray(ids, jnp.int32)[None, :]
    params, losses = train_lm_steps(model, params, batch, n_steps=steps,
                                    lr=lr)
    return model, params, losses[-1]


def drain_counted(srv):
    """drain() that also counts decode ticks -> (ticks, emitted)."""
    ticks = emitted = 0
    for _ in range(10_000):
        if srv.n_active == 0 and srv._pending.empty():
            return ticks, emitted
        e = srv.tick()
        ticks += 1
        emitted += e
    raise RuntimeError("drain did not converge")


def serve_once(srv, prompt):
    reqs = [srv.submit(prompt, N_NEW) for _ in range(N_REQ)]
    t0 = time.perf_counter()
    ticks, _ = drain_counted(srv)
    dt = time.perf_counter() - t0
    toks = [list(_iter_queue(r)) for r in reqs]
    total = sum(len(t) for t in toks)
    return total, dt, ticks, toks


def _iter_queue(req):
    while not req.out.empty():
        item = req.out.get_nowait()
        if item is not _END:
            yield item


def main():
    gamma = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    layers = int(sys.argv[2]) if len(sys.argv) > 2 else 16
    hidden = int(sys.argv[3]) if len(sys.argv) > 3 else 1024
    slots = int(sys.argv[4]) if len(sys.argv) > 4 else 8
    chunk = int(sys.argv[5]) if len(sys.argv) > 5 else 8
    print("platform:", jax.devices()[0].platform, flush=True)

    phrase = "the dose is 42 mg daily with food and water. "
    text = phrase * 6
    t0 = time.perf_counter()
    # f32 target: bf16 argmax-diverges between the wide verify forward
    # and the step forward at low-confidence positions (see
    # bench_speculative.py); f32 is also MORE weight-bound, which is
    # speculation's regime.
    target, tp, lt = fit(
        small_lm_config(hidden_size=hidden, num_layers=layers,
                        intermediate_size=2 * hidden, num_heads=8,
                        num_kv_heads=4, head_dim=hidden // 8),
        text, seed=1, steps=300, lr=1e-3,
    )
    draft, dp, ld = fit(
        small_lm_config(hidden_size=128, num_layers=2), text, seed=2
    )
    print(f"fitted target (loss {lt:.3f}) + draft (loss {ld:.3f}) "
          f"in {time.perf_counter() - t0:.0f}s", flush=True)

    tok = ByteTokenizer()
    prompt = tok.encode(phrase * 2)
    smax = len(prompt) + N_NEW + gamma + chunk

    plain = GenerationServer(target, tp, slots=slots, max_len=smax,
                             chunk=chunk, eos_id=-1)
    serve_once(plain, prompt)  # compile + warm
    total_p, dt_p, ticks_p, ref = serve_once(plain, prompt)

    spec = GenerationServer(target, tp, slots=slots, max_len=smax,
                            eos_id=-1, draft_model=draft,
                            draft_params=dp, gamma=gamma)
    serve_once(spec, prompt)  # compile + warm
    total_s, dt_s, ticks_s, out = serve_once(spec, prompt)

    agree = sum(
        sum(a == b for a, b in zip(x, y)) / max(len(y), 1)
        for x, y in zip(out, ref)
    ) / max(len(ref), 1)
    # Mean tokens per slot-round: emitted / (ticks * mean-active) is
    # noisy near the tail; the per-dispatch advance is the useful lens.
    print(f"plain  chunk={chunk}: {total_p} tok in {dt_p * 1e3:8.1f} ms "
          f"-> {total_p / dt_p:7.1f} tok/s aggregate "
          f"({ticks_p} ticks)", flush=True)
    print(f"spec   gamma={gamma}: {total_s} tok in {dt_s * 1e3:8.1f} ms "
          f"-> {total_s / dt_s:7.1f} tok/s aggregate "
          f"({ticks_s} ticks, {total_s / max(ticks_s, 1):.1f} tok/tick, "
          f"streams agree {agree:.1%}, {dt_p / dt_s:.2f}x)", flush=True)


if __name__ == "__main__":
    main()
