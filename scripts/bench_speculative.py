"""Speculative decoding speedup, measured host-visible on the device.

Speedup requires a draft that AGREES with the target, so both models
are fitted in-process on the same text (memorization — the acceptance
dynamics of a shared data distribution without needing downloadable
checkpoints). Compares:

* plain chunked decode of the target (generate_stream chunk=32 — the
  non-speculative dispatch-amortized baseline),
* speculative decode (gamma proposals/round, `rounds` rounds per
  dispatch), draft = a model ~10x smaller.

Usage: python scripts/bench_speculative.py [gamma=4] [rounds=8]
"""

from __future__ import annotations

import sys
import time

sys.path.insert(0, ".")

import jax.numpy as jnp

from a_nice_rag_tpu.models.decoder import (
    ByteTokenizer,
    generate_stream,
    init_decoder,
    small_lm_config,
    train_lm_steps,
)
from a_nice_rag_tpu.models.speculative import speculative_generate_stream

N_NEW = 96


def fit(cfg, text, seed, steps=150, lr=3e-3):
    tok = ByteTokenizer()
    ids = tok.encode(text)
    model, params = init_decoder(cfg, seed=seed, max_len=len(ids))
    batch = jnp.asarray(ids, jnp.int32)[None, :]
    params, losses = train_lm_steps(model, params, batch, n_steps=steps,
                                    lr=lr)
    return model, params, losses[-1]


def main():
    import jax

    gamma = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    rounds = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    layers = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    hidden = int(sys.argv[4]) if len(sys.argv) > 4 else 1024
    print("platform:", jax.devices()[0].platform, flush=True)

    phrase = "the dose is 42 mg daily with food and water. "
    text = phrase * 6
    t0 = time.perf_counter()
    # Speculation pays when the target's decode step is weight-bound
    # (big model) and the draft is ~free; a small target loses (its 4
    # sequential draft steps cost as much as 4 target steps).
    # f32 params: bf16 made the wide verify forward argmax-diverge
    # from the step forward at low-confidence positions (observed at
    # 16L x 1024h); f32 keeps the streams identical and is MORE
    # weight-bound, which is exactly speculation's regime.
    target, tp, lt = fit(
        small_lm_config(hidden_size=hidden, num_layers=layers,
                        intermediate_size=2 * hidden, num_heads=8,
                        num_kv_heads=4, head_dim=hidden // 8),
        text, seed=1, steps=300, lr=1e-3,  # deep nets diverge at 3e-3
    )
    draft, dp, ld = fit(
        small_lm_config(hidden_size=128, num_layers=2), text, seed=2
    )
    print(f"fitted target (loss {lt:.3f}) + draft (loss {ld:.3f}) "
          f"in {time.perf_counter() - t0:.0f}s", flush=True)

    tok = ByteTokenizer()
    prompt = tok.encode(phrase * 2)

    def run_plain():
        return list(generate_stream(target, tp, prompt,
                                    max_new_tokens=N_NEW, chunk=32))

    def run_spec():
        stats = {}
        out = list(speculative_generate_stream(
            target, tp, draft, dp, prompt, max_new_tokens=N_NEW,
            gamma=gamma, rounds=rounds, stats=stats,
        ))
        return out, stats

    ref = run_plain()  # compile
    t0 = time.perf_counter()
    ref = run_plain()
    t_plain = time.perf_counter() - t0

    out, _ = run_spec()  # compile
    t0 = time.perf_counter()
    out, stats = run_spec()
    t_spec = time.perf_counter() - t0

    agree = sum(a == b for a, b in zip(out, ref)) / max(len(ref), 1)
    if out != ref:
        # Low-confidence positions can argmax-flip between the wide
        # verify forward and the step forward (float non-associativity)
        # — report rather than die; timing stays comparable.
        print(f"NOTE: streams agree {agree:.1%} (float tie-breaks)")
    acc = stats["accepted"] / max(stats["rounds"], 1)
    print(f"plain chunk=32      : {len(ref)} tok in {t_plain * 1e3:7.1f} ms "
          f"-> {len(ref) / t_plain:6.1f} tok/s", flush=True)
    print(f"spec g={gamma} r={rounds}: {len(out)} tok in "
          f"{t_spec * 1e3:7.1f} ms -> {len(out) / t_spec:6.1f} tok/s "
          f"({acc:.2f} tok/round accepted, {t_plain / t_spec:.2f}x)",
          flush=True)


if __name__ == "__main__":
    main()
