"""Speculative decoding: draft-proposes, target-verifies, greedy-exact.

Autoregressive decode is memory-bound — every step streams the target
model's weights for ONE token of progress. Speculative decoding
(Leviathan et al., 2023) lets a small draft model propose ``gamma``
tokens autoregressively, then the target model scores all of them in a
SINGLE forward pass (s = gamma+1 positions — the same weight stream
buys up to gamma+1 tokens). The accepted prefix is exactly what plain
greedy decoding of the target would have produced, so output quality is
bit-identical to the target-only stream; only the latency changes.

Device-first shape: one jitted program per speculation round — the draft's
gamma-step ``lax.scan``, the target's verify forward over the proposal
window, and the accept/correct logic (cumprod prefix-match, no dynamic
shapes) all fuse into ONE dispatch. Both models' KV caches ride the
per-offset write/attend machinery of models/decoder._CachedBlock;
rejected positions' cache rows are overwritten before any later query
position can attend them (same argument as right-padded batch prefill).

The reference has no generation stack at all (SaaS-only,
reference src/query_rag.py:434-513); this accelerates the on-device one.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.models.decoder import (
    EOS,
    DecoderLM,
    init_caches,
    truncated_logits,
)

_SPEC_PROGRAMS: dict = {}


def spec_accept(ds, qs, ps, bonus_logits, key):
    """Rejection-accept core of sampled speculative decoding
    (Leviathan et al. 2023, app. A): accept draft token ``ds[i]``
    (drawn from q_i) with prob min(1, p_i(ds_i)/q_i(ds_i)); at the
    first rejection sample the replacement from norm(relu(p_i - q_i));
    on full acceptance sample the bonus token from p_{gamma+1}. The
    emitted sequence is distributed EXACTLY as target-only sampling
    (pinned distributionally in tests/test_speculative.py).

    ds [gamma] proposals; qs/ps [gamma, V] draft/target probs;
    bonus_logits [1, V] target logits past the last proposal.
    Returns (out [gamma+1], m): out[:m] are the emitted tokens."""
    gamma = ds.shape[0]
    k_u, k_rep, k_bonus = jax.random.split(key, 3)
    idx = jnp.arange(gamma)
    p_d = ps[idx, ds]
    q_d = qs[idx, ds]
    us = jax.random.uniform(k_u, (gamma,))
    acc = (us * q_d < p_d).astype(jnp.int32)  # u < p/q, div-free
    n_acc = jnp.cumprod(acc).sum()
    # Residual distribution at every candidate rejection point; where
    # p <= q everywhere (p == q) the residual is empty — fall back to
    # p itself (that branch is only selected with probability 0).
    res = jnp.maximum(ps - qs, 0.0)
    res_sum = res.sum(-1, keepdims=True)
    res = jnp.where(res_sum > 0, res / jnp.maximum(res_sum, 1e-30), ps)
    rep = jax.random.categorical(
        k_rep, jnp.log(res + 1e-30), axis=-1
    ).astype(jnp.int32)  # [gamma]
    bonus = jax.random.categorical(
        k_bonus, bonus_logits, axis=-1
    ).astype(jnp.int32)  # [1]
    cand = jnp.concatenate([rep, bonus])
    ds_pad = jnp.concatenate([ds, ds[-1:]])
    out = jnp.where(jnp.arange(gamma + 1) < n_acc, ds_pad, cand)
    return out, n_acc + 1


def _spec_programs(target: DecoderLM, draft: DecoderLM, gamma: int,
                   temperature: float = 0.0, top_k: int = 0,
                   top_p: float = 0.0, rounds: int = 1):
    """Jitted (prefill_both, spec_round) for one (target, draft, gamma,
    sampling, rounds) setting, cached at module level (fresh jit
    objects per call would recompile per request — see
    decoder._decode_programs). ``temperature <= 0`` builds the
    greedy-exact round; otherwise the distribution-preserving
    rejection-sampling round. Both take and return an rng key (ignored
    by the greedy round). ``rounds > 1`` scans that many speculation
    rounds inside ONE dispatched program (outputs [rounds, gamma+1] +
    per-round counts) — the dispatch-amortization knob for
    RTT-dominated links, mirroring generate_stream's ``chunk``."""
    try:
        key = (hash(target), hash(draft), int(gamma), float(temperature),
               int(top_k), float(top_p), int(rounds))
    except TypeError:
        key = (id(target), id(draft), int(gamma), float(temperature),
               int(top_k), float(top_p), int(rounds))
    if key in _SPEC_PROGRAMS:
        return _SPEC_PROGRAMS[key]
    greedy = temperature <= 0

    @jax.jit
    def prefill_both(tp, dp, ids, tkc, tvc, dkc, dvc, rkey):
        tlogits, tkc, tvc = target.apply(tp, ids, tkc, tvc, jnp.int32(0))
        _, dkc, dvc = draft.apply(dp, ids, dkc, dvc, jnp.int32(0))
        if greedy:
            tok = jnp.argmax(tlogits[:, -1], -1).astype(jnp.int32)
        else:
            rkey, sub = jax.random.split(rkey)
            ml = truncated_logits(tlogits[:, -1], temperature,
                                  top_k, top_p)
            tok = jax.random.categorical(sub, ml, axis=-1).astype(
                jnp.int32
            )
        return tok, tkc, tvc, dkc, dvc, rkey

    def _one_round(tp, dp, tok, tkc, tvc, dkc, dvc, pos, rkey):
        """One speculation round. ``tok`` [1] is the last accepted
        token (write slot ``pos``). Returns (out [gamma+1], m) where
        out[:m] are the emitted tokens: greedy mode reproduces plain
        target-greedy bit-for-bit; sampled mode is distributed exactly
        as plain target sampling (see spec_accept)."""

        def dbody(carry, _):
            tok, dkc, dvc, p, k_ = carry
            logits, dkc, dvc = draft.apply(dp, tok[:, None], dkc, dvc, p)
            if greedy:
                nxt = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
                q = jnp.zeros((logits.shape[-1],), jnp.float32)
            else:
                k_, sub = jax.random.split(k_)
                ml = truncated_logits(logits[:, -1], temperature,
                                      top_k, top_p)
                nxt = jax.random.categorical(sub, ml, axis=-1).astype(
                    jnp.int32
                )
                q = jax.nn.softmax(ml[0].astype(jnp.float32), -1)
            return (nxt, dkc, dvc, p + 1, k_), (nxt[0], q)

        (_, dkc, dvc, _, rkey), (ds, qs) = jax.lax.scan(
            dbody, (tok, dkc, dvc, pos, rkey), None, length=gamma
        )

        seq = jnp.concatenate([tok, ds])[None, :]  # [1, gamma+1]
        tlogits, tkc, tvc = target.apply(tp, seq, tkc, tvc, pos)

        if greedy:
            gs = jnp.argmax(tlogits[0], -1).astype(jnp.int32)
            match = (ds == gs[:gamma]).astype(jnp.int32)
            n_acc = jnp.cumprod(match).sum()
            ds_pad = jnp.concatenate([ds, ds[-1:]])
            out = jnp.where(jnp.arange(gamma + 1) < n_acc, ds_pad, gs)
            m = n_acc + 1
        else:
            mlt = truncated_logits(tlogits[0], temperature, top_k, top_p)
            ps = jax.nn.softmax(mlt[:gamma].astype(jnp.float32), -1)
            rkey, sub = jax.random.split(rkey)
            out, m = spec_accept(ds, qs, ps, mlt[gamma:gamma + 1], sub)
        new_tok = out[m - 1][None]
        return out, m, new_tok, tkc, tvc, dkc, dvc, pos + m, rkey

    if rounds == 1:
        @jax.jit
        def spec_round(tp, dp, tok, tkc, tvc, dkc, dvc, pos, rkey):
            out, m, tok, tkc, tvc, dkc, dvc, pos, rkey = _one_round(
                tp, dp, tok, tkc, tvc, dkc, dvc, pos, rkey
            )
            return (out[None], m[None], tok, tkc, tvc, dkc, dvc, pos,
                    rkey)
    else:
        @jax.jit
        def spec_round(tp, dp, tok, tkc, tvc, dkc, dvc, pos, rkey):
            def body(carry, _):
                tok, tkc, tvc, dkc, dvc, pos, rkey = carry
                out, m, tok, tkc, tvc, dkc, dvc, pos, rkey = _one_round(
                    tp, dp, tok, tkc, tvc, dkc, dvc, pos, rkey
                )
                return (tok, tkc, tvc, dkc, dvc, pos, rkey), (out, m)

            carry, (outs, ms) = jax.lax.scan(
                body, (tok, tkc, tvc, dkc, dvc, pos, rkey), None,
                length=rounds,
            )
            tok, tkc, tvc, dkc, dvc, pos, rkey = carry
            return outs, ms, tok, tkc, tvc, dkc, dvc, pos, rkey

    progs = (prefill_both, spec_round)
    _SPEC_PROGRAMS[key] = progs
    return progs


_BATCH_SPEC_PROGRAMS: dict = {}


def _batched_spec_programs(target: DecoderLM, draft: DecoderLM,
                           gamma: int, temperature: float = 0.0,
                           top_k: int = 0, top_p: float = 0.0):
    """Jitted batched speculation round for the continuous-batching
    server (serving/genserver.py): every SLOT of the batch runs one
    draft-propose/target-verify round at its OWN cache offset in one
    dispatched program. Per-row semantics are exactly
    ``_spec_programs``'s single-stream round — greedy rows reproduce
    plain per-row target-greedy bit-for-bit; sampled rows are
    distributed exactly as plain target sampling (vmapped
    ``spec_accept``). ``done`` rows freeze: they advance by m=0 and
    keep their token/pos (their cache rows still receive junk writes,
    which is harmless — admission prefill rewrites the whole row).

    Returns a jitted ``spec_tick(tp, dp, tok [S], tkc, tvc, dkc, dvc,
    pos [S], rkey, done [S]) -> (out [S, gamma+1], m [S], new_tok,
    tkc, tvc, dkc, dvc, pos, rkey)`` where row s emitted
    ``out[s, :m[s]]`` this round."""
    try:
        key = (hash(target), hash(draft), int(gamma), float(temperature),
               int(top_k), float(top_p))
    except TypeError:
        key = (id(target), id(draft), int(gamma), float(temperature),
               int(top_k), float(top_p))
    if key in _BATCH_SPEC_PROGRAMS:
        return _BATCH_SPEC_PROGRAMS[key]
    greedy = temperature <= 0

    @jax.jit
    def spec_tick(tp, dp, tok, tkc, tvc, dkc, dvc, pos, rkey, done):
        s_rows = tok.shape[0]

        def dbody(carry, _):
            t_, dkc, dvc, p, k_ = carry
            logits, dkc, dvc = draft.apply(dp, t_[:, None], dkc, dvc, p)
            last = logits[:, -1]  # [S, V]
            if greedy:
                nxt = jnp.argmax(last, -1).astype(jnp.int32)
                q = jnp.zeros_like(last)
            else:
                k_, sub = jax.random.split(k_)
                ml = truncated_logits(last, temperature, top_k, top_p)
                nxt = jax.random.categorical(sub, ml, axis=-1).astype(
                    jnp.int32
                )
                q = jax.nn.softmax(ml.astype(jnp.float32), -1)
            return (nxt, dkc, dvc, p + 1, k_), (nxt, q)

        (_, dkc, dvc, _, rkey), (ds, qs) = jax.lax.scan(
            dbody, (tok, dkc, dvc, pos, rkey), None, length=gamma
        )
        ds = jnp.swapaxes(ds, 0, 1)  # [S, gamma]
        seq = jnp.concatenate([tok[:, None], ds], axis=1)  # [S, gamma+1]
        tlogits, tkc, tvc = target.apply(tp, seq, tkc, tvc, pos)

        if greedy:
            gs = jnp.argmax(tlogits, -1).astype(jnp.int32)  # [S, g+1]
            match = (ds == gs[:, :gamma]).astype(jnp.int32)
            n_acc = jnp.cumprod(match, axis=1).sum(1)  # [S]
            ds_pad = jnp.concatenate([ds, ds[:, -1:]], axis=1)
            out = jnp.where(
                jnp.arange(gamma + 1)[None, :] < n_acc[:, None],
                ds_pad, gs,
            )
            m = n_acc + 1
        else:
            v = tlogits.shape[-1]
            mlt = truncated_logits(
                tlogits.reshape(-1, v), temperature, top_k, top_p
            ).reshape(s_rows, gamma + 1, v)
            ps = jax.nn.softmax(mlt[:, :gamma].astype(jnp.float32), -1)
            rkey, sub = jax.random.split(rkey)
            subs = jax.random.split(sub, s_rows)
            out, m = jax.vmap(spec_accept)(
                ds, jnp.swapaxes(qs, 0, 1), ps,
                mlt[:, gamma:gamma + 1], subs,
            )

        m = jnp.where(done, 0, m)
        new_tok = out[jnp.arange(s_rows), jnp.maximum(m, 1) - 1]
        new_tok = jnp.where(done, tok, new_tok)
        pos = pos + m
        return out, m, new_tok, tkc, tvc, dkc, dvc, pos, rkey

    _BATCH_SPEC_PROGRAMS[key] = spec_tick
    return spec_tick


def speculative_generate_stream(
    target: DecoderLM,
    target_params,
    draft: DecoderLM,
    draft_params,
    prompt_ids: List[int],
    max_new_tokens: int = 64,
    gamma: int = 4,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    seed: int = 0,
    eos_id: int = EOS,
    max_len: Optional[int] = None,
    rounds: int = 1,
    stats: Optional[dict] = None,
) -> Iterator[int]:
    """Streaming generation with the draft model absorbing most of the
    sequential work; one dispatch per round yields 1..gamma+1 tokens.
    Greedy (``temperature <= 0``) is bit-identical to
    ``generate_stream(target, target_params, ...)``; sampled mode is
    distributed exactly as plain target sampling (rejection scheme —
    the draft changes latency, never the distribution). Pass
    ``stats={}`` to receive ``rounds``/``accepted`` counters (mean
    tokens/round = accepted/rounds — the speedup factor when the draft
    is ~free). ``rounds > 1`` scans that many speculation rounds per
    dispatch (1..rounds*(gamma+1) tokens per host round-trip) — use it
    when dispatch latency dominates; tokens decoded past an in-block
    EOS are discarded."""
    n_prompt = len(prompt_ids)
    block = rounds * (gamma + 1)
    smax = max_len or (n_prompt + max_new_tokens + block)
    assert n_prompt + max_new_tokens + block <= smax + block
    tkc, tvc = init_caches(target.cfg, 1, smax)
    dkc, dvc = init_caches(draft.cfg, 1, smax)
    prefill_both, spec_round = _spec_programs(
        target, draft, gamma, temperature, top_k, top_p, rounds
    )

    ids = jnp.asarray(prompt_ids, jnp.int32)[None, :]
    rkey = jax.random.PRNGKey(seed)
    tok, tkc, tvc, dkc, dvc, rkey = prefill_both(
        target_params, draft_params, ids, tkc, tvc, dkc, dvc, rkey
    )
    t = int(tok[0])
    if t == eos_id:
        return
    yield t
    emitted = 1
    pos = jnp.int32(n_prompt)
    n_rounds = accepted = 0
    while emitted < max_new_tokens:
        if int(pos) + block > smax:
            break  # cache exhausted (caller sized max_len too small)
        outs, ms, tok, tkc, tvc, dkc, dvc, pos, rkey = spec_round(
            target_params, draft_params, tok, tkc, tvc, dkc, dvc, pos,
            rkey,
        )
        outs_np = np.asarray(outs)   # [rounds, gamma+1]
        ms_np = np.asarray(ms)       # [rounds]
        for r in range(outs_np.shape[0]):
            m = int(ms_np[r])
            n_rounds += 1
            accepted += m
            for t in outs_np[r, :m]:
                t = int(t)
                if t == eos_id or emitted >= max_new_tokens:
                    if stats is not None:
                        stats.update(rounds=n_rounds, accepted=accepted)
                    return
                yield t
                emitted += 1
    if stats is not None:
        stats.update(rounds=n_rounds, accepted=accepted)
