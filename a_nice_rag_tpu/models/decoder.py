"""Decoder-only LM with KV-cache autoregressive decoding on device.

The reference routes ALL generation to SaaS chat APIs
(reference src/query_rag.py:434-513); this module closes the remaining
SaaS dependency the way models/embedder.py did for query embedding: a
Qwen3-architecture causal LM (same blocks as models/qwen3.py, so real
Qwen3 checkpoints convert with the same weight mapping) with

* one unified forward for training, prefill, and per-token decode —
  every call writes its keys/values into a fixed-size cache at
  ``cache_len`` and attends over the cache prefix, so the step path is
  O(s * cache) with static shapes (XLA-friendly: the only dynamic
  values are scalar offsets into ``lax.dynamic_update_slice``);
* a byte-level reversible tokenizer (no external vocab files);
* a streaming ``generate_stream`` generator (greedy or temperature
  sampling) whose per-token step is a single jitted program, yielding
  UTF-8-safe text deltas for the RAG streaming contract.

Untrained weights generate noise, of course — the point is the
infrastructure: ``lm_loss``/``train_lm_steps`` fit small corpora (the
memorization test pins decode correctness end to end), and converted
checkpoints drop in via models/qwen3.convert_hf_qwen3.
"""

from __future__ import annotations

import dataclasses
from typing import Generator, Iterator, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from a_nice_rag_tpu.models.qwen3 import Qwen3Config, _RMSNorm, _rope

BOS, EOS, PAD = 256, 257, 258
BYTE_VOCAB = 259


class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0-255 are raw bytes, plus
    BOS/EOS/PAD specials. Streaming-safe decode via ``ByteDecoder``."""

    vocab_size = BYTE_VOCAB
    bos_id, eos_id, pad_id = BOS, EOS, PAD

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([BOS] if add_bos else []) + ids

    def decode(self, ids) -> str:
        data = bytes(int(i) for i in ids if 0 <= int(i) < 256)
        return data.decode("utf-8", errors="replace")

    def stream_decoder(self) -> "ByteDecoder":
        """Incremental decoder for this vocabulary (duck-typed with
        models/hf_tokenizer.HFTokenizer.stream_decoder)."""
        return ByteDecoder()


class ByteDecoder:
    """Incremental UTF-8 decoder: feed token ids, get back only the
    text that is complete so far (multi-byte codepoints buffer until
    their continuation bytes arrive)."""

    def __init__(self):
        self._buf = b""

    def feed(self, token_id: int) -> str:
        if not (0 <= token_id < 256):
            return ""
        self._buf += bytes([token_id])
        try:
            out = self._buf.decode("utf-8")
            self._buf = b""
            return out
        except UnicodeDecodeError:
            if len(self._buf) >= 4:  # invalid sequence, flush lossily
                out = self._buf.decode("utf-8", errors="replace")
                self._buf = b""
                return out
            return ""

    def flush(self) -> str:
        out = self._buf.decode("utf-8", errors="replace")
        self._buf = b""
        return out


class _CachedBlock(nn.Module):
    """Qwen3 block over a KV cache window.

    ``x`` holds s new tokens at absolute positions
    ``cache_len .. cache_len+s-1``; their keys/values are written into
    the [B, Smax, nkv, hd] caches in place and attention runs over the
    cache prefix with a causal mask. With ``cache_len=0`` and ``s=Smax``
    this is exactly the full causal forward of models/qwen3._Qwen3Block
    (same parameter names — converted checkpoints load unchanged).

    ``cache_len`` may be a scalar (all rows at the same offset — the
    single-stream decode path) or shape [B] (each row at its own
    offset — the batched/continuous-batching path, where every slot of
    the batch sits at a different point in its own sequence)."""

    cfg: Qwen3Config

    @nn.compact
    def __call__(self, x, kcache, vcache, cache_len):
        cfg = self.cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        b, s, _ = x.shape
        smax = kcache.shape[1]
        cl = jnp.asarray(cache_len, jnp.int32)
        per_row = cl.ndim == 1
        offs = cl[:, None] if per_row else cl
        positions = offs + jnp.arange(s, dtype=jnp.int32)[None, :]
        positions = jnp.broadcast_to(positions, (b, s))

        h = _RMSNorm(cfg.hidden_size, cfg.rms_eps, name="input_norm")(x)
        q = nn.Dense(nh * hd, use_bias=False, dtype=cfg.dtype,
                     name="q_proj")(h).reshape(b, s, nh, hd)
        k = nn.Dense(nkv * hd, use_bias=False, dtype=cfg.dtype,
                     name="k_proj")(h).reshape(b, s, nkv, hd)
        v = nn.Dense(nkv * hd, use_bias=False, dtype=cfg.dtype,
                     name="v_proj")(h).reshape(b, s, nkv, hd)
        q = _RMSNorm(hd, cfg.rms_eps, name="q_norm")(q)
        k = _RMSNorm(hd, cfg.rms_eps, name="k_norm")(k)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)

        if per_row:
            row_upd = lambda c, u, o: jax.lax.dynamic_update_slice(
                c, u, (o, 0, 0)
            )
            kcache = jax.vmap(row_upd)(kcache, k.astype(kcache.dtype), cl)
            vcache = jax.vmap(row_upd)(vcache, v.astype(vcache.dtype), cl)
        else:
            kcache = jax.lax.dynamic_update_slice(
                kcache, k.astype(kcache.dtype), (0, cache_len, 0, 0)
            )
            vcache = jax.lax.dynamic_update_slice(
                vcache, v.astype(vcache.dtype), (0, cache_len, 0, 0)
            )
        # Grouped-query attention WITHOUT materializing the repeated
        # cache: jnp.repeat(kcache, rep) writes a full [B, Smax, nh,
        # hd] copy of both caches every step of every layer, tripling
        # the bytes each step reads. Folding the group axis into the query
        # side contracts the same per-head dot products directly
        # against the stored [B, Smax, nkv, hd] layout.
        rep = nh // nkv
        qg = q.reshape(b, s, nkv, rep, hd)
        attn = jnp.einsum(
            "bsnrd,bknd->bnrsk", qg, kcache,
            preferred_element_type=jnp.float32,
        ) / np.sqrt(hd)  # [B, nkv, rep, s, Smax]
        key_pos = jnp.arange(smax, dtype=jnp.int32)
        # Query at absolute position cache_len + qi sees keys <= it.
        q_pos = offs + jnp.arange(s, dtype=jnp.int32)[None, :]  # [B|1, s]
        keep = key_pos[None, None, :] <= q_pos[:, :, None]  # [B|1, s, Smax]
        attn = jnp.where(keep[:, None, None, :, :], attn, -1e30)
        attn = jax.nn.softmax(attn, axis=-1).astype(cfg.dtype)
        out = jnp.einsum("bnrsk,bknd->bsnrd", attn, vcache).reshape(
            b, s, nh * hd
        )
        x = x + nn.Dense(cfg.hidden_size, use_bias=False, dtype=cfg.dtype,
                         name="o_proj")(out)

        h = _RMSNorm(cfg.hidden_size, cfg.rms_eps, name="post_attn_norm")(x)
        gate = nn.Dense(cfg.intermediate_size, use_bias=False,
                        dtype=cfg.dtype, name="gate_proj")(h)
        up = nn.Dense(cfg.intermediate_size, use_bias=False,
                      dtype=cfg.dtype, name="up_proj")(h)
        x = x + nn.Dense(cfg.hidden_size, use_bias=False, dtype=cfg.dtype,
                         name="down_proj")(nn.silu(gate) * up)
        return x, kcache, vcache


class DecoderLM(nn.Module):
    """Causal LM head over the cached Qwen3 stack (tied embeddings)."""

    cfg: Qwen3Config

    @nn.compact
    def __call__(self, token_ids, kcaches, vcaches, cache_len):
        """token_ids [B, s]; kcaches/vcaches lists of per-layer
        [B, Smax, nkv, hd]; cache_len scalar int32. Returns
        (logits [B, s, V] f32, new kcaches, new vcaches)."""
        cfg = self.cfg
        embed = nn.Embed(cfg.vocab_size, cfg.hidden_size,
                         dtype=cfg.dtype, name="embed")
        x = embed(jnp.maximum(token_ids, 0))
        new_k, new_v = [], []
        for i in range(cfg.num_layers):
            x, kc, vc = _CachedBlock(cfg, name=f"layer_{i}")(
                x, kcaches[i], vcaches[i], cache_len
            )
            new_k.append(kc)
            new_v.append(vc)
        x = _RMSNorm(cfg.hidden_size, cfg.rms_eps, name="final_norm")(x)
        logits = embed.attend(x.astype(cfg.dtype)).astype(jnp.float32)
        return logits, new_k, new_v


def small_lm_config(**overrides) -> Qwen3Config:
    base = dict(
        vocab_size=BYTE_VOCAB, hidden_size=128, num_layers=2,
        num_heads=4, num_kv_heads=2, head_dim=32, intermediate_size=256,
        rms_eps=1e-6, rope_theta=10000.0, dtype=jnp.float32,
    )
    base.update(overrides)
    fields = {f.name for f in dataclasses.fields(Qwen3Config)}
    return Qwen3Config(**{k: v for k, v in base.items() if k in fields})


def init_caches(cfg: Qwen3Config, batch: int, max_len: int):
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    k = [jnp.zeros(shape, cfg.dtype) for _ in range(cfg.num_layers)]
    v = [jnp.zeros(shape, cfg.dtype) for _ in range(cfg.num_layers)]
    return k, v


def init_decoder(cfg: Qwen3Config, seed: int = 0, max_len: int = 128):
    model = DecoderLM(cfg)
    kc, vc = init_caches(cfg, 1, max_len)
    params = model.init(
        jax.random.PRNGKey(seed),
        jnp.zeros((1, 1), jnp.int32), kc, vc, jnp.int32(0),
    )
    return model, params


def lm_logits(model: DecoderLM, params, token_ids: jax.Array) -> jax.Array:
    """Full causal forward (training path): cache sized to the sequence,
    cache_len 0 — bitwise the same computation the decode path splits
    into prefill + steps."""
    b, s = token_ids.shape
    kc, vc = init_caches(model.cfg, b, s)
    logits, _, _ = model.apply(params, token_ids, kc, vc, jnp.int32(0))
    return logits


def lm_loss(model: DecoderLM, params, token_ids, mask=None) -> jax.Array:
    """Mean next-token cross-entropy; ``mask`` [B, S] marks real tokens."""
    logits = lm_logits(model, params, token_ids)  # [B, S, V]
    targets = token_ids[:, 1:]
    lp = jax.nn.log_softmax(logits[:, :-1], axis=-1)
    nll = -jnp.take_along_axis(lp, targets[..., None], axis=-1)[..., 0]
    if mask is None:
        mask = jnp.ones_like(targets, jnp.float32)
    else:
        mask = mask[:, 1:].astype(jnp.float32)
    return (nll * mask).sum() / jnp.maximum(mask.sum(), 1.0)


def train_lm_steps(model, params, token_ids, n_steps: int = 200,
                   lr: float = 3e-3, mask=None):
    """Adam fit on one (small) batch; returns (params, losses)."""
    import optax

    opt = optax.adam(lr)
    state = opt.init(params)

    @jax.jit
    def step(p, s):
        loss, g = jax.value_and_grad(
            lambda pp: lm_loss(model, pp, token_ids, mask)
        )(p)
        upd, s = opt.update(g, s, p)
        return optax.apply_updates(p, upd), s, loss

    losses = []
    for _ in range(n_steps):
        params, state, loss = step(params, state)
        losses.append(float(loss))
    return params, losses


def truncated_logits(last: jax.Array, temperature: float,
                     top_k: int = 0, top_p: float = 0.0) -> jax.Array:
    """Temperature-scaled [B, V] logits with top-k / nucleus tokens
    masked to -inf; softmax of the result is the exact sampling
    distribution (shared by sample_logits and speculative verify)."""
    logits = last / temperature
    if top_k and top_k < logits.shape[-1]:
        kth = jax.lax.top_k(logits, top_k)[0][:, -1:]
        logits = jnp.where(logits < kth, -jnp.inf, logits)
    if top_p and 0.0 < top_p < 1.0:
        srt = jnp.sort(logits, axis=-1)[:, ::-1]
        probs = jax.nn.softmax(srt, axis=-1)
        cum = jnp.cumsum(probs, axis=-1)
        # Keep the smallest prefix whose mass reaches top_p (the first
        # token always survives: cum is shifted right by one position).
        keep = jnp.concatenate(
            [jnp.zeros_like(cum[:, :1]), cum[:, :-1]], axis=-1
        ) < top_p
        cutoff = jnp.min(
            jnp.where(keep, srt, jnp.inf), axis=-1, keepdims=True
        )
        logits = jnp.where(logits < cutoff, -jnp.inf, logits)
    return logits


def sample_logits(last: jax.Array, key, temperature: float = 0.0,
                  top_k: int = 0, top_p: float = 0.0) -> jax.Array:
    """One sampling decision over [B, V] logits: greedy at
    ``temperature == 0``; otherwise temperature scaling with optional
    top-k truncation and/or top-p (nucleus) truncation. The knobs are
    static — each setting is its own compiled program."""
    if temperature <= 0:
        return jnp.argmax(last, axis=-1).astype(jnp.int32)
    logits = truncated_logits(last, temperature, top_k, top_p)
    return jax.random.categorical(key, logits, axis=-1).astype(jnp.int32)


def truncated_logits_dynamic(last: jax.Array, temperature: jax.Array,
                             top_k: jax.Array, top_p: jax.Array
                             ) -> jax.Array:
    """Per-row runtime sampling knobs: ``temperature``/``top_k``/
    ``top_p`` are [B] arrays, so one compiled program serves every
    mix of per-request settings (the static ``truncated_logits`` bakes
    the knobs into the program — one compile per setting, fine for a
    single stream, wrong for a continuous-batching server whose slots
    carry different requests). Row semantics match the static version
    exactly: ``top_k[b] == 0`` disables top-k, ``top_p[b]`` outside
    (0, 1) disables nucleus; rows with ``temperature[b] <= 0`` are the
    caller's problem (``sample_logits_dynamic`` routes them to argmax).
    """
    V = last.shape[-1]
    t = jnp.maximum(temperature, 1e-6)[:, None]
    logits = last / t
    k = top_k.astype(jnp.int32)
    use_k = (k > 0) & (k < V)
    srt = jnp.sort(logits, axis=-1)[:, ::-1]
    kth = jnp.take_along_axis(
        srt, jnp.clip(k - 1, 0, V - 1)[:, None], axis=-1
    )
    kth = jnp.where(use_k[:, None], kth, -jnp.inf)
    logits = jnp.where(logits < kth, -jnp.inf, logits)
    # Nucleus over the post-top-k distribution, mirroring the static
    # order (top-k first, then the re-sorted cumulative-mass cutoff).
    srt = jnp.where(srt < kth, -jnp.inf, srt)  # same rows, masked
    probs = jax.nn.softmax(srt, axis=-1)
    cum = jnp.cumsum(probs, axis=-1)
    keep = jnp.concatenate(
        [jnp.zeros_like(cum[:, :1]), cum[:, :-1]], axis=-1
    ) < top_p[:, None]
    cutoff = jnp.min(jnp.where(keep, srt, jnp.inf), axis=-1, keepdims=True)
    use_p = (top_p > 0.0) & (top_p < 1.0)
    cutoff = jnp.where(use_p[:, None], cutoff, -jnp.inf)
    return jnp.where(logits < cutoff, -jnp.inf, logits)


def sample_logits_dynamic(last: jax.Array, key, temperature: jax.Array,
                          top_k: jax.Array, top_p: jax.Array
                          ) -> jax.Array:
    """Per-row sampling with runtime knobs ([B] arrays): greedy rows
    (``temperature[b] <= 0``) take the argmax; the truncation/sampling
    work is skipped entirely (lax.cond) when every row is greedy, so a
    greedy-only server pays nothing for the capability. For rows whose
    knobs equal a static config, the decision is bit-identical to
    ``sample_logits`` under the same key (pinned in tests)."""
    greedy = jnp.argmax(last, axis=-1).astype(jnp.int32)

    def _sampled(_):
        logits = truncated_logits_dynamic(last, temperature, top_k, top_p)
        return jax.random.categorical(key, logits, axis=-1).astype(
            jnp.int32
        )

    sampled = jax.lax.cond(
        jnp.any(temperature > 0.0), _sampled, lambda _: greedy, None
    )
    return jnp.where(temperature <= 0.0, greedy, sampled)


_PROGRAMS: dict = {}


def _decode_programs(model: DecoderLM, temperature: float, top_k: int,
                     top_p: float, eos_id: int, chunk: int):
    """Jitted (prefill, step, chunk_steps, prefill_batch) for one
    (model-architecture, sampling, chunk) setting, cached at module
    level — programs defined inside generate_* would be fresh jit
    objects every call, recompiling per request. Flax modules hash by
    their config, so equal-config models share programs; params are
    arguments, never closed over."""
    try:
        mkey = hash(model)
    except TypeError:  # unhashable custom module
        mkey = id(model)
    key = (mkey, float(temperature), int(top_k), float(top_p),
           int(eos_id), int(chunk))
    if key in _PROGRAMS:
        return _PROGRAMS[key]

    @jax.jit
    def prefill(p, ids, kc, vc, rkey):
        logits, kc, vc = model.apply(p, ids, kc, vc, jnp.int32(0))
        tok = sample_logits(logits[:, -1], rkey, temperature, top_k, top_p)
        return tok, kc, vc

    @jax.jit
    def prefill_batch(p, ids, lens, kc, vc, rkey):
        logits, kc, vc = model.apply(p, ids, kc, vc, jnp.int32(0))
        last = jnp.take_along_axis(
            logits, (lens - 1)[:, None, None], axis=1
        )[:, 0]  # [B, V]
        tok = sample_logits(last, rkey, temperature, top_k, top_p)
        return tok, kc, vc

    @jax.jit
    def step(p, tok, kc, vc, pos, rkey):
        logits, kc, vc = model.apply(p, tok, kc, vc, pos)
        nxt = sample_logits(logits[:, -1], rkey, temperature, top_k, top_p)
        return nxt, kc, vc

    @jax.jit
    def chunk_steps(p, tok, kc, vc, pos, rkey, done):
        """``chunk`` cached steps in one program. A finished row (EOS
        seen) freezes: emits ``eos_id``, stops advancing its ``pos``
        (so its cache-writes pin to one already-dead slot). ``pos``
        may be scalar (single stream) or [B] (per-row offsets)."""

        def body(carry, _):
            tok, kc, vc, pos, rkey, done = carry
            logits, kc, vc = model.apply(p, tok[:, None], kc, vc, pos)
            rkey, sub = jax.random.split(rkey)
            nxt = sample_logits(
                logits[:, -1], sub, temperature, top_k, top_p
            )
            nxt = jnp.where(done, jnp.int32(eos_id), nxt)
            frozen = done if pos.ndim else done[0]
            pos = jnp.where(frozen, pos, pos + 1)
            done = done | (nxt == eos_id)
            return (nxt, kc, vc, pos, rkey, done), nxt

        carry, toks = jax.lax.scan(
            body, (tok, kc, vc, pos, rkey, done), None, length=chunk
        )
        tok, kc, vc, pos, rkey, done = carry
        return toks, tok, kc, vc, pos, rkey, done

    progs = (prefill, step, chunk_steps, prefill_batch)
    _PROGRAMS[key] = progs
    return progs


_DYN_PROGRAMS: dict = {}


def _decode_programs_dynamic(model: DecoderLM, eos_id: int, chunk: int,
                             lp_k: int = 0):
    """``chunk_steps`` with per-row RUNTIME sampling knobs (temperature
    / top_k / top_p as [B] array arguments): one compiled program
    serves every mix of per-request sampling settings in a
    continuous-batching server, instead of one compile per (t, k, p)
    tuple. Splits the RNG key exactly like the static program, so
    all-greedy rows produce bit-identical streams to
    ``_decode_programs``' chunk_steps.

    ``lp_k > 0`` additionally emits the top-``lp_k`` raw-distribution
    alternatives per step ([chunk, S, lp_k] logprobs + token ids — the
    OpenAI ``top_logprobs`` surface); the token stream itself is
    unchanged."""
    try:
        mkey = hash(model)
    except TypeError:
        mkey = id(model)
    key = (mkey, int(eos_id), int(chunk), int(lp_k))
    if key in _DYN_PROGRAMS:
        return _DYN_PROGRAMS[key]

    @jax.jit
    def chunk_steps(p, tok, kc, vc, pos, rkey, done, temp, tk, tp):
        def body(carry, _):
            tok, kc, vc, pos, rkey, done = carry
            logits, kc, vc = model.apply(p, tok[:, None], kc, vc, pos)
            rkey, sub = jax.random.split(rkey)
            last = logits[:, -1]
            nxt = sample_logits_dynamic(last, sub, temp, tk, tp)
            # Chosen-token logprob under the model's RAW distribution
            # (pre-temperature/truncation — the model-confidence
            # convention), [S] per step.
            lsm = jax.nn.log_softmax(last, axis=-1)
            lp = jnp.take_along_axis(lsm, nxt[:, None], axis=-1)[:, 0]
            nxt = jnp.where(done, jnp.int32(eos_id), nxt)
            frozen = done if pos.ndim else done[0]
            pos = jnp.where(frozen, pos, pos + 1)
            done = done | (nxt == eos_id)
            ys = (nxt, lp)
            if lp_k:
                tlv, tli = jax.lax.top_k(lsm, lp_k)
                ys = ys + (tlv, tli.astype(jnp.int32))
            return (nxt, kc, vc, pos, rkey, done), ys

        carry, ys = jax.lax.scan(
            body, (tok, kc, vc, pos, rkey, done), None, length=chunk
        )
        tok, kc, vc, pos, rkey, done = carry
        return ys + (tok, kc, vc, pos, rkey, done)

    _DYN_PROGRAMS[key] = chunk_steps
    return chunk_steps


_CON_PROGRAMS: dict = {}


def _decode_programs_constrained(model: DecoderLM, eos_id: int,
                                 chunk: int, lp_k: int = 0):
    """The dynamic ``chunk_steps`` with GUIDED decoding: per-slot DFA
    constraints (models/constrain.py) applied as logit masks inside the
    scan, with the automaton state carried on device.

    ``tables`` is the stacked dense next-state tensor
    ``int32 [n_constraints, max_states, vocab]`` (slot 0 = the identity
    constraint), ``cid``/``cstate`` the per-row constraint id and DFA
    state. Each step gathers one table row per slot, masks disallowed
    tokens to -inf BEFORE sampling (so greedy/top-k/top-p all operate
    on the allowed set), samples, and advances the state through the
    same row — no host round-trip mid-chunk. The EOS column encodes
    acceptance (table[s, eos] == s iff accepting), so a constrained row
    can only terminate at a complete sentence; reported logprobs stay
    raw-distribution (pre-mask), the model-confidence convention."""
    try:
        mkey = hash(model)
    except TypeError:
        mkey = id(model)
    key = (mkey, int(eos_id), int(chunk), int(lp_k))
    if key in _CON_PROGRAMS:
        return _CON_PROGRAMS[key]

    @jax.jit
    def chunk_steps(p, tok, kc, vc, pos, rkey, done, temp, tk, tp,
                    cid, cstate, tables):
        nc, sm, v = tables.shape
        flat = tables.reshape(nc * sm, v)

        def body(carry, _):
            tok, kc, vc, pos, rkey, done, cstate = carry
            logits, kc, vc = model.apply(p, tok[:, None], kc, vc, pos)
            rkey, sub = jax.random.split(rkey)
            last = logits[:, -1]
            row = flat[cid * sm + cstate]  # [S, V]
            masked = jnp.where(row >= 0, last, -jnp.inf)
            nxt = sample_logits_dynamic(masked, sub, temp, tk, tp)
            lsm = jax.nn.log_softmax(last, axis=-1)
            lp = jnp.take_along_axis(lsm, nxt[:, None], axis=-1)[:, 0]
            nxt = jnp.where(done, jnp.int32(eos_id), nxt)
            nstate = jnp.take_along_axis(row, nxt[:, None], axis=-1)[:, 0]
            # A row finishing THIS step sampled EOS at an accepting
            # state (row[eos] = state >= 0); frozen rows keep theirs.
            cstate = jnp.where(done, cstate, jnp.maximum(nstate, 0))
            frozen = done if pos.ndim else done[0]
            pos = jnp.where(frozen, pos, pos + 1)
            done = done | (nxt == eos_id)
            ys = (nxt, lp)
            if lp_k:
                tlv, tli = jax.lax.top_k(lsm, lp_k)
                ys = ys + (tlv, tli.astype(jnp.int32))
            return (nxt, kc, vc, pos, rkey, done, cstate), ys

        carry, ys = jax.lax.scan(
            body, (tok, kc, vc, pos, rkey, done, cstate), None,
            length=chunk,
        )
        tok, kc, vc, pos, rkey, done, cstate = carry
        return ys + (tok, kc, vc, pos, rkey, done, cstate)

    _CON_PROGRAMS[key] = chunk_steps
    return chunk_steps


def generate_stream(
    model: DecoderLM,
    params,
    prompt_ids: List[int],
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    seed: int = 0,
    eos_id: int = EOS,
    max_len: Optional[int] = None,
    chunk: int = 1,
) -> Iterator[int]:
    """Yield generated token ids one at a time (greedy when
    ``temperature == 0``; temperature/top-k/top-p otherwise). Prefill
    runs once over the prompt; each subsequent token is one jitted
    cached step.

    ``chunk > 1`` moves the decode loop on-device: one dispatched
    program ``lax.scan``s over ``chunk`` cached steps (sampling
    included) and returns the whole token block, so host<->device
    round-trips drop by that factor. Token-for-token identical to ``chunk=1``; text
    still streams, in blocks of up to ``chunk`` tokens."""
    n_chunks = -(-max_new_tokens // chunk) if chunk > 1 else 0
    smax = max_len or (len(prompt_ids) + max(max_new_tokens,
                                             n_chunks * chunk))
    assert len(prompt_ids) + max_new_tokens <= smax + 1
    kc, vc = init_caches(model.cfg, 1, smax)
    ids = jnp.asarray(prompt_ids, jnp.int32)[None, :]
    prefill, step, chunk_steps, _ = _decode_programs(
        model, temperature, top_k, top_p, eos_id, chunk
    )

    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    tok, kc, vc = prefill(params, ids, kc, vc, sub)
    pos = len(prompt_ids)

    if chunk > 1:
        t = int(tok[0])
        if t == eos_id:
            return
        yield t
        emitted = 1
        done = jnp.zeros((1,), bool)
        pos_dev = jnp.int32(pos)  # write slot of the carried token
        while emitted < max_new_tokens:
            toks, tok, kc, vc, pos_dev, key, done = chunk_steps(
                params, tok, kc, vc, pos_dev, key, done
            )
            for t in np.asarray(toks)[:, 0]:
                t = int(t)
                if t == eos_id or emitted >= max_new_tokens:
                    return
                yield t
                emitted += 1
        return

    for _ in range(max_new_tokens):
        t = int(tok[0])
        if t == eos_id or pos >= smax:
            return
        yield t
        key, sub = jax.random.split(key)
        tok, kc, vc = step(
            params, tok[:, None], kc, vc, jnp.int32(pos), sub
        )
        pos += 1


def generate_batch(
    model: DecoderLM,
    params,
    prompts: List[List[int]],
    max_new_tokens: int = 64,
    temperature: float = 0.0,
    top_k: int = 0,
    top_p: float = 0.0,
    seed: int = 0,
    eos_id: int = EOS,
    max_len: Optional[int] = None,
    chunk: int = 8,
) -> List[List[int]]:
    """Generate continuations for B ragged prompts in one batched
    program. Prompts are right-padded to a common prefill width (padded
    tail keys are never attended: each row's decode overwrites slot
    ``len_i + t`` at step t before any query position can see it), and
    decode runs with per-row cache offsets (``cache_len`` as [B]) so
    every row advances through its own sequence. The decode loop is
    on-device (``lax.scan`` over ``chunk`` steps per dispatch). Each
    row stops at its own EOS; returns one token list per prompt."""
    bsz = len(prompts)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    pmax = int(lens.max())
    n_chunks = -(-max_new_tokens // chunk)
    smax = max_len or (pmax + n_chunks * chunk)
    padded = np.full((bsz, pmax), PAD, np.int32)
    for i, p in enumerate(prompts):
        padded[i, : len(p)] = p

    kc, vc = init_caches(model.cfg, bsz, smax)
    _, _, chunk_steps, prefill_batch = _decode_programs(
        model, temperature, top_k, top_p, eos_id, chunk
    )

    key = jax.random.PRNGKey(seed)
    key, sub = jax.random.split(key)
    tok, kc, vc = prefill_batch(
        params, jnp.asarray(padded), jnp.asarray(lens), kc, vc, sub
    )
    done = tok == eos_id
    pos = jnp.asarray(lens)
    blocks = [np.asarray(tok)[None]]  # prefill's sample is token 0
    while len(blocks) == 1 or not bool(np.asarray(done).all()):
        if (len(blocks) - 1) * chunk + 1 >= max_new_tokens:
            break
        toks, tok, kc, vc, pos, key, done = chunk_steps(
            params, tok, kc, vc, pos, key, done
        )
        blocks.append(np.asarray(toks))  # [chunk, B]
    stream = np.concatenate(blocks, axis=0)  # [T, B]
    out: List[List[int]] = []
    for i in range(bsz):
        row: List[int] = []
        for t in stream[:, i]:
            t = int(t)
            if t == eos_id or len(row) >= max_new_tokens:
                break
            row.append(t)
        out.append(row)
    return out


def generate_text_stream(
    model, params, prompt: str, tokenizer: Optional[ByteTokenizer] = None,
    **kwargs,
) -> Generator[str, None, None]:
    """Text-level streaming: UTF-8-safe deltas from the token stream."""
    tok = tokenizer or ByteTokenizer()
    dec = (tok.stream_decoder() if hasattr(tok, "stream_decoder")
           else ByteDecoder())
    for t in generate_stream(model, params, tok.encode(prompt), **kwargs):
        piece = dec.feed(t)
        if piece:
            yield piece
    tail = dec.flush()
    if tail:
        yield tail
