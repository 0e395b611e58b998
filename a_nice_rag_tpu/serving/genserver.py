"""Continuous-batching generation server for the on-device decoder LM.

The reference's generation hop is a per-request SaaS stream
(reference src/query_rag.py:434-513) — one connection per query, no
batching. Serving an LM *on the device* wants the opposite shape: decode
is memory-bound and a single stream leaves the chip idle, so requests
should share one batched decode program. This module implements
slot-based continuous batching (the vLLM serving pattern, with static
shapes throughout):

* a fixed number of **slots** — rows of one batched KV cache
  [S, Smax, nkv, hd]. Static shapes: admission/retirement never
  reshapes or recompiles anything;
* **admission** prefills a new request's prompt into a free slot's
  cache row (prompt padded to a power-of-two bucket, so a handful of
  compiled prefill programs serve all lengths) while other slots keep
  decoding;
* a **decode tick** advances every active slot by ``chunk`` tokens in
  ONE dispatched program — a ``lax.scan`` of cached steps with
  per-slot cache offsets (models/decoder._CachedBlock with
  ``cache_len: [S]``), per-slot EOS freezing, and sampling on device.
  Per-dispatch cost is amortized over ``slots x chunk`` tokens;
* rows are independent under attention (masks/positions are per-row),
  so each request's greedy stream is bit-identical to running it
  alone through models/decoder.generate_stream — pinned by
  tests/test_genserver.py.

Use ``tick()`` directly for deterministic stepping (tests, embedding
into an existing loop), or ``start()`` for a background thread feeding
per-request token queues (the HTTP /v1/generate SSE path).

``prefill_chunk=C`` turns admission into **incremental (chunked)
prefill**: a long prompt runs C tokens per tick into partial
full-length rows carried between ticks, interleaved with the decode
dispatches, so active streams never stall longer than one chunk's
forward (admission otherwise blocks the tick for the whole prompt's
prefill). The chunked forward is the same computation in pieces —
streams are identical to whole-prompt prefill (pinned).

Passing ``constraints={name: spec}`` registers **guided decoding**
grammars (models/constrain.py: JSON mode, regexes, choice lists): the
decode tick gathers each slot's DFA row from one stacked on-device
table, masks the logits before sampling, and carries the automaton
state in the scan — per-request ``submit(constraint="name")`` makes
invalid output unsamplable (the structured-output guarantee the
reference approximates with post-hoc LLM repair,
reference ragas_modified/prompt.py FixOutputFormat).

Passing ``draft_model=/draft_params=`` switches the decode tick to
**batched speculative decoding**: the draft proposes ``gamma`` tokens
per slot (a [S]-row scan at per-row offsets), the target verifies all
slots' windows in the same dispatched program, and each active slot
advances by its own accept count (1..gamma+1 tokens/tick). Greedy
streams remain bit-identical to the target-only server; sampled mode
is distribution-preserving per row (models/speculative.spec_accept).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass, field
from typing import Iterator, List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.models.decoder import (
    EOS,
    PAD,
    ByteDecoder,
    ByteTokenizer,
    init_caches,
    sample_logits_dynamic,
)

_END = object()  # sentinel on a request's token queue


class ServerBusy(RuntimeError):
    """Raised by submit() when the pending queue is at max_pending —
    backpressure for the HTTP surface (mapped to 429)."""


@dataclass
class _Request:
    prompt_ids: List[int]
    max_new_tokens: int
    out: "queue.Queue" = field(default_factory=queue.Queue)
    emitted: int = 0
    slot: int = -1
    cancelled: bool = False
    finished: bool = False
    # Per-request sampling knobs (resolved to the server defaults at
    # submit time; carried into the slot's row of the decode program's
    # runtime sampling vectors).
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 0.0
    # Tokens that terminate the stream like EOS (retired WITHOUT
    # emitting the stop token itself).
    stop_token_ids: Optional[frozenset] = None
    # Chosen-token logprobs under the model's raw distribution, one per
    # emitted token (empty in speculative mode — the verify step does
    # not surface per-token scores).
    logprobs: List[float] = field(default_factory=list)
    # "stop" (EOS / stop token), "length" (budget), or "cancelled".
    finish_reason: Optional[str] = None
    # Name of a server-registered decoding constraint (guided/JSON
    # mode); None = unconstrained.
    constraint: Optional[str] = None
    # Per emitted token: the top-K raw-distribution alternatives as a
    # list of (token_id, logprob) pairs (only when the server was built
    # with logprob_topk=K; empty otherwise / in speculative mode).
    top_logprobs: List[list] = field(default_factory=list)
    # Emitted token values, server-side (prefix retention builds the
    # cached-prefix key from prompt + the forwarded emitted tokens).
    sent_ids: List[int] = field(default_factory=list)


class GenerationServer:
    """Slot-based continuous batching over the KV-cached decoder LM."""

    def __init__(
        self,
        model,
        params,
        slots: int = 4,
        max_len: int = 512,
        chunk: int = 8,
        temperature: float = 0.0,
        top_k: int = 0,
        top_p: float = 0.0,
        eos_id: int = EOS,
        seed: int = 0,
        min_prefill_bucket: int = 16,
        draft_model=None,
        draft_params=None,
        gamma: int = 4,
        prefill_chunk: Optional[int] = None,
        max_pending: Optional[int] = None,
        mesh=None,
        tp_axis: str = "tp",
        constraints: Optional[dict] = None,
        logprob_topk: int = 0,
        retain_prefixes: int = 0,
        wave_prefill: bool = True,
    ):
        self.model, self.params = model, params
        # Tensor-parallel serving: with ``mesh=`` the params and KV
        # caches are placed with the Megatron column/row layout
        # (parallel/lm.py) and every jitted program below compiles to a
        # GSPMD-partitioned executable — admission, decode ticks, and
        # speculative rounds all run over the mesh with XLA-inserted
        # ICI collectives. No other code path changes: greedy streams
        # are pinned bit-identical to the single-device server
        # (tests/test_genserver_tp.py).
        self.mesh, self.tp_axis = mesh, tp_axis
        if mesh is not None:
            from a_nice_rag_tpu.parallel.lm import (
                shard_lm_params,
                validate_tp_config,
            )

            validate_tp_config(model.cfg, mesh, tp_axis)
            self.params = shard_lm_params(params, mesh, tp_axis)
        self.slots, self.smax, self.chunk = slots, max_len, chunk
        # top-K alternative logprobs per emitted token (the OpenAI
        # top_logprobs surface): baked into the decode/prefill programs
        # as a static K (one lax.top_k over the raw log-softmax per
        # step). 0 = off (no sort cost).
        self.lp_k = int(logprob_topk)
        # Batched wave prefill for burst admissions (see _admit). The
        # flag exists for A/B measurement (scripts/
        # bench_admission_wave.py) and as an escape hatch; both paths
        # produce bit-identical streams.
        self.wave_prefill = bool(wave_prefill)
        self.temperature, self.top_k, self.top_p = temperature, top_k, top_p
        self.eos_id = eos_id
        self.min_bucket = min_prefill_bucket
        # Chunked (incremental) prefill: a long prompt is prefilled
        # ``prefill_chunk`` tokens per tick into PARTIAL rows carried
        # between ticks, interleaved with decode dispatches, so
        # admission never stalls active streams for longer than one
        # chunk's forward. One prefill in flight at a time (bounds the
        # extra row memory to one slot's worth); prompts that fit in a
        # single chunk still use the one-dispatch whole-prompt prefill
        # (same latency bound, no head-of-line blocking behind a long
        # in-flight prefill). Partial rows carry ``prefill_chunk``
        # positions of slack past max_len so the final chunk's cache
        # write never clamps (dynamic_update_slice clamps out-of-range
        # starts, which would silently shift the write backwards and
        # corrupt the row); the slack is trimmed at install time.
        if prefill_chunk is not None and not (
            1 <= prefill_chunk <= max_len
        ):
            raise ValueError(
                f"prefill_chunk must be in [1, max_len={max_len}], "
                f"got {prefill_chunk}"
            )
        self.prefill_chunk = prefill_chunk
        # Backpressure: submit() raises ServerBusy beyond this many
        # queued (not-yet-admitted) requests. None = unbounded.
        if max_pending is not None and max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        self.max_pending = max_pending
        self._pf: Optional[dict] = None
        self._next: Optional[_Request] = None  # FIFO head, re-queued
        self._pending: "queue.Queue[_Request]" = queue.Queue()
        self._active: List[Optional[_Request]] = [None] * slots
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

        self._kc, self._vc = init_caches(model.cfg, slots, max_len)
        if mesh is not None:
            from a_nice_rag_tpu.parallel.lm import shard_lm_caches

            self._kc, self._vc = shard_lm_caches(
                self._kc, self._vc, mesh, tp_axis
            )
        self._tok = jnp.zeros((slots,), jnp.int32)
        self._pos = jnp.zeros((slots,), jnp.int32)
        self._done = jnp.ones((slots,), bool)
        self._key = jax.random.PRNGKey(seed)
        # Per-slot RUNTIME sampling vectors (host-side; shipped as [S]
        # arguments into the dynamic decode program each tick, so one
        # compiled program serves every mix of per-request settings).
        # Rows default to the server-level knobs; submit() overrides
        # them per request.
        self._s_temp = np.full((slots,), temperature, np.float32)
        self._s_topk = np.full((slots,), top_k, np.int32)
        self._s_topp = np.full((slots,), top_p, np.float32)

        cfg = model.cfg

        # Guided decoding: ``constraints={name: spec}`` registers
        # decoding constraints (models/constrain.py specs: a Constraint,
        # a ByteDFA, a regex string, "json"/"json_object"/"json_array",
        # or a list of choices). The registry is FIXED at construction —
        # all tables are padded to a common state count and stacked into
        # one [NC, Sm, V] tensor (id 0 = unconstrained identity), so the
        # constrained decode program compiles once and per-request
        # constraint choice is a runtime [S] id vector. Servers built
        # without constraints keep the plain dynamic program (no gather
        # cost).
        self.constraints = constraints is not None
        self._cname_to_id: dict = {}
        if constraints is not None:
            self._init_constraint_registry()
            for name, spec in constraints.items():
                self._add_constraint(name, spec)
            self._rebuild_ctables()
        self._allow_all = jnp.ones((cfg.vocab_size,), bool)

        def _install(kc, vc, kr, vr, slot):
            """Copy row buffers [1, <=Smax, ...] into batch row
            ``slot`` of the shared caches (traced inline by callers —
            keeping each admission a single dispatch)."""
            kr = [r[:, :max_len] for r in kr]
            vr = [r[:, :max_len] for r in vr]
            kc = [
                jax.lax.dynamic_update_slice(c, r, (slot, 0, 0, 0))
                for c, r in zip(kc, kr)
            ]
            vc = [
                jax.lax.dynamic_update_slice(c, r, (slot, 0, 0, 0))
                for c, r in zip(vc, vr)
            ]
            return kc, vc

        lp_k = self.lp_k

        def _last_tok(logits, length, key, t, k, p, allowed):
            """Sample from the logits of real token ``length-1`` with
            runtime knobs ``t``/``k``/``p`` ([1] arrays); ``allowed``
            ([V] bool — all-true when unconstrained, the constraint's
            start-state mask otherwise) is applied BEFORE sampling.
            Returns (token, raw logprob[, top-K logprobs, top-K ids])
            — the logprob fields use the model's RAW distribution."""
            last = jnp.take_along_axis(
                logits, (length - 1)[None, None, None], axis=1
            )[:, 0]
            masked = jnp.where(allowed[None, :], last, -jnp.inf)
            tok = sample_logits_dynamic(masked, key, t, k, p)
            lsm = jax.nn.log_softmax(last, axis=-1)
            lp = jnp.take_along_axis(lsm, tok[:, None], axis=-1)[0, 0]
            info = (tok[0], lp)
            if lp_k:
                tlv, tli = jax.lax.top_k(lsm[0], lp_k)
                info = info + (tlv, tli.astype(jnp.int32))
            return info

        def _prefill(prm, kc, vc, ids, length, slot, key, t, k, p,
                     allowed):
            """Prefill ``ids`` [1, P] into cache row ``slot``; returns
            the first sampled token for that row."""
            row_shape = (1, max_len, cfg.num_kv_heads, cfg.head_dim)
            kr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            vr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            logits, kr, vr = model.apply(prm, ids, kr, vr, jnp.int32(0))
            info = _last_tok(logits, length, key, t, k, p, allowed)
            kc, vc = _install(kc, vc, kr, vr, slot)
            return info, kc, vc

        self._prefill = jax.jit(_prefill)

        def _prefill_wave(prm, kc, vc, ids, lengths, slots, keys,
                          t, k, p, allowed):
            """Prefill W whole prompts (one shared length bucket) in
            ONE dispatched program: ids [W, P], per-row lengths/slot
            indices/RNG keys/sampling knobs, allowed [W, V]. The model
            forward batches over W, first-token sampling vmaps the
            single-row semantics with each admission's OWN key (bit-
            identical streams to the per-slot program), and the rows
            install with one scatter per cache tensor. Replaces W
            separate prefill dispatches per admission wave (not
            measured on the H100)."""
            w = ids.shape[0]
            row_shape = (w, max_len, cfg.num_kv_heads, cfg.head_dim)
            kr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            vr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            logits, kr, vr = model.apply(prm, ids, kr, vr, jnp.int32(0))
            last = jnp.take_along_axis(
                logits, (lengths - 1)[:, None, None], axis=1
            )[:, 0]  # [W, V]
            masked = jnp.where(allowed, last, -jnp.inf)
            toks = jax.vmap(
                lambda row, ky, tt, kk, pp: sample_logits_dynamic(
                    row[None], ky, tt[None], kk[None], pp[None]
                )[0]
            )(masked, keys, t, k, p)
            lsm = jax.nn.log_softmax(last, axis=-1)
            lps = jnp.take_along_axis(lsm, toks[:, None], axis=-1)[:, 0]
            outs = (toks, lps)
            if lp_k:
                tlv, tli = jax.lax.top_k(lsm, lp_k)
                outs = outs + (tlv, tli.astype(jnp.int32))
            kc = [c.at[slots].set(r[:, :max_len])
                  for c, r in zip(kc, kr)]
            vc = [c.at[slots].set(r[:, :max_len])
                  for c, r in zip(vc, vr)]
            return outs, kc, vc

        self._prefill_wave = jax.jit(_prefill_wave)

        def _prefill_rows(prm, ids):
            """Prefill ``ids`` [1, P] into FRESH full-length cache rows
            and return them (prefix caching: the rows are stored and
            later copied into a slot)."""
            row_shape = (1, max_len, cfg.num_kv_heads, cfg.head_dim)
            kr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            vr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            _, kr, vr = model.apply(prm, ids, kr, vr, jnp.int32(0))
            return kr, vr

        self._prefill_rows = jax.jit(_prefill_rows)

        def _prefill_suffix(prm, kc, vc, kr, vr, ids, length, offset,
                            slot, key, t, k, p, allowed):
            """Continue a cached prefix: run ``ids`` [1, P] (the suffix
            bucket, ``length`` real tokens) at cache offset ``offset``
            over the stored prefix rows, then install the combined row
            into slot ``slot``."""
            logits, kr, vr = model.apply(prm, ids, kr, vr, offset)
            info = _last_tok(logits, length, key, t, k, p, allowed)
            kc, vc = _install(kc, vc, kr, vr, slot)
            return info, kc, vc

        self._prefill_suffix = jax.jit(_prefill_suffix)

        def _prefill_step(prm, kr, vr, ids, offset):
            """One chunk of an incremental prefill: run ``ids`` [1, C]
            at absolute cache offset ``offset`` over partial rows."""
            logits, kr, vr = model.apply(prm, ids, kr, vr, offset)
            return logits, kr, vr

        self._prefill_step = jax.jit(_prefill_step)

        self._install_rows = jax.jit(_install)
        self._sample_local = jax.jit(_last_tok)
        # prefix tuple -> (krows, vrows) device arrays; insertion order
        # doubles as LRU order.
        self._prefix_cache: dict = {}
        self.prefix_cache_max = 8
        self.prefix_hits = 0
        # Automatic prefix retention: with retain_prefixes=N, a retired
        # request's KV row (already computed — zero extra forward work)
        # is kept as a cached prefix, so a follow-up request carrying
        # the conversation so far (multi-turn chat) prefills only its
        # new tail. The key covers exactly the positions whose KV the
        # row holds: the prompt plus every FORWARDED emitted token —
        # all of them when the row stopped on EOS/stop (the stop-
        # producing step forwarded the last emitted token), all but the
        # last on budget/cancel (the final token was sampled but never
        # fed back). N bounds the LRU (each entry is a full
        # 2*layers*max_len*nkv*hd row). Off in speculative mode (verify
        # rounds interleave draft state with the target rows).
        self.retain_prefixes = int(retain_prefixes)
        if self.retain_prefixes > 0:
            self.prefix_cache_max = self.retain_prefixes
        self.prefix_retained = 0
        # Serving counters (stats()): decode dispatches, tokens pushed
        # to request queues, requests cancelled before completion.
        self.ticks = 0
        self.tokens_emitted = 0
        self.cancelled_count = 0
        # One compiled decode program per (model, chunk) per process;
        # sampling knobs are [S] runtime arguments (per-request). With
        # a constraint registry, the guided variant (per-slot DFA ids/
        # states + the stacked table tensor as runtime arguments) is
        # used instead; unconstrained rows ride its identity row.
        if self.constraints:
            from a_nice_rag_tpu.models.decoder import (
                _decode_programs_constrained,
            )

            self._chunk_steps = _decode_programs_constrained(
                model, eos_id, chunk, self.lp_k
            )
        else:
            from a_nice_rag_tpu.models.decoder import (
                _decode_programs_dynamic,
            )

            self._chunk_steps = _decode_programs_dynamic(
                model, eos_id, chunk, self.lp_k
            )

        # Speculative mode: a draft model proposes gamma tokens per
        # slot, the target verifies every slot's window in ONE batched
        # dispatch (models/speculative._batched_spec_programs). Each
        # tick then advances every active slot by 1..gamma+1 tokens
        # instead of exactly ``chunk`` — greedy streams stay
        # bit-identical to the target-only server.
        self.draft, self.draft_params, self.gamma = (
            draft_model, draft_params, gamma
        )
        if draft_model is not None:
            from a_nice_rag_tpu.models.speculative import (
                _batched_spec_programs,
            )

            self._dkc, self._dvc = init_caches(
                draft_model.cfg, slots, max_len
            )
            if mesh is not None:
                from a_nice_rag_tpu.parallel.lm import (
                    shard_lm_caches,
                    shard_lm_params,
                    validate_tp_config,
                )

                validate_tp_config(draft_model.cfg, mesh, tp_axis)
                self.draft_params = draft_params = shard_lm_params(
                    draft_params, mesh, tp_axis
                )
                self._dkc, self._dvc = shard_lm_caches(
                    self._dkc, self._dvc, mesh, tp_axis
                )
            self._spec_tick = _batched_spec_programs(
                model, draft_model, gamma, temperature, top_k, top_p
            )
            dcfg = draft_model.cfg

            def _prefill_draft(dprm, dkc, dvc, ids, slot):
                """Prefill the draft's cache row for ``slot`` with the
                FULL prompt (no sampling — the first token comes from
                the target prefill)."""
                row_shape = (1, max_len, dcfg.num_kv_heads, dcfg.head_dim)
                kr = [jnp.zeros(row_shape, dcfg.dtype)
                      for _ in range(dcfg.num_layers)]
                vr = [jnp.zeros(row_shape, dcfg.dtype)
                      for _ in range(dcfg.num_layers)]
                _, kr, vr = draft_model.apply(dprm, ids, kr, vr,
                                              jnp.int32(0))
                return _install(dkc, dvc, kr, vr, slot)

            self._prefill_draft = jax.jit(_prefill_draft)

    # ------------------------------------------------------------ API

    def submit(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_token_ids=None,
               constraint: Optional[str] = None) -> _Request:
        """Enqueue a request; its tokens arrive on ``request.out``.

        ``temperature``/``top_k``/``top_p`` override the server-level
        sampling knobs FOR THIS REQUEST (None = server default): the
        decode program takes per-slot sampling vectors as runtime
        arguments, so mixed greedy/sampled batches share one compiled
        program. Speculative mode verifies against one static target
        distribution, so per-request overrides are rejected there.

        ``constraint`` names a server-registered decoding constraint
        (guided/JSON mode — ``GenerationServer(constraints={...})``):
        every sampled token is masked to what the constraint's DFA
        allows, so the output always matches the grammar (or ends with
        finish_reason "length" on budget exhaustion mid-sentence)."""
        if constraint is not None:
            if not self.constraints:
                raise ValueError(
                    "no constraints registered; construct the server "
                    "with GenerationServer(constraints={name: spec})"
                )
            if constraint not in self._cname_to_id:
                raise ValueError(
                    f"unknown constraint {constraint!r}; registered: "
                    f"{sorted(k for k in self._cname_to_id if k)}"
                )
            if self.draft is not None:
                raise ValueError(
                    "constrained decoding does not compose with "
                    "speculative mode (the verify step is unmasked)"
                )
        t = self.temperature if temperature is None else float(temperature)
        k = self.top_k if top_k is None else int(top_k)
        p = self.top_p if top_p is None else float(top_p)
        if self.draft is not None and (
            t != self.temperature or k != self.top_k or p != self.top_p
        ):
            raise ValueError(
                "per-request sampling overrides are not supported in "
                "speculative mode (the verify step bakes the target "
                "distribution); construct the server with the desired "
                "knobs instead"
            )
        if self.draft is not None:
            # An active row sits at pos = len(prompt) + emitted with
            # emitted <= budget - 1, and a spec round writes
            # pos..pos+gamma — so this bound keeps every write of an
            # active row in range (dead rows may clamp-write inside
            # their own row, which admission prefill rewrites anyway).
            need = len(prompt_ids) + max_new_tokens + self.gamma
        else:
            n_chunks = -(-max_new_tokens // self.chunk)
            need = len(prompt_ids) + n_chunks * self.chunk
        if need > self.smax:
            raise ValueError(
                f"prompt({len(prompt_ids)}) + budget({max_new_tokens}) "
                f"needs {need} cache slots > max_len={self.smax}"
            )
        if self.max_pending is not None and (
            self._pending.qsize() + (self._next is not None)
            >= self.max_pending
        ):
            raise ServerBusy(
                f"pending queue full ({self.max_pending}); retry later"
            )
        req = _Request(list(prompt_ids), max_new_tokens,
                       temperature=t, top_k=k, top_p=p,
                       stop_token_ids=(
                           frozenset(int(i) for i in stop_token_ids)
                           if stop_token_ids else None
                       ),
                       constraint=constraint)
        self._pending.put(req)
        return req

    def cancel(self, req: _Request) -> None:
        """Abort a request. A pending request is never admitted; an
        active request's slot is retired immediately (its queue gets
        the end sentinel) and the next tick decodes without it; an
        in-flight incremental prefill is dropped. Called automatically
        when a ``stream()`` consumer closes the generator — e.g. the
        HTTP SSE handler on client disconnect — so abandoned requests
        stop consuming decode slots and prefill dispatches."""
        with self._lock:
            if req.finished or req.cancelled:
                return
            req.cancelled = True
            req.finish_reason = "cancelled"
            self.cancelled_count += 1
            if req.slot >= 0 and self._active[req.slot] is req:
                if self._pf is not None and self._pf["req"] is req:
                    self._pf = None  # drop the in-flight prefill
                self._retire(req.slot)
            else:
                # Still pending (skipped at admission); unblock any
                # consumer waiting on the queue.
                req.out.put(_END)

    def stream(self, prompt_ids: List[int],
               max_new_tokens: int = 64,
               temperature: Optional[float] = None,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None,
               stop_token_ids=None,
               constraint: Optional[str] = None,
               info: Optional[dict] = None) -> Iterator[int]:
        """Submit and iterate tokens. Starts the background loop if it
        is not already running (otherwise the get() would deadlock
        unless another thread is calling tick()). Closing the generator
        early (``.close()``, ``break``, client disconnect upstream)
        cancels the request and frees its slot. Pass a mutable ``info``
        dict to receive ``info["finish_reason"]`` ("stop" | "length")
        when the stream ends normally."""
        if self._thread is None:
            self.start()
        req = self.submit(prompt_ids, max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, stop_token_ids=stop_token_ids,
                          constraint=constraint)
        try:
            while True:
                item = req.out.get()
                if item is _END:
                    if info is not None:
                        info["finish_reason"] = req.finish_reason
                    return
                yield item
        finally:
            self.cancel(req)  # no-op if the request finished normally

    def stream_text(self, prompt: str, max_new_tokens: int = 64,
                    tokenizer: Optional[ByteTokenizer] = None,
                    temperature: Optional[float] = None,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    stop: Optional[List[str]] = None,
                    stop_token_ids=None,
                    constraint: Optional[str] = None,
                    info: Optional[dict] = None) -> Iterator[str]:
        """Text streaming with optional STRING stop sequences: the
        stream ends just before the earliest match of any ``stop``
        string (the match itself is never emitted) and the underlying
        request is cancelled so it stops occupying a decode slot. A
        holdback of ``max(len(s)) - 1`` characters handles stop strings
        that straddle token/chunk boundaries. A mutable ``info`` dict
        receives ``info["finish_reason"]`` ("stop" on an EOS/stop cut,
        "length" on budget exhaustion) when the stream completes."""
        tok = tokenizer or ByteTokenizer()
        # Decode with the tokenizer's own incremental decoder (a real
        # checkpoint's vocabulary is multi-byte BPE pieces, not raw
        # bytes — models/hf_tokenizer.HFTokenizer).
        dec = (tok.stream_decoder() if hasattr(tok, "stream_decoder")
               else ByteDecoder())
        gen = self.stream(tok.encode(prompt), max_new_tokens,
                          temperature=temperature, top_k=top_k,
                          top_p=top_p, stop_token_ids=stop_token_ids,
                          constraint=constraint, info=info)
        if not stop:
            for t in gen:
                piece = dec.feed(t)
                if piece:
                    yield piece
            tail = dec.flush()
            if tail:
                yield tail
            return

        hold = max(len(s) for s in stop) - 1
        buf = ""

        def _earliest(text: str) -> int:
            hits = [text.find(s) for s in stop]
            hits = [h for h in hits if h >= 0]
            return min(hits) if hits else -1

        try:
            for t in gen:
                piece = dec.feed(t)
                if not piece:
                    continue
                buf += piece
                cut = _earliest(buf)
                if cut >= 0:
                    if info is not None:
                        info["finish_reason"] = "stop"
                    if buf[:cut]:
                        yield buf[:cut]
                    return  # finally closes gen -> cancels the request
                if len(buf) > hold:
                    out, buf = buf[: len(buf) - hold], buf[len(buf) - hold:]
                    yield out
            buf += dec.flush()
            cut = _earliest(buf)
            if cut >= 0:
                buf = buf[:cut]
                if info is not None:
                    info["finish_reason"] = "stop"
            if buf:
                yield buf
        finally:
            gen.close()

    def complete(self, prompt_ids: List[int],
                 max_new_tokens: int = 64, **submit_kw) -> dict:
        """Blocking non-streaming completion. Returns ``tokens``, the
        per-token raw-distribution ``logprobs`` (empty in speculative
        mode), and ``finish_reason`` ("stop" | "length" |
        "cancelled")."""
        if self._thread is None:
            self.start()
        req = self.submit(prompt_ids, max_new_tokens, **submit_kw)
        toks = []
        while True:
            item = req.out.get()
            if item is _END:
                break
            toks.append(item)
        out = {"tokens": toks, "logprobs": list(req.logprobs),
               "finish_reason": req.finish_reason}
        if self.lp_k:
            out["top_logprobs"] = list(req.top_logprobs)
        return out

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._active)

    def _bucket(self, n: int) -> int:
        b = self.min_bucket
        while b < n:
            b *= 2
        return min(b, self.smax)

    def _is_stop(self, req: _Request, token: int) -> bool:
        """EOS or a per-request stop token: retire without emitting."""
        return token == self.eos_id or (
            req.stop_token_ids is not None
            and token in req.stop_token_ids
        )

    def _set_slot_sampling(self, slot: int, req: _Request) -> None:
        self._s_temp[slot] = req.temperature
        self._s_topk[slot] = req.top_k
        self._s_topp[slot] = req.top_p
        if self.constraints:
            self._s_cid[slot] = self._cname_to_id.get(req.constraint, 0)

    def _req_allowed(self, req: _Request):
        """[V] bool first-token mask: the constraint's start-state row
        (all-true when unconstrained) — prefill programs apply it so
        the very first sampled token is already guided."""
        if not self.constraints or req.constraint is None:
            return self._allow_all
        con = self._cons[self._cname_to_id[req.constraint]]
        return jnp.asarray(con.allowed0())

    def _set_slot_cstate(self, slot: int, req: _Request,
                         first: int) -> None:
        """Advance the DFA past the prefill's first token (host-side —
        the numpy table is at hand; decode ticks carry it on device)."""
        if not self.constraints:
            return
        cid = self._cname_to_id.get(req.constraint, 0)
        ns = 0
        if cid:
            ns = max(int(self._cons[cid].table[0, first]), 0)
        self._cstate = self._cstate.at[slot].set(ns)

    def _split_lp(self, outs):
        """Split a decode-tick output tuple into (toks, lps,
        top-K-or-None, carry...) per the server's lp_k setting."""
        if self.lp_k:
            tlv, tli = outs[2], outs[3]
            tl = (np.asarray(tlv, np.float64), np.asarray(tli))
            return outs[0], outs[1], tl, outs[4:]
        return outs[0], outs[1], None, outs[2:]

    def _record_first(self, req: _Request, info) -> None:
        """Record the prefill token's logprob (+ top-K alternatives)."""
        if self.draft is not None:
            return  # speculative verify surfaces no scores
        req.logprobs.append(float(info[1]))
        if self.lp_k:
            req.top_logprobs.append(list(zip(
                np.asarray(info[3]).tolist(),
                np.asarray(info[2], np.float64).tolist(),
            )))

    # ------------------------------------------------ constraint registry

    def _init_constraint_registry(self) -> None:
        from a_nice_rag_tpu.models.constrain import unconstrained

        self._cname_to_id = {None: 0, "none": 0}
        self._cons = [unconstrained(self.model.cfg.vocab_size)]

    def _add_constraint(self, name: str, spec) -> None:
        from a_nice_rag_tpu.models.constrain import (
            Constraint,
            compile_constraint,
        )

        vocab = self.model.cfg.vocab_size
        con = (
            spec
            if isinstance(spec, Constraint)
            else compile_constraint(spec, vocab, self.eos_id, name=name)
        )
        if con.table.shape[1] != vocab:
            raise ValueError(
                f"constraint {name!r} vocab {con.table.shape[1]} != "
                f"model vocab {vocab}"
            )
        if name in self._cname_to_id:  # replace in place, id stable
            self._cons[self._cname_to_id[name]] = con
        else:
            self._cname_to_id[name] = len(self._cons)
            self._cons.append(con)

    def _rebuild_ctables(self) -> None:
        vocab = self.model.cfg.vocab_size
        sm = max(c.table.shape[0] for c in self._cons)
        stacked = np.full((len(self._cons), sm, vocab), -1, np.int32)
        for i, c in enumerate(self._cons):
            stacked[i, : c.table.shape[0]] = c.table
        self._ctables = jnp.asarray(stacked)
        if not hasattr(self, "_cstate"):
            self._cstate = jnp.zeros((self.slots,), jnp.int32)
            self._s_cid = np.zeros((self.slots,), np.int32)

    def register_constraint(self, name: str, spec) -> None:
        """Register (or replace) a decoding constraint AFTER
        construction — e.g. a per-prompt JSON-Schema DFA compiled on
        first use (LocalGuidedJudgeLLM does this). The stacked table
        tensor is rebuilt; a grown [NC, Sm, V] shape means the next
        decode tick traces a fresh program for that shape (jit caches
        per shape, so repeated registrations of same-size tables are
        free). Existing constraint ids are stable, so in-flight
        constrained slots are unaffected. Works on servers built
        without ``constraints=`` too (the first registration switches
        the decode tick to the guided program)."""
        if not name or name == "none":
            raise ValueError("constraint name must be non-empty")
        with self._lock:
            if not self.constraints:
                from a_nice_rag_tpu.models.decoder import (
                    _decode_programs_constrained,
                )

                self._init_constraint_registry()
                self._chunk_steps = _decode_programs_constrained(
                    self.model, self.eos_id, self.chunk, self.lp_k
                )
                self.constraints = True
            self._add_constraint(name, spec)
            self._rebuild_ctables()

    @staticmethod
    def _row_knobs(req: _Request):
        """One-row runtime sampling vectors for a prefill program."""
        return (jnp.full((1,), req.temperature, jnp.float32),
                jnp.full((1,), req.top_k, jnp.int32),
                jnp.full((1,), req.top_p, jnp.float32))

    def cache_prefix(self, prefix_ids: List[int]) -> None:
        """Precompute and store the KV rows for a shared prompt prefix
        (e.g. the RAG system prompt). Subsequent requests whose prompt
        starts with it prefill only their suffix — the prefix costs
        zero forward work per request. LRU-bounded at
        ``prefix_cache_max`` entries (~2 * layers * max_len * nkv * hd
        bytes each)."""
        key_t = tuple(int(i) for i in prefix_ids)
        if not key_t:
            raise ValueError("empty prefix")
        if len(key_t) + self.chunk > self.smax:
            raise ValueError("prefix longer than the cache allows")
        bucket = self._bucket(len(key_t))
        ids = np.full((1, bucket), PAD, np.int32)
        ids[0, : len(key_t)] = key_t
        rows = self._prefill_rows(self.params, jnp.asarray(ids))
        with self._lock:
            self._prefix_cache.pop(key_t, None)
            self._prefix_cache[key_t] = rows
            while len(self._prefix_cache) > self.prefix_cache_max:
                self._prefix_cache.pop(
                    next(iter(self._prefix_cache))
                )

    def _longest_cached_prefix(self, prompt: List[int]):
        """Best stored entry to continue ``prompt`` from, as
        ``(key, L)`` where ``L`` is the usable common-prefix length
        (``L <= len(key)``), or ``None``. A stored row's KV at
        positions ``0..L-1`` depends only on tokens ``0..L-1``
        (causal attention), so a PARTIAL match is as good as a whole
        one: the suffix prefill at offset ``L`` simply overwrites the
        stale tail. This matters for retained rows (retain_prefixes):
        a re-encoded follow-up conversation need not reproduce the
        emitted ids exactly at the prompt/generation BPE join, but it
        shares the long id prefix up to that join. At least one prompt
        token must remain to prefill (``L < len(prompt)``)."""
        best, best_l = None, 0
        cap = len(prompt) - 1
        for key_t in self._prefix_cache:
            n = min(len(key_t), cap)
            l = 0
            while l < n and key_t[l] == prompt[l]:
                l += 1
            # Ties go to the LATER (more recently used) entry.
            if l > 0 and l >= best_l:
                best, best_l = key_t, l
        return (best, best_l) if best is not None else None

    # ----------------------------------------------------------- loop

    def _next_request(self) -> Optional[_Request]:
        """Next pending request in FIFO order (the re-queued head, if
        any, comes first); requests cancelled while pending are
        discarded here."""
        while True:
            if self._next is not None:
                req, self._next = self._next, None
            else:
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    return None
            if not req.cancelled:
                return req

    def _has_pending(self) -> bool:
        return self._next is not None or not self._pending.empty()

    def _admit(self) -> int:
        """Prefill pending requests into free slots; returns #admitted.

        Two phases: every free slot's prefill program is DISPATCHED
        first (async, device-serialized), then ONE fused read fetches
        all first tokens/logprobs. The host-visible bookkeeping per
        admission was previously an ``int(tok0)`` read each — a full
        dispatch round-trip per request, which serialized a burst of
        admissions on transport latency instead of device time.
        """
        admitted = 0
        staged = []  # (slot, req, info, n)
        # Whole-prompt, non-cached admissions (the common burst shape)
        # are deferred and grouped by length bucket: each group of two
        # or more runs through ONE batched _prefill_wave dispatch
        # instead of per-slot programs. Cache-hit, chunked, and
        # speculative admissions keep the per-slot paths.
        wave = []  # (slot, req, n, bucket, sub, rt, rk, rp, allowed)
        for slot in range(self.slots):
            if self._active[slot] is not None:
                continue
            req = self._next_request()
            if req is None:
                break
            if (
                self.prefill_chunk is not None
                and len(req.prompt_ids) > self.prefill_chunk
            ):
                # Multi-chunk prompt -> incremental prefill, one in
                # flight at a time. Single-chunk prompts fall through
                # to the one-dispatch whole-prompt path below (its
                # stall is within the chunk-latency bound), so a short
                # request is never head-of-line blocked behind a long
                # prefill when free slots exist.
                if self._pf is not None:
                    self._next = req  # keep FIFO; retry next tick
                    break
                self._start_chunked_prefill(req, slot)
                admitted += 1
                continue
            n = len(req.prompt_ids)
            self._key, sub = jax.random.split(self._key)
            self._set_slot_sampling(slot, req)
            rt, rk, rp = self._row_knobs(req)
            hit = self._longest_cached_prefix(req.prompt_ids)
            if hit is not None and hit[1] + self._bucket(
                n - hit[1]
            ) <= self.smax:
                key_t, L = hit
                suffix = req.prompt_ids[L:]
                bucket = self._bucket(len(suffix))
                ids = np.full((1, bucket), PAD, np.int32)
                ids[0, : len(suffix)] = suffix
                # Refresh LRU position.
                rows = self._prefix_cache.pop(key_t)
                self._prefix_cache[key_t] = rows
                kr, vr = rows
                info, self._kc, self._vc = self._prefill_suffix(
                    self.params, self._kc, self._vc, kr, vr,
                    jnp.asarray(ids), jnp.int32(len(suffix)),
                    jnp.int32(L), jnp.int32(slot), sub, rt, rk, rp,
                    self._req_allowed(req),
                )
                self.prefix_hits += 1
            else:
                bucket = self._bucket(n)  # n <= smax by submit()
                if self.draft is None and self.wave_prefill:
                    req.slot = slot
                    self._active[slot] = req
                    wave.append((slot, req, n, bucket, sub, rt, rk,
                                 rp, self._req_allowed(req)))
                    admitted += 1
                    continue
                ids = np.full((1, bucket), PAD, np.int32)
                ids[0, :n] = req.prompt_ids
                info, self._kc, self._vc = self._prefill(
                    self.params, self._kc, self._vc, jnp.asarray(ids),
                    jnp.int32(n), jnp.int32(slot), sub, rt, rk, rp,
                    self._req_allowed(req),
                )
            if self.draft is not None:
                # The draft always prefills the full prompt (its
                # forward is the cheap one; prefix caching only covers
                # the target's rows).
                bucket_d = self._bucket(n)
                ids_d = np.full((1, bucket_d), PAD, np.int32)
                ids_d[0, :n] = req.prompt_ids
                self._dkc, self._dvc = self._prefill_draft(
                    self.draft_params, self._dkc, self._dvc,
                    jnp.asarray(ids_d), jnp.int32(slot),
                )
            req.slot = slot
            self._active[slot] = req
            staged.append((slot, req, info, n))
            admitted += 1
        if wave:
            by_bucket: dict = {}
            for item in wave:
                by_bucket.setdefault(item[3], []).append(item)
            for bucket, items in by_bucket.items():
                i = 0
                # Largest power-of-two groups first; singletons fall
                # through to the per-slot program (no new compiles for
                # steady-state dribble admissions).
                while len(items) - i >= 2:
                    w = 1
                    while w * 2 <= len(items) - i:
                        w *= 2
                    part = items[i:i + w]
                    i += w
                    ids = np.full((w, bucket), PAD, np.int32)
                    for j, (_s, rq, n_j, *_rest) in enumerate(part):
                        ids[j, :n_j] = rq.prompt_ids
                    outs, self._kc, self._vc = self._prefill_wave(
                        self.params, self._kc, self._vc,
                        jnp.asarray(ids),
                        jnp.asarray([it[2] for it in part], jnp.int32),
                        jnp.asarray([it[0] for it in part], jnp.int32),
                        jnp.stack([it[4] for it in part]),
                        jnp.concatenate([it[5] for it in part]),
                        jnp.concatenate([it[6] for it in part]),
                        jnp.concatenate([it[7] for it in part]),
                        jnp.stack([it[8] for it in part]),
                    )
                    for j, (slot, rq, n_j, *_rest) in enumerate(part):
                        info = (outs[0][j], outs[1][j])
                        if self.lp_k:
                            info = info + (outs[2][j], outs[3][j])
                        staged.append((slot, rq, info, n_j))
                for (slot, rq, n_j, bucket_j, sub, rt, rk, rp,
                     allowed) in items[i:]:
                    ids = np.full((1, bucket_j), PAD, np.int32)
                    ids[0, :n_j] = rq.prompt_ids
                    info, self._kc, self._vc = self._prefill(
                        self.params, self._kc, self._vc,
                        jnp.asarray(ids), jnp.int32(n_j),
                        jnp.int32(slot), sub, rt, rk, rp, allowed,
                    )
                    staged.append((slot, rq, info, n_j))
        if staged:
            # ONE scatter per slot-state vector instead of three tiny
            # .at[slot].set programs per admission (3 x k dispatches
            # for a k-wave). Device scalars stay on device —
            # bit-identical streams.
            slots_i = jnp.asarray([s for s, _, _, _ in staged],
                                  jnp.int32)
            firsts_d = jnp.stack([info[0] for _, _, info, _ in staged])
            lens_i = jnp.asarray([n for _, _, _, n in staged],
                                 jnp.int32)
            self._tok = self._tok.at[slots_i].set(firsts_d)
            self._pos = self._pos.at[slots_i].set(lens_i)
            self._done = self._done.at[slots_i].set(
                firsts_d == self.eos_id
            )
            # One fused transfer for every admission's host-visible
            # outputs (streams stay bit-identical: same tokens, same
            # per-request emit order).
            firsts = np.asarray(firsts_d)
            lps = None
            if self.draft is None:
                lps = np.asarray(
                    jnp.stack([info[1] for _, _, info, _ in staged])
                )
            for j, (slot, req, info, _n) in enumerate(staged):
                first = int(firsts[j])
                self._set_slot_cstate(slot, req, first)
                if not self._is_stop(req, first):
                    req.sent_ids.append(first)
                    req.out.put(first)
                    if lps is not None:
                        req.logprobs.append(float(lps[j]))
                        if self.lp_k:
                            req.top_logprobs.append(list(zip(
                                np.asarray(info[3]).tolist(),
                                np.asarray(info[2], np.float64).tolist(),
                            )))
                    req.emitted = 1
                    self.tokens_emitted += 1
                    if req.emitted >= req.max_new_tokens:
                        self._retire(slot, "length")
                else:
                    self._retire(slot, "stop")
        return admitted

    def _start_chunked_prefill(self, req: _Request, slot: int) -> None:
        """Reserve ``slot`` and set up the incremental prefill state;
        ``_advance_prefill`` runs one chunk per tick until done. The
        slot's ``done`` flag stays True so decode dispatches freeze its
        row until the prefill installs real state."""
        cfg = self.model.cfg
        c = self.prefill_chunk
        hit = self._longest_cached_prefix(req.prompt_ids)
        if hit is not None:
            key_t, done = hit
            rows = self._prefix_cache.pop(key_t)
            self._prefix_cache[key_t] = rows  # refresh LRU position
            kr, vr = rows  # apply() is functional: originals stay valid
            # Slack past max_len so a final chunk starting near the end
            # of the row never clamps its write (see __init__ note).
            pad = ((0, 0), (0, c), (0, 0), (0, 0))
            kr = [jnp.pad(r, pad) for r in kr]
            vr = [jnp.pad(r, pad) for r in vr]
            self.prefix_hits += 1
        else:
            row_shape = (1, self.smax + c, cfg.num_kv_heads, cfg.head_dim)
            kr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            vr = [jnp.zeros(row_shape, cfg.dtype)
                  for _ in range(cfg.num_layers)]
            done = 0
        req.slot = slot
        self._active[slot] = req
        self._set_slot_sampling(slot, req)
        self._pf = dict(req=req, slot=slot, kr=kr, vr=vr, done=done,
                        n=len(req.prompt_ids))

    def _advance_prefill(self) -> None:
        """Run ONE prefill chunk of the in-flight incremental prefill;
        on the final chunk, sample the first token and install the
        rows — from then on the slot decodes like any other."""
        if self._pf is None:
            return
        pf = self._pf
        c = self.prefill_chunk
        off = pf["done"]
        real = min(c, pf["n"] - off)
        ids = np.full((1, c), PAD, np.int32)
        ids[0, :real] = pf["req"].prompt_ids[off:off + real]
        logits, pf["kr"], pf["vr"] = self._prefill_step(
            self.params, pf["kr"], pf["vr"], jnp.asarray(ids),
            jnp.int32(off),
        )
        pf["done"] = off + real
        if pf["done"] < pf["n"]:
            return
        slot, req = pf["slot"], pf["req"]
        self._key, sub = jax.random.split(self._key)
        rt, rk, rp = self._row_knobs(req)
        info = self._sample_local(logits, jnp.int32(real), sub,
                                  rt, rk, rp, self._req_allowed(req))
        tok0 = info[0]
        self._kc, self._vc = self._install_rows(
            self._kc, self._vc, pf["kr"], pf["vr"], jnp.int32(slot)
        )
        if self.draft is not None:
            # The draft prefills its (cheap) full-prompt forward in one
            # dispatch at completion.
            bucket_d = self._bucket(pf["n"])
            ids_d = np.full((1, bucket_d), PAD, np.int32)
            ids_d[0, :pf["n"]] = req.prompt_ids
            self._dkc, self._dvc = self._prefill_draft(
                self.draft_params, self._dkc, self._dvc,
                jnp.asarray(ids_d), jnp.int32(slot),
            )
        self._pf = None
        self._tok = self._tok.at[slot].set(tok0)
        self._pos = self._pos.at[slot].set(pf["n"])
        self._done = self._done.at[slot].set(tok0 == self.eos_id)
        first = int(tok0)
        self._set_slot_cstate(slot, req, first)
        if not self._is_stop(req, first):
            req.sent_ids.append(first)
            req.out.put(first)
            self._record_first(req, info)
            req.emitted = 1
            self.tokens_emitted += 1
            if req.emitted >= req.max_new_tokens:
                self._retire(slot, "length")
        else:
            self._retire(slot, "stop")

    def _retire(self, slot: int, reason: str = "stop") -> None:
        req = self._active[slot]
        if req is not None:
            req.finished = True
            if req.finish_reason is None:
                req.finish_reason = reason
            if (
                self.retain_prefixes > 0
                and self.draft is None
                and req.finish_reason in ("stop", "length")
            ):
                self._retain_row(slot, req)
            req.out.put(_END)
        self._active[slot] = None
        self._done = self._done.at[slot].set(True)

    def _retain_row(self, slot: int, req: _Request) -> None:
        """Keep the retired slot's KV row as a cached prefix (see
        retain_prefixes in __init__ for the forwarded-token key rule).
        The slice creates fresh device buffers, so the batch cache can
        be freely overwritten afterwards; zero forward work."""
        fwd = (req.sent_ids if req.finish_reason == "stop"
               else req.sent_ids[:-1])
        key = tuple(req.prompt_ids) + tuple(int(t) for t in fwd)
        if not key or len(key) + self.chunk > self.smax:
            return
        if key in self._prefix_cache:
            self._prefix_cache[key] = self._prefix_cache.pop(key)
            return
        kr = [c[slot:slot + 1] for c in self._kc]
        vr = [c[slot:slot + 1] for c in self._vc]
        self._prefix_cache[key] = (kr, vr)
        self.prefix_retained += 1
        while len(self._prefix_cache) > self.prefix_cache_max:
            self._prefix_cache.pop(next(iter(self._prefix_cache)))

    def tick(self) -> int:
        """Admit + one chunked decode dispatch; returns #tokens emitted
        to request queues. Safe to call with no active work (no-op)."""
        with self._lock:
            self._admit()
            self._advance_prefill()
            pf_slot = self._pf["slot"] if self._pf is not None else -1
            decoding = sum(
                r is not None and s != pf_slot
                for s, r in enumerate(self._active)
            )
            if decoding == 0 and self._pf is not None:
                # No active streams to protect from jitter: run the
                # in-flight prefill to completion now instead of paying
                # one dispatch round-trip of TTFT per chunk for nothing.
                while self._pf is not None:
                    self._advance_prefill()
                pf_slot = -1
                decoding = sum(r is not None for r in self._active)
            if decoding == 0:
                return 0
            if self.draft is not None:
                (out, m, self._tok, self._kc, self._vc, self._dkc,
                 self._dvc, self._pos, self._key) = self._spec_tick(
                    self.params, self.draft_params, self._tok,
                    self._kc, self._vc, self._dkc, self._dvc,
                    self._pos, self._key, self._done,
                )
                block = np.asarray(out)  # [S, gamma+1]
                counts = np.asarray(m)   # [S]
                rows = [block[s, :counts[s]].tolist()
                        for s in range(self.slots)]
                lp_rows = None  # speculative verify surfaces no scores
                tl = None
            elif self.constraints:
                outs = self._chunk_steps(
                    self.params, self._tok, self._kc, self._vc,
                    self._pos, self._key, self._done,
                    jnp.asarray(self._s_temp), jnp.asarray(self._s_topk),
                    jnp.asarray(self._s_topp),
                    jnp.asarray(self._s_cid), self._cstate,
                    self._ctables,
                )
                toks, lps, tl, outs = self._split_lp(outs)
                (self._tok, self._kc, self._vc, self._pos,
                 self._key, self._done, self._cstate) = outs
                block = np.asarray(toks)  # [chunk, S]
                lpb = np.asarray(lps)     # [chunk, S]
                # One bulk device->host conversion to Python ints/
                # floats: the emit loop below touches every element,
                # and per-element int(np_scalar) costs ~10x tolist()
                # on this one-core host (2048 tokens/tick at 128
                # slots).
                rows = block.T.tolist()
                lp_rows = lpb.T.tolist()
            else:
                outs = self._chunk_steps(
                    self.params, self._tok, self._kc, self._vc,
                    self._pos, self._key, self._done,
                    jnp.asarray(self._s_temp), jnp.asarray(self._s_topk),
                    jnp.asarray(self._s_topp),
                )
                toks, lps, tl, outs = self._split_lp(outs)
                (self._tok, self._kc, self._vc, self._pos,
                 self._key, self._done) = outs
                block = np.asarray(toks)  # [chunk, S]
                lpb = np.asarray(lps)     # [chunk, S]
                # One bulk device->host conversion to Python ints/
                # floats: the emit loop below touches every element,
                # and per-element int(np_scalar) costs ~10x tolist()
                # on this one-core host (2048 tokens/tick at 128
                # slots).
                rows = block.T.tolist()
                lp_rows = lpb.T.tolist()
            emitted = 0
            for slot in range(self.slots):
                req = self._active[slot]
                if req is None or slot == pf_slot:
                    continue  # frozen mid-prefill: its row emits junk
                for j, t in enumerate(rows[slot]):
                    t = int(t)
                    if self._is_stop(req, t):
                        self._retire(slot, "stop")
                        break
                    req.sent_ids.append(t)
                    req.out.put(t)
                    if lp_rows is not None:
                        req.logprobs.append(float(lp_rows[slot][j]))
                        if tl is not None:
                            req.top_logprobs.append(list(zip(
                                tl[1][j, slot].tolist(),
                                tl[0][j, slot].tolist(),
                            )))
                    req.emitted += 1
                    emitted += 1
                    if req.emitted >= req.max_new_tokens:
                        self._retire(slot, "length")
                        break
            self.ticks += 1
            self.tokens_emitted += emitted
            return emitted

    def stats(self) -> dict:
        """Serving counters for the /v1/stats surface: slot occupancy,
        queue depth, dispatch/token totals, prefix-cache hits, and
        cancellations."""
        with self._lock:
            return {
                "slots": self.slots,
                "active": self.n_active,
                "pending": self._pending.qsize()
                + (self._next is not None),
                "max_len": self.smax,
                "chunk": self.chunk,
                "ticks": self.ticks,
                "tokens_emitted": self.tokens_emitted,
                "prefix_cache_hits": self.prefix_hits,
                "prefixes_retained": self.prefix_retained,
                "cancelled": self.cancelled_count,
                "speculative": self.draft is not None,
                "constraints": sorted(
                    k for k in self._cname_to_id
                    if k and k != "none"
                ),
                "tensor_parallel": (
                    int(self.mesh.shape[self.tp_axis])
                    if self.mesh is not None else 1
                ),
            }

    def drain(self, max_ticks: int = 10_000) -> None:
        """Tick until no pending and no active requests (tests/CLI)."""
        for _ in range(max_ticks):
            if self.n_active == 0 and not self._has_pending():
                return
            self.tick()
        raise RuntimeError("drain did not converge")

    # ------------------------------------------------- background mode

    def start(self, idle_sleep_s: float = 0.002) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def run():
            import time

            while not self._stop.is_set():
                if self.n_active == 0 and not self._has_pending():
                    time.sleep(idle_sleep_s)
                    continue
                self.tick()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
