"""One-command production serving: index -> scheduler -> HTTP.

Wires the serving stack end to end (round-2 verdict next-step #8):

* index artifact (or a synthetic demo corpus) loaded once,
* single-device ``FusedRetriever`` — or, with ``--shards N``, a
  ``ShardedRetriever``
  over an N-device corpus mesh guarded by a ``DeviceHealthMonitor``
  that reshards over survivors and swaps the retriever live,
* a ``SchedulerPool`` micro-batching every configuration,
* the stdlib HTTP surface: ``/v1/search`` (scheduler-batched when the
  payload carries a precomputed embedding), ``/v1/stats``
  (scheduler/batching counters + health events), ``/v1/health``.

The reference serves one Streamlit session per process
(reference src/streamlit_app.py); this is the production equivalent.

Usage:
    python -m a_nice_rag_tpu.serving.serve_cli --index artifacts/nice \
        [--port 8800] [--shards 4]
    python -m a_nice_rag_tpu.serving.serve_cli --demo
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

logger = logging.getLogger(__name__)


class ServeState:
    """Mutable serving state; the health monitor swaps retrievers."""

    def __init__(self, index, retriever, pool, monitor=None, t_max=16,
                 embedder=None):
        self.index = index
        self.retriever = retriever
        self.pool = pool
        self.monitor = monitor
        self.t_max = t_max
        # Optional on-device query embedder (models/embedder.py
        # protocol): lets /v1/search take raw text, closing the loop
        # the reference outsources to the Voyage API
        # (reference src/search_engine.py:148-159).
        self.embedder = embedder
        self.loop: Optional[asyncio.AbstractEventLoop] = None

    def encode_text_query(self, text: str):
        """Raw text -> (query embedding [D] f32, padded term ids
        [t_max] i32) via the on-device embedder + the index's BM25
        vocabulary (same preprocessing as the corpus side)."""
        if self.embedder is None:
            raise ValueError(
                "server has no embedder; pass 'query_embedding' or "
                "start with --embedder"
            )
        from a_nice_rag_tpu.text.preprocess import preprocess_text

        q_vec = np.asarray(
            self.embedder.embed_queries([text]), np.float32
        )[0]
        toks = preprocess_text(text, use_lemmatization=True)
        terms = self.index.pad_term_ids([toks], self.t_max)[0]
        return q_vec, terms

    def submit_sync(self, q_emb: Dict[str, np.ndarray], q_terms, weights,
                    filt, wrrf_k, timeout_s: float = 30.0):
        fut = asyncio.run_coroutine_threadsafe(
            self.pool.submit(q_emb, q_terms, weights=weights,
                             filename_type_filter=filt, wrrf_k=wrrf_k),
            self.loop,
        )
        return fut.result(timeout=timeout_s)

    def submit_batch_sync(self, model: str, q_mat: np.ndarray, terms,
                          weights, filt, wrrf_k,
                          timeout_s: float = 60.0):
        """Submit a CLIENT-SIDE batch: the row block rides one
        scheduler entry + one future (BatchScheduler.submit_many) and
        still coalesces with other pending traffic up to max_batch
        rows. Per-row futures were the measured host bottleneck on the
        E2E served path (one event-loop task per query at one CPU
        core). Returns (rows [B, n], scores [B, n])."""
        import ml_dtypes

        q_arr = np.asarray(q_mat)
        if q_arr.dtype != ml_dtypes.bfloat16:
            # Preserve bf16 rows so the scheduler can coalesce them
            # into a half-width device upload; everything else
            # normalizes to f32 as before.
            q_arr = q_arr.astype(np.float32, copy=False)
        fut = asyncio.run_coroutine_threadsafe(
            self.pool.submit_many(
                {model: q_arr},
                None if terms is None else np.asarray(terms, np.int32),
                weights=weights, filename_type_filter=filt,
                wrrf_k=wrrf_k,
            ),
            self.loop,
        )
        rows, scores = fut.result(timeout=timeout_s)
        return np.asarray(rows), np.asarray(scores)


def build_state(
    index,
    model_names,
    use_bm25: bool = True,
    shards: int = 0,
    two_tier_common: int = 0,
    scheduler_kwargs: Optional[Dict] = None,
    nprobe: int = 0,
    ivf_clusters: Optional[int] = None,
    ivf_cache: Optional[str] = None,
    ivf_spill: bool = False,
    embedder=None,
    ivf_max_coverage: float = 0.25,
) -> ServeState:
    """``nprobe > 0`` serves the flagship model through the IVF ANN
    route (building the IVF layout at startup if the artifact does not
    already carry one); filtered queries transparently fall back to the
    exact scan. ``ivf_spill`` stores boundary documents in their two
    nearest clusters (up to 2x IVF memory for better low-nprobe
    recall) on both the single-device and sharded routes.
    ``ivf_max_coverage``: the auto routing threshold — batches whose
    expected cluster coverage 1-(1-p/C)^B exceeds it take the exact
    stream even with nprobe set (the per-batch corpus pass amortizes;
    engine ivf_route="auto")."""
    monitor = None
    if shards > 1:
        import jax

        from a_nice_rag_tpu.parallel import (
            DeviceHealthMonitor,
            make_mesh,
            shard_index,
            shard_ivf,
        )
        from a_nice_rag_tpu.parallel.sharded import ShardedRetriever

        devices = jax.devices()[:shards]
        mesh = make_mesh(shape=(1, len(devices)),
                         axis_names=("dp", "corpus"), devices=devices)
        sidx = shard_index(index, mesh, two_tier_common=two_tier_common)
        if nprobe > 0:
            import os

            from a_nice_rag_tpu.parallel import (
                load_shard_ivf,
                save_shard_ivf,
            )

            sidx2 = None
            if ivf_cache and os.path.exists(ivf_cache):
                try:
                    sidx2 = load_shard_ivf(sidx, ivf_cache)
                    logger.info("serve: IVF layout loaded from %s",
                                ivf_cache)
                except ValueError as e:
                    logger.warning("serve: IVF cache unusable (%s); "
                                   "rebuilding", e)
            if sidx2 is None:
                sidx2 = shard_ivf(sidx, model_names[0],
                                  n_clusters=ivf_clusters,
                                  spill=ivf_spill)
                logger.info(
                    "serve: per-shard IVF built (%d clusters/shard)",
                    int(sidx2.ivf_centroids.shape[1]))
                if ivf_cache:
                    save_shard_ivf(sidx2, ivf_cache)
            sidx = sidx2

        def make_retriever(s):
            return ShardedRetriever(
                s, model_names, use_bm25=use_bm25, nprobe=nprobe or None,
                ivf_max_coverage=ivf_max_coverage,
            )

        retriever = make_retriever(sidx)
        state = ServeState(index, retriever, None)

        def rebuild(new_sidx):
            state.retriever = make_retriever(new_sidx)
            from a_nice_rag_tpu.serving import SchedulerPool

            old_pool = state.pool
            state.pool = SchedulerPool(state.retriever,
                                       **(scheduler_kwargs or {}))
            # Stop the replaced pool's scheduler loops — abandoning
            # them leaks pending asyncio tasks on the serving loop.
            if old_pool is not None and state.loop is not None:
                try:
                    asyncio.run_coroutine_threadsafe(
                        old_pool.stop(), state.loop
                    ).result(timeout=10)
                except Exception:  # noqa: BLE001 — best-effort cleanup
                    pass
            logger.warning("serve: retriever rebuilt over %d shards",
                           new_sidx.n_shards)

        monitor = DeviceHealthMonitor(sidx, rebuild=rebuild)
        state.monitor = monitor
    else:
        from a_nice_rag_tpu.retrieval import FusedRetriever

        if nprobe > 0 and (index.ivf or {}).get(model_names[0]) is None:
            from a_nice_rag_tpu.index.ivf import attach_ivf

            attach_ivf(index, model_names[0], n_clusters=ivf_clusters,
                       spill=ivf_spill)
            logger.info("serve: IVF built for %s (%d clusters)",
                        model_names[0],
                        index.ivf[model_names[0]].n_clusters)
        retriever = FusedRetriever(
            index, model_names, use_bm25=use_bm25, nprobe=nprobe or None,
            ivf_max_coverage=ivf_max_coverage,
        )
        state = ServeState(index, retriever, None)

    from a_nice_rag_tpu.serving import SchedulerPool

    state.pool = SchedulerPool(state.retriever, **(scheduler_kwargs or {}))
    state.embedder = embedder
    return state


def _make_handler(state: ServeState, default_weights: Dict[str, float],
                  api=None):
    """``api`` (serving.http_api.ServingAPI) adds the RAG surface:
    every endpoint the scheduler path does not own (/v1/rag,
    /v1/generate, /v1/feedback, the browser UI) delegates to the RAG
    handler by inheritance, so one port serves both."""
    if api is not None:
        from a_nice_rag_tpu.serving.http_api import (
            _make_handler as _rag_handler,
        )

        base = _rag_handler(api)
    else:
        base = BaseHTTPRequestHandler

    class Handler(base):
        def log_message(self, fmt, *args):
            logger.debug(fmt, *args)

        def _reply(self, code, payload):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._reply(200, {
                    "status": "ok",
                    "n_docs": state.index.n_docs,
                    "models": list(state.retriever.model_names),
                })
            elif self.path == "/v1/stats":
                out = {
                    "schedulers": state.pool.stats,
                    "health_events": (
                        state.monitor.events[-20:] if state.monitor else []
                    ),
                }
                if api is not None and getattr(
                    api, "gen_server", None
                ) is not None:
                    out["generation"] = api.gen_server.stats()
                self._reply(200, out)
            elif api is not None:
                super().do_GET()  # browser UI etc.
            else:
                self._reply(404, {"error": "unknown endpoint"})

        def do_POST(self):
            if self.path != "/v1/search":
                if api is not None:
                    # RAG/generate/feedback surface (reads rfile itself).
                    super().do_POST()
                else:
                    self._reply(404, {"error": "unknown endpoint"})
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                payload = json.loads(self.rfile.read(length) or b"{}")
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": f"bad JSON: {e}"})
                return
            try:
                if "query_embeddings_b64" in payload:
                    # Batched RPC form: raw little-endian f32 [B, D]
                    # (and optionally i32 term ids [B, T]) as base64 —
                    # the JSON-array encoding of a 256x2048 batch is
                    # ~2 MB of text and would bench the JSON parser,
                    # not the serving stack. dtype "bf16" halves the
                    # request bytes AND the host->device upload (the
                    # rows go to the device as-is); ranking is exact
                    # f32 ordering of the bf16-rounded query — same
                    # contract as the native front's wire_dtype.
                    import base64

                    dtype_s = payload.get("dtype", "f32")
                    if dtype_s == "bf16":
                        import ml_dtypes

                        q_dtype = ml_dtypes.bfloat16
                    elif dtype_s == "f32":
                        q_dtype = np.float32
                    else:
                        self._reply(400, {
                            "error": f"dtype must be 'f32' or 'bf16',"
                                     f" got {dtype_s!r}"})
                        return
                    shape = payload["shape"]
                    q_mat = np.frombuffer(
                        base64.b64decode(payload["query_embeddings_b64"]),
                        q_dtype,
                    ).reshape(shape)
                    terms_b = None
                    if payload.get("terms_b64"):
                        terms_b = np.frombuffer(
                            base64.b64decode(payload["terms_b64"]),
                            np.int32,
                        ).reshape(payload["terms_shape"])
                    model = payload.get(
                        "model", state.retriever.model_names[0]
                    )
                    weights = (payload.get("model_weights")
                               or default_weights)
                    rows, scores = state.submit_batch_sync(
                        model, q_mat, terms_b, weights,
                        payload.get("filename_type_filter"),
                        float(payload.get("wrrf_k", 40.0)),
                    )
                    # Binary reply in the same b64 form: JSON-texting
                    # a [512, n] float matrix costs tens of ms per
                    # request on one core — it was the measured E2E
                    # served-QPS bottleneck, not the device path.
                    rows = np.ascontiguousarray(rows, np.int32)
                    scores = np.ascontiguousarray(scores, np.float32)
                    self._reply(200, {
                        "rows_b64":
                            base64.b64encode(rows.tobytes()).decode(),
                        "scores_b64":
                            base64.b64encode(scores.tobytes()).decode(),
                        "out_shape": list(rows.shape),
                    })
                    return
                emb = payload.get("query_embedding")
                text = payload.get("query")
                text_terms = None
                if emb is not None:
                    q_vec = np.asarray(emb, np.float32)
                elif text is not None:
                    q_vec, text_terms = state.encode_text_query(str(text))
                else:
                    raise ValueError(
                        "'query_embedding' or 'query' is required"
                    )
                model = payload.get(
                    "model", state.retriever.model_names[0]
                )
                q = {model: q_vec}
                terms = None
                if payload.get("terms") is not None:
                    terms = np.asarray(payload["terms"], np.int32)
                elif text_terms is not None:
                    terms = text_terms
                weights = payload.get("model_weights") or default_weights
                rows, scores = state.submit_sync(
                    q, terms, weights,
                    payload.get("filename_type_filter"),
                    float(payload.get("wrrf_k", 40.0)),
                )
                meta = state.index.meta
                out = []
                for r, s in zip(rows.tolist(), scores.tolist()):
                    if r < 0 or r >= meta.n_docs:
                        continue
                    out.append({
                        "id": meta.ids[r],
                        "source": meta.sources[r],
                        "score": s,
                        "document": meta.contents[r],
                    })
                self._reply(200, {"results": out})
            except ValueError as e:
                self._reply(400, {"error": str(e)})
            except Exception as e:  # noqa: BLE001 — serving boundary
                logger.exception("search failed")
                self._reply(500, {"error": str(e)})

    return Handler


def serve_state(
    state: ServeState,
    default_weights: Dict[str, float],
    host: str = "127.0.0.1",
    port: int = 8800,
    background: bool = False,
    api=None,
):
    """Start the asyncio scheduler loop thread + HTTP server."""
    loop = asyncio.new_event_loop()
    state.loop = loop
    threading.Thread(target=loop.run_forever, daemon=True,
                     name="scheduler-loop").start()
    if state.monitor is not None:
        state.monitor.start()
    if api is not None and api.gen_server is not None:
        api.gen_server.start()
    server = ThreadingHTTPServer(
        (host, port), _make_handler(state, default_weights, api=api)
    )
    def _teardown():
        """Stop everything the serve started: monitor, generation
        server, the scheduler pool's loop tasks (so no asyncio task is
        left pending when the loop thread dies), then the loop."""
        if state.monitor is not None:
            state.monitor.stop()
        if api is not None and api.gen_server is not None:
            api.gen_server.stop()
        try:
            fut = asyncio.run_coroutine_threadsafe(state.pool.stop(), loop)
            fut.result(timeout=10)
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        loop.call_soon_threadsafe(loop.stop)

    if background:
        threading.Thread(target=server.serve_forever, daemon=True).start()
        orig_shutdown = server.shutdown

        def _shutdown():
            orig_shutdown()
            _teardown()

        server.shutdown = _shutdown
        return server
    logger.info("serving on http://%s:%d", host, port)
    try:
        server.serve_forever()
    finally:
        _teardown()
    return None


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser()
    p.add_argument("--index", default=None, help="index artifact path")
    p.add_argument("--demo", action="store_true",
                   help="serve a synthetic demo corpus")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8800)
    p.add_argument("--models", default=None,
                   help="comma-separated dense models (default: all)")
    p.add_argument("--no-bm25", action="store_true")
    p.add_argument("--shards", type=int, default=0)
    p.add_argument("--two-tier-common", type=int, default=0)
    p.add_argument("--nprobe", type=int, default=0,
                   help="serve the flagship model via IVF ANN, probing "
                        "this many clusters per query (0 = exact)")
    p.add_argument("--ivf-clusters", type=int, default=None,
                   help="IVF cluster count (default ~sqrt(N))")
    p.add_argument("--ivf-spill", action="store_true",
                   help="store boundary docs in their two nearest "
                        "clusters (better low-nprobe recall, up to 2x "
                        "IVF memory)")
    p.add_argument("--ivf-max-coverage", type=float, default=0.25,
                   help="auto IVF routing threshold: batches whose "
                        "expected cluster coverage 1-(1-p/C)^B "
                        "exceeds this take the exact stream (engine "
                        "ivf_route='auto')")
    p.add_argument("--ivf-cache", default=None,
                   help="path to persist/reuse the sharded IVF "
                        "clustering layout (skips startup k-means)")
    p.add_argument("--embedder", default=None,
                   help="on-device query embedder so /v1/search "
                        "accepts raw 'query' text: 'hashing' "
                        "(hashing-tokenizer flax encoder, random init "
                        "unless --embedder-ckpt)")
    p.add_argument("--embedder-ckpt", default=None,
                   help="orbax checkpoint dir with trained encoder "
                        "params (models/train.py output)")
    p.add_argument("--llm", default=None, choices=["local"],
                   help="'local' attaches the on-device decoder LM: "
                        "adds /v1/rag (+SSE), /v1/generate "
                        "(continuous-batching completion), /v1/feedback "
                        "and the browser UI to this port. Random-init "
                        "demo weights unless --llm-ckpt.")
    p.add_argument("--llm-ckpt", default=None,
                   help="HF-format Qwen3 checkpoint dir (config.json + "
                        "*.safetensors) for the local LM")
    p.add_argument("--gen-slots", type=int, default=4,
                   help="continuous-batching decode slots")
    p.add_argument("--gen-chunk", type=int, default=8,
                   help="decode steps fused per dispatched program")
    p.add_argument("--gen-max-len", type=int, default=1024,
                   help="KV-cache length per slot")
    p.add_argument("--draft-ckpt", default=None,
                   help="smaller HF-format Qwen3 checkpoint dir used "
                        "as the speculative-decoding draft: every "
                        "decode tick becomes one batched draft-propose"
                        "/target-verify round per slot (greedy streams "
                        "stay bit-identical to target-only)")
    p.add_argument("--gamma", type=int, default=4,
                   help="draft proposals per speculation round")
    p.add_argument("--prefill-chunk", type=int, default=None,
                   help="incremental prefill: admit long prompts "
                        "N tokens per decode tick so active streams "
                        "never stall longer than one chunk's forward")
    p.add_argument("--max-pending", type=int, default=None,
                   help="backpressure: reject /v1/generate submissions "
                        "(HTTP 429) beyond this many queued requests")
    p.add_argument("--retain-prefixes", type=int, default=0,
                   help="keep up to N retired requests' KV rows as "
                        "cached prefixes (multi-turn chat prefills "
                        "only the new tail; zero extra forward work)")
    p.add_argument("--logprob-topk", type=int, default=0,
                   help="emit the top-K raw-distribution alternatives "
                        "per generated token (/v1/generate "
                        "'top_logprobs'); 0 = off (no per-step sort)")
    p.add_argument("--json-mode", action="store_true",
                   help="register guided-decoding JSON constraints on "
                        "the local LM: /v1/generate then accepts "
                        "'constraint': 'json'|'json_object'|'json_array' "
                        "or response_format={'type': 'json_object'} and "
                        "the output is guaranteed to parse (DFA-masked "
                        "sampling, models/constrain.py)")
    p.add_argument("--json-depth", type=int, default=4,
                   help="max JSON nesting depth for --json-mode (table "
                        "size grows with depth)")
    p.add_argument("--lm-tp", type=int, default=None,
                   help="tensor-parallel degree for the local LM: "
                        "shard attention heads / MLP columns and KV "
                        "caches over the first N devices "
                        "(parallel/lm.py Megatron layout; streams stay "
                        "bit-identical to single-device)")
    p.add_argument("--native-port", type=int, default=None,
                   help="also serve the binary native (C++) front on "
                        "this port: length-prefixed raw-f32 frames, "
                        "socket-layer batching, ~zero Python per "
                        "request (serving/native_front.py). Single-"
                        "dense-model configs only; 0 picks a free port")
    p.add_argument("--native-t-max", type=int, default=32,
                   help="term-id columns per row on the native front")
    p.add_argument("--native-wire-dtype", default="f32",
                   choices=["f32", "bf16", "int8"],
                   help="embedding element width on the native wire: "
                        "bf16 halves the bytes per row on the socket "
                        "and the host->device upload; int8 quarters "
                        "them (per-row scale, device-side dequant); "
                        "ranking is exact f32 ordering of the "
                        "quantized query's scores")
    p.add_argument("--chat-template", default="auto",
                   choices=["auto", "chatml", "plain"],
                   help="chat prompt format for /v1/chat/completions: "
                        "auto = the checkpoint's declared chat_template "
                        "(tokenizer_config.json) with a marker-in-vocab "
                        "fallback; chatml/plain force it either way")
    args = p.parse_args(argv)
    from a_nice_rag_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    if args.demo:
        from a_nice_rag_tpu.index import build_index
        from a_nice_rag_tpu.testing import synth_corpus

        c = synth_corpus(n_docs=2048, dim=128, n_queries=4, seed=11)
        index = build_index(ids=c.ids, sources=c.sources,
                            contents=c.contents, embeddings=c.embeddings,
                            token_lists=c.tokens)
    elif args.index:
        from a_nice_rag_tpu.index import load_index

        index = load_index(args.index)
    else:
        raise SystemExit("--index or --demo is required")

    model_names = (
        args.models.split(",") if args.models
        else list(index.dense_model_names)
    )
    use_bm25 = not args.no_bm25 and index.bm25 is not None
    embedder = None
    if args.llm and not args.embedder:
        args.embedder = "hashing"  # RAG needs a query embedder
    if args.embedder == "hashing":
        from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
        from a_nice_rag_tpu.models.encoder import EncoderConfig

        out_dim = int(index.dense_matrix(model_names[0]).shape[1])
        embedder = OnDeviceEmbedder(EncoderConfig(out_dim=out_dim))
        if args.embedder_ckpt:
            from a_nice_rag_tpu.models.checkpoint import (
                restore_checkpoint,
            )

            embedder.params = restore_checkpoint(
                args.embedder_ckpt, template=embedder.params
            )
    elif args.embedder:
        raise SystemExit(f"unknown --embedder {args.embedder!r}")
    state = build_state(
        index, tuple(model_names), use_bm25=use_bm25,
        shards=args.shards,
        two_tier_common=args.two_tier_common,
        nprobe=args.nprobe, ivf_clusters=args.ivf_clusters,
        ivf_cache=args.ivf_cache, ivf_spill=args.ivf_spill,
        embedder=embedder,
        ivf_max_coverage=args.ivf_max_coverage,
    )
    weights = {m: (5.0 if m == model_names[0] else 1.0)
               for m in model_names}
    if use_bm25:
        weights["BM25"] = 1.0
    api = None
    if args.llm == "local":
        api = build_local_llm_api(
            index, state, embedder, model_names,
            llm_ckpt=args.llm_ckpt, gen_slots=args.gen_slots,
            gen_chunk=args.gen_chunk, gen_max_len=args.gen_max_len,
            draft_ckpt=args.draft_ckpt, gamma=args.gamma,
            prefill_chunk=args.prefill_chunk, lm_tp=args.lm_tp,
            max_pending=args.max_pending,
            json_mode=args.json_mode, json_depth=args.json_depth,
            logprob_topk=args.logprob_topk,
            retain_prefixes=args.retain_prefixes,
            chat_template=args.chat_template,
        )
    native = None
    if args.native_port is not None:
        from a_nice_rag_tpu.serving.native_front import (
            NativeRetrievalFront,
        )

        native = NativeRetrievalFront(
            state.retriever, weights, host=args.host,
            port=args.native_port, t_max=args.native_t_max,
            wire_dtype=args.native_wire_dtype,
        )
        logger.info(
            "native binary front on %s:%d (dim=%d, t_max=%d, wire=%s)",
            args.host, native.port, native.dim, native.t_max,
            native.wire_dtype,
        )
    try:
        serve_state(state, weights, host=args.host, port=args.port,
                    api=api)
    finally:
        if native is not None:
            native.stop()


def build_local_llm_api(index, state, embedder, model_names,
                        llm_ckpt=None, gen_slots: int = 4,
                        gen_chunk: int = 8, gen_max_len: int = 1024,
                        max_pending=None,
                        draft_ckpt=None, gamma: int = 4,
                        prefill_chunk=None, lm_tp=None,
                        json_mode: bool = False, json_depth: int = 4,
                        logprob_topk: int = 0,
                        retain_prefixes: int = 0,
                        chat_template: str = "auto"):
    """Attach the on-device decoder LM to this deployment: a
    continuous-batching GenerationServer shared by /v1/generate and the
    RAG LLM hop, a RAGSystem over this serve state's engine (sharded or
    single-device), and a ServingAPI exposing /v1/rag (+SSE) and the
    browser UI. No SaaS anywhere (the reference's generation hop is
    SaaS-only, src/query_rag.py:434-513)."""
    from a_nice_rag_tpu.config import InfoSource
    from a_nice_rag_tpu.models.decoder import (
        DecoderLM,
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu.rag.providers import LocalLLMClient
    from a_nice_rag_tpu.rag.system import RAGSystem
    from a_nice_rag_tpu.retrieval.rerank import IdentityReranker
    from a_nice_rag_tpu.serving.genserver import GenerationServer
    from a_nice_rag_tpu.serving.http_api import ServingAPI

    if llm_ckpt:
        from a_nice_rag_tpu.models.qwen3 import load_qwen3_checkpoint_dir

        lm_cfg, _, lm_params = load_qwen3_checkpoint_dir(llm_ckpt)
        lm = DecoderLM(lm_cfg)
        logger.info("serve: local LM loaded from %s (%d layers)",
                    llm_ckpt, lm_cfg.num_layers)
    else:
        lm, lm_params = init_decoder(small_lm_config(),
                                     max_len=gen_max_len)
        logger.warning("serve: local LM is RANDOM-INIT demo weights "
                       "(pass --llm-ckpt for real generation)")
    draft = draft_params = None
    if draft_ckpt:
        from a_nice_rag_tpu.models.qwen3 import load_qwen3_checkpoint_dir

        d_cfg, _, draft_params = load_qwen3_checkpoint_dir(draft_ckpt)
        if lm.cfg.vocab_size != d_cfg.vocab_size:
            raise SystemExit(
                f"--draft-ckpt vocab ({d_cfg.vocab_size}) must match "
                f"the target's ({lm.cfg.vocab_size})"
            )
        draft = DecoderLM(d_cfg)
        logger.info("serve: speculative draft loaded from %s "
                    "(%d layers, gamma=%d)", draft_ckpt,
                    d_cfg.num_layers, gamma)
    mesh = None
    if lm_tp is not None and lm_tp > 1:
        import jax
        import numpy as _np
        from jax.sharding import Mesh

        devs = jax.devices()
        if lm_tp > len(devs):
            raise SystemExit(
                f"--lm-tp {lm_tp} > available devices ({len(devs)})"
            )
        mesh = Mesh(_np.array(devs[:lm_tp]), ("tp",))
        logger.info("serve: local LM tensor-parallel over %d devices",
                    lm_tp)
    # The model's own EOS: a real HF checkpoint decodes until its
    # config's eos_token_id, not the demo byte-tokenizer's 257.
    import os as _os

    from a_nice_rag_tpu.models.decoder import EOS as _BYTE_EOS

    eos_id = _BYTE_EOS
    hf_tok = None
    if llm_ckpt:
        import json as _json

        with open(_os.path.join(llm_ckpt, "config.json")) as f:
            _eos = _json.load(f).get("eos_token_id")
        if isinstance(_eos, list):
            _eos = _eos[0] if _eos else None
        if _eos is not None:
            eos_id = int(_eos)
        # Serve with the checkpoint's OWN tokenizer: prompts must be
        # encoded with the vocabulary the weights were trained on, not
        # the demo byte tokenizer (models/hf_tokenizer.HFTokenizer —
        # exact BPE encode + streaming byte-map decode). A tokenizer
        # file the `tokenizers` runtime cannot parse (hand-reduced
        # fixtures) still yields its byte map for constraint lowering.
        if _os.path.exists(_os.path.join(llm_ckpt, "tokenizer.json")):
            from a_nice_rag_tpu.models.hf_tokenizer import HFTokenizer

            try:
                hf_tok = HFTokenizer(llm_ckpt)
                if chat_template != "auto":
                    # Explicit override of the template heuristic
                    # (models/hf_tokenizer.supports_chatml rule 1).
                    hf_tok.force_chatml = chat_template == "chatml"
                logger.info(
                    "serve: generation endpoints use the checkpoint's "
                    "tokenizer (%d pieces, %d specials)",
                    len(hf_tok.token_bytes), len(hf_tok.specials),
                )
            except Exception as e:  # noqa: BLE001 — degrade, don't die
                logger.warning(
                    "serve: tokenizers runtime rejected tokenizer.json "
                    "(%s); prompts use the demo byte tokenizer, "
                    "constraints still lower onto the byte map", e,
                )
    constraints = None
    if json_mode:
        if draft is not None:
            raise SystemExit(
                "--json-mode does not compose with --draft-ckpt "
                "(constrained decoding is rejected in speculative mode)"
            )
        from a_nice_rag_tpu.models.constrain import (
            compile_constraint,
            json_dfa,
        )

        # A real checkpoint's tokenizer is multi-byte (byte-level BPE):
        # lower the grammar onto it by walking each token's bytes
        # (models/hf_tokenizer.py). Demo weights use the byte-level
        # local tokenizer (token_bytes=None).
        token_bytes = None
        if hf_tok is not None:
            token_bytes = hf_tok.token_bytes
        elif llm_ckpt and _os.path.exists(
            _os.path.join(llm_ckpt, "tokenizer.json")
        ):
            from a_nice_rag_tpu.models.hf_tokenizer import (
                load_token_bytes,
            )

            token_bytes, _spec = load_token_bytes(llm_ckpt)
        if token_bytes is not None:
            logger.info(
                "serve: constraints lowered onto the checkpoint's "
                "tokenizer (%d tokens)", len(token_bytes),
            )
        dfas = {
            "json": json_dfa(max_depth=json_depth),
            "json_object": json_dfa(max_depth=json_depth,
                                    top_level="object"),
            "json_array": json_dfa(max_depth=json_depth,
                                   top_level="array"),
        }
        constraints = {
            name: compile_constraint(dfa, lm.cfg.vocab_size, eos_id,
                                     token_bytes=token_bytes, name=name)
            for name, dfa in dfas.items()
        }
        logger.info("serve: JSON guided decoding registered (depth=%d)",
                    json_depth)
    gen = GenerationServer(lm, lm_params, slots=gen_slots, eos_id=eos_id,
                           max_len=gen_max_len, chunk=gen_chunk,
                           draft_model=draft, draft_params=draft_params,
                           gamma=gamma, prefill_chunk=prefill_chunk,
                           max_pending=max_pending, mesh=mesh,
                           constraints=constraints,
                           logprob_topk=logprob_topk,
                           retain_prefixes=retain_prefixes)
    client = LocalLLMClient(lm, lm_params, server=gen,
                               tokenizer=hf_tok,
                               max_prompt_tokens=max(
                                   64, gen_max_len - 256))
    rag = RAGSystem(
        indexes={InfoSource.NICE: index},
        embedder=embedder,
        reranker=IdentityReranker(),
        llm_clients={"local": client},
    )
    sidx = getattr(state.retriever, "sidx", None)
    if sidx is not None:
        from a_nice_rag_tpu.parallel.engine import ShardedSearchEngine

        rag.attach_index(
            InfoSource.NICE, index,
            engine=ShardedSearchEngine(sidx, embedder=embedder,
                                       reranker=IdentityReranker()),
        )
    return ServingAPI(rag, gen_server=gen, llm_options=["local"],
                      tokenizer=hf_tok)


if __name__ == "__main__":
    main()
