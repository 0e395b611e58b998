"""Headline benchmark: hybrid retrieval on one NVIDIA GPU.

Reproduces the reference's retrieval workload at its corpus scale
(~9.6k chunks x 2048-dim embeddings, hybrid dense+BM25 with WRRF fusion,
BASELINE.md / src/retrieval_eval.py configuration 6) and measures
batched throughput and single-query latency of the fused device program,
then the million-document stages (2M hybrid, 10.5M int8, IVF at narrow
batch) and the served path (HTTP and native fronts).

Every stage runs on the GPU and a failed stage fails the run; with no GPU
the script exits non-zero. Times end in ``block_until_ready``. Prints ONE
JSON line tagged with the device's platform, kind and count.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

N_DOCS = 9728  # reference corpus scale (SURVEY.md §2.4: ~9.6k-12k chunks)
DIM = 2048  # voyage-3-large output_dimension (create_database.py:37)
VOCAB = 20000
BATCH = 2048
T_MAX = 16
WARMUP = 3
ITERS = 15
MODEL = "voyage-3-large"


def _build():
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.testing import synth_corpus

    # Noise calibrated at THIS dim (scripts/calibrate_headline.py) so the
    # corpus reproduces the reference's §6.1 structure: dense R@10 ~0.93
    # > BM25 ~0.86, WRRF 5:1 hybrid ~0.96 ABOVE both (reference
    # results/retrieval_evaluation_results.csv:7 — hybrid 0.989 > dense
    # 0.985 > BM25 0.887).
    c = synth_corpus(
        n_docs=N_DOCS, dim=DIM, n_queries=BATCH, vocab_size=VOCAB, seed=7,
        model_noise={MODEL: 0.22}, query_token_noise=0.15,
    )
    index = build_index(
        ids=c.ids,
        sources=c.sources,
        contents=c.contents,
        embeddings=c.embeddings,
        token_lists=c.tokens,
    )
    return c, index


def _recall10(fids, gold) -> float:
    f = np.asarray(fids)[:, :10]
    return float(np.mean([gold[b] in f[b] for b in range(len(gold))]))


def at_scale_metrics() -> dict:
    """2M x 256 bf16 dense + CSR BM25, hybrid through FusedRetriever's
    streaming route (the Pallas streaming top-k and the sort-based
    window-slice sparse BM25), with a planted-gold recall guard, the
    route asserted, and the kernel's dense ids checked against the plain
    blocked form."""
    import jax
    import jax.numpy as jnp

    from a_nice_rag_tpu.ops.streaming import (
        blocked_top_k,
        dense_stream_top_k,
    )
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing.scale import hybrid_2m
    from a_nice_rag_tpu.testing.timing import true_device_ms

    c = hybrid_2m()
    index = c.index
    n, d = index.dense[MODEL].shape
    b = c.queries.shape[0]
    k = 32
    retr = FusedRetriever(index, (MODEL,), use_bm25=True, similarity_k=k,
                          common_sections_n=k, budget=1024)
    assert retr.route.stream and retr.route.kernel, retr.route
    qd = {MODEL: c.queries}
    weights = {MODEL: 5.0, "BM25": 1.0}

    def recall(w):
        return _recall10(retr.retrieve_device(qd, c.terms, w)[0], c.gold)

    r_h = recall(weights)
    r_d = recall({MODEL: 1.0, "BM25": 0.0})
    r_b = recall({MODEL: 0.0, "BM25": 1.0})
    assert r_h >= 0.99, f"2M hybrid recall@10_planted {r_h} below floor 0.99"
    assert r_d >= 0.95 and r_b >= 0.95, (r_d, r_b)

    emb = index.dense[MODEL]
    q32 = c.queries[:32]
    _, ki = dense_stream_top_k(emb, q32, k, retr.route)
    _, bi = blocked_top_k(emb, q32.astype(emb.dtype), k)
    ids_equal = float(np.mean(np.asarray(ki) == np.asarray(bi)))
    assert ids_equal >= 0.95, f"kernel vs plain dense ids {ids_equal}"

    args, kw = retr._program_args(qd, c.terms, weights, None, 40.0)
    (dense_mats, bm, _, terms, mask, bmask, wv, wk) = args

    def _hybrid_call(dq, emb, bm, t):
        fids, fvals, _ = retr._run((emb,), bm, (dq,), t, mask, bmask, wv,
                                   wk)
        return fids, fvals

    batch_ms = true_device_ms(_hybrid_call, c.queries, emb, bm, terms,
                              n_loop=20, trials=3)

    # Stream floor: one plain XLA reduction over the same matrix.
    from a_nice_rag_tpu.testing.timing import chained_dispatch_ms

    total = jax.jit(lambda x: jnp.sum(x.astype(jnp.float32)))
    stream_ms = chained_dispatch_ms(lambda: total(emb), n=10, trials=3)
    emb_gb = n * d * emb.dtype.itemsize / 1e9
    return {
        "n_docs_2m": n,
        "dim_2m": d,
        "batch_2m": b,
        "batch_2m_ms": round(batch_ms, 3),
        "qps_2m": round(b / batch_ms * 1e3, 1),
        "stream_gb_s_2m": round(emb_gb / stream_ms * 1e3, 1),
        "fused_gb_s_2m": round(emb_gb / batch_ms * 1e3, 1),
        "pct_of_stream_2m": round(stream_ms / batch_ms, 3),
        "dense_ids_equal_plain_2m": ids_equal,
        "recall@10_2m_hybrid": r_h,
        "recall@10_2m_dense": r_d,
        "recall@10_2m_bm25": r_b,
        "route_2m": "stream-kernel",
    }


def int8_scale_metrics() -> dict:
    """10.5M x 1024 int8 (10.7 GB) through FusedRetriever's streaming
    int8 route at B=256 with a planted-gold recall guard, then IVF on the
    same corpus (already cluster-major: identity permutation, the planted
    centers as centroids) at B=8 against the exact route."""
    import jax.numpy as jnp

    from a_nice_rag_tpu.index.ivf import IVFDense, ivf_search
    from a_nice_rag_tpu.ops.quantized import QuantizedDense
    from a_nice_rag_tpu.ops.streaming import dense_stream_top_k
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing.scale import int8_10m
    from a_nice_rag_tpu.testing.timing import true_device_ms

    clusters = 4096
    c = int8_10m(clusters=clusters)
    index = c.index
    mat = index.dense_q[MODEL]
    n, d = mat.values.shape
    b, k = c.queries.shape[0], 25
    retr = FusedRetriever(index, (MODEL,), use_bm25=False, similarity_k=k,
                          common_sections_n=k)
    assert retr.route.stream and retr.route.kernel, retr.route
    qd = {MODEL: c.queries}
    w = {MODEL: 1.0}
    r10 = _recall10(retr.retrieve_device(qd, None, w)[0], c.gold)
    assert r10 >= 0.95, f"10.5M int8 recall@10_planted {r10} below 0.95"

    args, _ = retr._program_args(qd, None, w, None, 40.0)
    terms, mask, wv, wk = args[3], args[4], args[6], args[7]

    def _int8_call(dq, vals, scales):
        fids, fvals, _ = retr._run((QuantizedDense(vals, scales),), None,
                                   (dq,), terms, mask, mask, wv, wk)
        return fids, fvals

    batch_ms = true_device_ms(_int8_call, c.queries, mat.values, mat.scales,
                              n_loop=8, trials=2)

    # IVF on the same corpus at the low-latency batch B=8.
    nprobe, tile_n, b_ivf = 8, 2048, 8
    per = n // clusters
    cent = c.centers
    ivf = IVFDense(
        centroids=cent, perm=jnp.arange(n, dtype=jnp.int32),
        cluster_start=jnp.arange(clusters + 1, dtype=jnp.int32) * per,
        tile_n=tile_n, n_real=n, max_cluster_tiles=per // tile_n + 2,
        values=mat.values, scales=mat.scales,
    )
    q8 = c.queries[:b_ivf]
    _, ids_ivf, _ = ivf_search(ivf, q8, k, nprobe=nprobe)
    _, ids_exact = dense_stream_top_k(mat, q8, k, retr.route)
    r10_ivf = float(np.mean([
        len(set(np.asarray(ids_ivf)[i, :10])
            & set(np.asarray(ids_exact)[i, :10])) / 10
        for i in range(b_ivf)]))
    ivf_ms = true_device_ms(
        lambda q, v, s: ivf_search(
            IVFDense(centroids=cent, perm=ivf.perm,
                     cluster_start=ivf.cluster_start, tile_n=tile_n,
                     n_real=n, max_cluster_tiles=ivf.max_cluster_tiles,
                     values=v, scales=s), q, k, nprobe=nprobe)[0],
        q8, mat.values, mat.scales, n_loop=40, trials=3)
    exact_ms = true_device_ms(
        lambda q, v, s: dense_stream_top_k(
            QuantizedDense(v, s), q, k, retr.route)[0],
        q8, mat.values, mat.scales, n_loop=6, trials=2)
    return {
        "n_docs_10m_int8": n,
        "dim_10m_int8": d,
        "batch_10m_int8": b,
        "batch_10m_int8_ms": round(batch_ms, 3),
        "qps_10m_int8": round(b / batch_ms * 1e3, 1),
        "fused_gb_s_10m_int8": round(n * d / 1e9 / batch_ms * 1e3, 1),
        "recall@10_10m_int8": r10,
        "route_10m_int8": "stream-kernel",
        "ivf_10m_int8_b8_ms": round(ivf_ms, 3),
        "exact_10m_int8_b8_ms": round(exact_ms, 3),
        "ivf_speedup_10m_int8_b8": round(exact_ms / ivf_ms, 2),
        "recall@10_10m_int8_ivf_vs_exact": round(r10_ivf, 4),
        "ivf_nprobe_10m": nprobe,
        "ivf_clusters_10m": clusters,
    }


def ivf_scale_metrics() -> dict:
    """IVF micro-batch latency at N=2M x 256 bf16 with planted cluster
    structure: probed tiles through the streaming top-k's tile table
    against the exact streaming scan at the same B=8, with planted-gold
    recall@10 and the scheduled tile fraction."""
    import jax

    from a_nice_rag_tpu.index.ivf import IVFDense, build_ivf_dense, ivf_search
    from a_nice_rag_tpu.ops.streaming import choose_route, dense_stream_top_k
    from a_nice_rag_tpu.testing.scale import clustered_2m
    from a_nice_rag_tpu.testing.timing import true_device_ms

    b, k, nprobe = 8, 16, 16
    c = clustered_2m(b=64 * b)
    emb = c.index.dense[MODEL]
    t0 = time.perf_counter()
    ivf = build_ivf_dense(emb, tile_n=1024, n_iters=10, seed=0)
    jax.block_until_ready(ivf.emb)
    build_s = time.perf_counter() - t0
    qs = c.queries.reshape(64, b, -1)
    gold = c.gold.reshape(64, b)
    hits, fracs = 0, []
    for i in range(64):
        _, ids, n_uniq = ivf_search(ivf, qs[i], k, nprobe=nprobe)
        ids = np.asarray(ids)
        hits += sum(gold[i, j] in ids[j, :10] for j in range(b))
        fracs.append(min(int(n_uniq), ivf.n_tiles) / ivf.n_tiles)
    r10 = hits / (64 * b)
    assert r10 >= 0.90, f"IVF recall@10_planted {r10} below floor 0.90"
    route = choose_route(emb.shape[0], k)
    ivf_ms = true_device_ms(
        lambda q, e: ivf_search(
            IVFDense(centroids=ivf.centroids, perm=ivf.perm,
                      cluster_start=ivf.cluster_start, tile_n=ivf.tile_n,
                      n_real=ivf.n_real,
                      max_cluster_tiles=ivf.max_cluster_tiles, emb=e),
            q, k, nprobe=nprobe)[0],
        qs[0], ivf.emb, n_loop=50, trials=3)
    exact_ms = true_device_ms(
        lambda q, e: dense_stream_top_k(e, q, k, route)[0],
        qs[0], emb, n_loop=50, trials=3)
    return {
        "ivf_2m_b8_ms": round(ivf_ms, 3),
        "exact_2m_b8_ms": round(exact_ms, 3),
        "ivf_speedup_2m_b8": round(exact_ms / ivf_ms, 2),
        "recall@10_2m_ivf": round(r10, 4),
        "ivf_tile_fraction_2m": round(float(np.mean(fracs)), 4),
        "ivf_nprobe": nprobe,
        "ivf_clusters_2m": ivf.n_clusters,
        "ivf_build_s_2m": round(build_s, 1),
    }


def served_qps_metrics() -> dict:
    """E2E served throughput through the serving stack, both fronts on
    the same corpus so the layers attribute cleanly:

    - HTTP: loopback -> serve_cli handler -> SchedulerPool micro-batching
      -> FusedRetriever device program;
    - native: C++ socket front (native/anr_serve.cpp) -> one Python wake
      per batch -> the same device program, at f32, bf16 and int8 wire
      widths.

    Clients send 512-query frames; rows re-batch server-side.
    """
    import base64
    import http.client
    import threading

    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.serving.serve_cli import build_state, serve_state
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(
        n_docs=N_DOCS, dim=DIM, n_queries=512, vocab_size=VOCAB, seed=7,
        model_noise={MODEL: 0.22}, query_token_noise=0.15,
    )
    index = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    state = build_state(
        index, (MODEL,), use_bm25=True,
        scheduler_kwargs={
            "max_batch": 512, "max_wait_ms": 2.0, "max_inflight": 6,
        },
    )
    weights = {MODEL: 5.0, "BM25": 1.0}
    server = serve_state(state, weights, host="127.0.0.1", port=0,
                         background=True)
    port = server.server_address[1]
    B = 512
    q = np.asarray(c.query_embeddings[MODEL][:B], np.float32)
    terms = np.asarray(index.pad_term_ids(c.query_tokens[:B], T_MAX),
                       np.int32)
    body = json.dumps({
        "query_embeddings_b64": base64.b64encode(q.tobytes()).decode(),
        "shape": list(q.shape),
        "terms_b64": base64.b64encode(terms.tobytes()).decode(),
        "terms_shape": list(terms.shape),
        "model_weights": weights,
    })
    lat: list = []
    errs: list = []

    def client(n_req: int):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for _ in range(n_req):
                t0 = time.perf_counter()
                conn.request("POST", "/v1/search", body,
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                if r.status != 200:
                    errs.append(data[:200])
                    return
                out = json.loads(data)
                assert out["out_shape"][0] == B
                lat.append(time.perf_counter() - t0)
        finally:
            conn.close()

    try:
        client(2)  # warm: compile the batch-bucket programs
        lat.clear()
        n_threads, per = 8, 5
        threads = [threading.Thread(target=client, args=(per,))
                   for _ in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        scheds = list(state.pool._pool.values())
        batches = sum(s.batches_run for s in scheds)
        served = sum(s.queries_served for s in scheds)
    finally:
        server.shutdown()
    assert not errs, errs[0]
    out = {
        "served_qps": round(len(lat) * B / wall, 1),
        "served_p50_batch_ms": round(float(np.median(lat) * 1e3), 2),
        "served_batch": B,
        "served_clients": n_threads,
        "served_requests": len(lat),
        "served_avg_device_batch": round(served / max(batches, 1), 1),
    }
    for wire in ("f32", "bf16", "int8"):
        out.update(_served_native(state, weights, q, terms, n_threads, per,
                                  wire))
    return out


def _served_native(state, weights, q, terms, n_threads: int, per: int,
                   wire: str) -> dict:
    """The same traffic through the native C++ front at one wire width.
    Narrow wires change the ranking only through the quantized query:
    the top-k overlap with the f32 device ranking must stay >= 0.9."""
    import threading

    from a_nice_rag_tpu.serving.native_front import (
        NativeFrontClient,
        NativeRetrievalFront,
    )

    front = NativeRetrievalFront(
        state.retriever, weights, port=0, t_max=T_MAX, max_batch=512,
        wait_ms=2.0, wire_dtype=wire,
    )
    B = q.shape[0]
    lat: list = []
    first_rows: list = []

    def client(n_req: int, keep_rows: bool = False):
        with NativeFrontClient("127.0.0.1", front.port,
                               wire_dtype=wire) as cl:
            for _ in range(n_req):
                t0 = time.perf_counter()
                rows, _ = cl.search(q, terms)
                lat.append(time.perf_counter() - t0)
                if keep_rows and not first_rows:
                    first_rows.append(np.asarray(rows))

    try:
        # Warm with the measured concurrency pattern: each power-of-two
        # batch bucket compiles its own program.
        warm = [threading.Thread(target=client, args=(2, True))
                for _ in range(n_threads)]
        for t in warm:
            t.start()
        for t in warm:
            t.join()
        lat.clear()
        threads = [threading.Thread(target=client, args=(per,))
                   for _ in range(n_threads)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
    finally:
        front.stop()
    tag = "" if wire == "f32" else f"_{wire}"
    out = {
        f"served_qps_native{tag}": round(len(lat) * B / wall, 1),
        f"served_native{tag}_p50_batch_ms": round(
            float(np.median(lat) * 1e3), 2),
    }
    d_rows = np.asarray(state.retriever.retrieve_device(
        {state.retriever.model_names[0]: q}, terms, weights, None, 40.0,
    )[0])
    k = d_rows.shape[1]
    overlap = float(np.mean([
        len(set(first_rows[0][i]) & set(d_rows[i])) / k for i in range(B)
    ]))
    out[f"served_native{tag}_overlap10"] = round(overlap, 4)
    assert overlap >= 0.9, f"{wire}-wire top-k overlap {overlap:.3f}"
    return out


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py: no GPU (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 2
    import gc

    import jax.numpy as jnp

    from a_nice_rag_tpu.ops.bm25 import postings_required
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing.timing import true_device_ms
    from a_nice_rag_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    c, index = _build()
    terms_np = index.pad_term_ids(c.query_tokens, T_MAX)
    need = int(np.asarray(
        postings_required(index.bm25, jnp.asarray(terms_np))).max())
    budget = 1 << int(np.ceil(np.log2(max(need, 1024))))
    retriever = FusedRetriever(
        index, model_names=(MODEL,), use_bm25=True, similarity_k=25,
        common_sections_n=15, budget=budget,
    )
    q_dev = jnp.asarray(c.query_embeddings[MODEL])
    terms_dev = jnp.asarray(terms_np)
    q_embs = {MODEL: q_dev}
    weights = {MODEL: 5.0, "BM25": 1.0}

    # Quality guard on the measured configuration, asserting the
    # reference's central fusion claim: WRRF hybrid must beat BOTH single
    # rankers (results/retrieval_evaluation_results.csv:7).
    def _recall(w):
        fids, _, _ = retriever(q_embs, terms_np, w, None, 40.0)
        hits = sum(
            c.gold_ids[b]
            in [index.meta.ids[i] for i in fids[b] if i >= 0][:10]
            for b in range(256)
        )
        return hits / 256

    recall10 = _recall(weights)
    recall10_dense = _recall({MODEL: 1.0, "BM25": 0.0})
    recall10_bm25 = _recall({MODEL: 0.0, "BM25": 1.0})
    assert recall10 >= 0.90, (recall10, recall10_dense, recall10_bm25)
    assert recall10 >= max(recall10_dense, recall10_bm25), (
        recall10, recall10_dense, recall10_bm25)

    def call():
        return retriever.retrieve_device(q_embs, terms_dev, weights, None,
                                         40.0)[0]

    for _ in range(WARMUP):
        jax.block_until_ready(call())
    qps = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(ITERS):
            out = call()
        jax.block_until_ready(out)
        qps = max(qps, BATCH * ITERS / (time.perf_counter() - t0))

    # Host-synchronous throughput (download fused ids every batch).
    t0 = time.perf_counter()
    for _ in range(ITERS):
        np.asarray(call())
    qps_sync = BATCH * ITERS / (time.perf_counter() - t0)

    # Single-query latency, host-visible and in-device.
    q1 = {MODEL: q_dev[:1]}
    t1 = terms_dev[:1]
    for _ in range(WARMUP):
        jax.block_until_ready(
            retriever.retrieve_device(q1, t1, weights, None, 40.0)[0])
    lat = []
    for _ in range(30):
        t0 = time.perf_counter()
        np.asarray(retriever.retrieve_device(q1, t1, weights, None, 40.0)[0])
        lat.append(time.perf_counter() - t0)
    p50_ms = float(np.median(lat) * 1e3)

    args, _ = retriever._program_args(q1, t1, weights, None, 40.0)
    mask, bm25_mask, wv, wk = args[4], args[5], args[6], args[7]
    emb = index.dense[MODEL]
    bm25_arrays = args[1]

    def _one_query(dq, emb, bm, t):
        fids, fvals, _ = retriever._run((emb,), bm, (dq,), t, mask,
                                        bm25_mask, wv, wk)
        return fids, fvals

    p50_device_ms = true_device_ms(_one_query, q_dev[:1], emb, bm25_arrays,
                                   t1, n_loop=200, trials=3)

    # Free the reference-scale stage before the million-document ones.
    del retriever, index, q_embs, q_dev, terms_dev, out, emb, bm25_arrays
    del q1, t1, args, mask, bm25_mask, wv, wk
    gc.collect()
    stages = {}
    for stage in (at_scale_metrics, int8_scale_metrics, ivf_scale_metrics,
                  served_qps_metrics):
        stages.update(stage())
        gc.collect()

    print(json.dumps({
        "metric": "hybrid_retrieval_qps",
        "value": round(qps, 1),
        "unit": "queries/s",
        "qps_host_sync": round(qps_sync, 1),
        "p50_latency_ms": round(p50_ms, 3),
        "p50_device_ms": round(p50_device_ms, 3),
        "batch": BATCH,
        "n_docs": N_DOCS,
        "dim": DIM,
        "recall@10_planted": recall10,
        "recall@10_dense_only": recall10_dense,
        "recall@10_bm25_only": recall10_bm25,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        **stages,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
