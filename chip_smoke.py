#!/usr/bin/env python3
"""Bring-up check of the retrieval path on one NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --four-cards  # four cards: the sharded path only

Phases (one card), each compared with a plain reference; any failure
raises and the script exits non-zero:

1. served-reference: the NICE-shaped deployment (9,728 chunks x 2048 f32,
   dense-impact BM25) saved, loaded and served through ``serve_cli``'s
   ``build_state``/``serve_state``; /v1/search requests, single and
   batched, with and without the "CG,NG" filter, WRRF 5:1, k=25, n=15,
   against ``testing.golden``.
2. stream-2m: 2M x 256 bf16 + CSR BM25 hybrid at B=256 on the streaming
   route; no [B, N] buffer; ids against a plain chunked reference.
3. stream-int8-10m: 10.5M x 1024 int8 at B=256; ids bit-equal to an
   int32-accumulating reference.
4. ivf-2m: ``FusedRetriever(nprobe=16)`` at B=16 on a clustered 2M
   corpus; ids against a plain scan of the same tile table.
5. kernel-cases: the ``gpu`` cases of tests/test_stream_topk.py.

Tolerances: int8 ids bit-equal. bf16 and f32 ids equal except where the
reference's neighbouring scores (k-th and (k+1)-th included) differ by
less than 1e-5 x |score|, since the summation order differs; scores
within 1e-4 absolute.

All JAX work runs in this one process; ``nvidia-smi`` runs in a child
that never imports JAX. The last line of standard output is one JSON
object: {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import base64
import faulthandler
import http.client
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
MODEL = "voyage-3-large"
TOL = 1e-5


def check(ok, what) -> None:
    """Raise when a phase's check fails (unlike ``assert``, kept under
    ``python -O``)."""
    if not ok:
        raise AssertionError(what)


def watch(seconds: int = 300) -> None:
    """(Re)arm a timer that prints every thread's stack to standard
    error while the current step runs past ``seconds``: a stall then
    names its line."""
    faulthandler.dump_traceback_later(seconds, repeat=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


# --- references ---------------------------------------------------------

def exact_order(vals: np.ndarray, ids: np.ndarray, k: int):
    """Top-k of candidate (value, id) rows: value desc, id asc."""
    out_v = np.full((vals.shape[0], k), -np.inf)
    out_i = np.full((vals.shape[0], k), -1, np.int64)
    for r in range(vals.shape[0]):
        live = np.isfinite(vals[r]) & (ids[r] >= 0)
        v, i = vals[r][live], ids[r][live]
        o = np.lexsort((i, -v))[:k]
        out_v[r, :len(o)] = v[o]
        out_i[r, :len(o)] = i[o]
    return out_v, out_i


def chunked_top_k(score_chunk, n: int, k: int, chunk: int = 1 << 20):
    """Reference top-k over n docs: ``score_chunk(r0, size)`` gives
    host scores [B, size]; k + 16 candidates per chunk, then an exact
    merge."""
    vs, is_ = [], []
    for r0 in range(0, n, chunk):
        s = np.asarray(score_chunk(r0, min(chunk, n - r0)), np.float64)
        kk = min(k + 16, s.shape[1])
        part = np.argpartition(-s, kk - 1, axis=1)[:, :kk]
        vs.append(np.take_along_axis(s, part, 1))
        is_.append(part + r0)
    return exact_order(np.concatenate(vs, 1), np.concatenate(is_, 1), k)


def near_tie(vals: np.ndarray, upto: int, atol: float = 0.0) -> bool:
    """Any neighbouring pair among the first ``upto`` + 1 reference
    values closer than TOL x |value| (or ``atol``)?"""
    v = vals[: upto + 1]
    v = v[np.isfinite(v)]
    if len(v) < 2:
        return False
    gap = np.abs(np.diff(v))
    return bool(np.any(gap <= np.maximum(TOL * np.abs(v[1:]), atol)))


def compare(name, got_ids, ref_ids, ref_vals, k, exact=False, atol=0.0,
            got_vals=None, score_of=None):
    """Row-by-row id agreement under the tolerance rule; raises on a
    disagreement no near-tie explains. With ``score_of(row, ids)`` (the
    reference's scores of given ids), a differing row also passes when
    every returned id's reference score is within the tolerance of the
    reference score at its rank: the two lists differ only by swaps of
    near-equal scores."""
    got_ids = np.asarray(got_ids)[:, :k]
    agree = exempt = 0
    bad = []
    for r in range(ref_ids.shape[0]):
        if np.array_equal(got_ids[r], ref_ids[r, :k]):
            agree += 1
        elif exact:
            bad.append(r)
        elif score_of is not None:
            want = ref_vals[r, :k]
            have = score_of(r, got_ids[r])
            live = np.isfinite(want)
            ok = (np.array_equal(np.isfinite(have), live)
                  and np.all(np.abs(have[live] - want[live])
                             <= np.maximum(TOL * np.abs(want[live]), atol)))
            exempt += ok
            if not ok:
                bad.append(r)
        elif near_tie(ref_vals[r], k, atol):
            exempt += 1
        else:
            bad.append(r)
    if got_vals is not None:
        gv = np.asarray(got_vals)[:, :k]
        live = np.isfinite(ref_vals[:, :k]) & (ref_ids[:, :k] >= 0)
        same = np.asarray(got_ids) == ref_ids[:, :k]
        m = live & same
        err = float(np.abs(gv[m] - ref_vals[:, :k][m]).max()) if m.any() else 0.0
        if err > 1e-4:
            raise AssertionError(f"{name}: scores off by {err}")
    msg = (f"{name}: ids agree {agree}/{ref_ids.shape[0]}, "
           f"{exempt} differ at near-ties")
    if bad:
        raise AssertionError(f"{msg}, disagree rows {bad[:8]}")
    if agree < ref_ids.shape[0] // 2:
        raise AssertionError(f"{msg}: too few rows to judge")
    return f"{agree}/{ref_ids.shape[0]} ({exempt} differ at near-ties)"


def bm25_reference(index, terms: np.ndarray, k: int):
    """Top-k of the query terms' CSR postings summed per document on
    the host (documents with no posting do not qualify), and a function
    giving the reference score of any (row, ids)."""
    bm = index.bm25
    ptr, ids, imp = (np.asarray(x) for x in (bm.indptr, bm.doc_ids,
                                               bm.impact))
    width = 8 * k
    vals = np.full((terms.shape[0], width), -np.inf)
    out = np.full((terms.shape[0], width), -1, np.int64)
    totals = []
    for r in range(terms.shape[0]):
        tot = {}
        for t in terms[r][terms[r] >= 0]:
            for d, v in zip(ids[ptr[t]:ptr[t + 1]], imp[ptr[t]:ptr[t + 1]]):
                tot[int(d)] = tot.get(int(d), 0.0) + float(v)
        totals.append(tot)
        items = sorted(tot.items(), key=lambda kv: (-kv[1], kv[0]))[:width]
        for j, (d, v) in enumerate(items):
            out[r, j], vals[r, j] = d, v

    def score_of(r, got):
        return np.asarray([totals[r].get(int(d), -np.inf) if d >= 0
                           else -np.inf for d in got])

    return (*exact_order(vals, out, k), score_of)


# The sparse BM25 route's segment totals come from a cumsum difference
# (ops/bm25.py): accurate to a few ulp of the running sum (<= 256 here),
# so BM25 scores get an absolute tolerance of 1e-4 as well.
BM25_ATOL = 1e-4


# --- phases -------------------------------------------------------------

class Phase:
    def __init__(self, dev):
        self.dev = dev

    def run(self, name, fn):
        watch()
        t0 = time.perf_counter()
        info = fn()
        info["seconds"] = round(time.perf_counter() - t0, 2)
        stats = self.dev.memory_stats() or {}
        info["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
        print(f"phase {name}: {json.dumps(info)}", flush=True)


def compile_info(retr, *args):
    t0 = time.perf_counter()
    compiled = retr.lower(*args).compile()
    ma = compiled.memory_analysis()
    return round(time.perf_counter() - t0, 2), int(ma.temp_size_in_bytes)


def served_reference(n_docs=9728, dim=2048, vocab=20000):
    from a_nice_rag_tpu.index import build_index, load_index, save_index
    from a_nice_rag_tpu.serving.serve_cli import build_state, serve_state
    from a_nice_rag_tpu.testing import (
        GoldenBm25Okapi,
        golden_top_k,
        golden_wrrf,
        synth_corpus,
    )

    nq, t_max, k, n_out, wk = 64, 16, 25, 15, 40.0
    weights = {MODEL: 5.0, "BM25": 1.0}
    c = synth_corpus(
        n_docs=n_docs, dim=dim, n_queries=nq, vocab_size=vocab, seed=7,
        model_noise={MODEL: 0.22}, query_token_noise=0.15,
    )
    built = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                        embeddings=c.embeddings, token_lists=c.tokens)
    with tempfile.TemporaryDirectory() as tmp:
        save_index(built, tmp)
        index = load_index(tmp)
    del built
    check(index.bm25_dense is not None, "dense-impact BM25 expected")
    q = np.asarray(c.query_embeddings[MODEL], np.float32)
    terms = np.asarray(index.pad_term_ids(c.query_tokens, t_max), np.int32)

    # Plain reference: float64 dense scores, Okapi BM25 from the corpus
    # tokens, dict-accumulated WRRF.
    emb = np.asarray(c.embeddings[MODEL], np.float64)
    dense = q.astype(np.float64) @ emb.T
    okapi = GoldenBm25Okapi(c.tokens)
    bm25 = np.stack([okapi.get_scores(c.query_tokens[i][:t_max])
                     for i in range(nq)])
    upper = np.char.upper(np.asarray(c.sources))
    filters = {None: None,
               "CG,NG": np.char.startswith(upper, "CG")
               | np.char.startswith(upper, "NG")}
    golden = {}
    for filt, mask in filters.items():
        dv, di = golden_top_k(dense, k + 1, mask)
        bv, bi = golden_top_k(bm25, k + 1, mask)
        rows, exempt = [], []
        for r in range(nq):
            lists = [([c.ids[i] for i in di[r, :k] if i >= 0], MODEL),
                     ([c.ids[i] for i in bi[r, :k] if i >= 0], "BM25")]
            fused = golden_wrrf(lists, weights, k=int(wk))
            fv = np.asarray([s for _, s in fused[: n_out + 1]])
            rows.append([index.meta.id_to_row[s] for s, _ in fused[:n_out]])
            exempt.append(near_tie(dv[r], k) or near_tie(bv[r], k)
                          or near_tie(fv, n_out))
        golden[filt] = (rows, exempt)

    state = build_state(
        index, (MODEL,), use_bm25=True,
        scheduler_kwargs={"max_batch": 64, "max_wait_ms": 2.0},
    )
    check(not state.retriever.route.stream, state.retriever.route)
    compile_s = {}
    for b in (1, nq):
        compile_s[f"B={b}"], _ = compile_info(
            state.retriever, {MODEL: q[:b]}, terms[:b], weights, "CG,NG", wk)
    server = serve_state(state, weights, host="127.0.0.1", port=0,
                         background=True)
    port = server.server_address[1]
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)

    def post(body):
        conn.request("POST", "/v1/search", json.dumps(body),
                     {"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = json.loads(resp.read())
        if resp.status != 200:
            raise AssertionError(f"/v1/search {resp.status}: {data}")
        return data

    checks = agree = 0
    n_requests = 0
    try:
        for r in range(24):
            filt = "CG,NG" if r % 2 else None
            out = post({"query_embedding": q[r].tolist(),
                        "terms": terms[r].tolist(), "model_weights": weights,
                        "filename_type_filter": filt, "wrrf_k": wk})
            n_requests += 1
            got = [index.meta.id_to_row[d["id"]] for d in out["results"]]
            want, exempt = golden[filt][0][r], golden[filt][1][r]
            checks += 1
            if got == want:
                agree += 1
            elif not exempt:
                raise AssertionError(
                    f"served B=1 query {r} filter {filt}: {got} != {want}")
        for rep in range(8):
            filt = "CG,NG" if rep % 2 else None
            out = post({
                "query_embeddings_b64": base64.b64encode(q.tobytes()).decode(),
                "shape": list(q.shape),
                "terms_b64": base64.b64encode(terms.tobytes()).decode(),
                "terms_shape": list(terms.shape),
                "model_weights": weights, "filename_type_filter": filt,
                "wrrf_k": wk,
            })
            n_requests += 1
            rows = np.frombuffer(base64.b64decode(out["rows_b64"]),
                                 np.int32).reshape(out["out_shape"])
            for r in range(nq):
                got = [int(x) for x in rows[r] if x >= 0]
                want, exempt = golden[filt][0][r], golden[filt][1][r]
                checks += 1
                if got == want:
                    agree += 1
                elif not exempt:
                    raise AssertionError(
                        f"served B={nq} query {r} filter {filt}: "
                        f"{got} != {want}")
    finally:
        conn.close()
        server.shutdown()
    check(agree >= checks // 2, (agree, checks))
    return {"route": "materialize (xla)", "requests": n_requests,
            "compile_s": compile_s,
            "fused_ids_equal": f"{agree}/{checks} "
                               f"({checks - agree} differ at near-ties)"}


def stream_2m(b=256, k=32, n_ref=32):
    import jax
    import jax.numpy as jnp

    from a_nice_rag_tpu.ops.streaming import dense_stream_top_k
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing import golden_wrrf
    from a_nice_rag_tpu.testing.scale import hybrid_2m

    c = hybrid_2m(b=b)
    index = c.index
    n = index.n_docs
    weights = {MODEL: 5.0, "BM25": 1.0}
    retr = FusedRetriever(index, (MODEL,), use_bm25=True, similarity_k=k,
                          common_sections_n=k, budget=1024)
    check(retr.route.stream and retr.route.kernel, retr.route)
    qd = {MODEL: c.queries}
    compile_s, temp = compile_info(retr, qd, c.terms, weights, None, 40.0)
    check(temp < b * n * 4, f"temp {temp} >= B*N*4 {b * n * 4}")
    fids, _, lists = jax.block_until_ready(
        retr.retrieve_device(qd, c.terms, weights, None, 40.0))
    fids, lists = np.asarray(fids), np.asarray(lists)

    emb = index.dense[MODEL]
    q16 = c.queries[:n_ref].astype(jnp.bfloat16)
    dot = jax.jit(lambda q, e: jax.lax.dot_general(
        q, e, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    dv, di = chunked_top_k(
        lambda r0, sz: dot(q16, jax.lax.dynamic_slice_in_dim(emb, r0, sz)),
        n, k + 1)
    dense_agree = compare("stream-2m dense", lists[0][:n_ref], di, dv, k)
    kv, ki = dense_stream_top_k(emb, c.queries[:n_ref], k, retr.route)
    compare("stream-2m kernel scores", ki, di, dv, k, got_vals=kv)

    bv, bi, bscore = bm25_reference(index, np.asarray(c.terms)[:n_ref],
                                    k + 1)
    bm25_agree = compare("stream-2m bm25", lists[1][:n_ref], bi, bv, k,
                         atol=BM25_ATOL, score_of=bscore)

    # Fusion, given the route's own two lists: WRRF by the dict
    # reference must give the same fused ids (rows with tied fused
    # scores aside).
    fused_ok = 0
    for r in range(b):
        ranked = [([int(x) for x in lists[j][r] if x >= 0], name)
                  for j, name in enumerate((MODEL, "BM25"))]
        fused = golden_wrrf(ranked, weights, k=40)
        fv = np.asarray([v for _, v in fused[: k + 1]])
        if near_tie(fv, k):
            continue
        want = [x for x, _ in fused[:k]]
        check([int(x) for x in fids[r][: len(want)]] == want, (r, want))
        fused_ok += 1
    check(fused_ok >= b // 2, fused_ok)
    recall = float(np.mean([c.gold[r] in fids[r, :10] for r in range(b)]))
    check(recall >= 0.99, f"planted recall@10 {recall}")
    return {"route": "stream (pallas triton kernel)", "compile_s": compile_s,
            "temp_bytes": temp, "B*N*4": b * n * 4,
            "dense_ids": dense_agree, "bm25_ids": bm25_agree,
            "fused_rows_equal": f"{fused_ok}/{b}",
            "recall@10_planted": recall}


def stream_int8_10m(b=256, k=25, n_ref=16):
    import jax
    import jax.numpy as jnp

    from a_nice_rag_tpu.ops.quantized import quantize_queries
    from a_nice_rag_tpu.ops.streaming import dense_stream_top_k
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing.scale import int8_10m

    c = int8_10m(b=b)
    index = c.index
    n = index.n_docs
    w = {MODEL: 1.0}
    retr = FusedRetriever(index, (MODEL,), use_bm25=False, similarity_k=k,
                          common_sections_n=k)
    check(retr.route.stream and retr.route.kernel, retr.route)
    qd = {MODEL: c.queries}
    compile_s, temp = compile_info(retr, qd, None, w, None, 40.0)
    check(temp < b * n * 4, f"temp {temp} >= B*N*4 {b * n * 4}")
    fids = np.asarray(jax.block_until_ready(
        retr.retrieve_device(qd, None, w, None, 40.0)[0]))

    # Reference: the same int8 queries, exact int32 dot products, the
    # f32 rescale on the host.
    mat = index.dense_q[MODEL]
    qv, qs = quantize_queries(c.queries[:n_ref])
    qs_h = np.asarray(qs, np.float32)
    dot = jax.jit(lambda q, v: jax.lax.dot_general(
        q, v, (((1,), (1,)), ((), ())), preferred_element_type=jnp.int32))

    def chunk(r0, sz):
        acc = np.asarray(dot(qv, jax.lax.dynamic_slice_in_dim(
            mat.values, r0, sz))).astype(np.float32)
        es = np.asarray(jax.lax.dynamic_slice_in_dim(mat.scales, r0, sz))
        return acc * qs_h[:, None] * es[None, :]

    rv, ri = chunked_top_k(chunk, n, k)
    agree = compare("stream-int8-10m", fids[:n_ref], ri, rv, k, exact=True)
    kv, ki = dense_stream_top_k(mat, c.queries[:n_ref], k, retr.route)
    compare("stream-int8-10m kernel scores", ki, ri, rv, k, exact=True,
            got_vals=kv)
    recall = float(np.mean([c.gold[r] in fids[r, :10] for r in range(b)]))
    check(recall >= 0.95, f"planted recall@10 {recall}")
    return {"route": "stream (pallas triton kernel, int8)",
            "compile_s": compile_s, "temp_bytes": temp, "B*N*4": b * n * 4,
            "ids_bit_equal": agree, "recall@10_planted": recall}


def ivf_2m(b=16, nprobe=16, k=10):
    import jax
    import jax.numpy as jnp

    from a_nice_rag_tpu.index.ivf import attach_ivf, build_tile_table
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.retrieval.engine import _ivf_coverage
    from a_nice_rag_tpu.testing.scale import clustered_2m

    c = clustered_2m(b=b)
    index = c.index
    n = index.n_docs
    t0 = time.perf_counter()
    iv = attach_ivf(index, MODEL, tile_n=1024, n_iters=10, seed=0)
    jax.block_until_ready(iv.emb)
    build_s = round(time.perf_counter() - t0, 2)
    cov = _ivf_coverage(b, nprobe, iv.n_clusters)
    retr = FusedRetriever(index, (MODEL,), use_bm25=False, similarity_k=k,
                          common_sections_n=k, nprobe=nprobe)
    check(cov <= retr.ivf_max_coverage, cov)
    w = {MODEL: 1.0}
    qd = {MODEL: c.queries}
    compile_s, temp = compile_info(retr, qd, None, w, None, 40.0)
    fids = np.asarray(jax.block_until_ready(
        retr.retrieve_device(qd, None, w, None, 40.0)[0]))

    # Reference: score every row of the same tile table, plainly.
    mt = min(iv.n_tiles, b * nprobe * iv.max_cluster_tiles)
    table, n_uniq = build_tile_table(
        iv.centroids, iv.cluster_start, c.queries, nprobe=nprobe,
        max_tiles=mt, tile_n=iv.tile_n, mct=iv.max_cluster_tiles)
    tiles = np.asarray(table)
    tiles = tiles[tiles >= 0]
    rows = (tiles[:, None] * iv.tile_n + np.arange(iv.tile_n)).reshape(-1)
    rows = rows[rows < iv.n_real]
    sub = jnp.take(iv.emb, jnp.asarray(rows), axis=0)
    s = np.asarray(jax.lax.dot_general(
        c.queries.astype(jnp.bfloat16), sub, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32), np.float64)
    pv, pi = exact_order(s, np.broadcast_to(rows, s.shape), k + 1)
    perm = np.asarray(iv.perm)
    ref_ids = np.where(pi >= 0, perm[np.clip(pi, 0, None)], -1)
    agree = compare("ivf-2m", fids, ref_ids, pv, k)

    emb = index.dense[MODEL]
    dot = jax.jit(lambda q, e: jax.lax.dot_general(
        q, e, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32))
    _, exact = chunked_top_k(
        lambda r0, sz: dot(c.queries.astype(jnp.bfloat16),
                           jax.lax.dynamic_slice_in_dim(emb, r0, sz)),
        n, 10)
    recall = float(np.mean([len(set(fids[r, :10]) & set(exact[r]))
                            for r in range(b)]) / 10)
    return {"route": "ivf probe (pallas triton kernel, tile table)",
            "coverage": round(cov, 4), "clusters": iv.n_clusters,
            "tiles_scanned": int(len(tiles)), "n_tiles": iv.n_tiles,
            "build_s": build_s, "compile_s": compile_s,
            "ids_vs_same_tiles": agree, "recall@10_vs_exact": recall}


def kernel_cases(dev):
    import importlib.util

    # By path: an installed package named "tests" may shadow the repo's.
    path = os.path.join(REPO, "tests", "test_stream_topk.py")
    spec = importlib.util.spec_from_file_location("_stream_topk_cases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    t0 = time.perf_counter()
    for case in mod.GPU_CASES:
        mod.check_compiled_kernel(dev, case)
    return {"cases": len(mod.GPU_CASES), "all_exact": True,
            "compile_and_run_s": round(time.perf_counter() - t0, 2)}


def four_cards(n_cards=4):
    """Sharded path over a (1, n_cards) mesh; ids equal to a
    single-device FusedRetriever on device 0."""
    import jax

    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.parallel import make_mesh, shard_index, shard_ivf
    from a_nice_rag_tpu.parallel.sharded import ShardedRetriever
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.serving.serve_cli import build_state, serve_state
    from a_nice_rag_tpu.testing import synth_corpus
    from a_nice_rag_tpu.testing.scale import hybrid_2m, int8_10m

    import jax.numpy as jnp

    devs = jax.devices()[:n_cards]
    mesh = make_mesh(shape=(1, n_cards), axis_names=("dp", "corpus"),
                     devices=devs)
    out = {}
    t0 = time.perf_counter()

    def step(what):
        watch()
        print(f"four-cards step {what}: {time.perf_counter() - t0:.1f}s",
              flush=True)

    for name, make, bm25, k in (("stream-2m", hybrid_2m, True, 32),
                                ("stream-int8-10m", int8_10m, False, 25)):
        t0 = time.perf_counter()
        with jax.default_device(devs[0]):
            c = make()
            step(f"{name} corpus")
            single = FusedRetriever(c.index, (MODEL,), use_bm25=bm25,
                                    similarity_k=k, common_sections_n=k,
                                    budget=1024)
            w = {MODEL: 5.0, "BM25": 1.0} if bm25 else {MODEL: 1.0}
            want = np.asarray(single.retrieve_device(
                {MODEL: c.queries}, c.terms, w, None, 40.0)[0])
            tied = np.zeros(want.shape[0], bool)
            if bm25:
                # Per-shard and whole-corpus BM25 sum in another order,
                # and bf16 scores may tie: rows whose reference lists
                # hold a near-tie may differ (section C's rule).
                bv, _, _ = bm25_reference(c.index, np.asarray(c.terms),
                                          k + 1)
                dense_ids = np.asarray(FusedRetriever(
                    c.index, (MODEL,), use_bm25=False, similarity_k=k + 1,
                    common_sections_n=k + 1).retrieve_device(
                    {MODEL: c.queries}, None, {MODEL: 1.0})[0])
                e = c.index.dense[MODEL]
                dvals = np.asarray(jnp.einsum(
                    "bd,bkd->bk", c.queries.astype(jnp.bfloat16),
                    jnp.take(e, jnp.asarray(dense_ids), axis=0),
                    preferred_element_type=jnp.float32), np.float64)
                tied = np.asarray([
                    near_tie(bv[r], k, BM25_ATOL) or near_tie(dvals[r], k)
                    for r in range(want.shape[0])])
                del e
        step(f"{name} single-card reference")
        sidx = shard_index(c.index, mesh)
        step(f"{name} shard_index")
        # Copies to the other cards run asynchronously: wait for them
        # here, so a slow copy and a slow program show as separate steps.
        jax.block_until_ready(sidx.dense)
        step(f"{name} shard_index rows on every card")
        sharded = ShardedRetriever(sidx, (MODEL,), use_bm25=bm25,
                                   similarity_k=k, common_sections_n=k,
                                   budget=1024)
        check(sharded.route.stream and sharded.route.kernel, sharded.route)

        def same(ids, what):
            rows = (ids != want).any(axis=1)
            check(not (rows & ~tied).any(), (
                f"{name} {what}: ids differ in rows "
                f"{np.nonzero(rows & ~tied)[0][:8]}"))
            return (f"{int((~rows).sum())}/{len(rows)} "
                    f"({int(rows.sum())} differ at near-ties)")

        got = np.asarray(sharded.retrieve_device(
            {MODEL: c.queries}, c.terms, w, None, 40.0)[0])
        res = {"route": "stream (pallas triton kernel) per shard",
               "exact_rows_equal": same(got, "exact")}
        step(f"{name} sharded exact")
        # IVF per shard: a full probe must reproduce the exact ids; a
        # partial probe is approximate (recall reported).
        sidx_ivf = shard_ivf(sidx, MODEL, tile_n=1024, n_iters=4)
        c_shard = int(sidx_ivf.ivf_centroids.shape[1])
        step(f"{name} shard_ivf ({c_shard} clusters per shard)")
        for nprobe, route in ((c_shard, "always"), (16, "always")):
            r = ShardedRetriever(sidx_ivf, (MODEL,), use_bm25=bm25,
                                 similarity_k=k, common_sections_n=k,
                                 budget=1024, nprobe=nprobe, ivf_route=route)
            ids = np.asarray(r.retrieve_device(
                {MODEL: c.queries}, c.terms, w, None, 40.0)[0])
            step(f"{name} sharded ivf nprobe={nprobe}")
            if nprobe == c_shard:
                res["ivf_full_probe_rows_equal"] = same(ids, "full probe")
            else:
                res["ivf_nprobe16_overlap@k"] = round(float(np.mean([
                    len(set(ids[i]) & set(want[i])) / k
                    for i in range(ids.shape[0])])), 4)
        res["seconds"] = round(time.perf_counter() - t0, 2)
        print(f"four-cards {name}: {json.dumps(res)}", flush=True)
        out[name] = res
        del c, single, sidx, sidx_ivf, sharded, r

    # serve_cli with shards=n_cards answering /v1/search.
    cs = synth_corpus(n_docs=9728, dim=2048, n_queries=8, vocab_size=20000,
                      seed=7, model_noise={MODEL: 0.22},
                      query_token_noise=0.15)
    index = build_index(ids=cs.ids, sources=cs.sources, contents=cs.contents,
                        embeddings=cs.embeddings, token_lists=cs.tokens)
    weights = {MODEL: 5.0, "BM25": 1.0}
    terms = index.pad_term_ids(cs.query_tokens, 16)
    with jax.default_device(devs[0]):
        single = FusedRetriever(index, (MODEL,), use_bm25=True)
        want = np.asarray(single.retrieve_device(
            {MODEL: cs.query_embeddings[MODEL]}, terms, weights, None,
            40.0)[0])
    state = build_state(index, (MODEL,), use_bm25=True, shards=n_cards)
    server = serve_state(state, weights, host="127.0.0.1", port=0,
                         background=True)
    conn = http.client.HTTPConnection("127.0.0.1", server.server_address[1],
                                      timeout=300)
    try:
        for r in range(8):
            conn.request("POST", "/v1/search", json.dumps({
                "query_embedding": cs.query_embeddings[MODEL][r].tolist(),
                "terms": terms[r].tolist(), "model_weights": weights}),
                {"Content-Type": "application/json"})
            resp = conn.getresponse()
            data = json.loads(resp.read())
            check(resp.status == 200, data)
            got = [index.meta.id_to_row[d["id"]] for d in data["results"]]
            check(got == [int(x) for x in want[r] if x >= 0], (r, got))
    finally:
        conn.close()
        server.shutdown()
    print(f"four-cards serve_cli shards={n_cards}: 8 /v1/search requests, "
          "ids equal to the single-device retriever", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path over four cards")
    args = ap.parse_args()
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    want_count = 4 if args.four_cards else 1
    if len(devices) < want_count:
        print(f"chip_smoke: needs {want_count} GPUs, found {len(devices)}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    from a_nice_rag_tpu.utils.compile_cache import enable_compile_cache

    print(card_line(), flush=True)
    print(f"jax: {jax.__version__}; compile cache: {enable_compile_cache()}",
          flush=True)
    dev = devices[0]
    if args.four_cards:
        four_cards()
    else:
        with jax.default_device(dev):
            ph = Phase(dev)
            ph.run("served-reference", served_reference)
            ph.run("stream-2m", stream_2m)
            ph.run("stream-int8-10m", stream_int8_10m)
            ph.run("ivf-2m", ivf_2m)
            ph.run("kernel-cases", lambda: kernel_cases(dev))
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": want_count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
