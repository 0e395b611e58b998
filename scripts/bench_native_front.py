"""Measure E2E served QPS: native binary front vs Python HTTP front.

Same headline corpus and client-batched traffic shape as bench.py's
served stage (512-row frames, 8 concurrent clients) so the two fronts
are directly comparable. Runs on the default platform.
"""
import argparse
import base64
import http.client
import json
import threading
import time

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--n-docs", type=int, default=9728)
    p.add_argument("--dim", type=int, default=2048)
    p.add_argument("--batch", type=int, default=512)
    p.add_argument("--clients", type=int, default=8)
    p.add_argument("--per", type=int, default=5)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--skip-http", action="store_true")
    args = p.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", 8)

    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.serving.native_front import (
        NativeFrontClient,
        NativeRetrievalFront,
    )
    from a_nice_rag_tpu.serving.serve_cli import build_state, serve_state
    from a_nice_rag_tpu.testing import synth_corpus

    T_MAX = 32
    c = synth_corpus(
        n_docs=args.n_docs, dim=args.dim, n_queries=args.batch,
        vocab_size=30000, seed=7,
        model_noise={"voyage-3-large": 0.22}, query_token_noise=0.15,
    )
    index = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    weights = {"voyage-3-large": 5.0, "BM25": 1.0}
    state = build_state(
        index, ("voyage-3-large",), use_bm25=True,
        scheduler_kwargs={"max_batch": 512, "max_wait_ms": 2.0,
                          "max_inflight": 6},
    )
    B = args.batch
    q = np.asarray(c.query_embeddings["voyage-3-large"][:B], np.float32)
    terms = np.asarray(index.pad_term_ids(c.query_tokens[:B], T_MAX),
                       np.int32)

    # ---------------- native front ----------------
    front = NativeRetrievalFront(
        state.retriever, weights, port=0, t_max=T_MAX, max_batch=512,
        wait_ms=2.0,
    )
    lat_n, errs = [], []

    def native_client(n_req):
        try:
            with NativeFrontClient("127.0.0.1", front.port) as cl:
                for _ in range(n_req):
                    t0 = time.perf_counter()
                    rows, _ = cl.search(q, terms)
                    assert rows.shape[0] == B
                    lat_n.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))

    # Warm with the SAME concurrency pattern as the measured phase:
    # coalesced batch sizes vary with arrival timing, and each distinct
    # power-of-two bucket compiles its own program — an uncovered
    # bucket inside the measured window would bench the compiler.
    warm = [threading.Thread(target=native_client, args=(2,))
            for _ in range(args.clients)]
    for t in warm:
        t.start()
    for t in warm:
        t.join()
    native_client(1)  # single-frame bucket too
    if errs:
        raise SystemExit(f"native front warm errors: {errs[:3]}")
    lat_n.clear()
    threads = [threading.Thread(target=native_client, args=(args.per,))
               for _ in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_n = time.perf_counter() - t0
    if errs:
        raise SystemExit(f"native front errors: {errs[:3]}")
    native_qps = len(lat_n) * B / wall_n
    print(json.dumps({
        "front": "native", "qps": round(native_qps, 1),
        "p50_batch_ms": round(float(np.median(lat_n)) * 1e3, 2),
        "batches_run": front.batches_run,
        "stats": front.stats(),
    }))
    front.stop()

    if args.skip_http:
        return

    # ---------------- HTTP front ----------------
    server = serve_state(state, weights, host="127.0.0.1", port=0,
                         background=True)
    port = server.server_address[1]
    body = json.dumps({
        "query_embeddings_b64": base64.b64encode(q.tobytes()).decode(),
        "shape": list(q.shape),
        "terms_b64": base64.b64encode(terms.tobytes()).decode(),
        "terms_shape": list(terms.shape),
        "model_weights": weights,
    })
    lat_h = []

    def http_client_fn(n_req):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            for _ in range(n_req):
                t0 = time.perf_counter()
                conn.request("POST", "/v1/search", body,
                             {"Content-Type": "application/json"})
                r = conn.getresponse()
                data = r.read()
                assert r.status == 200, data[:200]
                out = json.loads(data)
                rows = np.frombuffer(
                    base64.b64decode(out["rows_b64"]), np.int32
                ).reshape(out["out_shape"])
                assert rows.shape[0] == B
                lat_h.append(time.perf_counter() - t0)
        except Exception as e:  # noqa: BLE001
            errs.append(repr(e))
        finally:
            conn.close()

    warm = [threading.Thread(target=http_client_fn, args=(2,))
            for _ in range(args.clients)]
    for t in warm:
        t.start()
    for t in warm:
        t.join()
    if errs:
        raise SystemExit(f"http front warm errors: {errs[:3]}")
    lat_h.clear()
    threads = [threading.Thread(target=http_client_fn, args=(args.per,))
               for _ in range(args.clients)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall_h = time.perf_counter() - t0
    server.shutdown()
    if errs:
        raise SystemExit(f"http front errors: {errs[:3]}")
    http_qps = len(lat_h) * B / wall_h
    print(json.dumps({
        "front": "http", "qps": round(http_qps, 1),
        "p50_batch_ms": round(float(np.median(lat_h)) * 1e3, 2),
    }))
    print(json.dumps({"native_vs_http": round(native_qps / http_qps, 2)}))


if __name__ == "__main__":
    main()
