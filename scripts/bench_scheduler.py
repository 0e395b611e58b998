"""In-process scheduler characterization: no HTTP in the overhead
numbers. This benchmark isolates the scheduler itself:

1. **null-retriever mode** — the device program is replaced by an
   instant in-process stub, so sustained QPS / added latency measure the
   scheduler's own queueing + batching + future plumbing, nothing else.
2. **device mode** — the same closed-loop submit pattern against the
   real FusedRetriever device program; the null number is the
   scheduler's own.

Usage:
    python scripts/bench_scheduler.py [n_clients] [seconds]
"""
import asyncio
import functools
import os
import sys
import time

print = functools.partial(print, flush=True)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


class _NullRetriever:
    """Instant retriever stub matching FusedRetriever's serving API."""

    model_names = ("voyage-3-large",)
    use_bm25 = True

    def __init__(self, n_out: int = 15):
        self.n_out = n_out

    def retrieve_device(self, q_embs, terms, weights, filt, wrrf_k):
        b = next(iter(q_embs.values())).shape[0]
        ids = np.tile(np.arange(self.n_out, dtype=np.int32), (b, 1))
        vals = np.ones((b, self.n_out), np.float32)
        return ids, vals, None


async def closed_loop(sched, make_query, n_clients: int, seconds: float):
    """n_clients concurrent submitters, each issuing back-to-back
    queries for ``seconds``. Returns (qps, p50_ms, p99_ms)."""
    latencies = []
    stop_at = time.perf_counter() + seconds

    async def client(ci):
        q_emb, q_terms = make_query(ci)
        while time.perf_counter() < stop_at:
            t0 = time.perf_counter()
            await sched.submit(q_emb, q_terms)
            latencies.append(time.perf_counter() - t0)

    await sched.start()
    t0 = time.perf_counter()
    await asyncio.gather(*(client(i) for i in range(n_clients)))
    wall = time.perf_counter() - t0
    await sched.stop()
    lat = np.asarray(latencies) * 1e3
    return len(latencies) / wall, float(np.percentile(lat, 50)), float(
        np.percentile(lat, 99)
    )


async def main():
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.serving import BatchScheduler
    from a_nice_rag_tpu.testing import synth_corpus

    n_clients = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    seconds = float(sys.argv[2]) if len(sys.argv) > 2 else 5.0

    dim = 256
    rng = np.random.default_rng(0)

    def make_query_null(ci):
        return {"voyage-3-large": rng.standard_normal(dim).astype(np.float32)}, \
            np.asarray([1, 2, 3], np.int32)

    # 1) Scheduler-only overhead: null retriever.
    sched = BatchScheduler(
        _NullRetriever(), {"voyage-3-large": 1.0}, max_batch=256,
        max_wait_ms=2.0, t_max=16,
    )
    qps, p50, p99 = await closed_loop(
        sched, make_query_null, n_clients, seconds
    )
    print(f"null-retriever : {qps:10.0f} QPS  p50={p50:6.2f} ms  "
          f"p99={p99:6.2f} ms  (scheduler-added latency; "
          f"{sched.batches_run} batches, "
          f"avg {sched.queries_served / max(sched.batches_run, 1):.0f}/batch)")

    # 2) Same loop against the real device program.
    import jax

    c = synth_corpus(n_docs=9728, dim=dim, n_queries=64, seed=3,
                     vocab_size=2000)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      embeddings=c.embeddings, token_lists=c.tokens)
    fr = FusedRetriever(idx, ("voyage-3-large",), use_bm25=True,
                        similarity_k=25, common_sections_n=15)
    terms = idx.pad_term_ids(c.query_tokens, 16)

    def make_query_dev(ci):
        qi = ci % 64
        return ({"voyage-3-large": c.query_embeddings["voyage-3-large"][qi]},
                terms[qi])

    # Warm the compile cache for the power-of-two buckets.
    sched = BatchScheduler(fr, {"voyage-3-large": 5.0, "BM25": 1.0},
                           max_batch=256, max_wait_ms=2.0, t_max=16)
    qps, p50, p99 = await closed_loop(
        sched, make_query_dev, n_clients, seconds
    )
    plat = jax.devices()[0].platform
    print(f"device ({plat:>4s}) : {qps:10.0f} QPS  p50={p50:6.2f} ms  "
          f"p99={p99:6.2f} ms  ({sched.batches_run} batches, "
          f"avg {sched.queries_served / max(sched.batches_run, 1):.0f}/batch)")


if __name__ == "__main__":
    asyncio.run(main())
