"""Stage-level device-side latency at B=1 on the reference-scale corpus.

Each timing is N calls ended by ``block_until_ready``, divided by N.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np


def timeit(fn, *args, n=50):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / n * 1e3


def main():
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.testing import synth_corpus
    from a_nice_rag_tpu.ops.dense import dense_top_k
    from a_nice_rag_tpu.ops.bm25 import bm25_scores_dense
    from a_nice_rag_tpu.ops.topk import masked_top_k
    from a_nice_rag_tpu.retrieval import FusedRetriever

    print("platform:", jax.devices()[0].platform)
    c = synth_corpus(n_docs=9728, dim=2048, n_queries=8, vocab_size=20000, seed=7)
    index = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    terms = jnp.asarray(index.pad_term_ids(c.query_tokens, 16))[:1]
    q = jnp.asarray(c.query_embeddings["voyage-3-large"])[:1]
    emb = index.dense["voyage-3-large"]
    print("emb", emb.shape, emb.dtype, "impact", index.bm25_dense.impact.shape,
          index.bm25_dense.impact.dtype)

    t = timeit(lambda: dense_top_k(emb, q, 25))
    print(f"dense_top_k B=1: {t:.3f} ms")

    t = timeit(lambda: bm25_scores_dense(index.bm25_dense, terms))
    print(f"bm25_scores_dense B=1: {t:.3f} ms")

    @jax.jit
    def bm25_gather(impact, qt):
        safe = jnp.where(qt >= 0, qt, 0)
        rows = jnp.take(impact, safe.reshape(-1), axis=0)
        w = (qt >= 0).reshape(-1, 1).astype(impact.dtype)
        return (rows * w).sum(axis=0, keepdims=True)

    ref = np.asarray(bm25_scores_dense(index.bm25_dense, terms))
    got = np.asarray(bm25_gather(index.bm25_dense.impact, terms))
    print("gather max abs diff:", np.abs(ref - got).max())
    t = timeit(lambda: bm25_gather(index.bm25_dense.impact, terms))
    print(f"bm25_gather B=1: {t:.3f} ms")

    scores = jnp.asarray(np.random.randn(1, index.n_docs_padded).astype(np.float32))
    t = timeit(lambda: masked_top_k(scores, 25))
    print(f"masked_top_k B=1: {t:.3f} ms")

    r = FusedRetriever(index, model_names=("voyage-3-large",), use_bm25=True,
                       similarity_k=25, common_sections_n=15)
    w = {"voyage-3-large": 5.0, "BM25": 1.0}
    qd = {"voyage-3-large": q}
    t = timeit(lambda: r.retrieve_device(qd, terms, w, None, 40.0))
    print(f"FusedRetriever full B=1: {t:.3f} ms")


if __name__ == "__main__":
    main()
