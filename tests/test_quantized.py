"""Int8 quantized scoring: fidelity vs f32 path."""

import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.ops.dense import dense_top_k
from a_nice_rag_tpu.ops.quantized import (
    quantize_embeddings,
    quantized_dense_top_k,
)
from a_nice_rag_tpu.testing import synth_corpus


def test_quantized_scores_close_and_recall_preserved():
    c = synth_corpus(n_docs=600, dim=128, n_queries=32, seed=161)
    emb = c.embeddings["voyage-3-large"]
    q = c.query_embeddings["voyage-3-large"]
    qd = quantize_embeddings(jnp.asarray(emb))
    assert qd.values.dtype == jnp.int8
    v8, i8 = quantized_dense_top_k(qd, jnp.asarray(q), 10)
    v32, i32 = dense_top_k(jnp.asarray(emb), jnp.asarray(q), 10)
    v8, i8 = np.asarray(v8), np.asarray(i8)
    v32, i32 = np.asarray(v32), np.asarray(i32)
    # Scores within quantization error.
    np.testing.assert_allclose(v8, v32, atol=0.02)
    # Top-1 (the planted gold) must agree for every query; the rest of
    # the list may permute among near-ties.
    np.testing.assert_array_equal(i8[:, 0], i32[:, 0])
    overlap = np.mean(
        [len(set(i8[b]) & set(i32[b])) / 10 for b in range(len(q))]
    )
    assert overlap >= 0.9, overlap


def test_quantized_memory_is_quarter():
    c = synth_corpus(n_docs=128, dim=64, n_queries=2, seed=163)
    emb = jnp.asarray(c.embeddings["voyage-3-large"])
    qd = quantize_embeddings(emb)
    assert qd.values.size * qd.values.dtype.itemsize == emb.size * 1
    assert emb.size * emb.dtype.itemsize == 4 * qd.values.size


# ---------------------------------------------------------------------------
# Engine-level int8: a quantized index served end-to-end.


def _build_pair(n_docs=640, dim=128, n_queries=24, seed=7):
    from a_nice_rag_tpu.index import build_index

    c = synth_corpus(n_docs=n_docs, dim=dim, n_queries=n_queries, seed=seed,
                     vocab_size=3000)
    kw = dict(ids=c.ids, sources=c.sources, contents=c.contents,
              embeddings=c.embeddings, token_lists=c.tokens)
    return c, build_index(**kw), build_index(**kw, quantize_dense=True)


def test_quantized_index_build_and_roundtrip(tmp_path):
    from a_nice_rag_tpu.index import load_index, save_index

    c, idx_f32, idx_q = _build_pair()
    assert not idx_q.dense and idx_q.dense_q
    assert set(idx_q.dense_model_names) == set(idx_f32.dense)
    qd = idx_q.dense_q["voyage-3-large"]
    assert qd.values.dtype == jnp.int8

    save_index(idx_q, str(tmp_path / "qidx"))
    idx_r = load_index(str(tmp_path / "qidx"))
    qd_r = idx_r.dense_q["voyage-3-large"]
    np.testing.assert_array_equal(np.asarray(qd.values),
                                  np.asarray(qd_r.values))
    np.testing.assert_array_equal(np.asarray(qd.scales),
                                  np.asarray(qd_r.scales))


def test_fused_retriever_quantized_matches_f32_on_golds():
    """The hybrid fused program over an int8 index finds the same
    planted golds as the f32 index (XLA route and Pallas route)."""
    from a_nice_rag_tpu.retrieval import FusedRetriever

    c, idx_f32, idx_q = _build_pair()
    q = {"voyage-3-large": jnp.asarray(
        c.query_embeddings["voyage-3-large"])}
    terms = jnp.asarray(idx_q.pad_term_ids(c.query_tokens, 12))
    w = {"voyage-3-large": 5.0, "BM25": 1.0}
    gold_rows = np.array([idx_q.meta.id_to_row[g] for g in c.gold_ids])

    out = {}
    for name, idx, backend in [("f32", idx_f32, "auto"),
                               ("q_xla", idx_q, "auto"),
                               ("q_pallas", idx_q, "stream")]:
        fr = FusedRetriever(idx, ("voyage-3-large",), use_bm25=True,
                            similarity_k=15, common_sections_n=10,
                            dense_backend=backend,
                            interpret=backend == "stream")
        ids, vals, _ = fr.retrieve_device(q, terms, w)
        out[name] = np.asarray(ids)
    for name in ("q_xla", "q_pallas"):
        hit = (out[name] == gold_rows[:, None]).any(axis=1).mean()
        hit_f32 = (out["f32"] == gold_rows[:, None]).any(axis=1).mean()
        assert hit >= hit_f32 - 0.05, (name, hit, hit_f32)
    # The two int8 routes agree on the fused candidate SETS (rank-fusion
    # order may permute among RRF ties).
    for a, b in zip(out["q_xla"], out["q_pallas"]):
        assert set(a[a >= 0]) == set(b[b >= 0])


def test_search_engine_and_evaluator_accept_quantized_index():
    from a_nice_rag_tpu.evals.retrieval_eval import (
        STANDARD_CONFIGURATIONS,
        RetrievalEvaluator,
    )
    from a_nice_rag_tpu.retrieval import SearchEngine

    c, idx_f32, idx_q = _build_pair()
    eng = SearchEngine(idx_q)
    got = eng.retrieve(
        query_embeddings={"voyage-3-large":
                          c.query_embeddings["voyage-3-large"][:8]},
        query_texts=[" ".join(t) for t in c.query_tokens[:8]],
        query_token_lists=c.query_tokens[:8],
        similarity_k=15, common_sections_n=10, wrrf_k=40.0,
        model_weights={"voyage-3-large": 5.0, "BM25": 1.0},
        filename_type_filter=None,
        use_hybrid_search=True, use_reranker=False,
    )
    hits = sum(c.gold_ids[i] in got[i] for i in range(8))
    assert hits >= 6, hits

    ev = RetrievalEvaluator(idx_q, eng)
    m = ev.evaluate_config(
        STANDARD_CONFIGURATIONS[0],
        {"voyage-3-large": c.query_embeddings["voyage-3-large"]},
        c.gold_ids, c.query_tokens,
        [" ".join(t) for t in c.query_tokens], None,
    )
    assert m["recall@10"] > 0.7, m


def test_append_preserves_quantized_rows_bit_for_bit():
    from a_nice_rag_tpu.index.updates import append_documents

    c, _, idx_q = _build_pair(n_docs=256, n_queries=4)
    rng = np.random.default_rng(11)
    new_emb = rng.standard_normal((3, 128)).astype(np.float32)
    new_emb /= np.linalg.norm(new_emb, axis=1, keepdims=True)
    old_vals = np.asarray(idx_q.dense_q["voyage-3-large"].values).copy()
    models = list(c.embeddings)
    idx2 = append_documents(
        idx_q,
        ids=[f"new{i}" for i in range(3)],
        sources=["NG999"] * 3,
        contents=["new doc"] * 3,
        embeddings={m: new_emb for m in models},
        token_lists=[["term1", "term2"]] * 3,
    )
    qd2 = idx2.dense_q["voyage-3-large"]
    np.testing.assert_array_equal(
        np.asarray(qd2.values)[:256], old_vals[:256]
    )
    assert idx2.n_docs == 259
    # The appended docs are retrievable through the quantized path.
    from a_nice_rag_tpu.ops.quantized import (
        quantize_queries,
        quantized_dense_scores,
    )
    qv, qs = quantize_queries(jnp.asarray(new_emb))
    scores = np.asarray(
        quantized_dense_scores(qd2, qv, qs)
    )[:, :idx2.n_docs]
    assert (scores.argmax(axis=1) == np.array([256, 257, 258])).all()
