"""End-to-end engine parity: SearchEngine/FusedRetriever vs golden pipeline."""

import numpy as np
import pytest

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.retrieval import FusedRetriever, SearchEngine
from a_nice_rag_tpu.retrieval.rerank import IdentityReranker, apply_rerank
from a_nice_rag_tpu.testing import (
    GoldenBm25Okapi,
    golden_dense_top_k,
    golden_wrrf,
    synth_corpus,
)

MODELS = ["voyage-3-large", "text-embedding-3-large"]


@pytest.fixture(scope="module")
def setup():
    c = synth_corpus(n_docs=400, dim=48, n_queries=12, seed=31, models=MODELS)
    idx = build_index(
        ids=c.ids,
        sources=c.sources,
        contents=c.contents,
        urls=c.urls,
        embeddings=c.embeddings,
        token_lists=c.tokens,
    )
    eng = SearchEngine(idx, reranker=IdentityReranker())
    golden_bm25 = GoldenBm25Okapi(c.tokens)
    return c, idx, eng, golden_bm25


def test_similarity_search_with_embedding_parity(setup):
    c, idx, eng, _ = setup
    q = c.query_embeddings["voyage-3-large"][0]
    docs = eng.similarity_search_with_embedding(q, "voyage-3-large", 15)
    g_vals, g_idx = golden_dense_top_k(c.embeddings["voyage-3-large"], q, 15)
    assert [d["id"] for d in docs] == [c.ids[i] for i in g_idx]
    np.testing.assert_allclose(
        [d["similarity"] for d in docs], g_vals, rtol=1e-3, atol=1e-5
    )
    assert docs[0]["document"] == c.contents[g_idx[0]]
    assert docs[0]["url"] == c.urls[g_idx[0]]


def test_bm25_search_preprocessed_parity(setup):
    c, idx, eng, golden_bm25 = setup
    for qi in range(4):
        toks = c.query_tokens[qi]
        ids = eng.bm25_search_preprocessed(toks, similarity_k=10)
        scores = golden_bm25.get_scores(toks)
        # Every returned doc must score at least as high as the best
        # excluded one (ordering among exact ties may differ).
        got_scores = [scores[c.ids.index(i)] for i in ids]
        assert sorted(got_scores, reverse=True) == got_scores
        kth = sorted(scores, reverse=True)[9]
        assert all(s >= kth - 1e-9 for s in got_scores)


def test_filename_filter_respected(setup):
    c, idx, eng, _ = setup
    q = c.query_embeddings["voyage-3-large"][:3]
    ids_lists = eng.retrieve(
        {"voyage-3-large": q},
        model_weights={"voyage-3-large": 1.0},
        filename_type_filter="CG",
        similarity_k=20,
        common_sections_n=20,
    )
    for ids in ids_lists:
        assert ids, "filter should not empty the result"
        for sid in ids:
            src = c.sources[c.ids.index(sid)]
            assert src.upper().startswith("CG")


def test_retrieve_dense_only_matches_golden(setup):
    c, idx, eng, _ = setup
    q = c.query_embeddings["voyage-3-large"]
    got = eng.retrieve(
        {"voyage-3-large": q},
        model_weights={"voyage-3-large": 1.0},
        similarity_k=25,
        common_sections_n=15,
    )
    for b in range(len(q)):
        _, g_idx = golden_dense_top_k(c.embeddings["voyage-3-large"], q[b], 25)
        assert got[b] == [c.ids[i] for i in g_idx[:15]]


def test_retrieve_hybrid_matches_golden_pipeline(setup):
    c, idx, eng, golden_bm25 = setup
    weights = {
        "voyage-3-large": 5.0,
        "text-embedding-3-large": 2.0,
        "BM25": 1.0,
    }
    k, n, wk = 10, 8, 40.0
    got = eng.retrieve(
        query_embeddings={m: c.query_embeddings[m] for m in MODELS},
        query_token_lists=c.query_tokens,
        model_weights=weights,
        similarity_k=k,
        common_sections_n=n,
        wrrf_k=wk,
        use_hybrid_search=True,
    )
    for b in range(4):
        lists = []
        for m in MODELS:
            _, g_idx = golden_dense_top_k(
                c.embeddings[m], c.query_embeddings[m][b], k
            )
            lists.append(([c.ids[i] for i in g_idx], m))
        scores = golden_bm25.get_scores(c.query_tokens[b])
        top = np.argsort(scores)[::-1][:k]
        assert scores[top[-1]] > 0, "fixture should have >k positive scores"
        lists.append(([c.ids[i] for i in top], "BM25"))
        fused = golden_wrrf(lists, weights, k=int(wk))
        expect = [sid for sid, _ in fused[:n]]
        # Sets must match; order must match where fused scores are unique.
        assert set(got[b]) == set(expect)
        fused_scores = dict(fused)
        for i, sid in enumerate(expect):
            ties = sum(
                1
                for v in fused_scores.values()
                if abs(v - fused_scores[sid]) < 1e-12
            )
            if ties == 1:
                assert got[b][i] == sid


def test_retrieve_single_list_when_one_ranker(setup):
    c, idx, eng, _ = setup
    got = eng.retrieve(
        {"voyage-3-large": c.query_embeddings["voyage-3-large"][:2]},
        query_token_lists=c.query_tokens[:2],
        model_weights={"voyage-3-large": 0.0, "BM25": 1.0},
        use_hybrid_search=True,
        similarity_k=12,
        common_sections_n=5,
    )
    for b in range(2):
        expect = eng.bm25_search_preprocessed(c.query_tokens[b], 12)[:5]
        assert got[b] == expect


def test_retrieve_with_reranker_top_k(setup):
    c, idx, eng, _ = setup
    got = eng.retrieve(
        {"voyage-3-large": c.query_embeddings["voyage-3-large"][:1]},
        query_texts=["some query"],
        model_weights={"voyage-3-large": 1.0},
        use_reranker=True,
        reranker_top_k=3,
        common_sections_n=15,
        return_docs=True,
    )
    assert len(got[0]) == 3


def test_rerank_failure_falls_back():
    class Boom:
        def rerank(self, *a, **k):
            raise RuntimeError("api down")

    docs = [{"id": "a", "document": "x"}, {"id": "b", "document": "y"}]
    out = apply_rerank(Boom(), "q", docs, "rerank-2", 1)
    assert out == docs  # original order, not truncated


def test_fused_retriever_matches_engine(setup):
    c, idx, eng, _ = setup
    weights = {"voyage-3-large": 5.0, "text-embedding-3-large": 2.0, "BM25": 1.0}
    fr = FusedRetriever(
        idx, MODELS, use_bm25=True, similarity_k=10, common_sections_n=8,
        budget=8192,
    )
    terms = idx.pad_term_ids(c.query_tokens, 16)
    fids, fvals, _ = fr(
        {m: c.query_embeddings[m] for m in MODELS}, terms, weights, None, 40.0
    )
    got_engine = eng.retrieve(
        query_embeddings={m: c.query_embeddings[m] for m in MODELS},
        query_token_lists=[t[:16] for t in c.query_tokens],
        model_weights=weights,
        similarity_k=10,
        common_sections_n=8,
        wrrf_k=40.0,
        use_hybrid_search=True,
    )
    for b in range(len(c.query_tokens)):
        fused_ids = [idx.meta.ids[i] for i in fids[b] if i >= 0]
        assert set(fused_ids) == set(got_engine[b])


def test_min_similarity_threshold(setup):
    c, idx, eng, _ = setup
    q = c.query_embeddings["voyage-3-large"][:2]
    # Impossible threshold -> dense candidates all dropped -> empty lists.
    got = eng.retrieve(
        {"voyage-3-large": q},
        model_weights={"voyage-3-large": 1.0},
        min_similarity=2.0,
    )
    assert all(len(ids) == 0 for ids in got)
    # Permissive threshold -> unchanged results.
    base = eng.retrieve(
        {"voyage-3-large": q}, model_weights={"voyage-3-large": 1.0}
    )
    thr = eng.retrieve(
        {"voyage-3-large": q},
        model_weights={"voyage-3-large": 1.0},
        min_similarity=-2.0,
    )
    assert base == thr


def test_fused_retriever_pallas_backend(setup):
    """Forced streaming route with its Pallas kernel (interpreted on the
    CPU) runs end to end."""
    c, idx, eng, _ = setup
    import jax

    if jax.default_backend() != "cpu":
        pytest.skip("interpret-mode check is for the CPU suite")
    # The kernel runs in the interpreter only when asked; also pin the
    # sparse-fusion op equivalence the streaming route relies on.
    from a_nice_rag_tpu.ops.fusion import wrrf_top_n, wrrf_top_n_sparse
    from a_nice_rag_tpu.retrieval import FusedRetriever
    import jax.numpy as jnp

    fr = FusedRetriever(idx, ("voyage-3-large",), use_bm25=True,
                        similarity_k=8, common_sections_n=8,
                        dense_backend="stream", interpret=True)
    assert fr.route.stream and fr.route.kernel and fr.route.interpret
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens, 16))
    ids, _, _ = fr(
        {"voyage-3-large": c.query_embeddings["voyage-3-large"]}, terms,
        {"voyage-3-large": 5.0, "BM25": 1.0}, None, 40.0,
    )
    assert (np.asarray(ids)[:, 0] >= 0).all()

    rng = np.random.default_rng(219)
    lists = rng.integers(0, 300, size=(2, 6, 12)).astype(np.int32)
    w = jnp.asarray([5.0, 1.0])
    v1, i1 = wrrf_top_n(jnp.asarray(lists), w, 8, idx.n_docs_padded, 40.0)
    v2, i2 = wrrf_top_n_sparse(jnp.asarray(lists), w, 8, 40.0)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-6)


def test_fused_pallas_csr_bm25_matches_xla_path():
    """At scale without a dense impact matrix the streaming route scores
    BM25 via the sort-based sparse top-k; results must match the XLA
    scatter path."""
    import jax.numpy as jnp
    import numpy as np

    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(n_docs=1024, dim=32, n_queries=8, seed=51,
                     vocab_size=500)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
        bm25_dense_max_bytes=0,  # force the CSR-only layout
    )
    assert idx.bm25_dense is None
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens, 16))
    w = {"voyage-3-large": 5.0, "BM25": 1.0}
    fr_x = FusedRetriever(idx, ("voyage-3-large",), use_bm25=True,
                          similarity_k=10, common_sections_n=10,
                          dense_backend="xla")
    fr_p = FusedRetriever(idx, ("voyage-3-large",), use_bm25=True,
                          similarity_k=10, common_sections_n=10,
                          dense_backend="stream")
    assert fr_p.route.stream and not fr_p.route.kernel
    ids_x, _, lists_x = fr_x(q, terms, w, None, 40.0)
    ids_p, _, lists_p = fr_p(q, terms, w, None, 40.0)
    # Compare the BM25 PER-LIST ids between backends (the fused set is
    # dense-dominated at 5:1, so comparing only it cannot catch a broken
    # sparse path). The sparse path reports -1 for zero-score docs the
    # scatter path surfaces as filler, so compare positive-score ranks.
    bm25_x = np.asarray(lists_x)[-1]
    bm25_p = np.asarray(lists_p)[-1]
    for b in range(8):
        a = [i for i in bm25_x[b] if i >= 0]
        p = [i for i in bm25_p[b] if i >= 0]
        n = min(len(a), len(p))
        assert n > 0
        assert len(set(a[:n]) ^ set(p[:n])) <= 2, (b, a, p)
    # Fused output matches too.
    for b in range(8):
        a = [i for i in np.asarray(ids_x)[b] if i >= 0]
        p = [i for i in np.asarray(ids_p)[b] if i >= 0]
        assert len(set(a) ^ set(p)) <= 2, (b, a, p)


def test_pallas_auto_route_accepts_misaligned_large_index():
    """A 1M+128-row index auto-routes to the streaming kernel on the
    GPU: the kernel masks the ragged last tile, so no doc-axis
    alignment is needed."""
    from a_nice_rag_tpu.ops.streaming import choose_route

    big_misaligned = (1 << 20) + 128
    r = choose_route(big_misaligned, 25, "auto", platform="gpu")
    assert r.stream and r.kernel and not r.interpret
    assert choose_route(1 << 20, 25, "auto", platform="gpu").kernel
    # Below the threshold, or on the CPU: plain XLA, scores materialized.
    assert not choose_route(9728, 25, "auto", platform="gpu").stream
    assert not choose_route(big_misaligned, 25, "auto",
                            platform="cpu").stream
    # k beyond the kernel's limit still streams, through plain XLA.
    r = choose_route(big_misaligned, 256, "auto", platform="gpu")
    assert r.stream and not r.kernel
    # A forced stream on the CPU takes the plain blocked form unless the
    # caller asks for the interpreter.
    assert choose_route(128, 25, "stream", platform="cpu") == (
        True, False, False)
    assert choose_route(128, 25, "stream", platform="cpu",
                        interpret=True) == (True, True, True)


def test_csr_xla_route_uses_window_slice_sparse_path():
    """Non-Pallas CSR BM25 (vocab x N too big for the impact matrix) now
    routes through the sort-based sparse top-k with per-term window
    fetches; positive-score results must match the scatter op exactly."""
    import jax.numpy as jnp
    from a_nice_rag_tpu.ops.bm25 import bm25_top_k

    c = synth_corpus(n_docs=700, dim=24, n_queries=10, seed=77,
                     vocab_size=400)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      embeddings=c.embeddings, token_lists=c.tokens,
                      bm25_dense_max_bytes=0)
    assert idx.bm25_dense is None
    assert idx.bm25_stats and idx.bm25_stats.get("max_df", 0) > 0
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens, 16))
    fr = FusedRetriever(idx, ("voyage-3-large",), use_bm25=True,
                        similarity_k=10, common_sections_n=10,
                        dense_backend="xla")
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    _, _, lists = fr(q, terms, {"voyage-3-large": 5.0, "BM25": 1.0},
                     None, 40.0)
    got = np.asarray(lists)[-1]  # BM25 per-list ids
    mask = jnp.asarray(idx.meta.filter_mask(None) & idx.bm25_doc_mask)
    ref_v, ref_i = bm25_top_k(idx.bm25, terms, 10, mask=mask)
    ref_v, ref_i = np.asarray(ref_v), np.asarray(ref_i)
    for b in range(10):
        want = [i for v, i in zip(ref_v[b], ref_i[b]) if v > 0]
        have = [i for i in got[b] if i >= 0]
        assert have[: len(want)] == want[: len(have)]
        assert len(have) >= min(len(want), 10)
