"""Dense eager-impact BM25 (matmul path) must equal the CSR kernel exactly."""

import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.index.array_index import dense_impact_from_csr
from a_nice_rag_tpu.ops.bm25 import (
    bm25_scores,
    bm25_scores_dense,
    bm25_scores_dense_gather,
)
from a_nice_rag_tpu.testing import GoldenBm25Okapi, synth_corpus


def test_dense_matches_csr_and_golden():
    c = synth_corpus(n_docs=300, dim=16, n_queries=12, seed=51)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    assert idx.bm25_dense is not None
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens, 16))
    s_csr = np.asarray(bm25_scores(idx.bm25, terms, budget=8192))
    s_dense = np.asarray(bm25_scores_dense(idx.bm25_dense, terms))
    np.testing.assert_allclose(s_dense, s_csr, rtol=1e-5, atol=1e-6)
    golden = GoldenBm25Okapi(c.tokens)
    for i in range(4):
        expect = golden.get_scores(c.query_tokens[i][:16])
        np.testing.assert_allclose(
            s_dense[i, : len(expect)], expect, rtol=2e-5, atol=1e-5
        )


def test_dense_duplicate_and_oov_terms():
    c = synth_corpus(n_docs=120, dim=8, n_queries=4, seed=53)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    bd = idx.bm25_dense
    t = idx.term_ids(c.query_tokens[0][:3])
    q = np.full((2, 8), -1, dtype=np.int32)
    q[0, :3] = t
    q[1, :3] = t
    q[1, 3:6] = t  # doubled
    s = np.asarray(bm25_scores_dense(bd, jnp.asarray(q)))
    np.testing.assert_allclose(s[1], 2 * s[0], rtol=1e-5, atol=1e-6)
    oov = np.full((1, 8), -1, dtype=np.int32)
    assert (np.asarray(bm25_scores_dense(bd, jnp.asarray(oov))) == 0).all()


def test_gather_path_matches_matmul():
    """Small-batch impact-row gather equals the matmul form (duplicates,
    OOV and padding included)."""
    c = synth_corpus(n_docs=300, dim=16, n_queries=12, seed=57)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens, 16))
    s_mat = np.asarray(bm25_scores_dense(idx.bm25_dense, terms))
    s_gat = np.asarray(bm25_scores_dense_gather(idx.bm25_dense, terms))
    np.testing.assert_allclose(s_gat, s_mat, rtol=1e-5, atol=1e-6)
    # single query with duplicates + padding
    t = idx.term_ids(c.query_tokens[0][:3])
    q = np.full((1, 8), -1, dtype=np.int32)
    q[0, :3] = t
    q[0, 3] = t[0]  # duplicate
    np.testing.assert_allclose(
        np.asarray(bm25_scores_dense_gather(idx.bm25_dense, jnp.asarray(q))),
        np.asarray(bm25_scores_dense(idx.bm25_dense, jnp.asarray(q))),
        rtol=1e-5, atol=1e-6,
    )
    oov = np.full((1, 8), -1, dtype=np.int32)
    assert (
        np.asarray(bm25_scores_dense_gather(idx.bm25_dense, jnp.asarray(oov)))
        == 0
    ).all()


def test_builder_memory_budget_gate():
    c = synth_corpus(n_docs=120, dim=8, n_queries=4, seed=55)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
        bm25_dense_max_bytes=1,  # force CSR-only
    )
    assert idx.bm25_dense is None
    d = dense_impact_from_csr(idx.bm25)
    assert d.impact.shape == (len(idx.vocab), idx.n_docs_padded)
