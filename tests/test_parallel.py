"""Sharded retrieval on the 8-device virtual CPU mesh: exactness vs
single-device kernels (the sharded path must change WHERE compute runs,
never WHAT it computes)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.ops import bm25_scores, dense_top_k, wrrf_top_n, wrrf_top_n_sparse
from a_nice_rag_tpu.parallel import make_mesh, shard_index, sharded_dense_top_k
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever
from a_nice_rag_tpu.retrieval import FusedRetriever
from a_nice_rag_tpu.testing import synth_corpus

MODELS = ["voyage-3-large"]


@pytest.fixture(scope="module")
def setup():
    c = synth_corpus(n_docs=900, dim=64, n_queries=16, seed=41, models=MODELS)
    idx = build_index(
        ids=c.ids,
        sources=c.sources,
        contents=c.contents,
        embeddings=c.embeddings,
        token_lists=c.tokens,
    )
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "corpus"))
    sidx = shard_index(idx, mesh)
    return c, idx, mesh, sidx


def test_mesh_shapes(setup):
    c, idx, mesh, sidx = setup
    assert len(jax.devices()) == 8
    assert sidx.n_shards == 4
    assert sidx.n_local * 4 >= idx.n_docs_padded
    assert sidx.n_local % 128 == 0


def test_sharded_dense_matches_single_device(setup):
    c, idx, mesh, sidx = setup
    q = c.query_embeddings["voyage-3-large"]
    vals_s, idx_s = sharded_dense_top_k(sidx, "voyage-3-large", q, 25)
    vals_1, idx_1 = dense_top_k(
        idx.dense["voyage-3-large"], jnp.asarray(q), 25,
        mask=idx.filter_mask(None),
    )
    np.testing.assert_allclose(vals_s, np.asarray(vals_1), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idx_s, np.asarray(idx_1))


def test_sharded_dense_with_filter(setup):
    c, idx, mesh, sidx = setup
    q = c.query_embeddings["voyage-3-large"][:4]
    vals_s, idx_s = sharded_dense_top_k(sidx, "voyage-3-large", q, 10, "NG")
    for b in range(4):
        for i in idx_s[b]:
            assert c.sources[int(i)].upper().startswith("NG")


def test_wrrf_sparse_matches_dense_impl():
    rng = np.random.default_rng(43)
    l, b, k, n_pad = 3, 5, 20, 512
    idx = rng.integers(0, 400, size=(l, b, k)).astype(np.int32)
    idx[0, 0, -3:] = -1  # padding
    w = jnp.asarray([5.0, 2.0, 1.0])
    v1, i1 = wrrf_top_n(jnp.asarray(idx), w, 10, n_pad, k_rrf=40.0)
    v2, i2 = wrrf_top_n_sparse(jnp.asarray(idx), w, 10, k_rrf=40.0)
    np.testing.assert_allclose(np.asarray(v1), np.asarray(v2), rtol=1e-6)
    # ids agree where scores are unique
    for bq in range(b):
        vals = np.asarray(v1)[bq]
        for j in range(10):
            if (np.abs(vals - vals[j]) < 1e-9).sum() == 1:
                assert int(np.asarray(i1)[bq, j]) == int(np.asarray(i2)[bq, j])


def test_sharded_hybrid_matches_fused_single_device(setup):
    c, idx, mesh, sidx = setup
    weights = {"voyage-3-large": 5.0, "BM25": 1.0}
    terms = idx.pad_term_ids(c.query_tokens, 16)
    sr = ShardedRetriever(
        sidx, MODELS, use_bm25=True, similarity_k=12, common_sections_n=10,
        budget=4096,
    )
    s_vals, s_ids = sr(
        {"voyage-3-large": c.query_embeddings["voyage-3-large"]},
        terms, weights, None, 40.0,
    )
    fr = FusedRetriever(
        idx, MODELS, use_bm25=True, similarity_k=12, common_sections_n=10,
        budget=4096,
    )
    f_ids, f_vals, _ = fr(
        {"voyage-3-large": c.query_embeddings["voyage-3-large"]},
        terms, weights, None, 40.0,
    )
    np.testing.assert_allclose(s_vals, f_vals, rtol=1e-5, atol=1e-7)
    for b in range(s_ids.shape[0]):
        # id sets must match; order may differ only among exact RRF ties
        assert set(s_ids[b][s_ids[b] >= 0]) == set(f_ids[b][f_ids[b] >= 0])


def test_sharded_bm25_scores_exact(setup):
    """Per-shard CSR with global stats must reproduce global BM25 scores."""
    c, idx, mesh, sidx = setup
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens[:4], 16))
    global_scores = np.asarray(bm25_scores(idx.bm25, terms, budget=4096))
    # Reconstruct global scores from the stacked per-shard arrays.
    from a_nice_rag_tpu.ops.bm25 import Bm25Arrays

    parts = []
    for s in range(sidx.n_shards):
        local = Bm25Arrays(
            indptr=jnp.asarray(np.asarray(sidx.bm25_indptr)[s]),
            doc_ids=jnp.asarray(np.asarray(sidx.bm25_doc_ids)[s]),
            impact=jnp.asarray(np.asarray(sidx.bm25_impact)[s]),
            n_docs_padded=sidx.n_local,
        )
        parts.append(np.asarray(bm25_scores(local, terms, budget=4096)))
    stitched = np.concatenate(parts, axis=1)[:, : idx.n_docs_padded]
    np.testing.assert_allclose(stitched, global_scores, rtol=1e-5, atol=1e-6)


def test_sharded_pallas_backend_matches_xla(setup):
    c, idx, mesh, sidx = setup
    weights = {"voyage-3-large": 1.0}
    q = c.query_embeddings["voyage-3-large"][:8]
    # Streaming route per shard, its Pallas kernel interpreted on the
    # CPU. A padded batch: the zero rows must not disturb the real ones.
    qp = np.zeros((128, q.shape[1]), np.float32)
    qp[:8] = q
    sr_p = ShardedRetriever(sidx, MODELS, use_bm25=False, similarity_k=16,
                            common_sections_n=16, dense_backend="stream",
                            interpret=True)
    sr_x = ShardedRetriever(sidx, MODELS, use_bm25=False, similarity_k=16,
                            common_sections_n=16)
    _, ids_p = sr_p({"voyage-3-large": qp}, None, weights, None, 40.0)
    _, ids_x = sr_x({"voyage-3-large": qp}, None, weights, None, 40.0)
    np.testing.assert_array_equal(ids_p[:8], ids_x[:8])


def test_hierarchical_multihost_merge():
    """dcn x ici corpus sharding: two-level merge equals brute force."""
    from jax.sharding import Mesh, PartitionSpec as P
    from a_nice_rag_tpu.ops.dense import dense_scores
    from a_nice_rag_tpu.ops.topk import masked_top_k
    from a_nice_rag_tpu.parallel.sharded import hierarchical_gather_merge

    n, d, b, k = 1024, 32, 4, 10
    rng = np.random.default_rng(47)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    # 2 "hosts" (dcn) x 4 chips (ici) = 8 shards of 128 docs.
    mesh = Mesh(np.asarray(jax.devices()).reshape(2, 4), ("dcn", "ici"))
    n_local = n // 8

    def shard_fn(e_l, q_l):
        scores = dense_scores(jnp.asarray(e_l), q_l)
        vals, idx = masked_top_k(scores, k)
        shard = jax.lax.axis_index("dcn") * 4 + jax.lax.axis_index("ici")
        gidx = idx + shard * n_local
        return hierarchical_gather_merge(vals, gidx, k, "ici", "dcn")

    run = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(P(("dcn", "ici"), None), P(None, None)),
            out_specs=(P(None, None), P(None, None)),
            check_vma=False,
        )
    )
    vals, idx = run(jnp.asarray(emb), jnp.asarray(q))
    scores = q @ emb.T
    for bq in range(b):
        expect = np.argsort(scores[bq])[::-1][:k]
        np.testing.assert_array_equal(np.asarray(idx)[bq], expect)


def test_sharded_k_exceeds_shard_size(setup):
    """similarity_k > docs-per-shard must still rank the merged corpus
    exactly (per-shard lists clamp, the merge keeps min(k, S*k_local))."""
    c, idx, mesh, sidx = setup
    q = c.query_embeddings["voyage-3-large"][:2]
    k = sidx.n_local + 50  # exceeds any single shard
    vals_s, idx_s = sharded_dense_top_k(sidx, "voyage-3-large", q, k)
    scores = q @ c.embeddings["voyage-3-large"].T
    for b in range(2):
        expect = np.argsort(scores[b])[::-1][: idx_s.shape[1]]
        # All returned entries must be valid and exactly the global order.
        got = idx_s[b][idx_s[b] >= 0]
        np.testing.assert_array_equal(got, expect[: len(got)])
        assert len(got) >= idx.n_docs or len(got) == idx_s.shape[1]


def test_host_axis_retriever_matches_single_axis(setup):
    """shard_index(host_axis=...) over a dp x host x corpus mesh must
    reproduce the single-axis ShardedRetriever results exactly (the
    hierarchical ICI->DCN merge is associative, so WHERE the merge runs
    must not change WHAT it returns)."""
    c, idx, mesh, sidx = setup
    weights = {"voyage-3-large": 5.0, "BM25": 1.0}
    terms = idx.pad_term_ids(c.query_tokens, 16)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}

    mh_mesh = make_mesh(shape=(2, 2, 2), axis_names=("dp", "host", "corpus"))
    sidx_mh = shard_index(idx, mh_mesh, host_axis="host")
    assert sidx_mh.n_shards == 4
    sr_mh = ShardedRetriever(
        sidx_mh, MODELS, use_bm25=True, similarity_k=12,
        common_sections_n=10, budget=4096,
    )
    sr_1 = ShardedRetriever(
        sidx, MODELS, use_bm25=True, similarity_k=12,
        common_sections_n=10, budget=4096,
    )
    v_mh, i_mh = sr_mh(q, terms, weights, None, 40.0)
    v_1, i_1 = sr_1(q, terms, weights, None, 40.0)
    np.testing.assert_allclose(v_mh, v_1, rtol=1e-5, atol=1e-7)
    for b in range(i_mh.shape[0]):
        assert set(i_mh[b][i_mh[b] >= 0]) == set(i_1[b][i_1[b] >= 0])


def test_host_axis_dense_top_k_exact(setup):
    """sharded_dense_top_k over a host-sharded index equals brute force."""
    c, idx, mesh, sidx = setup
    mh_mesh = make_mesh(shape=(1, 2, 4), axis_names=("dp", "host", "corpus"))
    sidx_mh = shard_index(idx, mh_mesh, host_axis="host")
    assert sidx_mh.n_shards == 8
    q = c.query_embeddings["voyage-3-large"][:4]
    vals, ids = sharded_dense_top_k(sidx_mh, "voyage-3-large", q, 15)
    scores = q @ c.embeddings["voyage-3-large"].T
    for b in range(4):
        expect = np.argsort(scores[b])[::-1][:15]
        np.testing.assert_array_equal(ids[b], expect)


def test_sharded_quantized_index_matches_single_device():
    """int8-quantized dense matrices shard over the corpus axis and the
    sharded retrieval matches the single-device quantized FusedRetriever
    (same int8 arithmetic, different placement)."""
    from a_nice_rag_tpu.ops.quantized import quantized_dense_top_k

    c = synth_corpus(n_docs=700, dim=64, n_queries=12, seed=43,
                     models=MODELS)
    idx_q = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
        quantize_dense=True,
    )
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "corpus"))
    sidx = shard_index(idx_q, mesh)

    q = c.query_embeddings["voyage-3-large"]
    # Exact vs single-device int8 scoring.
    vals_s, idx_s = sharded_dense_top_k(sidx, "voyage-3-large", q, 20)
    vals_1, idx_1 = quantized_dense_top_k(
        idx_q.dense_q["voyage-3-large"], jnp.asarray(q), 20,
        mask=idx_q.filter_mask(None),
    )
    np.testing.assert_allclose(vals_s, np.asarray(vals_1),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(idx_s, np.asarray(idx_1))

    # Hybrid end-to-end: sharded vs single-device quantized engine.
    weights = {"voyage-3-large": 5.0, "BM25": 1.0}
    terms = idx_q.pad_term_ids(c.query_tokens, 16)
    sr = ShardedRetriever(
        sidx, MODELS, use_bm25=True, similarity_k=12,
        common_sections_n=10, budget=4096,
    )
    s_vals, s_ids = sr(
        {"voyage-3-large": q}, terms, weights, None, 40.0,
    )
    fr = FusedRetriever(
        idx_q, MODELS, use_bm25=True, similarity_k=12,
        common_sections_n=10, budget=4096,
    )
    f_ids, f_vals, _ = fr(
        {"voyage-3-large": q}, terms, weights, None, 40.0,
    )
    np.testing.assert_allclose(s_vals, f_vals, rtol=1e-5, atol=1e-7)
    for b in range(s_ids.shape[0]):
        assert set(s_ids[b][s_ids[b] >= 0]) == set(f_ids[b][f_ids[b] >= 0])
