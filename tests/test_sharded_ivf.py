"""Per-shard IVF ANN over the corpus mesh (parallel.shard_ivf).

Each shard clusters its OWN rows and probes them independently inside
the pjit program; the global merge is unchanged. Exactness anchor: with
nprobe == n_clusters every shard schedules all of its real tiles, so
the ANN program must equal the exact ShardedRetriever bit-for-bit.
Per-shard real-row counts differ (the last shard is part padding),
which exercises the kernel's dynamic n_real form (trailing tile-table
slot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.parallel import make_mesh, shard_index, shard_ivf
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever, reshard_surviving
from a_nice_rag_tpu.testing import synth_corpus

MODELS = ["voyage-3-large"]
W = {"voyage-3-large": 1.0}


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    n, d, c_true = 900, 48, 20
    cents = _unit(rng.normal(size=(c_true, d)))
    x = _unit(
        np.repeat(cents, n // c_true, axis=0)
        + 0.08 * rng.normal(size=(n, d))
    ).astype(np.float32)
    gold = rng.integers(0, n, 16)
    q = _unit(x[gold] + 0.1 * rng.normal(size=(16, d))).astype(np.float32)
    c = synth_corpus(n_docs=n, dim=d, n_queries=16, seed=11, models=MODELS)
    idx = build_index(
        ids=c.ids,
        sources=c.sources,
        contents=c.contents,
        embeddings={"voyage-3-large": x},
        token_lists=c.tokens,
    )
    mesh = make_mesh(shape=(2, 4), axis_names=("dp", "corpus"))
    sidx = shard_ivf(shard_index(idx, mesh), "voyage-3-large", tile_n=128)
    return c, idx, x, q, gold, mesh, sidx


def test_dynamic_n_real_matches_static(setup):
    """The kernel's traced real-row count (per-shard counts differ under
    shard_map) must equal the static form."""
    from a_nice_rag_tpu.index.ivf import build_ivf_dense, build_tile_table
    from a_nice_rag_tpu.ops.pallas import stream_top_k

    _, _, x, q, _, _, _ = setup
    x480 = jnp.asarray(x[:480])  # NOT a tile multiple: 480 real of 512
    ivf = build_ivf_dense(x480, n_clusters=12, tile_n=128, n_iters=6,
                          seed=0)
    table, _ = build_tile_table(
        ivf.centroids, ivf.cluster_start, jnp.asarray(q), nprobe=12,
        max_tiles=ivf.n_tiles, tile_n=128, mct=ivf.max_cluster_tiles,
    )
    v_s, i_s = stream_top_k(
        ivf.emb, jnp.asarray(q), 9, tiles=table, tile_n=128, n_valid=480,
        interpret=True,
    )
    v_d, i_d = jax.jit(
        lambda nv: stream_top_k(
            ivf.emb, jnp.asarray(q), 9, tiles=table, tile_n=128,
            n_valid=nv, interpret=True,
        )
    )(jnp.int32(480))
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(i_d))
    np.testing.assert_allclose(np.asarray(v_s), np.asarray(v_d))


def test_shard_ivf_layout(setup):
    """Permutations cover every real local row exactly once; pads sort
    to the tail; per-shard real counts reflect the global doc count."""
    c, idx, x, _, _, _, sidx = setup
    assert sidx.ivf_model == "voyage-3-large"
    reals = np.asarray(sidx.ivf_n_real)
    assert reals.sum() == idx.n_docs
    perms = np.asarray(sidx.ivf_perm)
    rows = np.asarray(sidx.ivf_rows)
    for s in range(sidx.n_shards):
        real = int(reals[s])
        p = perms[s]
        assert sorted(p[p >= 0].tolist()) == list(range(real))
        # Cluster-major rows are the permuted local originals.
        lo = s * sidx.n_local
        local = np.asarray(x)[lo:lo + real]
        np.testing.assert_allclose(rows[s][p >= 0], local[p[p >= 0]])
        assert (rows[s][p < 0] == 0).all()


def test_full_probe_matches_exact(setup):
    c, idx, x, q, _, mesh, sidx = setup
    cfull = int(np.asarray(sidx.ivf_centroids).shape[1])
    sr_ivf = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12, nprobe=cfull,
    )
    assert sr_ivf.use_ivf
    sr_x = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12, common_sections_n=12,
    )
    _, ids_i = sr_ivf({"voyage-3-large": q}, None, W, None, 40.0)
    _, ids_x = sr_x({"voyage-3-large": q}, None, W, None, 40.0)
    np.testing.assert_array_equal(ids_i, ids_x)
    # Sanity vs brute force on the host.
    ref = np.argsort(-(q @ x.T), axis=1)[:, :12]
    for b in range(q.shape[0]):
        assert set(ids_i[b][ids_i[b] >= 0]) == set(ref[b])


def test_partial_probe_recall_and_fallbacks(setup):
    c, idx, x, q, gold, mesh, sidx = setup
    sr_p = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12, nprobe=4,
    )
    _, ids_p = sr_p({"voyage-3-large": q}, None, W, None, 40.0)
    hits = sum(gold[b] in set(ids_p[b]) for b in range(q.shape[0]))
    assert hits >= 13, hits
    # Filtered calls take the exact program (mask semantics preserved).
    sr_x = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12, common_sections_n=12,
    )
    _, f_p = sr_p({"voyage-3-large": q}, None, W, "NG", 40.0)
    _, f_x = sr_x({"voyage-3-large": q}, None, W, "NG", 40.0)
    np.testing.assert_array_equal(f_p, f_x)
    for b in range(q.shape[0]):
        for i in f_p[b]:
            if i >= 0:
                assert c.sources[int(i)].upper().startswith("NG")


def test_hybrid_ivf_full_probe_matches_exact(setup):
    c, idx, x, q, _, mesh, sidx = setup
    terms = idx.pad_term_ids(c.query_tokens, 16)
    w = {"voyage-3-large": 5.0, "BM25": 1.0}
    cfull = int(np.asarray(sidx.ivf_centroids).shape[1])
    sr_ivf = ShardedRetriever(
        sidx, MODELS, use_bm25=True, similarity_k=12, common_sections_n=10,
        budget=4096, nprobe=cfull,
    )
    sr_x = ShardedRetriever(
        sidx, MODELS, use_bm25=True, similarity_k=12, common_sections_n=10,
        budget=4096,
    )
    v_i, ids_i = sr_ivf({"voyage-3-large": q}, terms, w, None, 40.0)
    v_x, ids_x = sr_x({"voyage-3-large": q}, terms, w, None, 40.0)
    np.testing.assert_allclose(v_i, v_x, rtol=1e-6)
    for b in range(ids_i.shape[0]):
        assert set(ids_i[b][ids_i[b] >= 0]) == set(ids_x[b][ids_x[b] >= 0])


def test_quantized_shard_ivf_matches_exact(setup):
    c, idx, x, q, _, mesh, _ = setup
    idx_q = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings={"voyage-3-large": x}, token_lists=c.tokens,
        quantize_dense=True,
    )
    sidx_q = shard_ivf(shard_index(idx_q, mesh), "voyage-3-large",
                       tile_n=128)
    from a_nice_rag_tpu.ops.quantized import QuantizedDense

    assert isinstance(sidx_q.ivf_rows, QuantizedDense)
    cfull = int(np.asarray(sidx_q.ivf_centroids).shape[1])
    sr_ivf = ShardedRetriever(
        sidx_q, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12, nprobe=cfull,
    )
    sr_x = ShardedRetriever(
        sidx_q, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12,
    )
    _, ids_i = sr_ivf({"voyage-3-large": q}, None, W, None, 40.0)
    _, ids_x = sr_x({"voyage-3-large": q}, None, W, None, 40.0)
    for b in range(ids_i.shape[0]):
        assert set(ids_i[b][ids_i[b] >= 0]) == set(ids_x[b][ids_x[b] >= 0])


def test_reshard_surviving_keeps_ivf(setup):
    """Failure recovery re-clusters over the surviving shard layout and
    keeps serving the ANN route."""
    c, idx, x, q, _, mesh, sidx = setup
    survivors = jax.devices()[:4]
    sidx2 = reshard_surviving(sidx, survivors, dp=1)
    assert sidx2.ivf_model == "voyage-3-large"
    assert sidx2.n_shards == 4
    cfull = int(np.asarray(sidx2.ivf_centroids).shape[1])
    sr = ShardedRetriever(
        sidx2, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12, nprobe=cfull,
    )
    assert sr.use_ivf
    _, ids = sr({"voyage-3-large": q}, None, W, None, 40.0)
    ref = np.argsort(-(q @ x.T), axis=1)[:, :12]
    for b in range(q.shape[0]):
        assert set(ids[b][ids[b] >= 0]) == set(ref[b])


def test_save_load_shard_ivf_roundtrip(setup, tmp_path):
    """Persisted clustering layout (no permuted matrix on disk)
    reattaches to a freshly sharded index with identical arrays and
    identical retrieval; mismatched shard geometry is rejected."""
    import os

    from a_nice_rag_tpu.parallel import (
        load_shard_ivf,
        save_shard_ivf,
        shard_index,
    )

    c, idx, x, q, _, mesh, sidx = setup
    path = os.path.join(tmp_path, "ivf.npz")
    save_shard_ivf(sidx, path)
    fresh = load_shard_ivf(shard_index(idx, mesh), path)
    np.testing.assert_array_equal(
        np.asarray(fresh.ivf_perm), np.asarray(sidx.ivf_perm))
    np.testing.assert_array_equal(
        np.asarray(fresh.ivf_rows), np.asarray(sidx.ivf_rows))
    assert (fresh.ivf_tile_n, fresh.ivf_mct) == (
        sidx.ivf_tile_n, sidx.ivf_mct)
    cfull = int(np.asarray(fresh.ivf_centroids).shape[1])
    sr_a = ShardedRetriever(fresh, MODELS, use_bm25=False, similarity_k=12,
                            common_sections_n=12, nprobe=cfull)
    sr_b = ShardedRetriever(sidx, MODELS, use_bm25=False, similarity_k=12,
                            common_sections_n=12, nprobe=cfull)
    _, ids_a = sr_a({"voyage-3-large": q}, None, W, None, 40.0)
    _, ids_b = sr_b({"voyage-3-large": q}, None, W, None, 40.0)
    np.testing.assert_array_equal(ids_a, ids_b)
    # Wrong geometry is a loud error, not silent corruption.
    mesh2 = make_mesh_for_geometry_check()
    sidx2 = shard_index(idx, mesh2)
    with pytest.raises(ValueError, match="rebuild"):
        load_shard_ivf(sidx2, path)


def make_mesh_for_geometry_check():
    from a_nice_rag_tpu.parallel import make_mesh

    return make_mesh(shape=(4, 2), axis_names=("dp", "corpus"))


@pytest.mark.parametrize("n_docs,corpus,dp,tile_n", [
    (130, 2, 1, 64),    # tiny, heavy pad tail on shard 1
    (257, 4, 2, 32),    # prime-ish, all shards part-real
    (512, 8, 1, 64),    # exact fit, no pad
    (700, 4, 2, 128),   # tile_n > some shards' real rows
])
def test_fuzz_geometry_full_probe_exact(n_docs, corpus, dp, tile_n):
    """Full-probe sharded IVF equals brute force across awkward
    (corpus size, shard count, tile) geometries — the dynamic n_real
    masking and pad-tail layout must hold for every split."""
    rng = np.random.default_rng(n_docs)
    d = 32
    x = _unit(rng.normal(size=(n_docs, d))).astype(np.float32)
    q = _unit(rng.normal(size=(dp * 4, d))).astype(np.float32)
    c = synth_corpus(n_docs=n_docs, dim=d, n_queries=4, seed=n_docs,
                     models=MODELS)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings={"voyage-3-large": x}, token_lists=c.tokens,
    )
    mesh = make_mesh(shape=(dp, corpus), axis_names=("dp", "corpus"),
                     devices=jax.devices()[:dp * corpus])
    sidx = shard_ivf(shard_index(idx, mesh), "voyage-3-large",
                     tile_n=tile_n)
    cfull = int(np.asarray(sidx.ivf_centroids).shape[1])
    k = min(8, n_docs)
    sr = ShardedRetriever(sidx, MODELS, use_bm25=False, similarity_k=k,
                          common_sections_n=k, nprobe=cfull)
    _, ids = sr({"voyage-3-large": q}, None, W, None, 40.0)
    ref = np.argsort(-(q @ x.T), axis=1)[:, :k]
    for b in range(q.shape[0]):
        assert set(ids[b][ids[b] >= 0]) == set(ref[b]), (n_docs, corpus, b)


def test_multihost_ivf_full_probe_exact(setup):
    """Per-shard IVF over a dp x host x corpus mesh (host-major doc
    layout, hierarchical ICI->DCN merge) still equals brute force at
    full probe."""
    from jax.sharding import Mesh

    c, idx, x, q, _, _, _ = setup
    mesh = Mesh(
        np.asarray(jax.devices()[:8]).reshape(1, 2, 4),
        ("dp", "host", "corpus"),
    )
    sidx = shard_ivf(
        shard_index(idx, mesh, host_axis="host"), "voyage-3-large",
        tile_n=128,
    )
    assert sidx.n_shards == 8
    cfull = int(np.asarray(sidx.ivf_centroids).shape[1])
    sr = ShardedRetriever(sidx, MODELS, use_bm25=False, similarity_k=12,
                          common_sections_n=12, nprobe=cfull)
    _, ids = sr({"voyage-3-large": q}, None, W, None, 40.0)
    ref = np.argsort(-(q @ x.T), axis=1)[:, :12]
    for b in range(q.shape[0]):
        assert set(ids[b][ids[b] >= 0]) == set(ref[b])


def test_save_load_shard_ivf_quantized(setup, tmp_path):
    """The persisted layout re-gathers int8 rows + scales exactly."""
    import os

    from a_nice_rag_tpu.ops.quantized import QuantizedDense
    from a_nice_rag_tpu.parallel import load_shard_ivf, save_shard_ivf

    c, idx, x, q, _, mesh, _ = setup
    idx_q = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings={"voyage-3-large": x}, token_lists=c.tokens,
        quantize_dense=True,
    )
    sidx_q = shard_ivf(shard_index(idx_q, mesh), "voyage-3-large",
                       tile_n=128)
    path = os.path.join(tmp_path, "ivfq.npz")
    save_shard_ivf(sidx_q, path)
    fresh = load_shard_ivf(shard_index(idx_q, mesh), path)
    assert isinstance(fresh.ivf_rows, QuantizedDense)
    np.testing.assert_array_equal(
        np.asarray(fresh.ivf_rows.values),
        np.asarray(sidx_q.ivf_rows.values))
    np.testing.assert_array_equal(
        np.asarray(fresh.ivf_rows.scales),
        np.asarray(sidx_q.ivf_rows.scales))


# ------------------------------------------------------------ spill


def test_spilled_shard_ivf_full_probe_matches_exact(setup):
    """Spilled per-shard layout: every real row stored once or twice,
    full probe equals the exact retriever after per-shard dedup, and
    no duplicate ids survive."""
    c, idx, x, q, _, mesh, _ = setup
    sidx = shard_ivf(shard_index(idx, mesh), "voyage-3-large",
                     tile_n=128, spill=True)
    assert sidx.ivf_spilled
    reals = np.asarray(sidx.ivf_n_real)
    assert idx.n_docs < reals.sum() <= 2 * idx.n_docs
    perms = np.asarray(sidx.ivf_perm)
    for s in range(sidx.n_shards):
        p = perms[s][perms[s] >= 0]
        counts = np.bincount(p)
        assert ((counts >= 1) & (counts <= 2)).all()
        assert len(p) == int(reals[s])
    cfull = int(np.asarray(sidx.ivf_centroids).shape[1])
    sr_ivf = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12, nprobe=cfull,
    )
    sr_x = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12,
    )
    _, ids_i = sr_ivf({"voyage-3-large": q}, None, W, None, 40.0)
    _, ids_x = sr_x({"voyage-3-large": q}, None, W, None, 40.0)
    for b in range(q.shape[0]):
        valid = ids_i[b][ids_i[b] >= 0]
        assert len(set(valid.tolist())) == len(valid)
    np.testing.assert_array_equal(ids_i, ids_x)


def test_spilled_shard_ivf_persistence_and_recovery(setup, tmp_path):
    from a_nice_rag_tpu.parallel import load_shard_ivf, save_shard_ivf

    c, idx, x, q, _, mesh, _ = setup
    sidx = shard_ivf(shard_index(idx, mesh), "voyage-3-large",
                     tile_n=128, spill=True, spill_margin=0.2)
    path = str(tmp_path / "shard_ivf_spill.npz")
    save_shard_ivf(sidx, path)
    back = load_shard_ivf(shard_index(idx, mesh), path)
    assert back.ivf_spilled and back.ivf_spill_margin == 0.2
    np.testing.assert_array_equal(
        np.asarray(back.ivf_perm), np.asarray(sidx.ivf_perm)
    )
    sr_a = ShardedRetriever(sidx, MODELS, use_bm25=False,
                            similarity_k=12, common_sections_n=12,
                            nprobe=4)
    sr_b = ShardedRetriever(back, MODELS, use_bm25=False,
                            similarity_k=12, common_sections_n=12,
                            nprobe=4)
    _, ids_a = sr_a({"voyage-3-large": q}, None, W, None, 40.0)
    _, ids_b = sr_b({"voyage-3-large": q}, None, W, None, 40.0)
    np.testing.assert_array_equal(ids_a, ids_b)
    # Failure recovery keeps the spill configuration.
    devs = jax.devices()[:6]
    out = reshard_surviving(sidx, devs, dp=2)
    assert out.ivf_spilled and out.ivf_spill_margin == 0.2
    sr_r = ShardedRetriever(out, MODELS, use_bm25=False,
                            similarity_k=12, common_sections_n=12,
                            nprobe=4)
    _, ids_r = sr_r({"voyage-3-large": q}, None, W, None, 40.0)
    # Recovered results stay high-quality (re-clustered boundaries can
    # shift partial-probe results; gold overlap is the contract).
    ref = np.argsort(-(q @ x.T), axis=1)[:, :12]
    overlap = np.mean([
        len(set(ids_r[b][ids_r[b] >= 0]) & set(ref[b])) / 12
        for b in range(q.shape[0])
    ])
    assert overlap >= 0.8, overlap


def test_spilled_quantized_shard_ivf(setup):
    c, idx, x, q, _, mesh, _ = setup
    qidx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings={"voyage-3-large": x}, token_lists=c.tokens,
        quantize_dense=True,
    )
    sidx = shard_ivf(shard_index(qidx, mesh), "voyage-3-large",
                     tile_n=128, spill=True)
    assert sidx.ivf_spilled
    cfull = int(np.asarray(sidx.ivf_centroids).shape[1])
    sr_ivf = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12, nprobe=cfull,
    )
    sr_x = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=12,
        common_sections_n=12,
    )
    _, ids_i = sr_ivf({"voyage-3-large": q}, None, W, None, 40.0)
    _, ids_x = sr_x({"voyage-3-large": q}, None, W, None, 40.0)
    np.testing.assert_array_equal(ids_i, ids_x)


def test_sharded_ivf_batch_routing(setup):
    """ivf_route="auto": the ANN program serves only while the
    expected PER-SHARD cluster coverage 1-(1-p/C)^(b/dp) stays under
    ivf_max_coverage; wider batches and filtered/tombstoned calls take
    the exact program. "always" restores the unconditional probe;
    results stay exact at full probe either way."""
    from a_nice_rag_tpu.retrieval.engine import _ivf_coverage

    c, idx, x, q, gold, mesh, sidx = setup
    cs = int(sidx.ivf_centroids.shape[1])
    dp = mesh.shape["dp"]  # 2
    r = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=8,
        common_sections_n=8, nprobe=1, ivf_max_coverage=0.5,
    )
    # Narrow enough that nprobe=1 coverage is tiny: probes. (Explicit
    # 0.5 threshold — the production default is 0.25.)
    assert _ivf_coverage(8 // dp, 1, cs) <= 0.5
    assert r._route_ivf(8, filtered=False, tombstoned=False)
    # A batch wide enough to push expected coverage past the
    # threshold: exact stream. (1-(1-1/C)^n > 0.5 at n ~ 0.7*C.)
    wide = dp * cs * 2
    assert _ivf_coverage(wide // dp, 1, cs) > 0.5
    assert not r._route_ivf(wide, filtered=False, tombstoned=False)
    # Filters/tombstones always take the exact program.
    assert not r._route_ivf(8, filtered=True, tombstoned=False)
    assert not r._route_ivf(8, filtered=False, tombstoned=True)
    r_always = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=8,
        common_sections_n=8, nprobe=64, ivf_route="always",
    )
    assert r_always._route_ivf(wide, filtered=False, tombstoned=False)
    with pytest.raises(ValueError):
        ShardedRetriever(
            sidx, MODELS, use_bm25=False, similarity_k=8,
            common_sections_n=8, nprobe=64, ivf_route="never",
        )
    # End-to-end: the "always" retriever's full-probe ANN program
    # (nprobe=64 >= clusters/shard) equals the exact retriever, and
    # the auto retriever at full probe routes EXACT (coverage 1.0) —
    # also equal by construction.
    exact = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=8,
        common_sections_n=8,
    )
    r_full_auto = ShardedRetriever(
        sidx, MODELS, use_bm25=False, similarity_k=8,
        common_sections_n=8, nprobe=64,
    )
    assert not r_full_auto._route_ivf(8, filtered=False,
                                      tombstoned=False)
    qd = {"voyage-3-large": q}
    a, _, _ = r_always.retrieve_device(qd, None, W, None, 40.0)
    e, _, _ = exact.retrieve_device(qd, None, W, None, 40.0)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(e))
    a2, _, _ = r_full_auto.retrieve_device(qd, None, W, None, 40.0)
    np.testing.assert_array_equal(np.asarray(a2), np.asarray(e))
