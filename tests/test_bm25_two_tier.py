"""Two-tier BM25 (dense common terms + rare CSR) exactness + budget cut."""

import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.ops.bm25 import (
    bm25_scores,
    bm25_scores_two_tier,
    postings_required,
    split_two_tier,
)
from a_nice_rag_tpu.testing import synth_corpus


def _setup(n_docs=500, seed=221):
    c = synth_corpus(n_docs=n_docs, dim=8, n_queries=16, seed=seed,
                     vocab_size=400)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    terms = jnp.asarray(idx.pad_term_ids(c.query_tokens, 16))
    return c, idx, terms


def test_two_tier_matches_single_tier():
    c, idx, terms = _setup()
    full = np.asarray(bm25_scores(idx.bm25, terms, budget=16384))
    tt = split_two_tier(idx.bm25, v_common=32)
    split = np.asarray(bm25_scores_two_tier(tt, terms, budget=4096))
    np.testing.assert_allclose(split, full, rtol=1e-5, atol=1e-5)


def test_two_tier_budget_reduction():
    c, idx, terms = _setup()
    need_full = int(np.asarray(postings_required(idx.bm25, terms)).max())
    tt = split_two_tier(idx.bm25, v_common=32)
    need_rare = int(np.asarray(postings_required(tt.rare, terms)).max())
    # Zipf head dominates: removing 32 common terms must slash the budget.
    assert need_rare < need_full / 3, (need_rare, need_full)


def test_two_tier_oov_and_padding():
    c, idx, terms = _setup(n_docs=120, seed=223)
    tt = split_two_tier(idx.bm25, v_common=16)
    empty = jnp.full((2, 8), -1, jnp.int32)
    s = np.asarray(bm25_scores_two_tier(tt, empty, budget=512))
    assert (s == 0).all()


def test_two_tier_v_common_exceeds_vocab():
    c, idx, terms = _setup(n_docs=80, seed=227)
    tt = split_two_tier(idx.bm25, v_common=10_000)
    # Everything common -> rare tier empty, still exact.
    assert int(np.asarray(tt.rare.indptr)[-1]) == 0
    full = np.asarray(bm25_scores(idx.bm25, terms, budget=16384))
    split = np.asarray(bm25_scores_two_tier(tt, terms, budget=64))
    np.testing.assert_allclose(split, full, rtol=1e-5, atol=1e-5)


def test_sharded_two_tier_matches_sparse_backend():
    import jax

    from a_nice_rag_tpu.parallel import make_mesh, shard_index
    from a_nice_rag_tpu.parallel.sharded import ShardedRetriever

    c, idx, terms_dev = _setup(n_docs=600, seed=229)
    terms = np.asarray(terms_dev)
    mesh = make_mesh(shape=(1, 4), axis_names=("dp", "corpus"),
                     devices=jax.devices()[:4])
    sidx = shard_index(idx, mesh, two_tier_common=24)
    assert sidx.tt_common is not None
    weights = {"voyage-3-large": 5.0, "BM25": 1.0}
    kw = dict(similarity_k=10, common_sections_n=8, budget=4096)
    sr_tt = ShardedRetriever(sidx, ["voyage-3-large"], use_bm25=True,
                             bm25_backend="two_tier", **kw)
    sr_sp = ShardedRetriever(sidx, ["voyage-3-large"], use_bm25=True,
                             bm25_backend="sparse", **kw)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    v_tt, i_tt = sr_tt(q, terms, weights, None, 40.0)
    v_sp, i_sp = sr_sp(q, terms, weights, None, 40.0)
    np.testing.assert_allclose(v_tt, v_sp, rtol=1e-5, atol=1e-7)
    for b in range(i_tt.shape[0]):
        assert set(i_tt[b][i_tt[b] >= 0]) == set(i_sp[b][i_sp[b] >= 0])


def test_streaming_top_k_exact():
    """bm25_top_k_two_tier must equal materialized scores + top_k:
    same score multiset and every returned id carries its true score."""
    import jax

    from a_nice_rag_tpu.ops.bm25 import bm25_top_k_two_tier

    c, idx, terms = _setup(n_docs=500, seed=229)
    tt = split_two_tier(idx.bm25, v_common=32)
    k = 12
    vals, ids = bm25_top_k_two_tier(
        tt, terms, k, budget=4096, interpret=True
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    true = np.asarray(bm25_scores_two_tier(tt, terms, budget=16384))
    ref = np.asarray(jax.lax.top_k(jnp.asarray(true), k)[0])
    # Zero-score docs are unreachable for the candidate path (they have
    # neither common nor rare postings) — compare only positive ranks.
    for b in range(vals.shape[0]):
        got = np.where(np.isfinite(vals[b]), np.maximum(vals[b], 0.0), 0.0)
        np.testing.assert_allclose(got, np.maximum(ref[b], 0.0),
                                   rtol=1e-5, atol=1e-5)
        for j in range(k):
            if np.isfinite(vals[b, j]) and vals[b, j] > 0:
                assert ids[b, j] >= 0
                np.testing.assert_allclose(
                    vals[b, j], true[b, ids[b, j]], rtol=1e-5, atol=1e-5
                )
    # No duplicate ids among finite entries.
    for b in range(vals.shape[0]):
        fin = ids[b][np.isfinite(vals[b]) & (ids[b] >= 0)]
        assert len(fin) == len(set(fin.tolist()))


def test_streaming_top_k_mask_and_oov():
    from a_nice_rag_tpu.ops.bm25 import bm25_top_k_two_tier

    c, idx, terms = _setup(n_docs=120, seed=231)
    tt = split_two_tier(idx.bm25, v_common=16)
    n_pad = tt.n_docs_padded
    mask = np.zeros(n_pad, bool)
    mask[:40] = True
    vals, ids = bm25_top_k_two_tier(
        tt, terms, 8, mask=jnp.asarray(mask), budget=4096, interpret=True
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert (ids[np.isfinite(vals) & (vals > 0)] < 40).all()
    empty = jnp.full((2, 8), -1, jnp.int32)
    v2, i2 = bm25_top_k_two_tier(tt, empty, 5, budget=512, interpret=True)
    v2 = np.asarray(v2)
    assert not (np.asarray(v2) > 0).any()


def test_sharded_two_tier_streaming_matches_materialized():
    import jax

    from a_nice_rag_tpu.parallel import make_mesh, shard_index
    from a_nice_rag_tpu.parallel.sharded import ShardedRetriever

    c, idx, terms_dev = _setup(n_docs=600, seed=233)
    terms = np.asarray(terms_dev)
    mesh = make_mesh(shape=(1, 4), axis_names=("dp", "corpus"),
                     devices=jax.devices()[:4])
    sidx = shard_index(idx, mesh, two_tier_common=24)
    weights = {"voyage-3-large": 5.0, "BM25": 1.0}
    kw = dict(similarity_k=10, common_sections_n=8, budget=4096)
    sr_st = ShardedRetriever(sidx, ["voyage-3-large"], use_bm25=True,
                             bm25_backend="two_tier_streaming", **kw)
    sr_tt = ShardedRetriever(sidx, ["voyage-3-large"], use_bm25=True,
                             bm25_backend="two_tier", **kw)
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    v_st, i_st = sr_st(q, terms, weights, None, 40.0)
    v_tt, i_tt = sr_tt(q, terms, weights, None, 40.0)
    np.testing.assert_allclose(v_st, v_tt, rtol=1e-5, atol=1e-7)
    for b in range(i_st.shape[0]):
        assert set(i_st[b][i_st[b] >= 0]) == set(i_tt[b][i_tt[b] >= 0])


def test_df_cap_sliced_fetch_matches_flat_gather():
    """The per-term window-slice rare fetch (df_cap) must produce the
    same top-k as the flat budget gather, in the two-tier streaming
    path and in bm25_top_k_sparse."""
    import jax

    from a_nice_rag_tpu.ops.bm25 import (
        bm25_top_k_sparse,
        bm25_top_k_two_tier,
    )

    c, idx, terms = _setup(n_docs=400, seed=233)
    tt = split_two_tier(idx.bm25, v_common=32)
    cap = int(np.diff(np.asarray(tt.rare.indptr)).max())
    k = 10
    v_flat, i_flat = bm25_top_k_two_tier(
        tt, terms, k, budget=4096, interpret=True
    )
    v_cap, i_cap = bm25_top_k_two_tier(
        tt, terms, k, budget=4096, interpret=True, df_cap=max(cap, 1)
    )
    np.testing.assert_allclose(
        np.asarray(v_cap), np.asarray(v_flat), rtol=1e-5, atol=1e-5
    )
    # id sets match up to ties at the k-th value
    for b in range(terms.shape[0]):
        fa = set(np.asarray(i_flat)[b][np.isfinite(np.asarray(v_flat)[b])])
        fc = set(np.asarray(i_cap)[b][np.isfinite(np.asarray(v_cap)[b])])
        assert len(fa ^ fc) <= 2, (b, fa ^ fc)

    cap_full = int(np.diff(np.asarray(idx.bm25.indptr)).max())
    v1, i1 = bm25_top_k_sparse(idx.bm25, terms, k, budget=16384)
    v2, i2 = bm25_top_k_sparse(
        idx.bm25, terms, k, budget=16384, df_cap=cap_full
    )
    np.testing.assert_allclose(
        np.asarray(v2), np.asarray(v1), rtol=1e-5, atol=1e-5
    )


def test_df_cap_with_mask():
    from a_nice_rag_tpu.ops.bm25 import bm25_top_k_sparse

    c, idx, terms = _setup(n_docs=300, seed=239)
    cap = int(np.diff(np.asarray(idx.bm25.indptr)).max())
    n_pad = idx.bm25.n_docs_padded
    mask = np.zeros(n_pad, bool)
    mask[: n_pad // 2] = True
    v1, i1 = bm25_top_k_sparse(
        idx.bm25, terms, 8, mask=jnp.asarray(mask), budget=16384
    )
    v2, i2 = bm25_top_k_sparse(
        idx.bm25, terms, 8, mask=jnp.asarray(mask), budget=16384,
        df_cap=cap,
    )
    np.testing.assert_allclose(
        np.asarray(v2), np.asarray(v1), rtol=1e-5, atol=1e-5
    )
    assert (np.asarray(i2)[np.isfinite(np.asarray(v2))] < n_pad // 2).all()


def test_df_cap_fuzz_across_corpora():
    """Window-slice fetch == flat gather across random corpora, caps,
    and term paddings (incl. all-OOV rows and duplicate terms)."""
    import jax

    from a_nice_rag_tpu.ops.bm25 import bm25_top_k_sparse

    rng = np.random.default_rng(999)
    for seed in (41, 43, 47):
        c, idx, terms = _setup(
            n_docs=int(rng.integers(60, 400)), seed=seed
        )
        t = np.asarray(terms).copy()
        # inject OOV rows and duplicated terms
        t[0, :] = -1
        if t.shape[0] > 2:
            t[2, 1::2] = t[2, 0]
        terms = jnp.asarray(t)
        cap = int(np.diff(np.asarray(idx.bm25.indptr)).max())
        k = int(rng.integers(3, 12))
        v1, i1 = bm25_top_k_sparse(idx.bm25, terms, k, budget=16384)
        v2, i2 = bm25_top_k_sparse(
            idx.bm25, terms, k, budget=16384, df_cap=cap
        )
        np.testing.assert_allclose(
            np.asarray(v2), np.asarray(v1), rtol=1e-5, atol=1e-5,
            err_msg=f"seed={seed}",
        )
        # all-OOV row produces no candidates on both paths
        assert not np.isfinite(np.asarray(v1)[0]).any()
        assert not np.isfinite(np.asarray(v2)[0]).any()


def test_df_cap_narrower_than_k():
    """t_slots * df_cap < k must pad with -inf/-1, not crash (the
    sharded auto-route also refuses such caps, but the op itself must
    hold up for direct callers)."""
    from a_nice_rag_tpu.ops.bm25 import Bm25Arrays, bm25_top_k_sparse

    # every term df=1
    v, n = 8, 16
    indptr = np.arange(v + 1, dtype=np.int32)
    doc_ids = np.concatenate(
        [np.arange(v, dtype=np.int32), [n]]).astype(np.int32)
    impact = np.concatenate(
        [np.linspace(1.0, 2.0, v, dtype=np.float32), [0.0]])
    bm = Bm25Arrays(
        indptr=jnp.asarray(indptr), doc_ids=jnp.asarray(doc_ids),
        impact=jnp.asarray(impact), n_docs_padded=n,
    )
    q = jnp.asarray([[0, 3, -1, -1]], jnp.int32)  # 4 slots, df_cap=1
    vals, ids = bm25_top_k_sparse(bm, q, k=8, df_cap=1)
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert vals.shape == (1, 8)
    assert np.isfinite(vals[0, :2]).all()
    assert set(ids[0, :2]) == {0, 3}
    assert not np.isfinite(vals[0, 2:]).any()
    assert (ids[0, 2:] == -1).all()


def test_engine_auto_two_tier_matches_csr_route():
    """FusedRetriever(two_tier_common="auto") must build the two-tier
    layout on a skewed-df corpus (common terms make the single-tier
    sparse fetch unaffordable at the given budget) and return the SAME
    fused results as the CSR route with an adequate budget (round-3
    verdict next-step 6: two-tier becomes the default, gated on
    exactness)."""
    import jax

    from a_nice_rag_tpu.retrieval import FusedRetriever

    rng = np.random.default_rng(77)
    n_docs, vocab = 600, 300
    # Skew: tokens 0..3 appear in ~90% of docs; the tail is Zipf-ish.
    tokens = []
    for d in range(n_docs):
        toks = [f"t{t}" for t in range(4) if rng.random() < 0.9]
        toks += [f"t{int(x)}" for x in
                 rng.integers(4, vocab, size=rng.integers(3, 9))]
        tokens.append(toks or ["t0"])
    c = synth_corpus(n_docs=n_docs, dim=16, n_queries=12, seed=3,
                     vocab_size=vocab)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=tokens,
        bm25_dense_max_bytes=0,  # force the CSR layout under test
    )
    # Query terms mixing common + rare tokens.
    q_tokens = [
        ["t0", "t1", f"t{10 + i}", f"t{40 + i}"] for i in range(12)
    ]
    terms = idx.pad_term_ids(q_tokens, 8)
    model = list(c.embeddings)[0]
    q = c.query_embeddings[model]
    w = {model: 5.0, "BM25": 1.0}

    # Budget small enough that the common terms (~540 postings each)
    # overflow the window criterion -> auto two-tier must engage.
    kw = dict(
        model_names=(model,), use_bm25=True, similarity_k=10,
        common_sections_n=10, budget=256, dense_backend="stream",
    )
    auto = FusedRetriever(idx, two_tier_common="auto", t_max_hint=8,
                          two_tier_dtype="float32", **kw)
    assert auto._two_tier is not None, "auto two-tier did not engage"
    # Reference: CSR route with a budget that holds every posting.
    ref = FusedRetriever(idx, two_tier_common=0, **dict(kw, budget=16384))
    assert ref._two_tier is None

    ids_a, vals_a, _ = auto({model: q}, terms, w)
    ids_r, vals_r, _ = ref({model: q}, terms, w)
    ids_a, ids_r = np.asarray(ids_a), np.asarray(ids_r)
    # Tie-aware equality: routes may order EXACT BM25 ties at the k-th
    # boundary differently (documented "up to tie order"); any doc
    # swapped between the routes must therefore have a BM25 score
    # within float noise of a doc swapped the other way.
    exact = np.asarray(bm25_scores(idx.bm25, jnp.asarray(terms),
                                   budget=16384))
    for r in range(ids_a.shape[0]):
        only_a = set(ids_a[r]) - set(ids_r[r])
        only_r = set(ids_r[r]) - set(ids_a[r])
        assert len(only_a) == len(only_r)
        for da, dr in zip(sorted(only_a), sorted(only_r)):
            np.testing.assert_allclose(
                exact[r, da], exact[r, dr], rtol=1e-4,
                err_msg=f"row {r}: non-tie divergence {da} vs {dr}",
            )
    # Values compare only where both routes ranked the same doc (a
    # tie shuffle shifts WRRF rank contributions for tied docs).
    same = ids_a == ids_r
    np.testing.assert_allclose(
        np.asarray(vals_a)[same], np.asarray(vals_r)[same],
        rtol=2e-3, atol=5e-3,
    )

    # The default bf16 common tier may swap near-tie ranks only: the
    # fused id SETS must still overlap >= 90% with the f32 reference.
    auto16 = FusedRetriever(idx, two_tier_common="auto", t_max_hint=8,
                            **kw)
    ids_b, _, _ = auto16({model: q}, terms, w)
    ids_b, ids_rn = np.asarray(ids_b), np.asarray(ids_r)
    overlap = np.mean([
        len(set(ids_b[i]) & set(ids_rn[i])) / len(set(ids_rn[i]))
        for i in range(ids_b.shape[0])
    ])
    assert overlap >= 0.9, overlap


def test_engine_auto_two_tier_skips_flat_profiles():
    """A flat-df corpus keeps the single-tier CSR path (no dense tier
    allocated)."""
    from a_nice_rag_tpu.retrieval import FusedRetriever

    c, _, _ = _setup()
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
        bm25_dense_max_bytes=0,
    )
    model = list(c.embeddings)[0]
    r = FusedRetriever(
        idx, (model,), use_bm25=True, similarity_k=10,
        common_sections_n=10, budget=16384, dense_backend="stream",
        two_tier_common="auto",
    )
    assert r._two_tier is None


def test_auto_two_tier_respects_tombstones():
    """Tombstoned docs must vanish from the auto two-tier BM25 route
    (the mask flows into bm25_top_k_two_tier) like every other path."""
    from a_nice_rag_tpu.index.updates import delete_documents
    from a_nice_rag_tpu.retrieval import FusedRetriever

    rng = np.random.default_rng(88)
    n_docs, vocab = 400, 200
    tokens = []
    for d in range(n_docs):
        t = [f"c{j}" for j in range(3) if rng.random() < 0.9]
        t += [f"r{int(x)}" for x in rng.integers(0, vocab, size=6)]
        tokens.append(t or ["c0"])
    c = synth_corpus(n_docs=n_docs, dim=16, n_queries=6, seed=5)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=tokens,
        bm25_dense_max_bytes=0,
    )
    model = list(c.embeddings)[0]
    r = FusedRetriever(
        idx, (model,), use_bm25=True, similarity_k=10,
        common_sections_n=10, budget=128, dense_backend="stream",
        two_tier_common="auto", t_max_hint=8,
    )
    assert r._two_tier is not None
    q = c.query_embeddings[model][:4]
    terms = idx.pad_term_ids([["c0", "r1", "r2"]] * 4, 8)
    ids0, _, _ = r({model: q}, terms, {model: 5.0, "BM25": 1.0})
    victims = sorted({int(i) for i in np.asarray(ids0).ravel()
                      if i >= 0})[:5]
    victim_ids = [idx.meta.ids[v] for v in victims]
    assert delete_documents(idx, victim_ids) == len(victim_ids)
    ids1, _, _ = r({model: q}, terms, {model: 5.0, "BM25": 1.0})
    surviving = {int(i) for i in np.asarray(ids1).ravel() if i >= 0}
    assert not (surviving & set(victims)), (surviving, victims)
