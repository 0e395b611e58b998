"""IVF ANN layer: k-means, tile-table construction, probed search.

The exact-parity anchor: with nprobe == n_clusters every corpus tile is
scheduled, so ivf_search must equal the exact brute-force top-k
(including scores). Partial probing is checked against an overlap
floor on planted-cluster data.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_nice_rag_tpu.index.ivf import (
    build_ivf_dense,
    build_tile_table,
    ivf_search,
)
from a_nice_rag_tpu.ops.kmeans import spherical_kmeans


def _unit(x):
    return x / np.linalg.norm(x, axis=-1, keepdims=True)


@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(7)
    c_true, d, per = 12, 48, 40
    cents = _unit(rng.normal(size=(c_true, d)))
    x = _unit(
        np.repeat(cents, per, axis=0)
        + 0.08 * rng.normal(size=(c_true * per, d))
    ).astype(np.float32)
    gold = rng.integers(0, len(x), 16)
    q = _unit(
        x[gold] + 0.12 * rng.normal(size=(16, d))
    ).astype(np.float32)
    return x, q, gold


def test_kmeans_planted_probe_hit(clustered):
    x, q, gold = clustered
    cent, assign = spherical_kmeans(jnp.asarray(x), 12, n_iters=12, seed=1)
    cent, assign = np.asarray(cent), np.asarray(assign)
    # IVF-relevant property: the gold doc's cluster appears in the
    # query's top-4 probed clusters essentially always.
    probes = np.argsort(-(q @ cent.T), axis=1)[:, :4]
    hit = np.mean([assign[g] in probes[i] for i, g in enumerate(gold)])
    assert hit >= 0.9, hit
    # Unit-norm centroids.
    np.testing.assert_allclose(
        np.linalg.norm(cent, axis=1), 1.0, atol=1e-5
    )


def test_kmeans_handles_padding_and_tiny_inputs():
    rng = np.random.default_rng(0)
    x = _unit(rng.normal(size=(37, 16))).astype(np.float32)  # odd N
    cent, assign = spherical_kmeans(jnp.asarray(x), 5, n_iters=4, seed=0)
    assert assign.shape == (37,)
    assert int(np.asarray(assign).max()) < 5
    # Assignments are the argmax of x @ cent^T (padding never leaks).
    expect = np.argmax(x @ np.asarray(cent).T, axis=1)
    np.testing.assert_array_equal(np.asarray(assign), expect)


def test_ivf_exact_parity_full_probe(clustered):
    """nprobe == n_clusters schedules every tile -> exact top-k."""
    x, q, _ = clustered
    # N=480: NOT a tile multiple (tile_n=128) — exercises the
    # last-tile valid-count masking in the kernel.
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0
    )
    assert ivf.n_real == 480 and ivf.emb.shape[0] == 512
    k = 9
    vals, ids, n_unique = ivf_search(
        ivf, jnp.asarray(q), k, nprobe=12, interpret=True
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert int(n_unique) == ivf.n_tiles
    ref = q @ x.T
    ref_ids = np.argsort(-ref, axis=1)[:, :k]
    for b in range(q.shape[0]):
        assert set(ids[b]) == set(ref_ids[b])
        np.testing.assert_allclose(
            np.sort(vals[b]),
            np.sort(ref[b, ref_ids[b]]),
            rtol=1e-5,
        )
        assert (ids[b] >= 0).all()  # pad rows never surface


def test_ivf_partial_probe_overlap(clustered):
    x, q, gold = clustered
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0
    )
    k = 9
    vals, ids, _ = ivf_search(
        ivf, jnp.asarray(q), k, nprobe=3, interpret=True
    )
    ids = np.asarray(ids)
    ref_ids = np.argsort(-(q @ x.T), axis=1)[:, :k]
    overlap = np.mean(
        [len(set(ids[b]) & set(ref_ids[b])) / k for b in range(len(q))]
    )
    assert overlap >= 0.8, overlap
    # Scores of returned docs are the TRUE cosines (exact over the
    # scheduled tiles — no quantization of the scores themselves).
    ref = q @ x.T
    vals = np.asarray(vals)
    for b in range(len(q)):
        got = {int(i): v for i, v in zip(ids[b], vals[b]) if i >= 0}
        for i, v in got.items():
            np.testing.assert_allclose(v, ref[b, i], rtol=1e-5)


def test_tile_table_dedup_and_overflow(clustered):
    x, q, _ = clustered
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0
    )
    table, n_unique = build_tile_table(
        ivf.centroids, ivf.cluster_start, jnp.asarray(q),
        nprobe=12, max_tiles=ivf.n_tiles, tile_n=ivf.tile_n,
        mct=ivf.max_cluster_tiles,
    )
    table = np.asarray(table)
    real = table[table >= 0]
    assert len(np.unique(real)) == len(real)  # deduped
    assert int(n_unique) == len(real)
    # Truncation is visible: a 2-slot table reports the same demand.
    t2, n2 = build_tile_table(
        ivf.centroids, ivf.cluster_start, jnp.asarray(q),
        nprobe=12, max_tiles=2, tile_n=ivf.tile_n,
        mct=ivf.max_cluster_tiles,
    )
    assert int(n2) == int(n_unique) and np.asarray(t2).shape == (2,)


def test_ivf_int8_full_probe_matches_xla_int8(clustered):
    """Int8 IVF at full probe == the XLA int8 exact top-k (same
    quantized scores, same ids up to score ties)."""
    from a_nice_rag_tpu.index.ivf import build_ivf_quantized
    from a_nice_rag_tpu.ops.quantized import (
        quantize_embeddings,
        quantize_queries,
        quantized_dense_scores,
    )

    x, q, _ = clustered
    qd = quantize_embeddings(jnp.asarray(x))
    ivf = build_ivf_quantized(qd, n_clusters=12, tile_n=128,
                              n_iters=6, seed=0)
    assert ivf.values is not None and ivf.emb is None
    k = 9
    vals, ids, _ = ivf_search(
        ivf, jnp.asarray(q), k, nprobe=12, interpret=True
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    qv, qs = quantize_queries(jnp.asarray(q))
    ref = np.asarray(quantized_dense_scores(qd, qv, qs))
    ref_ids = np.argsort(-ref, axis=1)[:, :k]
    for b in range(q.shape[0]):
        np.testing.assert_allclose(
            np.sort(vals[b]),
            np.sort(ref[b, ref_ids[b]]),
            rtol=1e-5,
        )
    # Partial probe still overlaps well.
    _, ids3, _ = ivf_search(
        ivf, jnp.asarray(q), k, nprobe=3, interpret=True
    )
    ids3 = np.asarray(ids3)
    overlap = np.mean(
        [len(set(ids3[b]) & set(ref_ids[b])) / k for b in range(len(q))]
    )
    assert overlap >= 0.75, overlap


def test_engine_ivf_route_and_filtered_fallback():
    """FusedRetriever(nprobe=...) serves the ANN route unfiltered and
    falls back to the exact masked scan when a filter is active; IVF
    structures survive the index save/load roundtrip."""
    import os
    import tempfile

    from a_nice_rag_tpu.index import build_index, load_index, save_index
    from a_nice_rag_tpu.index.ivf import attach_ivf
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(n_docs=128, dim=32, n_queries=8, seed=41)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    attach_ivf(idx, "voyage-3-large", n_clusters=8, tile_n=32, n_iters=6)
    d = tempfile.mkdtemp()
    save_index(idx, os.path.join(d, "a"))
    idx = load_index(os.path.join(d, "a"))
    assert idx.ivf and "voyage-3-large" in idx.ivf

    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    terms = idx.pad_term_ids(c.query_tokens, 8)
    w = {"voyage-3-large": 5.0, "BM25": 1.0}
    # Full probe == the exact engine result.
    r_ivf = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=True,
        similarity_k=10, common_sections_n=10, budget=1024, nprobe=8,
    )
    r_exact = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=True,
        similarity_k=10, common_sections_n=10, budget=1024,
    )
    f1, _, _ = r_ivf(q, terms, w, None, 40.0)
    f2, _, _ = r_exact(q, terms, w, None, 40.0)
    np.testing.assert_array_equal(f1, f2)
    # Partial probe still finds the planted golds.
    r_p = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=True,
        similarity_k=10, common_sections_n=10, budget=1024, nprobe=3,
    )
    f3, _, _ = r_p(q, terms, w, None, 40.0)
    hits = sum(
        c.gold_ids[b] in [idx.meta.ids[i] for i in f3[b] if i >= 0]
        for b in range(8)
    )
    assert hits >= 6, hits
    # Filtered call: exact masked fallback, filter respected.
    f4, _, _ = r_p(q, terms, w, "CG", 40.0)
    f5, _, _ = r_exact(q, terms, w, "CG", 40.0)
    np.testing.assert_array_equal(f4, f5)
    for b in range(8):
        for i in f4[b]:
            if i >= 0:
                assert idx.meta.sources[i].upper().startswith("CG")


def test_ivf_permutation_roundtrip(clustered):
    """Cluster-major permutation preserves every document exactly."""
    x, _, _ = clustered
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=4, seed=0
    )
    perm = np.asarray(ivf.perm)
    emb_p = np.asarray(ivf.emb)
    assert sorted(perm[perm >= 0].tolist()) == list(range(len(x)))
    np.testing.assert_allclose(emb_p[perm >= 0], x[perm[perm >= 0]])
    # Padding rows are zero.
    assert (emb_p[perm < 0] == 0).all()


def test_tile_table_smaller_candidate_set_than_table():
    """max_tiles above the candidate bound (B*p*mct) pads with
    sentinels instead of failing (tiny-batch latency mode)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(480, 32)).astype(np.float32)
    from a_nice_rag_tpu.index.ivf import build_ivf_dense

    ivf = build_ivf_dense(jnp.asarray(x), n_clusters=12, tile_n=128,
                          n_iters=4, seed=0)
    q = jnp.asarray(x[:2])
    table, n_uniq = build_tile_table(
        ivf.centroids, ivf.cluster_start, q, nprobe=1,
        max_tiles=ivf.n_tiles, tile_n=128, mct=ivf.max_cluster_tiles,
    )
    table = np.asarray(table)
    assert table.shape == (ivf.n_tiles,)
    assert (table[int(n_uniq):] == -1).all()
    assert (table[:int(n_uniq)] >= 0).all()


def test_committed_ivf_recall_sweep_gates():
    """The committed recall/cost sweep artifact keeps its qualitative
    structure: recall and tile fraction monotone in nprobe, full probe
    exact-identical (overlap@10 == 1, recall == exact recall)."""
    import csv
    import os

    path = os.path.join(os.path.dirname(__file__), "..", "results",
                        "ivf_recall_sweep_synthetic.csv")
    with open(path) as f:
        all_rows = list(csv.DictReader(f))
    by_spill = {
        s: [r for r in all_rows if int(r.get("spill", 0)) == s]
        for s in (0, 1)
    }
    assert len(by_spill[0]) >= 6 and len(by_spill[1]) >= 6
    for rows in by_spill.values():
        rec = [float(r["recall@10_planted"]) for r in rows]
        frac = [float(r["mean_tile_fraction_b8"]) for r in rows]
        assert all(b >= a - 1e-9 for a, b in zip(rec, rec[1:]))
        assert all(b >= a - 1e-9 for a, b in zip(frac, frac[1:]))
        last = rows[-1]
        assert int(last["nprobe"]) == int(last["n_clusters"])
        assert float(last["overlap@10_vs_exact"]) == 1.0
        assert rec[-1] == float(last["exact_recall@10_planted"])
        # The ANN price at the cheapest probe is visible but small.
        assert frac[0] < 0.5 and rec[0] >= 0.8 * rec[-1]
    # Spill's purpose: strictly better low-nprobe agreement with the
    # exact top-10 (boundary docs recovered from the second cluster).
    o0 = float(by_spill[0][0]["overlap@10_vs_exact"])
    o1 = float(by_spill[1][0]["overlap@10_vs_exact"])
    assert int(by_spill[0][0]["nprobe"]) == 1
    assert o1 > o0, (o0, o1)


def test_ivf_with_online_updates():
    """Tombstone deletes force the exact masked fallback (the ANN
    kernel has no mask operand) and reflect immediately; appends return
    a fresh index WITHOUT the stale IVF — ANN must be re-attached, it
    can never silently miss appended docs."""
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.index.ivf import attach_ivf
    from a_nice_rag_tpu.index.updates import (
        append_documents,
        delete_documents,
        undelete_documents,
    )
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(n_docs=128, dim=32, n_queries=8, seed=17)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    attach_ivf(idx, "voyage-3-large", n_clusters=8, tile_n=32, n_iters=6)
    r = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=False,
        similarity_k=10, common_sections_n=10, nprobe=8,
    )
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:1]}
    f0, _, _ = r(q, None, {"voyage-3-large": 1.0}, None, 40.0)
    gold_row = idx.meta.id_to_row[c.gold_ids[0]]
    assert gold_row in f0[0]
    delete_documents(idx, [c.gold_ids[0]])
    f1, _, _ = r(q, None, {"voyage-3-large": 1.0}, None, 40.0)
    assert gold_row not in f1[0]
    undelete_documents(idx, [c.gold_ids[0]])
    f2, _, _ = r(q, None, {"voyage-3-large": 1.0}, None, 40.0)
    np.testing.assert_array_equal(f0, f2)
    # Appends drop the IVF: the returned index carries none.
    rng = np.random.default_rng(5)
    emb = rng.normal(size=(4, 32)).astype(np.float32)
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    idx2 = append_documents(
        idx, [f"new{i}" for i in range(4)], ["NG1"] * 4, ["text"] * 4,
        embeddings={"voyage-3-large": emb},
        token_lists=[["alpha"], ["beta"], ["gamma"], ["delta"]],
    )
    assert idx2.ivf is None


def test_batched_kmeans_matches_sequential():
    """spherical_kmeans_batched(seed per shard) reproduces the
    sequential per-shard runs (same init rows, same Lloyd math)."""
    from a_nice_rag_tpu.ops.kmeans import (
        spherical_kmeans,
        spherical_kmeans_batched,
    )

    rng = np.random.default_rng(2)
    s_cnt, npad, d, c = 3, 256, 24, 6
    xs = _unit(rng.normal(size=(s_cnt, npad, d))).astype(np.float32)
    reals = np.asarray([256, 200, 31], np.int32)  # one shard part-pad
    for s in range(s_cnt):
        xs[s, reals[s]:] = 0.0
    cents_b, assign_b = spherical_kmeans_batched(
        jnp.asarray(xs), reals, c, n_iters=6, seed=9
    )
    cents_b, assign_b = np.asarray(cents_b), np.asarray(assign_b)
    for s in range(s_cnt):
        cent, assign = spherical_kmeans(
            jnp.asarray(xs[s, :reals[s]]), c, n_iters=6, seed=9 + s
        )
        np.testing.assert_allclose(
            cents_b[s], np.asarray(cent), rtol=2e-5, atol=2e-6
        )
        agree = np.mean(assign_b[s, :reals[s]] == np.asarray(assign))
        assert agree >= 0.99, (s, agree)


# ------------------------------------------------------------ spill


def test_spill_layout_invariants(clustered):
    x, q, _ = clustered
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0,
        spill=True,
    )
    n = len(x)
    assert ivf.spilled
    # Full spill: every doc in exactly two clusters.
    assert ivf.n_real == 2 * n
    perm = np.asarray(ivf.perm)
    counts = np.bincount(perm[perm >= 0], minlength=n)
    assert (counts == 2).all()
    # Duplicated rows carry the same embedding as the original.
    emb = np.asarray(ivf.emb)
    for r in range(0, ivf.n_real, 97):
        np.testing.assert_array_equal(emb[r], x[perm[r]])
    # cluster_start covers all slots.
    cs = np.asarray(ivf.cluster_start)
    assert cs[-1] == ivf.n_real
    # Margin-limited spill stores fewer copies.
    ivf_m = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0,
        spill=True, spill_margin=0.05,
    )
    assert n <= ivf_m.n_real <= 2 * n
    assert ivf_m.n_real < 2 * n  # planted clusters: most docs interior


def test_spill_full_probe_equals_exact_after_dedup(clustered):
    """Full probe over a spilled layout sees every doc (some twice);
    dedup must land exactly on the brute-force top-k."""
    x, q, _ = clustered
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0,
        spill=True,
    )
    k = 9
    vals, ids, _ = ivf_search(
        ivf, jnp.asarray(q), k, nprobe=12, interpret=True
    )
    vals, ids = np.asarray(vals), np.asarray(ids)
    ref = q @ x.T
    ref_ids = np.argsort(-ref, axis=1)[:, :k]
    for b in range(q.shape[0]):
        assert len(set(ids[b])) == k  # no duplicates survive
        assert set(ids[b]) == set(ref_ids[b])
        np.testing.assert_allclose(
            np.sort(vals[b]), np.sort(ref[b, ref_ids[b]]), rtol=1e-5
        )


def test_spill_lifts_low_nprobe_overlap(clustered):
    """The point of spilling: nprobe=1 must recover boundary docs the
    unspilled layout misses, and never do worse."""
    x, q, _ = clustered
    k = 9
    ref_ids = np.argsort(-(q @ x.T), axis=1)[:, :k]

    def overlap(spill):
        ivf = build_ivf_dense(
            jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=8, seed=0,
            spill=spill,
        )
        _, ids, _ = ivf_search(
            ivf, jnp.asarray(q), k, nprobe=1, interpret=True
        )
        ids = np.asarray(ids)
        return np.mean(
            [len(set(ids[b]) & set(ref_ids[b])) / k for b in range(len(q))]
        )

    o0, o1 = overlap(False), overlap(True)
    assert o1 >= o0, (o0, o1)
    assert o1 > o0 or o0 == 1.0, (o0, o1)


def test_spill_quantized_and_persistence(tmp_path, clustered):
    from a_nice_rag_tpu.index.ivf import (
        build_ivf_quantized,
        load_ivf,
        save_ivf,
    )
    from a_nice_rag_tpu.ops.quantized import quantize_embeddings

    x, q, _ = clustered
    qd = quantize_embeddings(jnp.asarray(x))
    ivf = build_ivf_quantized(
        qd, n_clusters=12, tile_n=128, n_iters=8, seed=0, spill=True,
    )
    assert ivf.spilled and ivf.n_real == 2 * len(x)
    k = 9
    vals, ids, _ = ivf_search(
        ivf, jnp.asarray(q), k, nprobe=12, interpret=True
    )
    ids = np.asarray(ids)
    for b in range(q.shape[0]):
        assert len(set(ids[b])) == k
    path = str(tmp_path / "ivf_spill.npz")
    save_ivf(ivf, path)
    back = load_ivf(path)
    assert back.spilled and back.n_real == ivf.n_real
    v2, i2, _ = ivf_search(
        back, jnp.asarray(q), k, nprobe=12, interpret=True
    )
    np.testing.assert_array_equal(ids, np.asarray(i2))


def test_dedup_ranked():
    from a_nice_rag_tpu.ops.topk import dedup_ranked

    v = jnp.asarray([[9.0, 9.0, 7.0, 7.0, 5.0, -jnp.inf],
                     [3.0, 2.0, 1.0, -jnp.inf, -jnp.inf, -jnp.inf]])
    i = jnp.asarray([[4, 4, 2, 9, 4, -1],
                     [7, 7, 7, -1, -1, -1]], jnp.int32)
    dv, di = dedup_ranked(v, i)
    np.testing.assert_array_equal(
        np.asarray(di), [[4, 2, 9, -1, -1, -1], [7, -1, -1, -1, -1, -1]]
    )
    np.testing.assert_array_equal(
        np.asarray(dv),
        [[9.0, 7.0, 7.0, -np.inf, -np.inf, -np.inf],
         [3.0, -np.inf, -np.inf, -np.inf, -np.inf, -np.inf]],
    )


def test_engine_spilled_ivf_route():
    """FusedRetriever(nprobe=...) over a spilled IVF: unique ids, and
    full probe matches the exact program."""
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.index.ivf import attach_ivf
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(n_docs=600, dim=32, n_queries=8, seed=3)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    attach_ivf(idx, "voyage-3-large", n_clusters=10, tile_n=128,
               n_iters=6, seed=0, spill=True)
    assert idx.ivf["voyage-3-large"].spilled
    q = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    terms = idx.pad_term_ids(c.query_tokens, 8)
    w = {"voyage-3-large": 1.0, "BM25": 0.0}
    exact = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=False,
        similarity_k=10, common_sections_n=10,
    )
    ann = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=False,
        similarity_k=10, common_sections_n=10, nprobe=10,
    )
    r_exact, _, _ = exact(q, terms, w, None, 40.0)
    r_ann, _, _ = ann(q, terms, w, None, 40.0)
    r_exact, r_ann = np.asarray(r_exact), np.asarray(r_ann)
    for b in range(8):
        valid = r_ann[b][r_ann[b] >= 0]
        assert len(set(valid)) == len(valid), "duplicate ids surfaced"
    np.testing.assert_array_equal(r_exact, r_ann)


def test_tune_nprobe_picks_smallest_meeting_target(clustered):
    from a_nice_rag_tpu.index.ivf import tune_nprobe

    x, q, gold = clustered
    ivf = build_ivf_dense(
        jnp.asarray(x), n_clusters=12, tile_n=128, n_iters=12, seed=1
    )
    best, report = tune_nprobe(
        ivf, jnp.asarray(q), k=5, target_recall=0.9,
        candidates=(1, 2, 4, 8, 64), interpret=True,
    )
    assert best in report and report[best] >= 0.9
    # Monotone-ish: every candidate cheaper than best fell short.
    for c, r in report.items():
        if c < best:
            assert r < 0.9
    # The full probe (clamped 64 -> 12 clusters) is exact: recall 1.0.
    _, full_report = tune_nprobe(
        ivf, jnp.asarray(q), k=5, target_recall=2.0,  # unreachable
        candidates=(12,), interpret=True,
    )
    assert full_report[12] == 1.0


def test_engine_ivf_route_auto_batches(monkeypatch):
    """ivf_route="auto" (the default) probes only while the expected
    cluster coverage 1-(1-p/C)^B stays under ivf_max_coverage; wider
    batches take the exact stream (whose per-query cost is amortized
    over the batch). "always" restores the unconditional probe. The
    route is decided at trace time, so a counting wrapper on the
    tile-table builder observes it. Here C=8, nprobe=2: B=2 covers
    ~0.44 (probes at an explicit 0.5 threshold; the production
    default is 0.25), B=8 covers ~0.90 (exact)."""
    import a_nice_rag_tpu.index.ivf as ivf_mod
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.index.ivf import attach_ivf
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(n_docs=128, dim=32, n_queries=8, seed=7)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    attach_ivf(idx, "voyage-3-large", n_clusters=8, tile_n=32, n_iters=6)
    q8 = {"voyage-3-large": c.query_embeddings["voyage-3-large"]}
    q2 = {"voyage-3-large": c.query_embeddings["voyage-3-large"][:2]}
    terms8 = idx.pad_term_ids(c.query_tokens, 8)
    w = {"voyage-3-large": 5.0, "BM25": 1.0}

    calls = []
    real = ivf_mod.build_tile_table
    monkeypatch.setattr(
        ivf_mod, "build_tile_table",
        lambda *a, **k: calls.append(1) or real(*a, **k),
    )

    def fresh(nprobe=2, **kw):
        return FusedRetriever(
            idx, ("voyage-3-large",), use_bm25=True, similarity_k=10,
            common_sections_n=10, budget=1024, nprobe=nprobe, **kw,
        )

    from a_nice_rag_tpu.retrieval.engine import _ivf_coverage

    assert _ivf_coverage(2, 2, 8) <= 0.5 < _ivf_coverage(8, 2, 8)
    # Full probe (p == C) covers everything at any batch: auto routes
    # exact even at B=1 — the probe would schedule every tile anyway.
    assert _ivf_coverage(1, 8, 8) == 1.0
    # The calibrated production default (see engine docstring).
    assert FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=True, similarity_k=10,
        common_sections_n=10, budget=1024,
    ).ivf_max_coverage == 0.25

    # auto + wide batch: exact stream, no probe; equals the exact engine.
    r = fresh()
    got, _, _ = r(q8, terms8, w, None, 40.0)
    assert not calls
    exact = FusedRetriever(
        idx, ("voyage-3-large",), use_bm25=True, similarity_k=10,
        common_sections_n=10, budget=1024,
    )
    want, _, _ = exact(q8, terms8, w, None, 40.0)
    np.testing.assert_array_equal(got, want)
    # auto + narrow batch (coverage 0.44 <= explicit 0.5): probes.
    fresh(ivf_max_coverage=0.5)(q2, terms8[:2], w, None, 40.0)
    assert calls
    # ...but the tighter calibrated default routes the same B=2 exact.
    calls.clear()
    fresh()(q2, terms8[:2], w, None, 40.0)
    assert not calls
    # always + wide batch: probes regardless.
    calls.clear()
    fresh(nprobe=8, ivf_route="always")(q8, terms8, w, None, 40.0)
    assert calls
    # invalid route rejected eagerly.
    with pytest.raises(ValueError):
        fresh(ivf_route="sometimes")
