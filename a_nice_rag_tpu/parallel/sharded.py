"""Corpus-sharded retrieval over a device mesh.

Layout (the scaling-book recipe: pick a mesh, annotate shardings, let XLA
insert collectives):

* dense matrix  [N_pad, D]   -> P("corpus", None)
* BM25 postings [S, ...]     -> P("corpus", None)  (stacked per-shard CSR)
* candidate masks [N_pad]    -> P("corpus")
* query batch  [B, D]        -> P("dp", None)

Inside ``shard_map`` each device scores its corpus shard and takes a
local top-k; local indices are rebased to global ids, all-gathered over
the ``corpus`` axis (payload is S*k ids+scores per query, tiny),
and k-way merged. The merge of per-shard top-k lists is EXACT: any
global top-k document is by definition in its own shard's top-k. Fusion
then runs on global id lists via the sparse WRRF (no N-sized buffer).

This replaces the "distributed communication backend: absent" row of
SURVEY.md §5 with XLA collectives, within a host and across hosts.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from a_nice_rag_tpu.index.array_index import ArrayIndex
from a_nice_rag_tpu.ops.bm25 import (
    Bm25Arrays,
    Bm25TwoTier,
    bm25_scores_two_tier,
    bm25_top_k_sparse,
    bm25_top_k_two_tier,
    split_two_tier,
)
from a_nice_rag_tpu.ops.dense import dense_scores
from a_nice_rag_tpu.ops.fusion import wrrf_top_n_sparse
from a_nice_rag_tpu.ops.quantized import (
    QuantizedDense,
    quantize_queries,
    quantized_dense_scores,
)
from a_nice_rag_tpu.ops.streaming import choose_route, dense_stream_top_k
from a_nice_rag_tpu.ops.topk import masked_top_k, merge_top_k


@dataclasses.dataclass
class ShardedIndex:
    """Device-mesh-resident hybrid index, corpus axis sharded."""

    mesh: Mesh
    # model -> [N_pad, D] array sharded P(corpus, None), OR a
    # QuantizedDense whose values/scales are corpus-sharded (int8
    # indexes built with build_index(quantize_dense=...)).
    dense: Dict[str, jax.Array]
    bm25_indptr: Optional[jax.Array]  # [S, V+1]
    bm25_doc_ids: Optional[jax.Array]  # [S, nnz_pad+1]
    bm25_impact: Optional[jax.Array]  # [S, nnz_pad+1]
    base_index: ArrayIndex
    n_local: int  # docs per shard (padded)
    n_shards: int
    corpus_axis: str = "corpus"
    data_axis: str = "dp"
    # Multi-host layout: when set, the document axis is sharded over
    # (host_axis, corpus_axis) host-major and top-k merges run
    # hierarchically — within each host first, then across hosts
    # (SURVEY.md §7 stage 5, multi-host).
    host_axis: Optional[str] = None
    # Optional two-tier layout (common dense rows + rare CSR per shard).
    tt_common: Optional[jax.Array] = None  # [S, Vc, N_local]
    tt_map: Optional[jax.Array] = None  # [S, V+1]
    tt_rare_indptr: Optional[jax.Array] = None  # [S, V+1]
    tt_rare_doc_ids: Optional[jax.Array] = None  # [S, rare_nnz_pad+1]
    tt_rare_impact: Optional[jax.Array] = None  # [S, rare_nnz_pad+1]
    # Build kwargs retained so failure recovery (reshard_surviving) can
    # rebuild the *same* layout — notably the two-tier streaming BM25
    # configuration — over the surviving devices.
    two_tier_common: int = 0
    two_tier_dtype: str = "bfloat16"
    # Per-shard IVF ANN layout for ONE flagship model (shard_ivf):
    # each shard clusters its own rows; probing and the probed streaming
    # top-k run per shard inside the pjit program, merged like every
    # other ranked list. Rows are the cluster-major permuted local
    # matrix ([S, Npl, D] float or a QuantizedDense of stacked
    # values/scales); perms map permuted -> LOCAL row.
    ivf_model: Optional[str] = None
    ivf_centroids: Optional[jax.Array] = None  # [S, C, D] f32
    ivf_rows: Optional[object] = None  # [S, Npl, D] or QuantizedDense
    ivf_perm: Optional[jax.Array] = None  # [S, Npl] int32
    ivf_cluster_start: Optional[jax.Array] = None  # [S, C+1] int32
    ivf_n_real: Optional[jax.Array] = None  # [S] int32
    ivf_tile_n: int = 0
    ivf_mct: int = 0
    # Spilled per-shard layouts store boundary docs in their two nearest
    # clusters (index/ivf.py spill); the retriever dedups per shard
    # before the cross-shard merge. Margin kept so failure recovery
    # rebuilds the same configuration.
    ivf_spilled: bool = False
    ivf_spill_margin: Optional[float] = None

    def __post_init__(self) -> None:
        self._mask_cache: Dict[Optional[str], jax.Array] = {}

    @property
    def n_docs_padded(self) -> int:
        return self.n_local * self.n_shards

    @property
    def doc_axes(self):
        """Mesh axes the document dimension is sharded over (host-major)."""
        if self.host_axis is not None:
            return (self.host_axis, self.corpus_axis)
        return self.corpus_axis

    def refresh_masks(self) -> None:
        """Drop cached device masks immediately (the version-keyed
        caches below also refresh lazily on their next call)."""
        self._mask_cache.clear()

    def _evict_stale(self, version: int) -> None:
        for k in [k for k in self._mask_cache if k[-1] != version]:
            del self._mask_cache[k]

    def filter_mask(self, filename_type_filter: Optional[str]) -> jax.Array:
        # Version-keyed on the base index so tombstone deletes
        # (index.updates) are visible on the next call; stale-version
        # entries are evicted, not leaked.
        version = getattr(self.base_index, "_version", 0)
        key = (filename_type_filter or None, version)
        if key not in self._mask_cache:
            self._evict_stale(version)
            m = self.base_index.meta.filter_mask(filename_type_filter)
            m = np.pad(m, (0, self.n_docs_padded - m.shape[0]))
            sh = NamedSharding(self.mesh, P(self.doc_axes))
            self._mask_cache[key] = jax.device_put(m, sh)
        return self._mask_cache[key]

    def bm25_mask(self, filename_type_filter: Optional[str]) -> jax.Array:
        version = getattr(self.base_index, "_version", 0)
        key = ("bm25", filename_type_filter or None, version)
        if key not in self._mask_cache:
            self._evict_stale(version)
            m = self.base_index.meta.filter_mask(filename_type_filter)
            if self.base_index.bm25_doc_mask is not None:
                m = m & self.base_index.bm25_doc_mask
            m = np.pad(m, (0, self.n_docs_padded - m.shape[0]))
            sh = NamedSharding(self.mesh, P(self.doc_axes))
            self._mask_cache[key] = jax.device_put(m, sh)
        return self._mask_cache[key]


def _shard_csr(
    indptr: np.ndarray,
    doc_ids: np.ndarray,
    impact: np.ndarray,
    n_shards: int,
    n_local: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Split a global CSR postings structure into stacked per-shard CSRs.

    Postings are already grouped contiguously by (term, shard) because
    each term's postings are sorted by doc id, so extraction is a pure
    boolean select per shard. Impact values are unchanged: BM25 scoring
    statistics (idf, avgdl) stay GLOBAL so sharded scores equal
    single-device scores exactly.
    """
    v = indptr.shape[0] - 1
    nnz = int(indptr[-1])
    ids = doc_ids[:nnz]
    imp = impact[:nnz]
    term_of = np.repeat(np.arange(v, dtype=np.int64), np.diff(indptr))
    shard_of = ids // n_local

    parts_ids, parts_imp, parts_ptr = [], [], []
    for s in range(n_shards):
        sel = shard_of == s
        local_ids = (ids[sel] - s * n_local).astype(np.int32)
        counts = np.zeros(v, dtype=np.int64)
        np.add.at(counts, term_of[sel], 1)
        ptr = np.zeros(v + 1, dtype=np.int32)
        np.cumsum(counts, out=ptr[1:])
        parts_ids.append(local_ids)
        parts_imp.append(imp[sel].astype(np.float32))
        parts_ptr.append(ptr)

    nnz_pad = max(p.shape[0] for p in parts_ids)
    s_doc_ids = np.full((n_shards, nnz_pad + 1), n_local, dtype=np.int32)
    s_impact = np.zeros((n_shards, nnz_pad + 1), dtype=np.float32)
    for s in range(n_shards):
        k = parts_ids[s].shape[0]
        s_doc_ids[s, :k] = parts_ids[s]
        s_impact[s, :k] = parts_imp[s]
        # Sentinel slot (index nnz_pad) dumps padded gathers onto row
        # n_local with impact 0 (matches ops.bm25 conventions).
    s_indptr = np.stack(parts_ptr)
    return s_indptr, s_doc_ids, s_impact


def _to_mesh(x, n_total: int, sharding: NamedSharding) -> jax.Array:
    """Lay ``x`` out over the mesh with its doc axis zero-padded to
    ``n_total``, one shard at a time: each device receives its own rows
    (padded alone), so neither the host nor the source device ever holds
    a second full copy of the corpus."""
    n = x.shape[0]
    xp = np if isinstance(x, np.ndarray) else jnp

    def shard(index):
        lo, hi, _ = index[0].indices(n_total)
        part = x[min(lo, n):min(hi, n)]
        if part.shape[0] < hi - lo:
            part = xp.pad(part, [(0, hi - lo - part.shape[0])]
                          + [(0, 0)] * (x.ndim - 1))
        return part

    return jax.make_array_from_callback(
        (n_total,) + tuple(x.shape[1:]), sharding, shard
    )


def _local_rows(sidx: "ShardedIndex", model_name: str, width: int,
                perm=None):
    """A model's rows per shard, ``[S, width, D]`` (plus scales
    ``[S, width]`` for an int8 model, else None), cut or zero-padded
    from the sharded matrix on the devices. With ``perm`` ([S, width]
    local row ids, -1 for a pad slot) row j of shard s is local row
    ``perm[s, j]`` instead, zero where the id is -1."""
    mat = sidx.dense[model_name]
    s_cnt, nl = sidx.n_shards, sidx.n_local

    def fit(x, p):
        x = x.reshape((s_cnt, nl) + x.shape[1:])
        if p is not None:
            taken = jax.vmap(lambda a, i: jnp.take(a, i, axis=0))(
                x, jnp.clip(p, 0, nl - 1))
            live = (p >= 0).reshape(p.shape + (1,) * (x.ndim - 2))
            return jnp.where(live, taken, jnp.zeros((), x.dtype))
        if width > nl:
            return jnp.pad(
                x, [(0, 0), (0, width - nl)] + [(0, 0)] * (x.ndim - 2)
            )
        return x[:, :width]

    def laid_out(x):
        spec = P(sidx.doc_axes, *([None] * x.ndim))
        return jax.jit(
            fit, out_shardings=NamedSharding(sidx.mesh, spec)
        )(x, perm)

    if isinstance(mat, QuantizedDense):
        return laid_out(mat.values), laid_out(mat.scales)
    return laid_out(mat), None


def shard_index(index: ArrayIndex, mesh: Mesh, corpus_axis: str = "corpus",
                data_axis: str = "dp", two_tier_common: int = 0,
                two_tier_dtype: str = "bfloat16",
                host_axis: Optional[str] = None) -> ShardedIndex:
    """Lay an ArrayIndex out across the mesh's corpus axis.

    ``two_tier_common > 0`` additionally builds the per-shard two-tier
    BM25 layout (that many dense common-term rows per shard + rare CSR),
    cutting the sharded BM25 postings budget by orders of magnitude
    (see ops.bm25.split_two_tier).

    ``host_axis`` shards the document axis over (host, corpus) host-major
    for multi-host meshes; retrieval then merges hierarchically (within
    a host first, then one k-list per host across hosts).
    """
    n_shards = mesh.shape[corpus_axis]
    if host_axis is not None:
        n_shards *= mesh.shape[host_axis]
    doc_axes = (host_axis, corpus_axis) if host_axis is not None \
        else corpus_axis
    n_pad = index.n_docs_padded
    n_local = -(-n_pad // n_shards)
    # Round shard size up to the index pad multiple so every shard keeps
    # lane-aligned score tiles.
    n_local = -(-n_local // 128) * 128
    n_total = n_local * n_shards

    sh_rows = NamedSharding(mesh, P(doc_axes, None))
    dense = {}
    for m, emb in index.dense.items():
        dense[m] = _to_mesh(emb, n_total, sh_rows)
    for m, qd in (index.dense_q or {}).items():
        dense[m] = QuantizedDense(
            values=_to_mesh(qd.values, n_total, sh_rows),
            scales=_to_mesh(
                qd.scales, n_total, NamedSharding(mesh, P(doc_axes))
            ),
        )

    bm25_indptr = bm25_doc_ids = bm25_impact = None
    if index.bm25 is not None:
        s_indptr, s_doc_ids, s_impact = _shard_csr(
            np.asarray(index.bm25.indptr),
            np.asarray(index.bm25.doc_ids),
            np.asarray(index.bm25.impact),
            n_shards,
            n_local,
        )
        sh = NamedSharding(mesh, P(doc_axes, None))
        bm25_indptr = jax.device_put(s_indptr, sh)
        bm25_doc_ids = jax.device_put(s_doc_ids, sh)
        bm25_impact = jax.device_put(s_impact, sh)

    tt_common = tt_map = tt_rare_ptr = tt_rare_ids = tt_rare_imp = None
    if index.bm25 is not None and two_tier_common > 0:
        commons, maps, rptrs, rids, rimps = [], [], [], [], []
        for s_i in range(n_shards):
            local = Bm25Arrays(
                indptr=jnp.asarray(s_indptr[s_i]),
                doc_ids=jnp.asarray(s_doc_ids[s_i]),
                impact=jnp.asarray(s_impact[s_i]),
                n_docs_padded=n_local,
            )
            tt = split_two_tier(local, two_tier_common, two_tier_dtype)
            commons.append(np.asarray(tt.common_impact_t))
            maps.append(np.asarray(tt.common_map))
            rptrs.append(np.asarray(tt.rare.indptr))
            rids.append(np.asarray(tt.rare.doc_ids))
            rimps.append(np.asarray(tt.rare.impact))
        # Pad rare nnz to a common width across shards.
        rare_pad = max(a.shape[0] for a in rids)
        for s_i in range(n_shards):
            padc = rare_pad - rids[s_i].shape[0]
            if padc:
                rids[s_i] = np.concatenate(
                    [rids[s_i], np.full(padc, n_local, np.int32)]
                )
                rimps[s_i] = np.concatenate(
                    [rimps[s_i], np.zeros(padc, np.float32)]
                )
        sh2 = NamedSharding(mesh, P(doc_axes, None))
        sh3 = NamedSharding(mesh, P(doc_axes, None, None))
        tt_common = jax.device_put(np.stack(commons), sh3)
        tt_map = jax.device_put(np.stack(maps), sh2)
        tt_rare_ptr = jax.device_put(np.stack(rptrs), sh2)
        tt_rare_ids = jax.device_put(np.stack(rids), sh2)
        tt_rare_imp = jax.device_put(np.stack(rimps), sh2)

    return ShardedIndex(
        mesh=mesh,
        dense=dense,
        bm25_indptr=bm25_indptr,
        bm25_doc_ids=bm25_doc_ids,
        bm25_impact=bm25_impact,
        base_index=index,
        n_local=n_local,
        n_shards=n_shards,
        corpus_axis=corpus_axis,
        data_axis=data_axis,
        tt_common=tt_common,
        tt_map=tt_map,
        tt_rare_indptr=tt_rare_ptr,
        tt_rare_doc_ids=tt_rare_ids,
        tt_rare_impact=tt_rare_imp,
        host_axis=host_axis,
        two_tier_common=two_tier_common if index.bm25 is not None else 0,
        two_tier_dtype=two_tier_dtype,
    )


def shard_ivf(
    sidx: ShardedIndex,
    model_name: str,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> ShardedIndex:
    """Build the per-shard IVF ANN layout for one flagship model.

    Each shard clusters its OWN rows (spherical k-means; uniform C so
    the stacked arrays shard over the corpus axis) and stores them
    cluster-major with padding rows forced to the END of the permuted
    layout — the kernel's dynamic real-row count (carried in the tile
    table's trailing slot) masks exactly the boundary over-scan into
    the pad tail, so per-shard pad counts may differ freely.

    ``spill`` stores each shard's boundary documents in their two
    nearest LOCAL clusters too (all of them, or only those within
    ``spill_margin`` cosine of the primary), like
    index.ivf.build_ivf_dense(spill=True); duplicates stay within one
    shard, so the retriever dedups per shard before the cross-shard merge.

    Returns a new ShardedIndex carrying the IVF arrays; serve it with
    ``ShardedRetriever(..., nprobe=p)``.
    """
    from a_nice_rag_tpu.index.ivf import _default_clusters
    from a_nice_rag_tpu.ops.kmeans import (
        kmeans_init_rows,
        spherical_kmeans_batched,
    )

    n_docs = sidx.base_index.n_docs  # rows past n_docs are index padding
    nl, s_cnt = sidx.n_local, sidx.n_shards
    npl = -(-nl // tile_n) * tile_n
    c = _default_clusters(nl, n_clusters)
    reals = [int(np.clip(n_docs - s * nl, 0, nl)) for s in range(s_cnt)]
    c = min(c, min(r for r in reals if r > 0) if any(reals) else 1)

    # All S k-means in ONE vmapped device program per Lloyd iteration,
    # with the stacked rows laid out over the corpus axis — each shard
    # clusters on its own device instead of S sequential programs.
    xs, _ = _local_rows(sidx, model_name, npl)
    d = xs.shape[2]
    init_rows = np.zeros((s_cnt, c), np.int32)
    for s in range(s_cnt):
        if reals[s] > 0:
            init_rows[s] = kmeans_init_rows(reals[s], c, seed + s)
    init = np.asarray(jax.vmap(lambda x, r: jnp.take(x, r, axis=0))(
        xs, jnp.asarray(init_rows)), np.float32)
    norm = np.linalg.norm(init, axis=2, keepdims=True)
    init = np.where(np.asarray(reals)[:, None, None] > 0,
                    init / np.maximum(norm, 1e-12), 0.0).astype(np.float32)
    cents_d, assign_d = spherical_kmeans_batched(
        xs, np.asarray(reals, np.int32), c, n_iters=n_iters, seed=seed,
        init=init,
    )
    cents_np = np.asarray(cents_d)
    assign_np = np.asarray(assign_d)

    # Per-shard slot lists: primary assignment for every real row, plus
    # (when spilling) the secondary cluster for boundary rows. Slots
    # carry LOCAL row ids; duplicates are confined to their shard.
    slot_rows, slot_clusters = [], []
    for s in range(s_cnt):
        real = reals[s]
        a1 = assign_np[s, :real]
        rows_s = np.arange(real, dtype=np.int32)
        clusters_s = a1.astype(np.int64)
        if spill and real > 0 and c > 1:
            from a_nice_rag_tpu.ops.kmeans import assign_clusters

            ids2, scs2 = assign_clusters(
                xs[s, :real], jnp.asarray(cents_np[s]), top=2,
            )
            ids2, scs2 = np.asarray(ids2), np.asarray(scs2)
            sec = np.where(ids2[:, 0] == a1, ids2[:, 1], ids2[:, 0])
            sec_s = np.where(ids2[:, 0] == a1, scs2[:, 1], scs2[:, 0])
            pri_s = np.where(ids2[:, 0] == a1, scs2[:, 0], scs2[:, 1])
            keep = (
                np.ones(real, bool) if spill_margin is None
                else (pri_s - sec_s) <= float(spill_margin)
            )
            keep &= sec != a1
            rows_s = np.concatenate([rows_s, rows_s[keep]])
            clusters_s = np.concatenate([clusters_s, sec[keep]])
        slot_rows.append(rows_s)
        slot_clusters.append(clusters_s)
    del xs

    # Uniform padded slot width so the stacked arrays shard cleanly.
    max_slots = max((len(r) for r in slot_rows), default=0)
    npl = max(tile_n, -(-max(max_slots, 1) // tile_n) * tile_n)

    cents, perms, cstarts = [], [], []
    slot_counts = []
    mct = 1
    for s in range(s_cnt):
        n_slots = len(slot_rows[s])
        # Pads (slots >= n_slots) sort AFTER every cluster.
        key = np.full(npl, c, np.int64)
        key[:n_slots] = slot_clusters[s]
        order = np.argsort(key, kind="stable").astype(np.int32)
        counts = np.bincount(
            slot_clusters[s].astype(np.int64), minlength=c
        ).astype(np.int64)
        cstart = np.zeros(c + 1, np.int32)
        np.cumsum(counts, out=cstart[1:])
        if n_slots:
            perm = np.where(
                order < n_slots,
                slot_rows[s][np.clip(order, 0, n_slots - 1)],
                -1,
            ).astype(np.int32)
        else:  # empty shard (all padding): every slot is a pad
            perm = np.full(npl, -1, np.int32)
        cents.append(
            cents_np[s] if reals[s] > 0 else np.zeros((c, d), np.float32)
        )
        perms.append(perm)
        cstarts.append(cstart)
        slot_counts.append(n_slots)
        if counts.size:
            mct = max(mct, int(-(-counts.max() // tile_n)) + 1)

    return _materialize_shard_ivf(
        sidx, model_name, np.stack(cents).astype(np.float32),
        np.stack(perms), np.stack(cstarts),
        np.asarray(slot_counts, np.int32), tile_n, mct,
        spilled=spill, spill_margin=spill_margin,
    )


def _materialize_shard_ivf(sidx, model_name, cents, perms, cstarts,
                           reals, tile_n, mct, spilled=False,
                           spill_margin=None):
    """Gather the cluster-major permuted per-shard rows from the sharded
    matrix on the devices (perm rows < 0 — the pad tail — become zero
    rows / zero scales) and device_put everything with corpus-axis
    shardings."""
    import dataclasses as _dc

    # The slot width is independent of the local row count (spill grows
    # it, a tiny corpus shrinks it); every perm id is a real local row.
    mesh = sidx.mesh
    dx = sidx.doc_axes
    sh2 = NamedSharding(mesh, P(dx, None))
    sh3 = NamedSharding(mesh, P(dx, None, None))
    sh1 = NamedSharding(mesh, P(dx))
    p = jax.device_put(perms, sh2)
    vals, scales = _local_rows(sidx, model_name, perms.shape[1], perm=p)
    rows = (vals if scales is None
            else QuantizedDense(values=vals, scales=scales))
    return _dc.replace(
        sidx,
        ivf_model=model_name,
        ivf_centroids=jax.device_put(cents, sh3),
        ivf_rows=rows,
        ivf_perm=p,
        ivf_cluster_start=jax.device_put(cstarts, sh2),
        ivf_n_real=jax.device_put(reals, sh1),
        ivf_tile_n=tile_n,
        ivf_mct=mct,
        ivf_spilled=bool(spilled),
        ivf_spill_margin=spill_margin,
    )


def save_shard_ivf(sidx: ShardedIndex, path: str) -> None:
    """Persist the per-shard IVF CLUSTERING (centroids, permutation,
    cluster offsets — ~4 bytes/doc), NOT the permuted matrix: rows are
    re-gathered from the base dense matrix on load, so serve restarts
    skip the k-means but never duplicate the corpus on disk."""
    assert sidx.ivf_model is not None, "no IVF layout attached"
    np.savez(
        path,
        model=np.array(sidx.ivf_model),
        centroids=np.asarray(sidx.ivf_centroids),
        perm=np.asarray(sidx.ivf_perm),
        cluster_start=np.asarray(sidx.ivf_cluster_start),
        n_real=np.asarray(sidx.ivf_n_real),
        layout=np.asarray(
            [sidx.ivf_tile_n, sidx.ivf_mct, sidx.n_shards, sidx.n_local,
             int(sidx.ivf_spilled)],
            np.int64,
        ),
        spill_margin=np.asarray(
            np.nan if sidx.ivf_spill_margin is None
            else float(sidx.ivf_spill_margin)
        ),
    )


def load_shard_ivf(sidx: ShardedIndex, path: str) -> ShardedIndex:
    """Attach a persisted IVF layout to a freshly sharded index. The
    shard geometry must match the one the layout was built for (a
    changed device count needs a shard_ivf rebuild)."""
    with np.load(path) as z:
        layout = [int(v) for v in z["layout"]]
        tile_n, mct, s_cnt, nl = layout[:4]
        spilled = bool(layout[4]) if len(layout) > 4 else False
        margin = None
        if "spill_margin" in z:
            m = float(z["spill_margin"])
            margin = None if np.isnan(m) else m
        if (s_cnt, nl) != (sidx.n_shards, sidx.n_local):
            raise ValueError(
                f"IVF layout built for {s_cnt} shards x {nl} local rows; "
                f"index has {sidx.n_shards} x {sidx.n_local} — rebuild "
                "with shard_ivf"
            )
        return _materialize_shard_ivf(
            sidx, str(z["model"]), z["centroids"], z["perm"],
            z["cluster_start"], z["n_real"], tile_n, mct,
            spilled=spilled, spill_margin=margin,
        )


def _gather_merge(vals, gidx, k, corpus_axis):
    """All-gather per-shard (vals, global ids) over one axis and merge to the
    best min(k, S * k_local) candidates."""
    all_vals = jax.lax.all_gather(vals, corpus_axis)  # [S, B, k_local]
    all_idx = jax.lax.all_gather(gidx, corpus_axis)
    all_vals = jnp.moveaxis(all_vals, 0, 1)  # [B, S, k_local]
    all_idx = jnp.moveaxis(all_idx, 0, 1)
    k_out = min(k, all_vals.shape[1] * all_vals.shape[2])
    mvals, midx = merge_top_k(all_vals, all_idx, k_out)
    return mvals, jnp.where(jnp.isfinite(mvals), midx, -1)


def _shard_offset(n_local, corpus_axis, host_axis, n_corpus):
    """Global doc-id offset of this device's shard. With a host axis the
    document dimension is laid out host-major (P((host, corpus), ...)),
    so the global shard id is host_idx * n_corpus + corpus_idx."""
    sid = jax.lax.axis_index(corpus_axis)
    if host_axis is not None:
        sid = sid + jax.lax.axis_index(host_axis) * n_corpus
    return sid * n_local


def _merge_over(vals, gidx, k, corpus_axis, host_axis):
    """Exact global merge of per-shard candidates: a single all-gather,
    or hierarchical (intra-host, then inter-host) when a host axis is
    present."""
    if host_axis is None:
        return _gather_merge(vals, gidx, k, corpus_axis)
    return hierarchical_gather_merge(vals, gidx, k, corpus_axis, host_axis)


def _local_to_global_topk(scores, k, n_local, corpus_axis,
                          host_axis=None, n_corpus=1):
    """Local masked top-k -> exact global top-k via all-gather + merge.
    Requests with k > shard size take min(k, n_local) per shard, which
    keeps the GLOBAL top-min(k, S*n_local) exact."""
    vals, idx = masked_top_k(scores, min(k, scores.shape[-1]))
    gidx = idx + _shard_offset(n_local, corpus_axis, host_axis, n_corpus)
    gidx = jnp.where(jnp.isfinite(vals), gidx, -1)
    return _merge_over(vals, gidx, k, corpus_axis, host_axis)


def hierarchical_gather_merge(vals, gidx, k, intra_axis, inter_axis):
    """Two-level top-k merge for multi-host meshes.

    Merge per-shard candidates over the fast intra-host axis FIRST —
    each host reduces its shards to one k-list — then merge the per-host
    winners over the slow inter-host axis. The inter-host leg
    carries k entries per host instead of k per shard, cutting
    cross-host traffic by the intra-axis size while remaining exact
    (top-k merge is associative).
    """
    v, i = _gather_merge(vals, gidx, k, intra_axis)
    return _gather_merge(v, i, k, inter_axis)


class ShardedRetriever:
    """Sharded equivalent of retrieval.FusedRetriever: every ranker,
    the cross-shard merge, fusion and final top-n in one pjit program."""

    def __init__(
        self,
        sidx: ShardedIndex,
        model_names: Sequence[str],
        use_bm25: bool,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        budget: int = 16384,
        dense_backend: str = "auto",
        bm25_backend: str = "auto",
        nprobe: Optional[int] = None,
        ivf_max_tiles: Optional[int] = None,
        ivf_route: str = "auto",
        ivf_max_coverage: float = 0.25,
        interpret: bool = False,
    ):
        """dense_backend: "auto", "xla" or "stream", resolved per shard
        by :func:`ops.streaming.choose_route`; a streaming route never
        materializes [B, N_local] scores (for million-doc shards).
        ``interpret=True`` runs the streaming kernel in the Pallas
        interpreter (tests on the CPU).
        bm25_backend: "auto" uses the two-tier layout when the sharded
        index carries one (see shard_index(two_tier_common=...)),
        "sparse" forces the sort-based CSR path, "two_tier" requires the
        layout and materializes per-shard scores,
        "two_tier_streaming" additionally streams the common tier
        through the streaming top-k so no [B, N_local] score matrix is
        ever materialized (exact; for million-doc shards).

        ``nprobe``: opt-in ANN for the flagship model carried by
        ``shard_ivf`` — each shard probes its own top-``nprobe``
        clusters and scans only their covering tiles through the
        streaming top-k's tile table; the global merge is unchanged.
        Approximate; calls with a filename filter or tombstoned docs
        fall back to the exact program (same contract as
        FusedRetriever(nprobe=...)).

        ``ivf_route``/``ivf_max_coverage``: same coverage policy as
        FusedRetriever — "auto" (default) probes only while the
        expected per-shard cluster coverage
        ``1 - (1 - p/C_shard)^(B/dp)`` stays at or below
        ``ivf_max_coverage``; wider batches amortize the exact shard
        stream better than the batch-scaled tile table. The 0.25
        default is FusedRetriever's (not measured on the H100). "always"
        restores the unconditional probe. Decided host-side per call
        (:meth:`_route_ivf`)."""
        self.sidx = sidx
        self.model_names = tuple(model_names)
        self.use_bm25 = use_bm25
        similarity_k = min(similarity_k, sidx.n_docs_padded)
        common_sections_n = min(common_sections_n, sidx.n_docs_padded)
        self.similarity_k = similarity_k
        self.common_sections_n = common_sections_n
        self.budget = budget

        mesh = sidx.mesh
        ca, da = sidx.corpus_axis, sidx.data_axis
        ha = sidx.host_axis
        n_corpus = mesh.shape[ca]
        doc_axes = sidx.doc_axes
        n_local = sidx.n_local
        # Per-shard lists cannot exceed the shard size; the global merge
        # still yields up to min(k, S * k_local) candidates.
        k = similarity_k
        k_local = min(k, n_local)
        n = common_sections_n
        route = choose_route(n_local, k_local, dense_backend,
                             interpret=interpret)
        self.route = route
        has_tt = sidx.tt_common is not None
        if bm25_backend in ("two_tier", "two_tier_streaming") and not has_tt:
            raise ValueError(
                f"{bm25_backend} bm25_backend requires "
                "shard_index(two_tier_common=...)"
            )
        use_two_tier = use_bm25 and has_tt and bm25_backend in (
            "auto", "two_tier", "two_tier_streaming"
        )
        tt_streaming = bm25_backend == "two_tier_streaming"
        # Rare-tier max df (over all shards) enables the per-term
        # window-slice postings fetch; fall back to the flat budget
        # gather when the rare tier is skewed enough that T*df_cap
        # would dwarf the budget (decided per trace, where T is known).
        rare_df_cap = None
        csr_df_cap = None
        import numpy as _np

        if use_two_tier:
            diffs = _np.diff(_np.asarray(sidx.tt_rare_indptr), axis=-1)
            cap = int(diffs.max()) if diffs.size else 0
            rare_df_cap = max(cap, 1)
        elif use_bm25 and sidx.bm25_indptr is not None:
            diffs = _np.diff(_np.asarray(sidx.bm25_indptr), axis=-1)
            cap = int(diffs.max()) if diffs.size else 0
            csr_df_cap = max(cap, 1)

        # IVF ANN is available when the index carries the per-shard
        # layout (shard_ivf) for one of the serving models AND the
        # caller opted in with nprobe. Two programs are compiled: the
        # exact one (ivf_on=False) and the ANN one; retrieve_device
        # routes per call (filters/tombstones -> exact).
        self.nprobe = nprobe
        if ivf_route not in ("auto", "always"):
            raise ValueError(
                f"ivf_route must be 'auto' or 'always', got {ivf_route!r}"
            )
        self.ivf_route = ivf_route
        self.ivf_max_coverage = float(ivf_max_coverage)
        self.use_ivf = bool(
            nprobe
            and sidx.ivf_model is not None
            and sidx.ivf_model in self.model_names
        )
        ivf_model = sidx.ivf_model if self.use_ivf else None
        if self.use_ivf:
            from a_nice_rag_tpu.index.ivf import build_tile_table, ivf_fetch_k

            rows_ = sidx.ivf_rows
            npl = (rows_.values if isinstance(rows_, QuantizedDense)
                   else rows_).shape[1]
            k_ivf = ivf_fetch_k(k_local, sidx.ivf_spilled, npl)
            ivf_stream = choose_route(npl, k_ivf, "stream",
                                      interpret=interpret)

        def make_shard_fn(ivf_on):
          def shard_fn(dense_mats, bm25_parts, tt_parts, ivf_parts,
                       q_embs, q_terms, mask, bmask, weights, wrrf_k):
            lists = []
            for name, mat, q in zip(self.model_names, dense_mats, q_embs):
                if ivf_on and name == ivf_model:
                    # Per-shard IVF: probe THIS shard's clusters, scan
                    # only their covering tiles. The real-row count is
                    # a traced scalar since per-shard pad counts differ
                    # under shard_map.
                    cent, cstart, perm, nrl, rows = (
                        ivf_parts[0][0], ivf_parts[1][0],
                        ivf_parts[2][0], ivf_parts[3][0],
                        jax.tree.map(lambda x: x[0], ivf_parts[4]),
                    )
                    tile_n, mct = sidx.ivf_tile_n, sidx.ivf_mct
                    c = cent.shape[0]
                    mt = ivf_max_tiles or min(
                        npl // tile_n, q.shape[0] * nprobe * mct
                    )
                    table, _ = build_tile_table(
                        cent, cstart, q, nprobe=min(nprobe, c),
                        max_tiles=mt, tile_n=tile_n, mct=mct,
                    )
                    # A spilled shard dedups its own candidates (the
                    # duplicates never cross shards) and cuts back to
                    # k_local before the cross-shard merge.
                    vals, pidx = dense_stream_top_k(
                        rows, q, k_ivf, ivf_stream,
                        tiles=table, tile_n=tile_n, n_valid=nrl,
                    )
                    lidx = jnp.where(
                        pidx >= 0,
                        jnp.take(perm, jnp.clip(pidx, 0, npl - 1)),
                        -1,
                    )
                    if sidx.ivf_spilled:
                        from a_nice_rag_tpu.ops.topk import dedup_ranked

                        vals, lidx = dedup_ranked(vals, lidx)
                        vals = vals[:, :k_local]
                        lidx = lidx[:, :k_local]
                    gidx = jnp.where(
                        (lidx >= 0) & jnp.isfinite(vals),
                        lidx + _shard_offset(n_local, ca, ha, n_corpus),
                        -1,
                    )
                    vals = jnp.where(gidx >= 0, vals, -jnp.inf)
                    _, gidx = _merge_over(vals, gidx, k, ca, ha)
                    lists.append(gidx)
                    continue
                quantized = isinstance(mat, QuantizedDense)
                if route.stream:
                    vals, lidx = dense_stream_top_k(
                        mat, q, k_local, route, mask=mask
                    )
                    gidx = jnp.where(
                        jnp.isfinite(vals),
                        lidx + _shard_offset(n_local, ca, ha, n_corpus),
                        -1,
                    )
                    _, gidx = _merge_over(vals, gidx, k, ca, ha)
                    lists.append(gidx)
                    continue
                if quantized:
                    qv, qs = quantize_queries(q)
                    scores = quantized_dense_scores(mat, qv, qs)
                else:
                    scores = dense_scores(mat, q)
                scores = jnp.where(mask[None, :], scores, -jnp.inf)
                _, gidx = _local_to_global_topk(
                    scores, k, n_local, ca, ha, n_corpus
                )
                lists.append(gidx)
            if use_bm25 and use_two_tier:
                tt_c, tt_m, r_ptr, r_ids, r_imp = (x[0] for x in tt_parts)
                tt = Bm25TwoTier(
                    common_impact_t=tt_c,
                    common_map=tt_m,
                    rare=Bm25Arrays(
                        indptr=r_ptr, doc_ids=r_ids, impact=r_imp,
                        n_docs_padded=n_local,
                    ),
                )
                if tt_streaming:
                    t_slots = q_terms.shape[1]
                    df_cap = (
                        rare_df_cap
                        if rare_df_cap is not None
                        and t_slots * rare_df_cap <= 4 * budget
                        and t_slots * rare_df_cap >= k_local
                        else None
                    )
                    vals, lidx = bm25_top_k_two_tier(
                        tt, q_terms, k_local, mask=bmask, budget=budget,
                        interpret=interpret, df_cap=df_cap,
                    )
                    gidx = jnp.where(
                        jnp.isfinite(vals),
                        lidx + _shard_offset(n_local, ca, ha, n_corpus),
                        -1,
                    )
                    _, gidx = _merge_over(vals, gidx, k, ca, ha)
                else:
                    scores = bm25_scores_two_tier(tt, q_terms, budget)
                    scores = jnp.where(bmask[None, :], scores, -jnp.inf)
                    _, gidx = _local_to_global_topk(
                        scores, k, n_local, ca, ha, n_corpus
                    )
                lists.append(gidx)
            elif use_bm25:
                indptr, doc_ids, impact = (x[0] for x in bm25_parts)
                local = Bm25Arrays(
                    indptr=indptr, doc_ids=doc_ids, impact=impact,
                    n_docs_padded=n_local,
                )
                # Sort-based sparse scoring: no [N_local] accumulator and
                # no scatter per query; per-query cost depends
                # on the postings budget only. Window-slice fetch when
                # the corpus's df skew allows (full-vocab caps usually
                # include head terms, so this mostly stays flat).
                t_slots = q_terms.shape[1]
                df_cap = (
                    csr_df_cap
                    if csr_df_cap is not None
                    and t_slots * csr_df_cap <= 4 * budget
                    and t_slots * csr_df_cap >= k_local
                    else None
                )
                vals, lidx = bm25_top_k_sparse(
                    local, q_terms, k_local, mask=bmask, budget=budget,
                    df_cap=df_cap,
                )
                gidx = jnp.where(
                    jnp.isfinite(vals),
                    lidx + _shard_offset(n_local, ca, ha, n_corpus),
                    -1,
                )
                _, gidx = _merge_over(vals, gidx, k, ca, ha)
                lists.append(gidx)
            if len(lists) == 1:
                ids = lists[0][:, :n]
                return jnp.zeros(ids.shape, jnp.float32), ids
            all_idx = jnp.stack(lists)  # [L, B, K] — replicated over corpus
            fvals, fids = wrrf_top_n_sparse(all_idx, weights, n, wrrf_k)
            return fvals, jnp.where(jnp.isfinite(fvals), fids, -1)

          return shard_fn

        n_dense = len(self.model_names)
        dx = doc_axes
        # Per-model spec: a plain corpus-sharded matrix, or a
        # QuantizedDense pytree of (values [N, D], scales [N]) specs.
        dense_specs = tuple(
            QuantizedDense(values=P(dx, None), scales=P(dx))
            if isinstance(sidx.dense[m], QuantizedDense)
            else P(dx, None)
            for m in self.model_names
        )
        bm25_spec = (P(dx, None),) * 3
        tt_spec = (P(dx, None, None), P(dx, None), P(dx, None),
                   P(dx, None), P(dx, None))
        ivf_rows_spec = (
            QuantizedDense(values=P(dx, None, None), scales=P(dx, None))
            if self.use_ivf and isinstance(sidx.ivf_rows, QuantizedDense)
            else P(dx, None, None)
        )
        ivf_spec = (P(dx, None, None), P(dx, None), P(dx, None),
                    P(dx), ivf_rows_spec)
        in_specs = (
            dense_specs,                        # dense shards
            bm25_spec,                          # bm25 stacked arrays
            tt_spec,                            # two-tier stacked arrays
            ivf_spec,                           # per-shard IVF arrays
            (P(da, None),) * n_dense,           # query embeddings
            P(da, None),                        # query terms
            P(dx),                              # mask
            P(dx),                              # bm25 mask
            P(None),                            # weights
            P(),                                # wrrf_k
        )
        out_specs = (P(da, None), P(da, None))
        self._run = jax.jit(
            jax.shard_map(
                make_shard_fn(False), mesh=mesh, in_specs=in_specs,
                out_specs=out_specs, check_vma=False,
            )
        )
        self._run_ivf = (
            jax.jit(
                jax.shard_map(
                    make_shard_fn(True), mesh=mesh, in_specs=in_specs,
                    out_specs=out_specs, check_vma=False,
                )
            )
            if self.use_ivf
            else None
        )

    def __call__(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ) -> Tuple[np.ndarray, np.ndarray]:
        fids, fvals, _ = self.retrieve_device(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k
        )
        return np.asarray(fvals), np.asarray(fids)

    def _route_ivf(self, b: int, filtered: bool,
                   tombstoned: bool) -> bool:
        """Host-side per-call IVF routing: ANN only when the layout is
        attached, no candidate mask is needed, and (under "auto") the
        expected per-shard cluster coverage keeps the probed scan
        cheaper than the batch-amortized exact shard stream."""
        from a_nice_rag_tpu.retrieval.engine import _ivf_coverage

        if self._run_ivf is None or filtered or tombstoned:
            return False
        if self.ivf_route == "always":
            return True
        dp = self.sidx.mesh.shape[self.sidx.data_axis]
        c_shard = int(self.sidx.ivf_centroids.shape[1])
        cov = _ivf_coverage(max(1, b // dp), self.nprobe or 0, c_shard)
        return cov <= self.ivf_max_coverage

    def retrieve_device(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        """Device-resident fast path with the serving scheduler's
        contract: returns (fused ids, fused scores, None) as jax arrays
        (BatchScheduler downloads only the fused outputs). Batch sizes
        must be divisible by the mesh's dp axis."""
        sidx = self.sidx
        mesh = sidx.mesh
        da = sidx.data_axis
        dense_mats = tuple(sidx.dense[m] for m in self.model_names)
        qsh = NamedSharding(mesh, P(da, None))
        q_tuple = tuple(
            jax.device_put(np.asarray(q_embs[m], np.float32), qsh)
            for m in self.model_names
        )
        b = q_tuple[0].shape[0] if q_tuple else np.asarray(q_terms).shape[0]
        csh = NamedSharding(mesh, P(sidx.doc_axes, None))
        csh3 = NamedSharding(mesh, P(sidx.doc_axes, None, None))
        z = jax.device_put(jnp.zeros((sidx.n_shards, 1), jnp.int32), csh)
        zf = jax.device_put(jnp.zeros((sidx.n_shards, 1), jnp.float32), csh)
        zf3 = jax.device_put(
            jnp.zeros((sidx.n_shards, 1, 1), jnp.float32), csh3
        )
        if self.use_bm25:
            terms = jax.device_put(np.asarray(q_terms, np.int32), qsh)
            bm25_parts = (sidx.bm25_indptr, sidx.bm25_doc_ids, sidx.bm25_impact)
        else:
            terms = jax.device_put(np.full((b, 1), -1, np.int32), qsh)
            bm25_parts = (z, z, zf)
        if sidx.tt_common is not None:
            tt_parts = (sidx.tt_common, sidx.tt_map, sidx.tt_rare_indptr,
                        sidx.tt_rare_doc_ids, sidx.tt_rare_impact)
        else:
            tt_parts = (zf3, z, z, z, zf)
        if self.use_ivf:
            ivf_parts = (sidx.ivf_centroids, sidx.ivf_cluster_start,
                         sidx.ivf_perm, sidx.ivf_n_real, sidx.ivf_rows)
        else:
            sh1 = NamedSharding(mesh, P(sidx.doc_axes))
            z1 = jax.device_put(
                jnp.zeros((sidx.n_shards,), jnp.int32), sh1
            )
            ivf_parts = (zf3, z, z, z1, zf3)
        w = jnp.asarray(
            [weights.get(m, 1.0) for m in self.model_names]
            + ([weights.get("BM25", 1.0)] if self.use_bm25 else []),
            dtype=jnp.float32,
        )
        mask = sidx.filter_mask(filename_type_filter)
        bmask = (
            sidx.bm25_mask(filename_type_filter)
            if self.use_bm25
            else mask
        )
        run = self._run
        if self._route_ivf(
            b,
            filtered=filename_type_filter is not None,
            tombstoned=bool(sidx.base_index.meta.deleted.any()),
        ):
            # ANN program: the flagship model scans only probed tiles.
            # Filters/tombstones need the candidate mask the IVF kernel
            # has no operand for -> exact program (same fallback
            # contract as FusedRetriever(nprobe=...)); wide batches
            # take the exact stream under ivf_route="auto" (the
            # per-shard corpus pass amortizes over the local batch).
            run = self._run_ivf
        fvals, fids = run(
            dense_mats, bm25_parts, tt_parts, ivf_parts, q_tuple, terms,
            mask, bmask, w, jnp.float32(wrrf_k),
        )
        return fids, fvals, None


def reshard_surviving(
    sidx: ShardedIndex,
    devices,
    dp: int = 1,
) -> ShardedIndex:
    """Failure recovery: rebuild the sharded index over surviving devices.

    The reference's graceful-degradation contract (SURVEY.md §5: shard
    failure => keep serving) maps to SPMD as: the host retains the full
    base index, so losing chips never loses data — recovery is a
    re-shard of the document axis over the remaining devices (smaller
    corpus axis, same results). Callers catch the execution error from a
    dead chip, call this with the surviving device list, and rebuild
    their ShardedRetriever.

    The rebuilt index carries the original build configuration — the
    two-tier streaming BM25 layout (``two_tier_common``/``two_tier_dtype``)
    and, when the surviving devices still factor over the original host
    count, the multi-host ``host_axis`` — so a deployment running the
    flagship ``bm25_backend="two_tier_streaming"`` keeps serving with the
    same backend after recovery.
    """
    devices = list(devices)
    host_axis = sidx.host_axis
    n_hosts = sidx.mesh.shape[host_axis] if host_axis is not None else 1
    if host_axis is not None and len(devices) % (dp * n_hosts) == 0:
        corpus = len(devices) // (dp * n_hosts)
        mesh = Mesh(
            np.asarray(devices).reshape(dp, n_hosts, corpus),
            (sidx.data_axis, host_axis, sidx.corpus_axis),
        )
    else:
        # Survivors no longer factor over hosts (or single-host): collapse
        # to a flat corpus axis. Results are unchanged — only the merge
        # topology degrades from hierarchical to a single all-gather.
        host_axis = None
        corpus = len(devices) // dp
        mesh = Mesh(
            np.asarray(devices).reshape(dp, corpus),
            (sidx.data_axis, sidx.corpus_axis),
        )
    out = shard_index(
        sidx.base_index,
        mesh,
        sidx.corpus_axis,
        sidx.data_axis,
        two_tier_common=sidx.two_tier_common,
        two_tier_dtype=sidx.two_tier_dtype,
        host_axis=host_axis,
    )
    if sidx.ivf_model is not None:
        # Re-cluster over the new shard boundaries (the per-shard IVF
        # layout is shard-count-dependent); a recovered deployment
        # serving with nprobe keeps its ANN route AND its spill config.
        out = shard_ivf(
            out, sidx.ivf_model, tile_n=sidx.ivf_tile_n,
            spill=sidx.ivf_spilled, spill_margin=sidx.ivf_spill_margin,
        )
    return out


def sharded_dense_top_k(
    sidx: ShardedIndex,
    model_name: str,
    queries: np.ndarray,
    k: int,
    filename_type_filter: Optional[str] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact global dense top-k over the sharded corpus."""
    mesh = sidx.mesh
    ca, da, ha = sidx.corpus_axis, sidx.data_axis, sidx.host_axis
    dx = sidx.doc_axes
    n_corpus = mesh.shape[ca]
    n_local = sidx.n_local

    mat = sidx.dense[model_name]
    quantized = isinstance(mat, QuantizedDense)

    def shard_fn(emb_l, q_l, mask_l):
        if quantized:
            qv, qs = quantize_queries(q_l)
            scores = quantized_dense_scores(emb_l, qv, qs)
        else:
            scores = dense_scores(emb_l, q_l)
        scores = jnp.where(mask_l[None, :], scores, -jnp.inf)
        return _local_to_global_topk(scores, k, n_local, ca, ha, n_corpus)

    emb_spec = (
        QuantizedDense(values=P(dx, None), scales=P(dx))
        if quantized else P(dx, None)
    )
    run = jax.jit(
        jax.shard_map(
            shard_fn,
            mesh=mesh,
            in_specs=(emb_spec, P(da, None), P(dx)),
            out_specs=(P(da, None), P(da, None)),
            check_vma=False,
        )
    )
    q = jax.device_put(
        np.atleast_2d(np.asarray(queries, np.float32)),
        NamedSharding(mesh, P(da, None)),
    )
    vals, idx = run(
        sidx.dense[model_name], q, sidx.filter_mask(filename_type_filter)
    )
    return np.asarray(vals), np.asarray(idx)


def sharded_hybrid_retrieve(
    sidx: ShardedIndex,
    q_embs: Dict[str, np.ndarray],
    q_terms: Optional[np.ndarray],
    weights: Dict[str, float],
    similarity_k: int = 25,
    common_sections_n: int = 15,
    wrrf_k: float = 40.0,
    filename_type_filter: Optional[str] = None,
    budget: int = 16384,
) -> Tuple[np.ndarray, np.ndarray]:
    """One-shot functional wrapper around :class:`ShardedRetriever`."""
    model_names = [m for m in q_embs if m in sidx.dense]
    retr = ShardedRetriever(
        sidx,
        model_names,
        use_bm25=q_terms is not None and sidx.bm25_indptr is not None,
        similarity_k=similarity_k,
        common_sections_n=common_sections_n,
        budget=budget,
    )
    return retr(q_embs, q_terms, weights, filename_type_filter, wrrf_k)
