"""IVF (inverted-file) ANN layer over the dense index.

The reference's dense search is an exact full-corpus ``np.dot``
(src/search_engine.py:128-142). At multi-million-document scale the
exact streaming scan is bound by device-memory bandwidth — every batch reads
the whole matrix. IVF trades a small recall loss for reading only the
probed fraction: spherical k-means clusters the corpus at build time
(ops/kmeans.py), documents are permuted cluster-major, and a query
batch scores only the tiles covering its top-``nprobe`` clusters
through the streaming top-k's tile-table operand (ops/streaming.py).

The probe (q @ centroids^T + top_k) and the tile-table construction
(sort-based dedup over a static-size candidate set) run inside one jit;
cluster boundaries over-scan into neighbouring tiles rather than padding
per cluster, so the device layout stays dense and scoring stays exact
over the scheduled tiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.ops.kmeans import spherical_kmeans

_BIG = jnp.int32(2**30)


@dataclasses.dataclass
class IVFDense:
    """Cluster-major permuted dense matrix + probe metadata.

    Rows are ordered by cluster; ``perm[r]`` is the ORIGINAL document
    row stored at permuted row ``r`` (-1 for the padded tail).
    ``cluster_start`` has C+1 entries; cluster c occupies rows
    [cluster_start[c], cluster_start[c+1]). Exactly one of ``emb``
    (float) or ``values``+``scales`` (int8, ops.quantized layout) is
    set.
    """

    centroids: jax.Array  # [C, D] f32, unit-norm
    perm: jax.Array  # [Np] int32 -> original rows (-1 pad)
    cluster_start: jax.Array  # [C+1] int32
    tile_n: int
    n_real: int  # valid permuted rows (corpus size + spilled copies)
    max_cluster_tiles: int  # static bound: tiles covering any cluster
    emb: Optional[jax.Array] = None  # [Np, D] (Np % tile_n == 0)
    values: Optional[jax.Array] = None  # [Np, D] int8
    scales: Optional[jax.Array] = None  # [Np] f32 (0.0 on pad rows)
    # Spilled layouts store some documents in their second-nearest
    # cluster too (ScaNN-style multi-assignment): searches must fetch
    # extra slots and dedup ids (ivf_search does; see dedup_ranked).
    spilled: bool = False

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def rows(self):
        """The permuted matrix: ``emb``, or a QuantizedDense."""
        if self.emb is not None:
            return self.emb
        from a_nice_rag_tpu.ops.quantized import QuantizedDense

        return QuantizedDense(values=self.values, scales=self.scales)

    @property
    def n_tiles(self) -> int:
        rows = self.emb if self.emb is not None else self.values
        return rows.shape[0] // self.tile_n


# Pytree registration so an IVFDense can cross a jit boundary (the
# engine passes it into its fused program). Static aux: the layout
# scalars; children: the device arrays (None children are fine).
jax.tree_util.register_pytree_node(
    IVFDense,
    lambda s: (
        (s.centroids, s.perm, s.cluster_start, s.emb, s.values, s.scales),
        (s.tile_n, s.n_real, s.max_cluster_tiles, s.spilled),
    ),
    lambda aux, ch: IVFDense(
        centroids=ch[0], perm=ch[1], cluster_start=ch[2],
        emb=ch[3], values=ch[4], scales=ch[5],
        tile_n=aux[0], n_real=aux[1], max_cluster_tiles=aux[2],
        spilled=aux[3],
    ),
)


def save_ivf(ivf: IVFDense, path: str) -> None:
    """Persist to one .npz (compressed layout scalars included)."""
    arrs = {
        "centroids": np.asarray(ivf.centroids),
        "perm": np.asarray(ivf.perm),
        "cluster_start": np.asarray(ivf.cluster_start),
        "layout": np.array(
            [ivf.tile_n, ivf.n_real, ivf.max_cluster_tiles,
             int(ivf.spilled)],
            np.int64,
        ),
    }
    if ivf.emb is not None:
        arrs["emb"] = np.asarray(ivf.emb)
    else:
        arrs["values"] = np.asarray(ivf.values)
        arrs["scales"] = np.asarray(ivf.scales)
    np.savez(path, **arrs)


def load_ivf(path: str) -> IVFDense:
    with np.load(path) as z:
        layout = [int(v) for v in z["layout"]]
        tile_n, n_real, mct = layout[:3]
        spilled = bool(layout[3]) if len(layout) > 3 else False
        return IVFDense(
            centroids=jnp.asarray(z["centroids"]),
            perm=jnp.asarray(z["perm"]),
            cluster_start=jnp.asarray(z["cluster_start"]),
            tile_n=tile_n,
            n_real=n_real,
            max_cluster_tiles=mct,
            spilled=spilled,
            emb=jnp.asarray(z["emb"]) if "emb" in z else None,
            values=jnp.asarray(z["values"]) if "values" in z else None,
            scales=jnp.asarray(z["scales"]) if "scales" in z else None,
        )


def _ivf_layout(assign_np: np.ndarray, n: int, n_clusters: int,
                tile_n: int, rows: Optional[np.ndarray] = None):
    """Shared permutation/offsets/bounds for the cluster-major layout.

    ``assign_np`` is per-SLOT: without spill there is one slot per
    document (``rows`` defaults to arange); a spilled layout passes one
    extra slot per spilled document with ``rows`` carrying the original
    document id of every slot. Returns the gather order over original
    rows (== perm prefix), so builders materialize duplicated rows with
    one jnp.take."""
    s = len(assign_np)
    order = np.argsort(assign_np, kind="stable").astype(np.int32)
    src = order if rows is None else rows[order].astype(np.int32)
    counts = np.bincount(assign_np, minlength=n_clusters)
    cluster_start = np.zeros(n_clusters + 1, dtype=np.int32)
    np.cumsum(counts, out=cluster_start[1:])
    npad = -(-s // tile_n) * tile_n
    perm = np.full(npad, -1, dtype=np.int32)
    perm[:s] = src
    # A cluster spanning rows [s, e) touches floor(s/T)..floor((e-1)/T):
    # at most ceil(max_count/T) + 1 tiles.
    max_count = int(counts.max()) if n_clusters else 0
    mct = int(-(-max_count // tile_n)) + 1
    return src, cluster_start, perm, npad, mct


def _spill_slots(
    x, cent, assign_np: np.ndarray, spill_margin: Optional[float]
):
    """(rows, clusters) slot lists for a spilled layout: every document
    in its primary cluster, plus documents whose second-nearest centroid
    is within ``spill_margin`` cosine of the primary (None: all) in that
    secondary cluster too. Boundary documents are the ones an
    under-probed query misses; storing them twice is the classic
    multi-assignment recall fix."""
    from a_nice_rag_tpu.ops.kmeans import assign_clusters

    n = len(assign_np)
    ids, scs = assign_clusters(x, cent, top=2)
    ids = np.asarray(ids)
    scs = np.asarray(scs)
    sec = np.where(ids[:, 0] == assign_np, ids[:, 1], ids[:, 0])
    sec_s = np.where(ids[:, 0] == assign_np, scs[:, 1], scs[:, 0])
    pri_s = np.where(ids[:, 0] == assign_np, scs[:, 0], scs[:, 1])
    if spill_margin is None:
        keep = np.ones(n, dtype=bool)
    else:
        keep = (pri_s - sec_s) <= float(spill_margin)
    keep &= sec != assign_np  # C == 1 degenerate: nothing to spill to
    rows = np.concatenate(
        [np.arange(n, dtype=np.int32), np.arange(n, dtype=np.int32)[keep]]
    )
    clusters = np.concatenate([assign_np, sec[keep]])
    return rows, clusters


def _default_clusters(n: int, n_clusters: Optional[int]) -> int:
    """~sqrt(N) clamped to [16, 65536] — the classic IVF sizing (probe
    cost ~C + N*p/C is minimized at C ~ sqrt(N*p))."""
    if n_clusters is None:
        n_clusters = int(min(65536, max(16, round(np.sqrt(n)))))
    return min(n_clusters, n)


def build_ivf_dense(
    emb: jax.Array,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> IVFDense:
    """Cluster + permute a [N, D] dense matrix (one-time build cost).

    ``spill`` additionally stores documents in their second-nearest
    cluster (all of them, or only those within ``spill_margin`` cosine
    of the primary assignment) — boundary documents stop being missed
    by low-nprobe searches at the cost of up to 2x IVF memory.
    Searches over a spilled layout dedup ids (ivf_search handles it)."""
    n, d = emb.shape
    n_clusters = _default_clusters(n, n_clusters)
    cent, assign = spherical_kmeans(
        emb, n_clusters, n_iters=n_iters, seed=seed
    )
    assign_np = np.asarray(assign)
    rows = None
    if spill and n_clusters > 1:
        rows, assign_np = _spill_slots(emb, cent, assign_np, spill_margin)
    order, cluster_start, perm, npad, mct = _ivf_layout(
        assign_np, n, n_clusters, tile_n, rows=rows
    )
    # Device-side row permutation (one-time; XLA row gather).
    emb_p = jnp.take(emb, jnp.asarray(order), axis=0)
    if npad != len(order):
        emb_p = jnp.pad(emb_p, ((0, npad - len(order)), (0, 0)))
    return IVFDense(
        centroids=cent,
        emb=emb_p,
        perm=jnp.asarray(perm),
        cluster_start=jnp.asarray(cluster_start),
        tile_n=tile_n,
        n_real=len(order),
        max_cluster_tiles=mct,
        spilled=rows is not None,
    )


def build_ivf_quantized(
    qd,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> IVFDense:
    """IVF over an int8-quantized matrix (ops.quantized.QuantizedDense).

    Clustering runs on the int8 values directly (cast per chunk inside
    the k-means matmuls — per-row positive scales don't change a row's
    direction, so cosine assignments match the unquantized ones up to
    quantization noise). The permuted corpus keeps the 4x-compressed
    layout; pad rows carry scale 0.0 so their scores are exactly 0
    before the kernel's last-tile valid mask even applies.
    """
    n, d = qd.values.shape
    n_clusters = _default_clusters(n, n_clusters)
    cent, assign = spherical_kmeans(
        qd.values, n_clusters, n_iters=n_iters, seed=seed
    )
    assign_np = np.asarray(assign)
    rows = None
    if spill and n_clusters > 1:
        rows, assign_np = _spill_slots(
            qd.values, cent, assign_np, spill_margin
        )
    order, cluster_start, perm, npad, mct = _ivf_layout(
        assign_np, n, n_clusters, tile_n, rows=rows
    )
    order_d = jnp.asarray(order)
    vals_p = jnp.take(qd.values, order_d, axis=0)
    scales_p = jnp.take(qd.scales, order_d, axis=0)
    if npad != len(order):
        vals_p = jnp.pad(vals_p, ((0, npad - len(order)), (0, 0)))
        scales_p = jnp.pad(scales_p, (0, npad - len(order)))
    return IVFDense(
        centroids=cent,
        values=vals_p,
        scales=scales_p,
        perm=jnp.asarray(perm),
        cluster_start=jnp.asarray(cluster_start),
        tile_n=tile_n,
        n_real=len(order),
        max_cluster_tiles=mct,
        spilled=rows is not None,
    )


@functools.partial(
    jax.jit,
    static_argnames=("nprobe", "max_tiles", "tile_n", "mct"),
)
def build_tile_table(
    centroids: jax.Array,
    cluster_start: jax.Array,
    queries: jax.Array,
    nprobe: int,
    max_tiles: int,
    tile_n: int,
    mct: int,
) -> Tuple[jax.Array, jax.Array]:
    """Probe clusters and emit the deduped covering-tile table.

    Returns (tile_table [max_tiles] int32 with real tiles first and -1
    padding, n_unique — the number of distinct tiles the batch wanted;
    n_unique > max_tiles means the table was truncated and recall
    degrades: raise max_tiles or lower nprobe).
    """
    scores = jnp.dot(
        queries, centroids.T.astype(queries.dtype),
        preferred_element_type=jnp.float32,
    )  # [B, C]
    _, cids = jax.lax.top_k(scores, nprobe)  # [B, p]
    starts = jnp.take(cluster_start, cids)  # [B, p]
    ends = jnp.take(cluster_start, cids + 1)
    t0 = starts // tile_n
    t1 = (ends - 1) // tile_n  # inclusive (empty cluster -> t1 < t0)
    j = jnp.arange(mct, dtype=jnp.int32)
    tiles = t0[..., None] + j  # [B, p, mct]
    valid = (tiles <= t1[..., None]) & (ends > starts)[..., None]
    flat = jnp.where(valid, tiles, _BIG).reshape(-1)
    srt = jnp.sort(flat)
    uniq = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_), srt[1:] != srt[:-1]]
    )
    keyed = jnp.where(uniq & (srt < _BIG), srt, _BIG)
    n_unique = jnp.sum(keyed < _BIG)
    keyed = jnp.sort(keyed)
    if keyed.shape[0] < max_tiles:
        # Tiny batches can demand fewer candidates (B*p*mct) than the
        # requested table size; pad with sentinels rather than fail.
        keyed = jnp.pad(
            keyed, (0, max_tiles - keyed.shape[0]), constant_values=_BIG
        )
    table = jax.lax.slice(keyed, (0,), (max_tiles,))
    table = jnp.where(table >= _BIG, -1, table).astype(jnp.int32)
    return table, n_unique


def attach_ivf(
    index,
    model_name: str,
    n_clusters: Optional[int] = None,
    tile_n: int = 1024,
    n_iters: int = 10,
    seed: int = 0,
    spill: bool = False,
    spill_margin: Optional[float] = None,
) -> IVFDense:
    """Build and attach an IVF structure for one of an ArrayIndex's
    dense models (float or int8-quantized). The original matrix is
    kept — the exact and filtered paths still use it — so memory for
    that model doubles; at memory-bound scale build the IVFDense
    standalone instead and serve it directly."""
    if model_name in index.dense:
        ivf = build_ivf_dense(
            index.dense[model_name], n_clusters=n_clusters,
            tile_n=tile_n, n_iters=n_iters, seed=seed,
            spill=spill, spill_margin=spill_margin,
        )
    elif index.dense_q and model_name in index.dense_q:
        ivf = build_ivf_quantized(
            index.dense_q[model_name], n_clusters=n_clusters,
            tile_n=tile_n, n_iters=n_iters, seed=seed,
            spill=spill, spill_margin=spill_margin,
        )
    else:
        raise KeyError(f"no dense matrix for model {model_name!r}")
    if index.ivf is None:
        index.ivf = {}
    index.ivf[model_name] = ivf
    return ivf


def ivf_fetch_k(k: int, spilled: bool, n_rows: int) -> int:
    """Candidates an IVF scan fetches for a top-k. A spilled layout can
    surface a boundary document from BOTH of its clusters, so it fetches
    double (at most ``n_rows``), merges the duplicates and compacts back
    to k."""
    return min(2 * k, n_rows) if spilled else k


def ivf_search(
    ivf: IVFDense,
    queries: jax.Array,
    k: int,
    nprobe: int,
    max_tiles: Optional[int] = None,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """ANN top-k: probe ``nprobe`` clusters per query, scan the union
    through the streaming top-k (``interpret`` runs its kernel in the
    Pallas interpreter).

    Returns (values [B, k] desc, ORIGINAL doc rows [B, k] with -1 for
    unfilled slots, n_unique tile count for overflow observability).
    With nprobe == n_clusters this equals the exact scan (every tile
    scheduled) — the parity anchor for tests. For an int8 IVF the float
    queries are quantized on the fly (probe scores stay float).
    """
    from a_nice_rag_tpu.ops.streaming import choose_route, dense_stream_top_k

    k_fetch = ivf_fetch_k(k, ivf.spilled, ivf.n_real)
    if max_tiles is None:
        # Worst case: every probed cluster on a distinct tile run, plus
        # batch-wide dedup usually shrinks this a lot. Cap at the whole
        # corpus (the exact-scan upper bound).
        max_tiles = min(
            ivf.n_tiles,
            queries.shape[0] * nprobe * ivf.max_cluster_tiles,
        )
    table, n_unique = build_tile_table(
        ivf.centroids, ivf.cluster_start, queries,
        nprobe=nprobe, max_tiles=max_tiles, tile_n=ivf.tile_n,
        mct=ivf.max_cluster_tiles,
    )
    route = choose_route(ivf.n_tiles * ivf.tile_n, k_fetch, "stream",
                         interpret=interpret)
    vals, pidx = dense_stream_top_k(
        ivf.rows, queries, k_fetch, route, tiles=table,
        tile_n=ivf.tile_n, n_valid=ivf.n_real,
    )
    ids = jnp.where(
        pidx >= 0,
        jnp.take(ivf.perm, jnp.clip(pidx, 0, ivf.perm.shape[0] - 1)),
        -1,
    )
    if ivf.spilled:
        from a_nice_rag_tpu.ops.topk import dedup_ranked

        vals, ids = dedup_ranked(vals, ids)
        vals = vals[:, :k]
        ids = ids[:, :k]
    return vals, ids, n_unique


def tune_nprobe(
    ivf: IVFDense,
    queries: jax.Array,
    k: int = 10,
    target_recall: float = 0.95,
    candidates: Tuple[int, ...] = (4, 8, 16, 32, 64, 128, 256),
    exact_ids: Optional[np.ndarray] = None,
    interpret: bool = False,
) -> Tuple[int, dict]:
    """Pick the smallest ``nprobe`` whose recall@k vs the exact scan
    meets ``target_recall`` on a validation query batch.

    The counterpart of the reference's BM25 hyperparameter tuner
    (src/processing/bm25_test.py:192-247): tune the latency/quality
    knob offline against held-out queries, then serve with the winner
    (``FusedRetriever(nprobe=...)`` / ``serve_cli --nprobe``). The
    exact baseline is the IVF layout probed with every cluster — the
    parity anchor ``ivf_search`` documents — unless ``exact_ids`` from
    another exact route is supplied.

    Returns (best nprobe, {nprobe: measured recall}). Falls back to the
    largest candidate when none reaches the target (callers can see
    that from the report). Candidates above the cluster count are
    clamped and deduplicated.
    """
    cands = sorted({min(int(c), ivf.n_clusters) for c in candidates})
    if exact_ids is None:
        _, exact, _ = ivf_search(
            ivf, queries, k, nprobe=ivf.n_clusters, interpret=interpret
        )
        exact_ids = np.asarray(exact)
    exact_sets = [set(r[r >= 0].tolist()) for r in np.asarray(exact_ids)]
    denom = max(1, sum(len(s) for s in exact_sets))
    report: dict = {}
    best = cands[-1]
    for cand in cands:
        _, got, _ = ivf_search(
            ivf, queries, k, nprobe=cand, interpret=interpret
        )
        got = np.asarray(got)
        hits = sum(
            len(exact_sets[i] & set(got[i][got[i] >= 0].tolist()))
            for i in range(len(exact_sets))
        )
        recall = hits / denom
        report[cand] = recall
        if recall >= target_recall:
            best = cand
            break
    return best, report
