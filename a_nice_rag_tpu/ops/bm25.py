"""BM25 Okapi scoring as a jitted gather/scatter kernel.

Replaces ``rank_bm25.BM25Okapi.get_scores`` (reference hot loop at
``src/search_engine.py:219``). Numerics follow the Okapi variant the
reference shipped (``src/processing/bm25_search.py:45-79``):

    idf(t)   = ln((N - df + 0.5) / (df + 0.5)); negative idfs floored to
               epsilon * mean(idf)   (rank_bm25's epsilon rule)
    score(d) = sum_t idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b*dl/avgdl))

Design ("eager impact scoring"): because (k1, b, dl, avgdl, idf) are all
fixed at index-build time, the full per-(term, doc) impact
``idf*tf*(k1+1)/(tf+K_d)`` is precomputed into a CSR postings structure.
Query scoring is then a pure flattened gather of at most
``postings_budget`` impact values followed by one scatter-add over the
document axis — no per-term Python loop, fully static shapes, vmap-able
over query batches.

Repeated query terms contribute once per occurrence, matching rank_bm25's
per-occurrence summation. Out-of-vocabulary terms are mapped to id -1 by
the vocab lookup and contribute nothing.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.ops.topk import masked_top_k


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bm25Arrays:
    """Device-resident CSR postings with precomputed impact scores.

    indptr:  [V + 1] int32 — postings offsets per term id.
    doc_ids: [nnz + 1] int32 — document row per posting; the final
             sentinel slot points at the dump row ``n_docs_padded``.
    impact:  [nnz + 1] float32 — precomputed BM25 impact per posting;
             sentinel slot is 0.
    n_docs_padded: static — padded document-axis length (scatter target).
    """

    indptr: jax.Array
    doc_ids: jax.Array
    impact: jax.Array
    n_docs_padded: int = dataclasses.field(metadata=dict(static=True))

    @property
    def nnz(self) -> int:
        return self.doc_ids.shape[0] - 1

    @property
    def vocab_size(self) -> int:
        return self.indptr.shape[0] - 1


def _flat_postings_indices(
    indptr: jax.Array,
    q_terms: jax.Array,
    budget: int,
    sentinel: int,
) -> jax.Array:
    """Indices into the flat postings arrays for one query.

    q_terms: [T] int32 term ids, -1 = padding/OOV. Produces [budget] gather
    indices: the concatenation of each query term's postings range, padded
    with ``sentinel`` (which addresses the zero-impact dump slot).
    """
    valid = q_terms >= 0
    t = jnp.where(valid, q_terms, 0)
    starts = indptr[t]
    dfs = jnp.where(valid, indptr[t + 1] - starts, 0)
    cum = jnp.cumsum(dfs)
    total = cum[-1]
    p = jnp.arange(budget, dtype=jnp.int32)
    seg = jnp.searchsorted(cum, p, side="right")
    seg = jnp.clip(seg, 0, q_terms.shape[0] - 1)
    prev = jnp.where(seg > 0, cum[seg - 1], 0)
    g = starts[seg] + (p - prev)
    return jnp.where(p < total, g, sentinel)


def _bm25_scores_single(
    bm25: Bm25Arrays, q_terms: jax.Array, budget: int
) -> jax.Array:
    g = _flat_postings_indices(bm25.indptr, q_terms, budget, bm25.nnz)
    ids = bm25.doc_ids[g]
    vals = bm25.impact[g]
    scores = jnp.zeros(bm25.n_docs_padded + 1, dtype=vals.dtype).at[ids].add(vals)
    return scores[: bm25.n_docs_padded]


@partial(jax.jit, static_argnames=("budget",))
def bm25_scores(
    bm25: Bm25Arrays,
    q_terms: jax.Array,
    budget: int = 16384,
) -> jax.Array:
    """BM25 scores [B, N_pad] for a batch of term-id queries [B, T].

    ``budget`` is the static per-query flattened-postings budget; postings
    beyond it are dropped (choose it >= the corpus's realistic worst case —
    see :func:`postings_required`).
    """
    return jax.vmap(lambda q: _bm25_scores_single(bm25, q, budget))(q_terms)


@partial(jax.jit, static_argnames=("k", "budget"))
def bm25_top_k(
    bm25: Bm25Arrays,
    q_terms: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    budget: int = 16384,
) -> Tuple[jax.Array, jax.Array]:
    """Fused BM25 scoring + masked top-k. Returns ([B, k], [B, k])."""
    scores = bm25_scores(bm25, q_terms, budget)
    if mask is not None:
        scores = jnp.where(mask[None, :], scores, -jnp.inf)
    return masked_top_k(scores, k)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bm25DenseArrays:
    """Dense eager-impact matrix: impact[v, d] = full BM25 contribution of
    term v in document d (0 where the term is absent).

    Turns BM25 scoring into a matmul: with query term-count vector
    q_tf [V], scores = q_tf @ impact, which replaces a scatter per
    query for corpus sizes where V*N fits in device memory (the
    reference corpus is ~30k vocab x ~10k docs: <2 GB f32, <1 GB bf16).
    The CSR form (:class:`Bm25Arrays`) remains the representation
    for memory-constrained / sharded-at-scale settings.
    """

    impact: jax.Array  # [V, N_pad]

    @property
    def vocab_size(self) -> int:
        return self.impact.shape[0]

    @property
    def n_docs_padded(self) -> int:
        return self.impact.shape[1]


@partial(jax.jit, static_argnames=())
def bm25_scores_dense(
    bm25: Bm25DenseArrays, q_terms: jax.Array
) -> jax.Array:
    """BM25 scores [B, N_pad] via term-count matmul.

    q_terms: [B, T] term ids (-1 pad/OOV). Builds the [B, V] term-count
    matrix with a (tiny) scatter-add and contracts it against the impact
    matrix. Duplicate terms accumulate counts, matching rank_bm25's
    per-occurrence summation. An f32 impact matrix is contracted at
    ``Precision.HIGHEST`` (never TF32); a bf16 one as bf16 x bf16 with
    f32 accumulation.
    """
    b, t = q_terms.shape
    v = bm25.vocab_size
    valid = q_terms >= 0
    cols = jnp.where(valid, q_terms, v)  # dump column for padding
    rows = jnp.broadcast_to(jnp.arange(b)[:, None], (b, t))
    q_tf = jnp.zeros((b, v + 1), dtype=bm25.impact.dtype)
    q_tf = q_tf.at[rows.reshape(-1), cols.reshape(-1)].add(1.0)
    return jax.lax.dot_general(
        q_tf[:, :v],
        bm25.impact,
        dimension_numbers=(((1,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST
        if bm25.impact.dtype == jnp.float32 else None,
        preferred_element_type=jnp.float32,
    )


@partial(jax.jit, static_argnames=())
def bm25_scores_dense_gather(
    bm25: Bm25DenseArrays, q_terms: jax.Array
) -> jax.Array:
    """BM25 scores [B, N_pad] via impact-row gather (small-batch path).

    Reads only the B*T query-term rows of the impact matrix instead of
    all V rows: at B=1, T<=16 on the reference corpus that is ~0.6 MB of
    device-memory traffic vs ~780 MB for the matmul form (device times
    not measured on the H100). Crossover vs :func:`bm25_scores_dense`
    is taken at roughly B*T = V. Numerically equal to
    the matmul form up to f32 summation order (duplicate query terms
    contribute once per occurrence, as rank_bm25 does).
    """
    b, t = q_terms.shape
    safe = jnp.where(q_terms >= 0, q_terms, 0)
    rows = jnp.take(bm25.impact, safe.reshape(-1), axis=0)  # [B*T, N_pad]
    rows = rows.reshape(b, t, -1)
    w = (q_terms >= 0).astype(bm25.impact.dtype)[:, :, None]
    return (rows * w).sum(axis=1).astype(jnp.float32)


@partial(jax.jit, static_argnames=("k", "budget", "df_cap"))
def bm25_top_k_sparse(
    bm25: Bm25Arrays,
    q_terms: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    budget: int = 16384,
    df_cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """BM25 top-k without an N-sized score vector OR a scatter.

    ``df_cap`` (optional) switches the postings fetch to per-term
    window slices instead of the flat budget gather, but the cap MUST be >= every queried term's df (:func:`max_df`); a smaller
    cap silently truncates longer posting lists.

    A dense [B, N] accumulator costs device memory at sharded scale, and
    a scatter per query is the slow part of bm25_scores. Instead: gather the query's (doc id, impact) postings,
    SORT by doc id, segment-sum duplicates (same doc hit by several
    terms), and take top-k over the per-document totals directly —
    O(P log P) per query with P = postings budget, independent of N.

    Only documents with at least one matching posting can appear (score
    > 0); that matches ranking semantics for retrieval (zero-score docs
    carry no signal), unlike bm25_scores which materializes zeros.
    Returns (scores [B, k], doc ids [B, k], -inf/-1 padded).
    """
    def one(q: jax.Array):
        if df_cap is not None:
            s_ids, score = _rare_candidates_sliced(bm25, q, df_cap, mask)
        else:
            s_ids, score = _rare_candidates(bm25, q, budget, mask)
        # The sliced candidate set can be narrower than k (few term
        # slots x small df_cap): top_k over min(k, width), -inf/-1 pad.
        kk = min(k, score.shape[0])
        top_s, pos = jax.lax.top_k(score, kk)
        top_ids = jnp.where(jnp.isfinite(top_s), s_ids[pos], -1)
        if kk < k:
            top_s = jnp.concatenate(
                [top_s, jnp.full((k - kk,), -jnp.inf, top_s.dtype)]
            )
            top_ids = jnp.concatenate(
                [top_ids, jnp.full((k - kk,), -1, top_ids.dtype)]
            )
        return top_s, top_ids

    return jax.vmap(one)(q_terms)


_SENTINEL_DOC = jnp.iinfo(jnp.int32).max


def _rare_candidates(
    bm25: Bm25Arrays,
    q: jax.Array,
    budget: int,
    mask: Optional[jax.Array],
) -> Tuple[jax.Array, jax.Array]:
    """Per-document score totals for one query's postings.

    Returns (s_ids [budget] ascending with _SENTINEL_DOC padding,
    score [budget]) where each document's total sits at its LAST
    occurrence in s_ids and every other slot is -inf. No top-k is
    applied — callers that only need the candidate set (e.g. the
    two-tier streaming merge) skip that sort entirely.
    """
    g = _flat_postings_indices(bm25.indptr, q, budget, bm25.nnz)
    ids = bm25.doc_ids[g]
    vals = bm25.impact[g]
    # Padding gathers land on the dump row; push them to the end of
    # the sort instead.
    ids = jnp.where(ids >= bm25.n_docs_padded, _SENTINEL_DOC, ids)
    return _segment_totals(ids, vals, mask)


def max_df(bm25: Bm25Arrays) -> int:
    """Largest document frequency over the vocabulary — the df_cap a
    caller must pass for the window-slice fetch to be lossless. (A
    df_cap below a queried term's df silently truncates that posting
    list; derive caps with this helper, as ShardedRetriever does.)"""
    import numpy as np

    diffs = np.diff(np.asarray(bm25.indptr))
    return int(diffs.max()) if diffs.size else 0


def _rare_candidates_sliced(
    bm25: Bm25Arrays,
    q: jax.Array,
    df_cap: int,
    mask: Optional[jax.Array],
) -> Tuple[jax.Array, jax.Array]:
    """_rare_candidates via per-term contiguous window reads.

    CONTRACT: ``df_cap`` must be >= the df of every queried term (use
    :func:`max_df`); a smaller cap silently truncates longer posting
    lists and undercounts the affected documents' scores.

    Posting lists are contiguous CSR runs, so the T query terms' lists
    are T batched ``lax.dynamic_slice`` windows of static width
    ``df_cap`` (>= the corpus's max rare-term df) instead of a
    ``budget``-wide elementwise gather: B*T contiguous row slices, and
    the downstream sort width drops from ``budget`` to ``T*df_cap``
    (not measured on the H100). Prefer this path whenever T*df_cap is within ~4x of the flat
    budget; heavily skewed rare tiers (huge df_cap) keep the flat
    gather.
    """
    t_slots = q.shape[0]
    valid_t = q >= 0
    t = jnp.where(valid_t, q, 0)
    starts = bm25.indptr[t]
    lens = jnp.where(valid_t, bm25.indptr[t + 1] - starts, 0)
    # Pad so a window starting at the last posting never clamps (a
    # clamped dynamic_slice would shift the window and misalign the
    # validity mask).
    ids_pad = jnp.concatenate(
        [bm25.doc_ids,
         jnp.full((df_cap,), bm25.n_docs_padded, bm25.doc_ids.dtype)]
    )
    imp_pad = jnp.concatenate(
        [bm25.impact, jnp.zeros((df_cap,), bm25.impact.dtype)]
    )
    ids_tc = jax.vmap(
        lambda s: jax.lax.dynamic_slice(ids_pad, (s,), (df_cap,))
    )(starts)
    vals_tc = jax.vmap(
        lambda s: jax.lax.dynamic_slice(imp_pad, (s,), (df_cap,))
    )(starts)
    pos = jnp.arange(df_cap, dtype=jnp.int32)
    keep = pos[None, :] < lens[:, None]
    ids = jnp.where(keep, ids_tc, _SENTINEL_DOC)
    ids = jnp.where(ids >= bm25.n_docs_padded, _SENTINEL_DOC, ids)
    vals = jnp.where(keep, vals_tc, 0.0)
    return _segment_totals(
        ids.reshape(t_slots * df_cap), vals.reshape(t_slots * df_cap), mask
    )


def _segment_totals(
    ids: jax.Array, vals: jax.Array, mask: Optional[jax.Array]
) -> Tuple[jax.Array, jax.Array]:
    """Sort (id, value) pairs and total duplicate ids' values.

    Returns (s_ids [P] ascending, score [P]) with each id's total at
    its LAST occurrence, -inf elsewhere; _SENTINEL_DOC-padded.
    """
    # Variadic sort carries the values along with the id keys in ONE
    # sort instead of an argsort and two gathers.
    s_ids, s_vals = jax.lax.sort((ids, vals), dimension=-1, num_keys=1)
    # Segment totals WITHOUT a scatter: impacts are positive, so the
    # running csum is nondecreasing and a cummax broadcasts each
    # group's starting prefix to all its members. The group total
    # lands on the group's LAST element. Precision note: the
    # cumsum-difference cancels ~budget*eps absolute (~1e-3 at
    # budget 4096); rank order is unaffected in practice. (A segmented
    # associative_scan is exact within a group; not measured on this
    # card.)
    csum = jnp.cumsum(s_vals)
    csum_before = jnp.concatenate([jnp.zeros((1,), csum.dtype), csum[:-1]])
    first = jnp.concatenate(
        [jnp.ones((1,), bool), s_ids[1:] != s_ids[:-1]]
    )
    last = jnp.concatenate([s_ids[1:] != s_ids[:-1], jnp.ones((1,), bool)])
    start_prefix = jax.lax.cummax(
        jnp.where(first, csum_before, -jnp.inf)
    )
    score = jnp.where(
        last & (s_ids != _SENTINEL_DOC), csum - start_prefix, -jnp.inf
    )
    if mask is not None:
        keep = mask[jnp.clip(s_ids, 0, mask.shape[0] - 1)]
        score = jnp.where(keep, score, -jnp.inf)
    return s_ids, score


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Bm25TwoTier:
    """Two-tier postings layout for large sharded corpora.

    High-df ("common") terms — the handful of terms whose posting lists
    dominate the flattened-gather budget — get dense impact rows scored
    as a matmul; the long tail stays CSR with a budget bounded by
    the rare-term df cap. Splitting by df keeps exactness: every posting
    lives in exactly one tier and the tiers' scores add.

    common_impact_t: [N_pad, V_common] dense impact, document-major —
                   the same layout as a dense embedding matrix, so the
                   common tier rides the dense matmul AND the streaming
                   top-k (ops.streaming) unchanged.
    common_map:    [V + 1] int32 — full-vocab term id -> common column,
                   -1 for rare/absent (slot V covers padded queries).
    rare:          CSR with common terms' ranges emptied.
    """

    common_impact_t: jax.Array
    common_map: jax.Array
    rare: Bm25Arrays

    @property
    def v_common(self) -> int:
        return self.common_impact_t.shape[1]

    @property
    def n_docs_padded(self) -> int:
        return self.rare.n_docs_padded


def split_two_tier(
    bm25: Bm25Arrays, v_common: int = 256, dtype: str = "float32"
) -> Bm25TwoTier:
    """Split CSR postings into dense-common + rare-CSR tiers by df."""
    import numpy as np

    indptr = np.asarray(bm25.indptr)
    doc_ids = np.asarray(bm25.doc_ids)
    impact = np.asarray(bm25.impact)
    v = indptr.shape[0] - 1
    n_pad = bm25.n_docs_padded
    df = np.diff(indptr)
    v_common = min(v_common, v)
    common_terms = np.sort(np.argsort(df)[::-1][:v_common])

    common_map = np.full(v + 1, -1, dtype=np.int32)
    common_map[common_terms] = np.arange(v_common, dtype=np.int32)
    dense = np.zeros((n_pad, v_common), dtype=np.float32)
    for col, t in enumerate(common_terms):
        lo, hi = indptr[t], indptr[t + 1]
        dense[doc_ids[lo:hi], col] = impact[lo:hi]

    # Rare CSR: common terms' ranges removed.
    keep = np.ones(int(indptr[-1]), dtype=bool)
    for t in common_terms:
        keep[indptr[t] : indptr[t + 1]] = False
    new_df = df.copy()
    new_df[common_terms] = 0
    new_ptr = np.zeros(v + 1, dtype=np.int32)
    np.cumsum(new_df, out=new_ptr[1:])
    nnz = int(new_ptr[-1])
    new_ids = np.empty(nnz + 1, dtype=np.int32)
    new_imp = np.empty(nnz + 1, dtype=np.float32)
    new_ids[:nnz] = doc_ids[: keep.shape[0]][keep]
    new_imp[:nnz] = impact[: keep.shape[0]][keep]
    new_ids[nnz] = n_pad
    new_imp[nnz] = 0.0
    rare = Bm25Arrays(
        indptr=jnp.asarray(new_ptr),
        doc_ids=jnp.asarray(new_ids),
        impact=jnp.asarray(new_imp),
        n_docs_padded=n_pad,
    )
    return Bm25TwoTier(
        common_impact_t=jnp.asarray(dense, dtype=jnp.dtype(dtype)),
        common_map=jnp.asarray(common_map),
        rare=rare,
    )


def _two_tier_q_tf(tt: Bm25TwoTier, q_terms: jax.Array) -> jax.Array:
    """Common-tier term-count matrix [B, V_common] for a term-id batch."""
    b, t = q_terms.shape
    v_common = tt.v_common
    safe_terms = jnp.where(q_terms >= 0, q_terms, tt.common_map.shape[0] - 1)
    rows = tt.common_map[safe_terms]  # [B, T] common column or -1
    cols = jnp.where(rows >= 0, rows, v_common)
    bidx = jnp.broadcast_to(jnp.arange(b)[:, None], (b, t))
    q_tf = jnp.zeros((b, v_common + 1), dtype=tt.common_impact_t.dtype)
    q_tf = q_tf.at[bidx.reshape(-1), cols.reshape(-1)].add(1.0)
    return q_tf[:, :v_common]


@partial(jax.jit, static_argnames=("budget",))
def bm25_scores_two_tier(
    tt: Bm25TwoTier, q_terms: jax.Array, budget: int = 2048
) -> jax.Array:
    """BM25 scores [B, N_pad]: dense-common matmul + rare CSR gather.

    ``budget`` bounds only the RARE tier's flattened postings, typically
    orders of magnitude below the single-tier requirement.
    """
    q_tf = _two_tier_q_tf(tt, q_terms)
    s_common = jax.lax.dot_general(
        q_tf,
        tt.common_impact_t,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    s_rare = bm25_scores(tt.rare, q_terms, budget)
    return s_common + s_rare


@partial(
    jax.jit,
    static_argnames=("k", "budget", "interpret", "df_cap"),
)
def bm25_top_k_two_tier(
    tt: Bm25TwoTier,
    q_terms: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    budget: int = 2048,
    interpret: bool = False,
    df_cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Exact two-tier BM25 top-k WITHOUT materializing [B, N] scores.

    The common tier is a matmul against ``common_impact_t`` — the same
    shape as dense retrieval — so it takes the streaming dense top-k
    (:func:`ops.streaming.dense_stream_top_k`; ``interpret`` runs its
    kernel in the Pallas interpreter). The rare tier touches at
    most ``budget`` postings per query, so every document with a nonzero
    rare score is enumerable. Exactness: a document in the true top-k
    either has a rare posting for this query (it is in the rare
    candidate set, scored with its full common+rare total) or its total
    equals its common score — and if k or more documents beat that
    common score in the common ordering, each beats it in totals too, so
    the common top-k covers all remaining contenders.

    Candidates from both sets are deduplicated by document id keeping
    the maximum score (the full total dominates the common-only entry
    because impacts are nonnegative). Returns (scores [B, k],
    doc ids [B, k]), -inf/-1 padded.
    """
    from a_nice_rag_tpu.ops.streaming import choose_route, dense_stream_top_k

    n_pad = tt.n_docs_padded
    q_tf = _two_tier_q_tf(tt, q_terms)

    # Common tier: streaming matmul + top-k over [N_pad, V_common].
    route = choose_route(n_pad, k, "stream", interpret=interpret)
    c_vals, c_ids = dense_stream_top_k(
        tt.common_impact_t, q_tf, k, route, mask=mask
    )

    # Rare tier: per-document totals for every touched document,
    # id-sorted with the total on each document's LAST occurrence
    # (no top-k sort needed — the merge below consumes the set as-is).
    # A static df_cap routes through the per-term window-slice fetch
    # (piecewise-contiguous reads; ~10x over the budget gather).
    if df_cap is not None:
        r_ids, r_scores = jax.vmap(
            lambda q: _rare_candidates_sliced(tt.rare, q, df_cap, mask)
        )(q_terms)
    else:
        r_ids, r_scores = jax.vmap(
            lambda q: _rare_candidates(tt.rare, q, budget, mask)
        )(q_terms)
    # Add the common contribution at the rare candidates' rows.
    safe = jnp.clip(r_ids, 0, n_pad - 1)
    rows = jnp.take(tt.common_impact_t, safe.reshape(-1), axis=0)
    rows = rows.reshape(r_ids.shape + (tt.v_common,))
    c_at = jnp.einsum(
        "brv,bv->br", rows.astype(jnp.float32), q_tf.astype(jnp.float32)
    )
    r_totals = jnp.where(jnp.isfinite(r_scores), r_scores + c_at, -jnp.inf)

    # Dedup: a common-top-k doc that also has rare postings is already in
    # the rare set with its full total (which dominates the common-only
    # entry, impacts being nonnegative). r_ids is sorted ascending, so
    # membership is a searchsorted probe instead of a joint sort. Slots
    # whose total is -inf are not live candidates (sentinel padding or
    # non-last duplicate occurrences) — exclude them from membership.
    def member(sorted_ids, live, probe):
        # side="right" - 1 = the LAST occurrence, where the live total
        # sits (earlier duplicate slots carry -inf).
        pos = jnp.searchsorted(sorted_ids, probe, side="right") - 1
        pos = jnp.clip(pos, 0, sorted_ids.shape[0] - 1)
        return (sorted_ids[pos] == probe) & live[pos]

    live = jnp.isfinite(r_totals)
    dup = jax.vmap(member)(r_ids, live, jnp.where(c_ids >= 0, c_ids, -1))
    c_vals = jnp.where(dup, -jnp.inf, c_vals)

    ids = jnp.concatenate([r_ids, jnp.where(c_ids >= 0, c_ids, n_pad)], axis=1)
    vals = jnp.concatenate([r_totals, c_vals], axis=1)
    top_v, pos = jax.lax.top_k(vals, k)
    top_i = jnp.take_along_axis(ids, pos, axis=1)
    return top_v, jnp.where(jnp.isfinite(top_v), top_i, -1)


def postings_required(bm25: Bm25Arrays, q_terms: jax.Array) -> jax.Array:
    """Total postings each query would touch — for budget validation [B]."""
    valid = q_terms >= 0
    t = jnp.where(valid, q_terms, 0)
    dfs = jnp.where(valid, bm25.indptr[t + 1] - bm25.indptr[t], 0)
    return dfs.sum(axis=-1)
