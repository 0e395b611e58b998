"""Search engine over the array index.

Two API levels:

* :class:`SearchEngine` — behavioral parity with the reference's
  ``SearchEngine`` + ``RetrievalEvaluationSystem.retrieve_documents``
  (src/search_engine.py:14-293, src/query_rag_retrieval.py:149-407):
  per-model gating on weights and available query embeddings, optional
  hybrid BM25, WRRF fusion, first-stage-wins doc records, optional
  rerank stage with graceful fallback. Batched-first: every method takes
  a batch of queries; single-query wrappers are provided for parity.

* :class:`FusedRetriever` — the device fast path: all active rankers,
  fusion and final top-n compiled into ONE XLA program (one device
  round-trip per query batch).
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.config import Config
from a_nice_rag_tpu.index.array_index import ArrayIndex
from a_nice_rag_tpu.index.ivf import ivf_fetch_k
from a_nice_rag_tpu.ops.bm25 import (
    Bm25TwoTier,
    bm25_scores,
    bm25_scores_dense,
    bm25_scores_dense_gather,
    bm25_top_k_sparse,
    bm25_top_k_two_tier,
)
from a_nice_rag_tpu.ops.dense import dense_scores
from a_nice_rag_tpu.ops.fusion import wrrf_top_n
from a_nice_rag_tpu.ops.quantized import (
    QuantizedDense,
    quantize_queries,
    quantized_dense_scores,
)
from a_nice_rag_tpu.ops.streaming import choose_route, dense_stream_top_k
from a_nice_rag_tpu.ops.topk import masked_top_k
from a_nice_rag_tpu.retrieval.rerank import Reranker, apply_rerank
from a_nice_rag_tpu.text import preprocess_text

logger = logging.getLogger(__name__)

# Model iteration order mirrors the reference's fixed search order
# (src/query_rag_retrieval.py:197-301).
MODEL_ORDER = ("voyage-3-large", "voyage-3.5", "text-embedding-3-large", "Qwen3")


def _ivf_coverage(batch: int, nprobe: int, n_clusters: int) -> float:
    """Expected fraction of clusters scheduled by a batch's probe union
    under (approximately) uniform cluster draws: ``1 - (1 - p/C)^B``.
    Static at trace time (all three are Python ints), so the IVF-vs-
    exact routing it drives costs nothing at dispatch. Both retriever
    layers share this model."""
    if n_clusters <= 0:
        return 1.0
    p = min(nprobe, n_clusters) / n_clusters
    return 1.0 - (1.0 - p) ** max(1, batch)


@partial(jax.jit, static_argnames=("k",))
def _dense_list(emb, q, mask, k):
    """Per-model ranked list: ids [B, k] with -1 where masked out/invalid."""
    scores = dense_scores(emb, q)
    scores = jnp.where(mask[None, :], scores, -jnp.inf)
    vals, idx = masked_top_k(scores, k)
    return vals, jnp.where(jnp.isfinite(vals), idx, -1)


@partial(jax.jit, static_argnames=("k",))
def _dense_list_q(qd, q, mask, k):
    """Per-model ranked list over an int8-quantized matrix (queries
    quantized on the fly; int32 accumulation)."""
    qv, qs = quantize_queries(q)
    scores = quantized_dense_scores(qd, qv, qs)
    scores = jnp.where(mask[None, :], scores, -jnp.inf)
    vals, idx = masked_top_k(scores, k)
    return vals, jnp.where(jnp.isfinite(vals), idx, -1)


@partial(jax.jit, static_argnames=("k", "budget"))
def _bm25_list(bm25, q_terms, mask, k, budget):
    scores = bm25_scores(bm25, q_terms, budget)
    scores = jnp.where(mask[None, :], scores, -jnp.inf)
    vals, idx = masked_top_k(scores, k)
    return vals, jnp.where(jnp.isfinite(vals), idx, -1)


@partial(jax.jit, static_argnames=("k",))
def _bm25_list_dense(bm25_dense, q_terms, mask, k):
    b, t = q_terms.shape
    if b * t <= bm25_dense.vocab_size // 2:
        scores = bm25_scores_dense_gather(bm25_dense, q_terms)
    else:
        scores = bm25_scores_dense(bm25_dense, q_terms)
    scores = jnp.where(mask[None, :], scores, -jnp.inf)
    vals, idx = masked_top_k(scores, k)
    return vals, jnp.where(jnp.isfinite(vals), idx, -1)


class FusedRetriever:
    """One-XLA-program hybrid retrieval for a fixed configuration.

    Static configuration: which dense models participate, whether BM25
    participates, similarity_k, common_sections_n, postings budget.
    Dynamic per call: query embeddings, query term ids, candidate mask,
    fusion weights, wrrf_k.
    """

    def __init__(
        self,
        index: ArrayIndex,
        model_names: Sequence[str],
        use_bm25: bool,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        budget: int = 16384,
        dense_backend: str = "auto",
        nprobe: Optional[int] = None,
        ivf_max_tiles: Optional[int] = None,
        ivf_route: str = "auto",
        ivf_max_coverage: float = 0.25,
        two_tier_common="auto",
        two_tier_dtype: str = "bfloat16",
        t_max_hint: int = 16,
        interpret: bool = False,
    ):
        """``dense_backend``: "auto", "xla" or "stream", resolved with
        the corpus size by :func:`ops.streaming.choose_route` (exposed as
        ``self.route``). A streaming route never materializes [B, N]
        scores. ``interpret=True`` runs its Pallas kernel in the
        interpreter (tests on the CPU).

        ``nprobe``: opt-in ANN — models with an attached IVF structure
        (index.ivf, see index/ivf.attach_ivf) probe only their top-p
        clusters instead of scanning the corpus. Approximate (recall
        depends on nprobe/n_clusters); applies only when no candidate
        mask is active — filtered or tombstoned calls fall back to the
        exact scan, preserving reference filter semantics exactly.
        ``ivf_max_tiles`` caps the per-batch scheduled tile table
        (default: worst-case, no truncation).

        ``ivf_route`` picks WHEN the ANN route applies once ``nprobe``
        is set. "auto" (default) probes only while the EXPECTED
        cluster coverage ``1 - (1 - p/C)^B`` stays at or below
        ``ivf_max_coverage`` — the exact stream's cost is one corpus
        pass per BATCH (its per-query price collapses as the batch
        widens) while the probed-tile union grows with batch until it
        covers the corpus, so the policy is shape-aware in (B, nprobe,
        n_clusters) rather than a fixed batch cap. The coverage model
        assumes roughly uniform cluster draws; the 0.25 default puts
        B=16 (analytic coverage 0.163 at the 2M x 256 IVF shape) on the
        probed route and B=32 (0.299) on the exact one. The crossover is
        not measured on the H100. "always" probes at every batch size;
        either way the decision is static per compiled batch bucket
        (batch size is static under jit).

        Backend semantics note: on the streaming route a CSR-only BM25 list
        reports -1 for zero-score slots (docs with no matching term are
        not candidates), while the XLA scatter path surfaces arbitrary
        zero-score filler ids to fill k — so a query matching fewer than
        similarity_k docs can yield a shorter fused list under
        dense_backend="stream". Zero-score docs carry no ranking signal
        either way."""
        self.index = index
        self.model_names = tuple(model_names)
        self.use_bm25 = use_bm25
        similarity_k = min(similarity_k, index.n_docs)
        common_sections_n = min(common_sections_n, index.n_docs_padded)
        self.similarity_k = similarity_k
        self.common_sections_n = common_sections_n
        self.budget = budget
        n_pad = index.n_docs_padded
        n_lists = len(self.model_names) + (1 if use_bm25 else 0)
        if n_lists == 0:
            raise ValueError("FusedRetriever needs at least one ranker")
        use_dense_bm25 = use_bm25 and index.bm25_dense is not None
        csr_df_cap = None
        if use_bm25 and not use_dense_bm25 and index.bm25_stats:
            csr_df_cap = int(index.bm25_stats.get("max_df", 0) or 0) or None
        route = choose_route(n_pad, similarity_k, dense_backend,
                             interpret=interpret)
        streams = route.stream
        # Two-tier BM25 by DEFAULT on skewed CSR corpora: when common
        # terms' dfs make both sparse fetch forms unaffordable (window
        # slices need t*max_df <= 4*budget; the flat gather silently
        # truncates past budget), split the top-df terms into a dense
        # impact tier taken by the streaming top-k and keep the rare CSR side window-
        # sliced — exact (tiers partition postings; scores add;
        # ops.bm25.bm25_top_k_two_tier docstring). "auto" builds the
        # smallest power-of-two common tier that makes the rare side
        # affordable, capped at 1 GB of bf16 dense rows; an int forces
        # that width; 0/None disables.
        self._two_tier = None
        self._tt_rare_cap = None
        if (
            use_bm25 and not use_dense_bm25 and streams
            and two_tier_common and index.bm25 is not None
        ):
            df = np.diff(np.asarray(index.bm25.indptr))
            if df.size:
                sorted_df = np.sort(df)[::-1]
                affordable = sorted_df * t_max_hint <= 4 * budget
                if two_tier_common == "auto":
                    if affordable[0]:
                        v_common = 0  # single-tier already affordable
                    else:
                        first_ok = int(np.argmax(affordable))
                        v_common = 1 << max(first_ok - 1, 0).bit_length()
                        v_common = min(v_common, df.size)
                        if n_pad * v_common * 2 > (1 << 30):
                            v_common = 0  # dense tier too big: keep CSR
                else:
                    v_common = int(two_tier_common)
                if v_common > 0:
                    from a_nice_rag_tpu.ops.bm25 import split_two_tier

                    self._two_tier = split_two_tier(
                        index.bm25, v_common, two_tier_dtype
                    )
                    rare_df = np.diff(
                        np.asarray(self._two_tier.rare.indptr)
                    )
                    rmax = int(rare_df.max()) if rare_df.size else 0
                    if rmax and rmax * t_max_hint <= 4 * budget:
                        self._tt_rare_cap = rmax
        tt_rare_cap = self._tt_rare_cap
        # Exposed so callers (bench.py, tests) can assert which route the
        # configuration actually took.
        self.route = route
        self.nprobe = nprobe
        if ivf_route not in ("auto", "always"):
            raise ValueError(
                f"ivf_route must be 'auto' or 'always', got {ivf_route!r}"
            )
        self.ivf_route = ivf_route
        self.ivf_max_coverage = float(ivf_max_coverage)
        self._ivf_structs = tuple(
            (index.ivf or {}).get(m) if nprobe else None
            for m in self.model_names
        )
        # The probed scan streams over its tile table on every platform:
        # the kernel where the route has one, else plain XLA.
        ivf_ks = tuple(
            None if iv is None
            else ivf_fetch_k(similarity_k, iv.spilled, iv.n_real)
            for iv in self._ivf_structs
        )
        ivf_routes = tuple(
            None if kf is None
            else choose_route(n_pad, kf, "stream", interpret=interpret)
            for kf in ivf_ks
        )

        @partial(jax.jit, static_argnames=())
        def run(dense_mats, bm25_arrays, q_embs, q_terms, mask, bm25_mask,
                weights, wrrf_k, ivf_structs=None):
            lists = []
            if ivf_structs is None:
                ivf_structs = (None,) * len(q_embs)
            for mat, q, iv, ivr, ivk in zip(dense_mats, q_embs, ivf_structs,
                                            ivf_routes, ivf_ks):
                probe_this_batch = iv is not None and mask is None and (
                    self.ivf_route == "always"
                    or _ivf_coverage(q.shape[0], nprobe, iv.n_clusters)
                    <= self.ivf_max_coverage
                )
                if probe_this_batch:
                    # IVF ANN route: probe nprobe clusters, scan only
                    # their covering tiles. Only when no mask is active
                    # (filtered calls trace with mask != None and take
                    # the exact branch below, keeping the reference's
                    # filter semantics exact) and, under "auto", only
                    # while the expected cluster coverage keeps the
                    # probed scan cheaper than the batch-amortized
                    # exact stream.
                    from a_nice_rag_tpu.index.ivf import build_tile_table

                    mt = ivf_max_tiles or min(
                        iv.n_tiles,
                        q.shape[0] * nprobe * iv.max_cluster_tiles,
                    )
                    table, _ = build_tile_table(
                        iv.centroids, iv.cluster_start, q,
                        nprobe=min(nprobe, iv.n_clusters), max_tiles=mt,
                        tile_n=iv.tile_n, mct=iv.max_cluster_tiles,
                    )
                    ivals, pidx = dense_stream_top_k(
                        iv.rows, q, ivk, ivr,
                        tiles=table, tile_n=iv.tile_n, n_valid=iv.n_real,
                    )
                    iids = jnp.where(
                        pidx >= 0,
                        jnp.take(
                            iv.perm,
                            jnp.clip(pidx, 0, iv.perm.shape[0] - 1),
                        ),
                        -1,
                    )
                    if iv.spilled:
                        from a_nice_rag_tpu.ops.topk import dedup_ranked

                        _, iids = dedup_ranked(ivals, iids)
                        iids = iids[:, :similarity_k]
                    lists.append(iids)
                    continue
                if streams:
                    vals, idx = dense_stream_top_k(
                        mat, q, similarity_k, route, mask=mask
                    )
                    lists.append(idx)
                    continue
                if isinstance(mat, QuantizedDense):
                    qv, qs = quantize_queries(q)
                    scores = quantized_dense_scores(mat, qv, qs)
                else:
                    scores = dense_scores(mat, q)
                if mask is not None:
                    scores = jnp.where(mask[None, :], scores, -jnp.inf)
                vals, idx = masked_top_k(scores, similarity_k)
                lists.append(jnp.where(jnp.isfinite(vals), idx, -1))
            if use_bm25:
                if use_dense_bm25:
                    # Small batches read only the query-term impact rows;
                    # the matmul form amortizes the full-matrix read only
                    # once B*T approaches the vocab size.
                    b, t = q_terms.shape
                    if b * t <= bm25_arrays.vocab_size // 2:
                        scores = bm25_scores_dense_gather(bm25_arrays, q_terms)
                    else:
                        scores = bm25_scores_dense(bm25_arrays, q_terms)
                    if bm25_mask is not None:
                        scores = jnp.where(
                            bm25_mask[None, :], scores, -jnp.inf
                        )
                    vals, idx = masked_top_k(scores, similarity_k)
                elif isinstance(bm25_arrays, Bm25TwoTier):
                    # Auto-selected two-tier layout: dense common tier
                    # through the streaming top-k, rare CSR side
                    # window-sliced. Exact (tiers partition postings).
                    vals, idx = bm25_top_k_two_tier(
                        bm25_arrays, q_terms, similarity_k,
                        mask=bm25_mask, budget=budget,
                        df_cap=tt_rare_cap, interpret=route.interpret,
                    )
                elif streams:
                    # Million-doc CSR index: sort-based sparse top-k —
                    # the [B, N_pad] score matrix is the thing the
                    # streaming route exists to avoid. Window-slice
                    # fetch when the corpus's df skew allows.
                    # Window slices are lossless whenever df_cap covers
                    # every term's df (it does: derived from max_df) and
                    # the op pads when the candidate set is narrower
                    # than k, so the only routing criterion is width vs
                    # the flat budget.
                    t = q_terms.shape[1]
                    cap = (
                        csr_df_cap
                        if csr_df_cap is not None
                        and t * csr_df_cap <= 4 * budget
                        else None
                    )
                    vals, idx = bm25_top_k_sparse(
                        bm25_arrays, q_terms, similarity_k,
                        mask=bm25_mask, budget=budget, df_cap=cap,
                    )
                elif csr_df_cap is not None \
                        and q_terms.shape[1] * csr_df_cap <= 4 * budget:
                    # CSR-only index (vocab x N too big for the dense
                    # impact matrix) on the XLA route: the sort-based
                    # sparse top-k with per-term window-slice postings
                    # fetches instead of a scatter per query (lossless —
                    # the cap is the corpus max_df). Same
                    # -1-for-zero-score semantics as the streaming route
                    # (documented above).
                    vals, idx = bm25_top_k_sparse(
                        bm25_arrays, q_terms, similarity_k,
                        mask=bm25_mask, budget=budget,
                        df_cap=csr_df_cap,
                    )
                else:
                    scores = bm25_scores(bm25_arrays, q_terms, budget)
                    if bm25_mask is not None:
                        scores = jnp.where(
                            bm25_mask[None, :], scores, -jnp.inf
                        )
                    vals, idx = masked_top_k(scores, similarity_k)
                lists.append(jnp.where(jnp.isfinite(vals), idx, -1))
            if len(lists) == 1:
                ids = lists[0][:, :common_sections_n]
                return ids, jnp.zeros(ids.shape, jnp.float32), lists[0][None]
            all_idx = jnp.stack(lists)  # [L, B, K]
            if streams:
                # Large corpora: fuse on the id lists directly (the
                # scatter form would allocate [B, N_pad]).
                from a_nice_rag_tpu.ops.fusion import wrrf_top_n_sparse

                fvals, fids = wrrf_top_n_sparse(
                    all_idx, weights, common_sections_n, wrrf_k
                )
            else:
                fvals, fids = wrrf_top_n(
                    all_idx, weights, common_sections_n, n_pad, wrrf_k
                )
            fids = jnp.where(jnp.isfinite(fvals), fids, -1)
            return fids, fvals, all_idx

        self._run = run
        self._const_cache: Dict[tuple, jax.Array] = {}

    def _weights_device(self, weights: Dict[str, float]) -> jax.Array:
        """Cache the tiny weights vector on device: one upload per
        distinct weighting instead of one per call."""
        key = tuple(
            [weights.get(m, 1.0) for m in self.model_names]
            + ([weights.get("BM25", 1.0)] if self.use_bm25 else [])
        )
        if key not in self._const_cache:
            self._const_cache[key] = jnp.asarray(key, dtype=jnp.float32)
        return self._const_cache[key]

    def _scalar_device(self, value: float) -> jax.Array:
        key = ("scalar", value)
        if key not in self._const_cache:
            self._const_cache[key] = jnp.float32(value)
        return self._const_cache[key]

    def retrieve_device(
        self,
        q_embs: Dict[str, jax.Array],
        q_terms: Optional[jax.Array],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        """Device-to-device fast path: inputs/outputs stay on device
        (no host sync). Returns (fused ids, fused scores, per-list ids)
        as jax arrays."""
        args, kw = self._program_args(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k
        )
        return self._run(*args, **kw)

    def lower(
        self,
        q_embs: Dict[str, jax.Array],
        q_terms: Optional[jax.Array],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ):
        """The device program :meth:`retrieve_device` runs for these
        inputs, lowered (``.compile()`` it for its memory analysis)."""
        args, kw = self._program_args(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k
        )
        return self._run.lower(*args, **kw)

    def _program_args(self, q_embs, q_terms, weights, filename_type_filter,
                      wrrf_k):
        idx = self.index
        dense_mats = tuple(idx.dense_matrix(m) for m in self.model_names)
        q_tuple = tuple(jnp.asarray(q_embs[m]) for m in self.model_names)
        # None when all-true: the streaming top-k then drops its mask
        # operand and the per-tile select.
        mask = idx.filter_mask_or_none(filename_type_filter)
        if self.use_bm25:
            version = getattr(idx, "_version", 0)
            key = ("bm25_mask", filename_type_filter or None, version)
            if key not in self._const_cache:
                # Evict masks from older index versions (tombstone
                # mutations) so repeated deletes cannot leak device
                # arrays in a long-lived retriever.
                for stale in [
                    k for k in self._const_cache
                    if k[0] == "bm25_mask" and k[-1] != version
                ]:
                    del self._const_cache[stale]
                doc_mask = idx.bm25_doc_mask_or_none()
                if mask is None and doc_mask is None:
                    bm = None
                elif doc_mask is None:
                    bm = mask
                elif mask is None:
                    bm = jnp.asarray(doc_mask)
                else:
                    bm = mask & jnp.asarray(doc_mask)
                self._const_cache[key] = bm
            bm25_mask = self._const_cache[key]
            terms = jnp.asarray(q_terms)
            if self._two_tier is not None:
                bm25_arrays = self._two_tier
            elif idx.bm25_dense is not None:
                bm25_arrays = idx.bm25_dense
            else:
                bm25_arrays = idx.bm25
        else:
            b = q_tuple[0].shape[0] if q_tuple else 1
            key = ("noterms", b)
            if key not in self._const_cache:
                self._const_cache[key] = jnp.full((b, 1), -1, jnp.int32)
            terms = self._const_cache[key]
            bm25_mask = mask
            bm25_arrays = idx.bm25
        args = (dense_mats, bm25_arrays, q_tuple, terms, mask, bm25_mask,
                self._weights_device(weights), self._scalar_device(wrrf_k))
        return args, dict(ivf_structs=self._ivf_structs)

    def __call__(
        self,
        q_embs: Dict[str, np.ndarray],
        q_terms: Optional[np.ndarray],
        weights: Dict[str, float],
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (fused ids [B, n], fused scores [B, n], per-list ids)."""
        fids, fvals, all_idx = self.retrieve_device(
            q_embs, q_terms, weights, filename_type_filter, wrrf_k
        )
        return np.asarray(fids), np.asarray(fvals), np.asarray(all_idx)


class SearchEngine:
    """Reference-parity search API over one :class:`ArrayIndex`."""

    def __init__(
        self,
        index: ArrayIndex,
        embedder=None,
        reranker: Optional[Reranker] = None,
    ):
        self.index = index
        self.embedder = embedder
        self.reranker = reranker

    # ------------------------------------------------------------------
    # Dense search
    # ------------------------------------------------------------------

    def similarity_search_batch(
        self,
        query_embeddings: np.ndarray,
        model_name: str = "voyage-3-large",
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched dense search: (scores [B, k], doc rows [B, k], -1 pad)."""
        emb = self.index.dense_matrix(model_name)
        mask = self.index.filter_mask(filename_type_filter)
        q = jnp.asarray(np.atleast_2d(np.asarray(query_embeddings, np.float32)))
        k = min(similarity_k, self.index.n_docs)
        if isinstance(emb, QuantizedDense):
            vals, idx = _dense_list_q(emb, q, mask, k)
        else:
            vals, idx = _dense_list(emb, q, mask, k)
        return np.asarray(vals), np.asarray(idx)

    def similarity_search_with_embedding(
        self,
        query_embedding: np.ndarray,
        model_name: str = "voyage-3-large",
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
    ) -> List[Dict]:
        """Single-query parity wrapper returning doc dicts with scores
        (reference src/search_engine.py:57-98)."""
        vals, idx = self.similarity_search_batch(
            query_embedding, model_name, similarity_k, filename_type_filter
        )
        return self._rows_to_docs(idx[0], vals[0])

    def similarity_search(
        self,
        query_text: str,
        model_name: str = "voyage-3-large",
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
        query_embedding: Optional[np.ndarray] = None,
    ) -> List[Dict]:
        """Dense search embedding the query text if needed
        (reference src/search_engine.py:100-146)."""
        if query_embedding is None:
            if self.embedder is None:
                raise ValueError("No embedder configured for text queries")
            query_embedding = self.embedder.embed_queries([query_text])[0]
        return self.similarity_search_with_embedding(
            query_embedding, model_name, similarity_k, filename_type_filter
        )

    # ------------------------------------------------------------------
    # BM25 search
    # ------------------------------------------------------------------

    def bm25_search_preprocessed_batch(
        self,
        query_token_lists: Sequence[Sequence[str]],
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
        t_max: int = 32,
        budget: Optional[int] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched BM25: (scores [B, k], doc rows [B, k], -1 pad)."""
        if self.index.bm25 is None:
            raise ValueError("Index has no BM25 component")
        terms = self.index.pad_term_ids(query_token_lists, t_max)
        mask = self.index.filter_mask(filename_type_filter) & jnp.asarray(
            self.index.bm25_doc_mask
        )
        k = min(similarity_k, self.index.n_docs)
        if self.index.bm25_dense is not None:
            vals, idx = _bm25_list_dense(
                self.index.bm25_dense, jnp.asarray(terms), mask, k
            )
        else:
            budget = budget or Config.DEVICE.bm25_postings_budget
            vals, idx = _bm25_list(
                self.index.bm25, jnp.asarray(terms), mask, k, budget
            )
        return np.asarray(vals), np.asarray(idx)

    def bm25_search_preprocessed(
        self,
        query_tokens: Sequence[str],
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
    ) -> List[str]:
        """Single-query parity wrapper returning ranked section ids
        (reference src/search_engine.py:271-293)."""
        if not query_tokens:
            return []
        vals, idx = self.bm25_search_preprocessed_batch(
            [query_tokens], similarity_k, filename_type_filter
        )
        return [self.index.meta.ids[i] for i in idx[0] if i >= 0]

    def bm25_search(
        self,
        query_text: str,
        similarity_k: int = 25,
        filename_type_filter: Optional[str] = None,
        use_lemmatized: bool = True,
    ) -> List[str]:
        """BM25 with query preprocessing (reference src/search_engine.py:245-269)."""
        tokens = preprocess_text(query_text, use_lemmatization=use_lemmatized)
        return self.bm25_search_preprocessed(
            tokens, similarity_k, filename_type_filter
        )

    # ------------------------------------------------------------------
    # Fusion + rerank
    # ------------------------------------------------------------------

    def weighted_reciprocal_rank_fusion(
        self,
        ranked_lists: List[Tuple[List[str], str]],
        model_weights: Dict[str, float],
        k: int = 50,
    ) -> List[Tuple[str, float]]:
        """Host-side WRRF over section-id lists (API parity with
        src/search_engine.py:21-34; the hot path uses ops.fusion)."""
        scores: Dict[str, float] = {}
        for ranked_list, model_name in ranked_lists:
            weight = model_weights.get(model_name, 1.0)
            for rank, doc_id in enumerate(ranked_list, start=1):
                scores[doc_id] = scores.get(doc_id, 0.0) + weight / (k + rank)
        return sorted(scores.items(), key=lambda x: x[1], reverse=True)

    def rerank_documents(
        self,
        query_text: str,
        documents: List[Dict],
        reranker_model: str = "rerank-2",
        reranker_top_k: Optional[int] = None,
    ) -> List[Dict]:
        return apply_rerank(
            self.reranker, query_text, documents, reranker_model, reranker_top_k
        )

    # ------------------------------------------------------------------
    # Full pipeline (retrieve_documents semantics)
    # ------------------------------------------------------------------

    def retrieve(
        self,
        query_embeddings: Dict[str, np.ndarray],
        query_texts: Optional[Sequence[str]] = None,
        query_token_lists: Optional[Sequence[Sequence[str]]] = None,
        similarity_k: int = 25,
        common_sections_n: int = 15,
        wrrf_k: float = 60.0,
        model_weights: Optional[Dict[str, float]] = None,
        filename_type_filter: Optional[str] = None,
        use_hybrid_search: bool = False,
        use_reranker: bool = False,
        reranker_model: str = "rerank-2-lite",
        reranker_top_k: Optional[int] = 5,
        return_docs: bool = False,
        min_similarity: Optional[float] = None,
    ) -> List[List]:
        """Batched equivalent of the reference's ``retrieve_documents``
        (src/query_rag_retrieval.py:149-407). Returns, per query, a
        ranked list of section ids (or doc dicts with ``return_docs``).

        ``min_similarity`` drops dense candidates whose cosine score
        falls below the threshold before fusion (BASELINE config 4's
        similarity-threshold stage; the reference exposes no equivalent).
        """
        if model_weights is None:
            model_weights = Config.DEFAULT_MODEL_WEIGHTS.copy()
        if not query_embeddings:
            raise ValueError("Query embeddings dictionary cannot be empty")
        if similarity_k <= 0 or common_sections_n <= 0:
            raise ValueError(
                "similarity_k and common_sections_n must be positive integers"
            )

        batch = next(iter(query_embeddings.values()))
        b = np.atleast_2d(np.asarray(batch)).shape[0]

        active = [
            m
            for m in MODEL_ORDER
            if m in self.index.dense_model_names
            and model_weights.get(m, 0) > 0
            and m in query_embeddings
        ]

        ranked: List[Tuple[np.ndarray, str, Optional[np.ndarray]]] = []
        for m in active:
            vals, idx = self.similarity_search_batch(
                query_embeddings[m], m, similarity_k, filename_type_filter
            )
            if min_similarity is not None:
                idx = np.where(vals >= min_similarity, idx, -1)
            ranked.append((idx, m, vals))

        use_bm25 = (
            use_hybrid_search
            and self.index.bm25 is not None
            and model_weights.get("BM25", 0) > 0
        )
        if use_bm25:
            if query_token_lists is None and query_texts is not None:
                query_token_lists = [
                    preprocess_text(t, use_lemmatization=True)
                    for t in query_texts
                ]
            if query_token_lists is not None:
                _, bidx = self.bm25_search_preprocessed_batch(
                    query_token_lists, similarity_k, filename_type_filter
                )
                ranked.append((bidx, "BM25", None))
            else:
                logger.warning(
                    "BM25 search requested but no query_text or "
                    "query_tokens provided - skipping BM25"
                )

        if not ranked:
            return [[] for _ in range(b)]

        if len(ranked) > 1:
            all_idx = jnp.asarray(np.stack([r[0] for r in ranked]))
            w = jnp.asarray(
                [model_weights.get(r[1], 1.0) for r in ranked], jnp.float32
            )
            fvals, fids = wrrf_top_n(
                all_idx,
                w,
                min(common_sections_n, self.index.n_docs),
                self.index.n_docs_padded,
                float(wrrf_k),
            )
            fused_ids = np.where(
                np.isfinite(np.asarray(fvals)), np.asarray(fids), -1
            )
        else:
            fused_ids = ranked[0][0][:, :common_sections_n]

        # Host-side doc assembly: similarity comes from the first ranker
        # that surfaced the doc (reference first-stage-wins dedup,
        # src/query_rag_retrieval.py:242-248).
        out: List[List] = []
        for qi in range(b):
            sim_by_row: Dict[int, float] = {}
            for idx_arr, name, vals_arr in ranked:
                for j, row in enumerate(idx_arr[qi]):
                    row = int(row)
                    if row >= 0 and row not in sim_by_row:
                        sim_by_row[row] = (
                            float(vals_arr[qi][j]) if vals_arr is not None else 0.0
                        )
            docs = []
            for row in fused_ids[qi]:
                row = int(row)
                if row < 0:
                    continue
                d = self.index.meta.doc(row)
                d["similarity"] = sim_by_row.get(row, 0.0)
                docs.append(d)
            docs = docs[:common_sections_n]

            if use_reranker and len(docs) > 1 and query_texts is not None:
                docs = self.rerank_documents(
                    query_texts[qi], docs, reranker_model, reranker_top_k
                )
            out.append(
                docs if return_docs else [d["id"] for d in docs]
            )
        return out

    # ------------------------------------------------------------------

    def _rows_to_docs(self, rows: np.ndarray, scores: np.ndarray) -> List[Dict]:
        docs = []
        for row, s in zip(rows, scores):
            if int(row) < 0:
                continue
            d = self.index.meta.doc(int(row))
            d["similarity"] = float(s)
            docs.append(d)
        return docs
