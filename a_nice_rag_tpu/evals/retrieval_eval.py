"""Retrieval evaluation harness: the framework's regression gate.

Re-implements the reference benchmark (src/retrieval_eval.py) on device:
instead of building a ranked Python list per query and scanning for the
gold id (reference evaluate_query, :51-84), the rank of the gold chunk is
computed ON DEVICE for a whole query batch at once:

    rank(gold) = 1 + |{d : valid(d), score(d) > score(gold)}|

which is exact up to tie ordering (the reference's argpartition tie order
is itself arbitrary). Fusion configs materialize per-ranker rank arrays
and fuse with the WRRF scatter kernel before the same rank computation.

The 9 standard configurations, the seed-42 85/15 split convention (the
85% partition is evaluated, as in the reference, :273-274 + :338), the
CSV schema, and append-per-config resume semantics are all preserved.
"""

from __future__ import annotations

import dataclasses
import logging
import os
from functools import partial
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.evals.metrics import (
    CSV_HEADER,
    calculate_metrics,
    metrics_csv_row,
)
from a_nice_rag_tpu.index.array_index import ArrayIndex
from a_nice_rag_tpu.ops.bm25 import bm25_scores, bm25_scores_dense
from a_nice_rag_tpu.ops.dense import dense_scores
from a_nice_rag_tpu.ops.fusion import wrrf_scores
from a_nice_rag_tpu.ops.quantized import (
    QuantizedDense,
    quantize_queries,
    quantized_dense_scores,
)
from a_nice_rag_tpu.ops.topk import masked_top_k
from a_nice_rag_tpu.retrieval.engine import MODEL_ORDER, SearchEngine

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class EvalConfig:
    """One benchmark configuration (reference src/retrieval_eval.py:131-255)."""

    name: str
    model_weights: Dict[str, float]
    use_hybrid_search: bool
    similarity_k: int = 12000
    common_sections_n: int = 12000
    use_reranker: bool = False
    reranker_model: str = "rerank-2"
    reranker_top_k: Optional[int] = 10


def _w(voyage=0.0, v35=0.0, te3l=0.0, qwen=0.0, bm25=0.0):
    return {
        "voyage-3-large": voyage,
        "voyage-3.5": v35,
        "text-embedding-3-large": te3l,
        "Qwen3": qwen,
        "BM25": bm25,
    }


STANDARD_CONFIGURATIONS: List[EvalConfig] = [
    EvalConfig("Voyage-3-Large", _w(voyage=1.0), False),
    EvalConfig("Voyage-3.5", _w(v35=1.0), False),
    EvalConfig("Text-Embedding-3-Large", _w(te3l=1.0), False),
    EvalConfig("Qwen3-Embedding-0.6B", _w(qwen=1.0), False),
    EvalConfig("BM25", _w(bm25=1.0), True),
    EvalConfig("Voyage-3-Large + BM25", _w(voyage=5.0, bm25=1.0), True),
    EvalConfig(
        "Voyage-3-Large + Text-Embedding-3-Large",
        _w(voyage=2.0, te3l=1.0),
        False,
    ),
    EvalConfig(
        "Voyage-3-Large + BM25 (Reranker 2 Lite)",
        _w(voyage=5.0, bm25=1.0),
        True,
        similarity_k=25,
        common_sections_n=15,
        use_reranker=True,
        reranker_model="rerank-2-lite",
        reranker_top_k=10,
    ),
    EvalConfig(
        "Voyage-3-Large + BM25 (Reranker 2)",
        _w(voyage=5.0, bm25=1.0),
        True,
        similarity_k=25,
        common_sections_n=15,
        use_reranker=True,
        reranker_model="rerank-2",
        reranker_top_k=10,
    ),
]


@partial(jax.jit, static_argnames=())
def _rank_of_gold(scores, mask, gold_rows):
    """(found [B], rank [B]) for gold doc rows against score vectors."""
    gold_score = jnp.take_along_axis(scores, gold_rows[:, None], axis=1)
    valid = mask[None, :]
    better = jnp.sum(valid & (scores > gold_score), axis=1)
    found = mask[gold_rows] & jnp.isfinite(gold_score[:, 0])
    return found, (better + 1).astype(jnp.int32)


@partial(jax.jit, static_argnames=())
def _rank_of_gold_positive(scores, mask, gold_rows):
    """Fusion variant: a doc is in the ranking only if its fused score is
    positive (absent docs have score 0)."""
    gold_score = jnp.take_along_axis(scores, gold_rows[:, None], axis=1)
    valid = mask[None, :] & (scores > 0.0)
    better = jnp.sum(valid & (scores > gold_score), axis=1)
    found = mask[gold_rows] & (gold_score[:, 0] > 0.0)
    return found, (better + 1).astype(jnp.int32)


class RetrievalEvaluator:
    """Batched gold-rank evaluation over an ArrayIndex."""

    def __init__(self, index: ArrayIndex, engine: Optional[SearchEngine] = None,
                 batch_size: int = 512, bm25_budget: int = 65536):
        self.index = index
        self.engine = engine or SearchEngine(index)
        self.batch_size = batch_size
        self.bm25_budget = bm25_budget

    # ------------------------------------------------------------------

    def _ranker_scores(
        self,
        model: str,
        q_emb: Optional[np.ndarray],
        q_terms: Optional[np.ndarray],
    ) -> jax.Array:
        if model == "BM25":
            if self.index.bm25_dense is not None:
                return bm25_scores_dense(
                    self.index.bm25_dense, jnp.asarray(q_terms)
                )
            return bm25_scores(
                self.index.bm25, jnp.asarray(q_terms), self.bm25_budget
            )
        mat = self.index.dense_matrix(model)
        if isinstance(mat, QuantizedDense):
            qv, qs = quantize_queries(jnp.asarray(q_emb))
            return quantized_dense_scores(mat, qv, qs)
        return dense_scores(mat, jnp.asarray(q_emb))

    def evaluate_config(
        self,
        config: EvalConfig,
        query_embeddings: Dict[str, np.ndarray],
        gold_ids: Sequence[str],
        query_token_lists: Optional[Sequence[Sequence[str]]] = None,
        query_texts: Optional[Sequence[str]] = None,
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
    ) -> Dict[str, float]:
        """Gold-rank metrics for one configuration over all queries."""
        meta = self.index.meta
        gold_rows_all = np.array(
            [meta.id_to_row.get(g, -1) for g in gold_ids], dtype=np.int32
        )
        n_q = len(gold_ids)

        active = [
            m
            for m in MODEL_ORDER
            if config.model_weights.get(m, 0) > 0
            and m in self.index.dense_model_names
            and m in query_embeddings
        ]
        use_bm25 = (
            config.use_hybrid_search
            and config.model_weights.get("BM25", 0) > 0
            and self.index.bm25 is not None
            and query_token_lists is not None
        )
        rankers = list(active) + (["BM25"] if use_bm25 else [])
        if not rankers:
            raise ValueError(f"No active rankers for config {config.name}")

        if config.use_reranker:
            return self._evaluate_with_reranker(
                config, query_embeddings, gold_ids, query_token_lists,
                query_texts, filename_type_filter, wrrf_k,
            )

        mask_np = meta.filter_mask(filename_type_filter)
        terms_all = (
            self.index.pad_term_ids(query_token_lists, 32) if use_bm25 else None
        )

        found_all, rank_all = [], []
        bs = self.batch_size
        for start in range(0, n_q, bs):
            sl = slice(start, min(start + bs, n_q))
            gold_rows = jnp.asarray(np.where(
                gold_rows_all[sl] >= 0, gold_rows_all[sl], 0
            ))
            gold_missing = gold_rows_all[sl] < 0
            scores_list = []
            for m in rankers:
                q_emb = query_embeddings.get(m)
                s = self._ranker_scores(
                    m,
                    None if q_emb is None else q_emb[sl],
                    None if terms_all is None else terms_all[sl],
                )
                if m == "BM25" and self.index.bm25_doc_mask is not None:
                    bm = jnp.asarray(mask_np & self.index.bm25_doc_mask)
                else:
                    bm = jnp.asarray(mask_np)
                scores_list.append((s, bm, m))

            if len(scores_list) == 1:
                s, m_arr, _ = scores_list[0]
                s = jnp.where(m_arr[None, :], s, -jnp.inf)
                found, rank = _rank_of_gold(s, m_arr, gold_rows)
            else:
                k = min(config.similarity_k, self.index.n_docs)
                idx_lists, weights = [], []
                for s, m_arr, m in scores_list:
                    s = jnp.where(m_arr[None, :], s, -jnp.inf)
                    vals, idx = masked_top_k(s, k)
                    idx_lists.append(jnp.where(jnp.isfinite(vals), idx, -1))
                    weights.append(config.model_weights.get(m, 1.0))
                fused = wrrf_scores(
                    jnp.stack(idx_lists),
                    jnp.asarray(weights, jnp.float32),
                    self.index.n_docs_padded,
                    wrrf_k,
                )
                found, rank = _rank_of_gold_positive(
                    fused, jnp.asarray(mask_np), gold_rows
                )
            found = np.asarray(found) & ~gold_missing
            rank = np.asarray(rank)
            # Cap by common_sections_n: the reference only scans the
            # first common_sections_n entries of the fused list.
            within = rank <= config.common_sections_n
            found = found & within
            found_all.append(found)
            rank_all.append(np.where(found, rank, -1))

        ranks = np.concatenate(rank_all)
        founds = np.concatenate(found_all)
        return calculate_metrics(ranks, founds)

    # ------------------------------------------------------------------

    def _evaluate_with_reranker(
        self,
        config: EvalConfig,
        query_embeddings: Dict[str, np.ndarray],
        gold_ids: Sequence[str],
        query_token_lists,
        query_texts,
        filename_type_filter,
        wrrf_k: float,
    ) -> Dict[str, float]:
        """Small-k path through the full engine incl. rerank stage."""
        n_q = len(gold_ids)
        ranks = np.full(n_q, -1, dtype=np.int64)
        bs = self.batch_size
        for start in range(0, n_q, bs):
            sl = slice(start, min(start + bs, n_q))
            got = self.engine.retrieve(
                query_embeddings={
                    m: v[sl] for m, v in query_embeddings.items()
                },
                query_texts=None if query_texts is None else query_texts[sl],
                query_token_lists=(
                    None if query_token_lists is None else query_token_lists[sl]
                ),
                similarity_k=config.similarity_k,
                common_sections_n=config.common_sections_n,
                wrrf_k=wrrf_k,
                model_weights=config.model_weights,
                filename_type_filter=filename_type_filter,
                use_hybrid_search=config.use_hybrid_search,
                use_reranker=config.use_reranker,
                reranker_model=config.reranker_model,
                reranker_top_k=config.reranker_top_k,
            )
            for i, ids in enumerate(got):
                gold = gold_ids[start + i]
                if gold in ids:
                    ranks[start + i] = ids.index(gold) + 1
        return calculate_metrics(ranks)

    # ------------------------------------------------------------------

    def run(
        self,
        configurations: Sequence[EvalConfig],
        query_embeddings: Dict[str, np.ndarray],
        gold_ids: Sequence[str],
        query_token_lists: Optional[Sequence[Sequence[str]]] = None,
        query_texts: Optional[Sequence[str]] = None,
        filename_type_filter: Optional[str] = "CG,NG",
        wrrf_k: float = 40.0,
        output_csv: Optional[str] = None,
    ) -> Dict[str, Dict[str, float]]:
        """Run configurations, appending each result row to the CSV as it
        lands (interrupted sweeps resume by re-running; completed configs
        already present in the CSV are skipped)."""
        done = set()
        if output_csv and os.path.exists(output_csv):
            with open(output_csv) as f:
                done = {line.split(",")[0] for line in f.readlines()[1:]}
        elif output_csv:
            os.makedirs(os.path.dirname(output_csv) or ".", exist_ok=True)
            with open(output_csv, "w") as f:
                f.write(CSV_HEADER + "\n")

        results = {}
        for config in configurations:
            if config.name in done:
                logger.info("Skipping %s (already in CSV)", config.name)
                continue
            logger.info("Evaluating: %s", config.name)
            try:
                m = self.evaluate_config(
                    config,
                    query_embeddings,
                    gold_ids,
                    query_token_lists=query_token_lists,
                    query_texts=query_texts,
                    filename_type_filter=filename_type_filter,
                    wrrf_k=wrrf_k,
                )
            except ValueError as e:
                # Configs whose embedding models/tokens are unavailable
                # skip instead of aborting the sweep (the append/resume
                # CSV contract keeps completed configs).
                logger.warning("Skipping %s: %s", config.name, e)
                continue
            results[config.name] = m
            logger.info(
                "%s: MRR=%.3f R@10=%.3f", config.name, m["mrr"], m["recall@10"]
            )
            if output_csv:
                with open(output_csv, "a") as f:
                    f.write(metrics_csv_row(config.name, m) + "\n")
        return results


def seed42_split(n: int, test_size: float = 0.15) -> Tuple[np.ndarray, np.ndarray]:
    """The reference's train_test_split(range(n), test_size=0.15,
    random_state=42, shuffle=True) — the larger partition is what gets
    evaluated (src/retrieval_eval.py:273-274, :338)."""
    try:
        from sklearn.model_selection import train_test_split

        train_idx, val_idx = train_test_split(
            range(n), test_size=test_size, random_state=42, shuffle=True
        )
        return np.asarray(train_idx), np.asarray(val_idx)
    except ImportError:
        rng = np.random.RandomState(42)
        perm = rng.permutation(n)
        n_test = int(np.ceil(n * test_size))
        return perm[n_test:], perm[:n_test]
