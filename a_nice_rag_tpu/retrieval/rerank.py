"""Cross-encoder reranking stage.

The reference reranks fused candidates through the VoyageAI rerank API
(``src/search_engine.py:161-203``), attaching a ``rerank_score`` and
falling back to the original order on any failure. The stage is a
protocol here so deployments can choose:

* ``VoyageReranker`` — the same external cross-encoder over REST,
* ``IdentityReranker`` — no-op (offline/eval),
* the on-device cross-encoder in ``a_nice_rag_tpu.models`` (fully local).
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional, Protocol

from a_nice_rag_tpu.retrieval.embed import _post_json

logger = logging.getLogger(__name__)


class Reranker(Protocol):
    def rerank(
        self,
        query_text: str,
        documents: List[Dict],
        model: str,
        top_k: Optional[int],
    ) -> List[Dict]:
        ...


class IdentityReranker:
    """Pass-through (keeps fused order), truncating to top_k."""

    def rerank(self, query_text, documents, model="identity", top_k=None):
        return documents[:top_k] if top_k else documents


class VoyageReranker:
    """VoyageAI rerank-2 / rerank-2-lite over REST. Requires VOYAGE_API_KEY."""

    def __init__(self, api_key: Optional[str] = None):
        self.api_key = api_key or os.getenv("VOYAGE_API_KEY")
        if not self.api_key:
            raise ValueError("VOYAGE_API_KEY not set")

    def rerank(self, query_text, documents, model="rerank-2", top_k=None):
        texts = [d.get("document", "") for d in documents]
        out = _post_json(
            "https://api.voyageai.com/v1/rerank",
            {
                "query": query_text,
                "documents": texts,
                "model": model,
                "top_k": top_k or len(texts),
                "truncation": True,
            },
            {"Authorization": f"Bearer {self.api_key}"},
        )
        results = out.get("data") or out.get("results") or []
        reranked = []
        for r in results:
            i = r.get("index")
            if i is not None and i < len(documents):
                reranked.append(
                    {**documents[i], "rerank_score": r.get("relevance_score")}
                )
        return reranked


class MultiModelReranker:
    """Dispatch on the ``model`` argument to per-tier rerankers.

    The reference's rerank hop is one API with a quality-tier model
    parameter (rerank-2 vs rerank-2-lite,
    src/search_engine.py:161-203); locally each tier is its own
    trained cross-encoder (models/rerank_train.py at different
    capacities), so the tiers measurably separate the way the
    reference's do (results/retrieval_evaluation_results.csv rows
    9-10: R@1 0.810 vs 0.779)."""

    def __init__(self, rerankers: Dict[str, Reranker],
                 default: Optional[str] = None):
        if not rerankers:
            raise ValueError("rerankers must be non-empty")
        self.rerankers = dict(rerankers)
        self.default = default or next(iter(rerankers))
        if self.default not in self.rerankers:
            raise ValueError(f"default {self.default!r} not among "
                             f"{sorted(self.rerankers)}")

    def rerank(self, query_text, documents, model="rerank-2",
               top_k=None):
        r = self.rerankers.get(model) or self.rerankers[self.default]
        return r.rerank(query_text, documents, model, top_k)


def apply_rerank(
    reranker: Optional[Reranker],
    query_text: str,
    documents: List[Dict],
    model: str,
    top_k: Optional[int],
) -> List[Dict]:
    """Rerank with the reference's graceful-degradation contract:
    any failure returns the documents in their original order."""
    if reranker is None or not documents:
        return documents
    try:
        return reranker.rerank(query_text, documents, model, top_k)
    except Exception as e:  # noqa: BLE001 — deliberate fallback contract
        logger.warning("Reranking failed, returning original order: %s", e)
        return documents
