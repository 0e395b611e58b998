"""Retrieval engine: the L3 layer (reference ``src/search_engine.py``).

``SearchEngine`` exposes the reference's per-method API (similarity
search, BM25 search, WRRF, rerank) over the array index, batched-first.
``FusedRetriever`` is the device fast path: one jitted function
running every active ranker + fusion + top-n in a single XLA program.
"""

from a_nice_rag_tpu.retrieval.engine import (  # noqa: F401
    SearchEngine,
    FusedRetriever,
)
from a_nice_rag_tpu.retrieval.embed import (  # noqa: F401
    Embedder,
    PrecomputedEmbedder,
    VoyageEmbedder,
    OpenAIEmbedder,
)
from a_nice_rag_tpu.retrieval.rerank import (  # noqa: F401
    Reranker,
    IdentityReranker,
    MultiModelReranker,
    VoyageReranker,
)
