"""Device compute ops for the retrieval core.

Everything here is functional, jit-safe (static shapes, no data-dependent
Python control flow) and batched over queries. These ops replace the
reference's NumPy hot loops (``src/search_engine.py:80-92`` dense scoring,
``rank_bm25`` scoring at ``src/search_engine.py:219``, and the dict-based
reciprocal-rank fusion at ``src/search_engine.py:21-34``).
"""

from a_nice_rag_tpu.ops.topk import (  # noqa: F401
    masked_top_k,
    hierarchical_top_k,
    merge_top_k,
)
from a_nice_rag_tpu.ops.dense import dense_scores, dense_top_k  # noqa: F401
from a_nice_rag_tpu.ops.bm25 import (  # noqa: F401
    Bm25Arrays,
    bm25_scores,
    bm25_top_k,
)
from a_nice_rag_tpu.ops.fusion import (  # noqa: F401
    wrrf_scores,
    wrrf_top_n,
    wrrf_top_n_sparse,
)
