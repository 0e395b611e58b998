"""Central configuration.

Mirrors the knob surface of the reference (``src/config.py:7-59``): the
``InfoSource`` enum, per-source artifact paths, default fusion weights, and
the context/not-found strings used by the RAG prompt. Extends it with
device execution settings (dtype policy, padding, sharding axes).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, Optional


class InfoSource(enum.Enum):
    NICE = "nice"


@dataclasses.dataclass
class SourceConfig:
    """Per-source artifact locations and prompt strings.

    ``index_path`` points at the framework's native array-index artifact
    directory (see :mod:`a_nice_rag_tpu.index.io`). The reference-format
    paths (SQLite chunk DBs per embedding model + BM25 pickle,
    reference ``src/config.py:38-49``) are kept so reference artifacts can
    be imported directly.
    """

    index_path: str
    context_description: str
    not_found_message: str
    # Reference-format import paths (optional).
    db_path: Optional[str] = None
    bm25_path: Optional[str] = None
    voyage_db_path: Optional[str] = None
    voyage_3_5_db_path: Optional[str] = None
    openai_db_path: Optional[str] = None
    qwen_db_path: Optional[str] = None

    def __post_init__(self) -> None:
        if self.voyage_db_path is None:
            self.voyage_db_path = self.db_path


@dataclasses.dataclass
class DeviceConfig:
    """Device execution policy.

    * ``score_dtype``: dtype of the dense scoring matmul accumulator.
    * ``emb_dtype``: storage dtype of the device-resident embedding
      matrix. float32 keeps exact ranking parity with the NumPy
      reference; bfloat16 halves device-memory traffic for large corpora.
    * ``doc_pad``: document-axis padding multiple.
    * ``bm25_postings_budget``: static flattened-postings budget per query
      for the jitted BM25 gather/scatter kernel (see ops/bm25.py).
    """

    emb_dtype: str = "float32"
    score_dtype: str = "float32"
    doc_pad: int = 128
    bm25_postings_budget: int = 16384
    corpus_axis: str = "corpus"
    data_axis: str = "dp"


class Config:
    """Global defaults, mirroring reference ``src/config.py:30-49``."""

    # Default fusion weights (reference src/config.py:30-36).
    DEFAULT_MODEL_WEIGHTS: Dict[str, float] = {
        "voyage-3-large": 5.0,
        "text-embedding-3-large": 0.0,
        "voyage-3.5": 0.0,
        "Qwen3": 0.0,
        "BM25": 1.0,
    }

    # Default retrieval knobs (reference src/query_rag.py:263-277).
    DEFAULT_SIMILARITY_K: int = 25
    DEFAULT_COMMON_SECTIONS_N: int = 15
    DEFAULT_WRRF_K: int = 40
    DEFAULT_RERANKER_MODEL: str = "rerank-2"
    DEFAULT_RERANKER_TOP_K: int = 10

    # BM25 index parameters (reference src/processing/bm25_search.py:134-139).
    BM25_K1: float = 1.7
    BM25_B: float = 0.83
    BM25_EPSILON: float = 0.05

    DEVICE = DeviceConfig()

    SOURCE_CONFIGS: Dict[InfoSource, SourceConfig] = {
        InfoSource.NICE: SourceConfig(
            index_path="artifacts/nice_index",
            context_description="NICE guidelines",
            not_found_message="no relevant NICE guidelines were found",
            db_path="databases/voyage_3_large_nice_guidelines_2048.db",
            bm25_path="databases/bm25_index_nice_guidelines.pkl",
            voyage_db_path="databases/voyage_3_large_nice_guidelines_2048.db",
            voyage_3_5_db_path="databases/voyage_3.5_nice_guidelines_2048.db",
            openai_db_path="databases/text_embedding_3_large_nice_guidelines.db",
            qwen_db_path="databases/Qwen3-Embedding-0.6B_nice_guidelines.db",
        )
    }

    @classmethod
    def get_source_config(cls, source: str) -> SourceConfig:
        try:
            source_enum = InfoSource(source.lower())
        except ValueError:
            raise ValueError(
                f"Unknown source: {source}. "
                f"Valid sources: {[s.value for s in InfoSource]}"
            )
        return cls.SOURCE_CONFIGS[source_enum]
