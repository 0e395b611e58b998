"""a_nice_rag_tpu — a retrieval-augmented-generation framework in JAX.

Re-design of the capabilities of the A-NICE-RAG reference system
(retrieval over NICE clinical guidelines) for accelerators:

* the SQLite vector store / pickled BM25 index become a single device-resident
  :class:`~a_nice_rag_tpu.index.ArrayIndex` (dense embedding matrix + CSR
  "eager impact" BM25 arrays),
* cosine top-k, BM25 Okapi scoring and weighted reciprocal-rank fusion run
  as jitted XLA / Pallas kernels (``a_nice_rag_tpu.ops``),
* corpora scale across chips by sharding the document axis over a
  ``jax.sharding.Mesh`` with an ICI all-gather top-k merge
  (``a_nice_rag_tpu.parallel``),
* RAG orchestration, ingestion, serving, and an LLM-judged evaluation
  framework mirror the reference's behavioral surface.

Reference parity targets are documented in SURVEY.md / BASELINE.md.
"""

__version__ = "0.1.0"

from a_nice_rag_tpu.config import Config, InfoSource, SourceConfig  # noqa: F401
