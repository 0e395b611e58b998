"""Test utilities: golden reference algorithms and synthetic corpora."""

from a_nice_rag_tpu.testing.golden import (  # noqa: F401
    GoldenBm25Okapi,
    golden_dense_top_k,
    golden_top_k,
    golden_wrrf,
)
from a_nice_rag_tpu.testing.synth import (  # noqa: F401
    REFERENCE_QUALITY_NOISE,
    add_hard_distractors,
    calibrated_quality_corpus,
    calibrated_sample_queries,
    sample_queries,
    synth_corpus,
)
from a_nice_rag_tpu.testing.timing import chained_dispatch_ms  # noqa: F401,E501
