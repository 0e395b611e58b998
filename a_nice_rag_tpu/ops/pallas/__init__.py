"""Pallas kernels for the retrieval hot path (Triton route, Hopper)."""

from a_nice_rag_tpu.ops.pallas.stream_topk import (  # noqa: F401
    merge_candidates,
    stream_top_k,
)
