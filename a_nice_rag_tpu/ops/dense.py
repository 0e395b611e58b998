"""Dense (cosine) retrieval scoring.

Replaces the reference hot loop ``np.dot(q, E.T)`` + argpartition top-k
(``src/search_engine.py:80-92`` / ``:128-138``). Embeddings are
unit-normalized at index build time (the reference relies on Voyage
returning unit-norm vectors), so the dot product IS the cosine similarity.

The scoring matmul is [B, D] x [D, N] with a float32 accumulator.
Embeddings may be stored bfloat16 to halve device-memory traffic; f32
matrices are contracted at ``Precision.HIGHEST`` so an f32 index is
ranked in f32, not TF32.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.ops.topk import hierarchical_top_k, masked_top_k

# Above this document count, avoid a full sort and use the two-stage top-k.
_HIERARCHICAL_THRESHOLD = 16384


def dense_scores(
    emb: jax.Array,
    queries: jax.Array,
    score_dtype: jnp.dtype = jnp.float32,
) -> jax.Array:
    """Similarity scores [B, N] = queries [B, D] @ emb [N, D]^T.

    The queries are rounded to the index's dtype first, as on the
    streaming routes (``ops.streaming``), so every route scores one
    index at one precision: an f32 index at ``Precision.HIGHEST`` (IEEE
    f32, never TF32), a bf16 index as bf16 x bf16 with f32 accumulation.
    """
    return jax.lax.dot_general(
        queries.astype(emb.dtype),
        emb,
        dimension_numbers=(((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST
        if emb.dtype == jnp.float32 else None,
        preferred_element_type=score_dtype,
    )


@partial(jax.jit, static_argnames=("k", "score_dtype"))
def dense_top_k(
    emb: jax.Array,
    queries: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    score_dtype: jnp.dtype = jnp.float32,
) -> Tuple[jax.Array, jax.Array]:
    """Fused dense scoring + masked top-k (XLA path).

    emb: [N, D] (unit-norm), queries: [B, D], mask: optional [N] bool
    (True = candidate; padding rows and filename-type filtering are
    expressed through this mask). Returns (values [B, k], indices [B, k]).
    """
    scores = dense_scores(emb, queries, score_dtype)
    if mask is not None:
        scores = jnp.where(mask[None, :], scores, -jnp.inf)
    n = scores.shape[-1]
    if n > _HIERARCHICAL_THRESHOLD and n % 1024 == 0:
        return hierarchical_top_k(scores, k)
    return masked_top_k(scores, k)


def dense_top_k_auto(
    emb: jax.Array,
    queries: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
    backend: str = "auto",
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Dense top-k by the route :func:`ops.streaming.choose_route`
    picks: streaming (never [B, N] scores) for large corpora on the GPU,
    the XLA path above otherwise."""
    from a_nice_rag_tpu.ops.streaming import choose_route, dense_stream_top_k

    route = choose_route(emb.shape[0], k, backend, interpret=interpret)
    if route.stream:
        return dense_stream_top_k(emb, queries, k, route, mask=mask)
    return dense_top_k(emb, queries, k, mask=mask)
