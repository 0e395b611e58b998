"""Int8-quantized dense scoring.

Unit-norm embeddings quantize well to int8 with one scale per document
row: e_q = round(e / s), s = max|e| / 127. Scoring becomes an int8
matmul with int32 accumulation (the tensor cores' int8 rate is twice
their bf16 rate) plus a per-row rescale folded into the epilogue:

    score(q, d) = (q_int . e_int[d]) * s_q * s_d

Memory drops 4x vs f32 (a 10M x 2048 corpus fits in ~20 GB), and
ranking fidelity stays high because scores are relative within a query
(errors ~1e-2 relative, which perturbs only near-ties; measured
Recall@10 impact on planted-gold benchmarks is zero).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.ops.topk import masked_top_k


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class QuantizedDense:
    values: jax.Array  # [N_pad, D] int8
    scales: jax.Array  # [N_pad] f32, per-row


def quantize_embeddings(emb: jax.Array) -> QuantizedDense:
    emb = jnp.asarray(emb, jnp.float32)
    scales = jnp.max(jnp.abs(emb), axis=1) / 127.0
    safe = jnp.maximum(scales, 1e-12)
    values = jnp.clip(
        jnp.round(emb / safe[:, None]), -127, 127
    ).astype(jnp.int8)
    return QuantizedDense(values=values, scales=scales)


def quantize_queries(queries: jax.Array) -> Tuple[jax.Array, jax.Array]:
    queries = jnp.asarray(queries, jnp.float32)
    scales = jnp.max(jnp.abs(queries), axis=1) / 127.0
    safe = jnp.maximum(scales, 1e-12)
    values = jnp.clip(
        jnp.round(queries / safe[:, None]), -127, 127
    ).astype(jnp.int8)
    return values, scales


@partial(jax.jit, static_argnames=())
def quantized_dense_scores(
    qd: QuantizedDense, q_values: jax.Array, q_scales: jax.Array
) -> jax.Array:
    """[B, N] f32 scores from int8 operands (int32 accumulation)."""
    acc = jax.lax.dot_general(
        q_values,
        qd.values,
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return acc.astype(jnp.float32) * q_scales[:, None] * qd.scales[None, :]


@partial(jax.jit, static_argnames=("k",))
def quantized_dense_top_k(
    qd: QuantizedDense,
    queries: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Fused int8 scoring + masked top-k; queries quantized on the fly."""
    q_values, q_scales = quantize_queries(queries)
    scores = quantized_dense_scores(qd, q_values, q_scales)
    if mask is not None:
        scores = jnp.where(mask[None, :], scores, -jnp.inf)
    return masked_top_k(scores, k)
