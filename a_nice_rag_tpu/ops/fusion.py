"""Weighted reciprocal-rank fusion (WRRF) on rank arrays.

Replaces the dict-accumulation loop of the reference
(``src/search_engine.py:21-34``): for each ranked list m with weight w_m,

    fused[doc] += w_m * 1 / (k + rank)      (rank 1-based)

expressed as a scatter-add over the padded document axis so fusion runs
inside the same jit as the per-model top-k kernels. Documents in no list
keep score -inf so they can never enter the fused top-n (the reference
only ranks union members).

Tie-breaking note: the reference sorts a Python dict (stable by first-touch
order); the array version breaks ties by document index. RRF score ties
across different documents are rare and do not affect Recall@k/MRR parity
on realistic data.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.ops.topk import masked_top_k


@partial(jax.jit, static_argnames=("n_docs_padded",))
def wrrf_scores(
    indices: jax.Array,
    weights: jax.Array,
    n_docs_padded: int,
    k_rrf: float = 40.0,
) -> jax.Array:
    """Fused WRRF scores.

    indices: [L, B, K] global document ids per ranked list (descending
             rank order), -1 = padding (shorter lists).
    weights: [L] per-list fusion weights.
    Returns [B, N_pad] fused scores; documents absent from every list
    get 0 (mask them out with ``wrrf_top_n``).
    """
    l, b, k = indices.shape
    ranks = jnp.arange(1, k + 1, dtype=jnp.float32)  # [K]
    contrib = weights[:, None] / (k_rrf + ranks)[None, :]  # [L, K]
    contrib = jnp.broadcast_to(contrib[:, None, :], (l, b, k))
    valid = indices >= 0
    ids = jnp.where(valid, indices, n_docs_padded)  # dump row for padding
    contrib = jnp.where(valid, contrib, 0.0)

    def per_query(ids_q: jax.Array, c_q: jax.Array) -> jax.Array:
        s = jnp.zeros(n_docs_padded + 1, dtype=jnp.float32)
        s = s.at[ids_q.reshape(-1)].add(c_q.reshape(-1))
        return s[:n_docs_padded]

    # [L, B, K] -> [B, L, K] so we vmap over queries.
    return jax.vmap(per_query)(
        jnp.swapaxes(ids, 0, 1), jnp.swapaxes(contrib, 0, 1)
    )


@partial(jax.jit, static_argnames=("n",))
def wrrf_top_n_sparse(
    indices: jax.Array,
    weights: jax.Array,
    n: int,
    k_rrf: float = 40.0,
) -> Tuple[jax.Array, jax.Array]:
    """WRRF fusion + top-n without an N-sized accumulator.

    Identical math to :func:`wrrf_top_n`, but cost is O(L*K log L*K) per
    query instead of O(N): sort the L*K (doc id, contribution) pairs by
    id, segment-sum contributions of equal ids, and take the top-n group
    totals. This is the form used at sharded scale (N in the millions),
    where scattering into [B, N] would dominate device-memory traffic.

    indices: [L, B, K] global doc ids (-1 = padding). Returns
    (scores [B, n], ids [B, n]) with -inf/-1 marking absent entries.
    """
    l, b, k = indices.shape
    ranks = jnp.arange(1, k + 1, dtype=jnp.float32)
    contrib = weights[:, None] / (k_rrf + ranks)[None, :]  # [L, K]
    contrib = jnp.broadcast_to(contrib[:, None, :], (l, b, k))
    valid = indices >= 0
    big = jnp.iinfo(jnp.int32).max
    ids = jnp.where(valid, indices, big)  # padding sorts last
    contrib = jnp.where(valid, contrib, 0.0)

    flat_ids = jnp.swapaxes(ids, 0, 1).reshape(b, l * k)
    flat_c = jnp.swapaxes(contrib, 0, 1).reshape(b, l * k)

    def per_query(ids_q: jax.Array, c_q: jax.Array):
        # Variadic sort: values ride along with the id keys in one sort
        # (instead of an argsort and gathers, see ops/bm25).
        s_ids, s_c = jax.lax.sort((ids_q, c_q), dimension=-1, num_keys=1)
        first = jnp.concatenate(
            [jnp.ones((1,), bool), s_ids[1:] != s_ids[:-1]]
        )
        seg = jnp.cumsum(first) - 1
        totals = jax.ops.segment_sum(s_c, seg, num_segments=l * k)
        score = jnp.where(first & (s_ids != big), totals[seg], -jnp.inf)
        top_s, pos = jax.lax.top_k(score, n)
        top_ids = jnp.where(jnp.isfinite(top_s), s_ids[pos], -1)
        return top_s, top_ids

    return jax.vmap(per_query)(flat_ids, flat_c)


@partial(jax.jit, static_argnames=("n", "n_docs_padded"))
def wrrf_top_n(
    indices: jax.Array,
    weights: jax.Array,
    n: int,
    n_docs_padded: int,
    k_rrf: float = 40.0,
    mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """WRRF fusion + top-n. Returns (scores [B, n], doc ids [B, n]).

    Entries with fused score 0 (document in no list) are masked to -inf;
    callers should treat returned ids with value == -inf as absent.
    """
    scores = wrrf_scores(indices, weights, n_docs_padded, k_rrf)
    live = scores > 0.0
    if mask is not None:
        live = live & mask[None, :]
    scores = jnp.where(live, scores, -jnp.inf)
    return masked_top_k(scores, n)
