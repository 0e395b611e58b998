"""Top-k primitives.

The reference selects top-k with ``np.argpartition`` + descending
``argsort`` (``src/search_engine.py:84-85``). In JAX the equivalent is
``jax.lax.top_k``; for large document axes we use a two-stage hierarchical
top-k so XLA never has to sort the full score vector: per-tile top-k
(parallel over tiles, VPU-friendly) followed by a top-k over the small
candidate set. ``merge_top_k`` is the k-way merge used to combine
per-shard results after an ICI all-gather (SURVEY.md §7 stage 5).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

NEG_INF = float("-inf")


def masked_top_k(
    scores: jax.Array,
    k: int,
    mask: Optional[jax.Array] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k along the last axis, with invalid entries masked to -inf.

    Returns (values, indices), values descending. ``mask`` broadcasts
    against ``scores`` (True = keep). Slots whose value is -inf (masked
    out, or k exceeding the valid count) report index -1 — the same
    contract as the Pallas streaming kernel, and what WRRF fusion's
    ``indices >= 0`` validity test expects (a phantom id for a -inf slot
    would otherwise leak into fused rankings).
    """
    if mask is not None:
        scores = jnp.where(mask, scores, NEG_INF)
    vals, idx = jax.lax.top_k(scores, k)
    return vals, jnp.where(jnp.isneginf(vals), -1, idx)


@partial(jax.jit, static_argnames=("k", "tile"))
def hierarchical_top_k(
    scores: jax.Array,
    k: int,
    tile: int = 1024,
) -> Tuple[jax.Array, jax.Array]:
    """Two-stage top-k along the last axis for large N.

    Stage 1: reshape [..., N] -> [..., N/tile, tile] and take top-min(k,tile)
    per tile. Stage 2: top-k over the [..., (N/tile)*kt] candidates.
    N must be divisible by ``tile`` (pad scores with -inf first if needed).
    """
    *lead, n = scores.shape
    if n <= tile:
        return jax.lax.top_k(scores, k)
    assert n % tile == 0, f"N={n} must be a multiple of tile={tile}"
    kt = min(k, tile)
    tiles = scores.reshape(*lead, n // tile, tile)
    tvals, tidx = jax.lax.top_k(tiles, kt)  # [..., n/tile, kt]
    base = (jnp.arange(n // tile, dtype=tidx.dtype) * tile)[..., None]
    gidx = (tidx + base).reshape(*lead, -1)
    cand = tvals.reshape(*lead, -1)
    vals, ci = jax.lax.top_k(cand, k)
    idx = jnp.take_along_axis(gidx, ci, axis=-1)
    return vals, jnp.where(jnp.isneginf(vals), -1, idx)


def merge_top_k(
    values: jax.Array,
    indices: jax.Array,
    k: int,
) -> Tuple[jax.Array, jax.Array]:
    """Merge S per-shard top-k lists into one global top-k.

    values/indices: [..., S, k_local] where indices are already global
    document ids. Returns ([..., k], [..., k]).
    """
    *lead, s, kl = values.shape
    flat_v = values.reshape(*lead, s * kl)
    flat_i = indices.reshape(*lead, s * kl)
    vals, ci = jax.lax.top_k(flat_v, k)
    idx = jnp.take_along_axis(flat_i, ci, axis=-1)
    return vals, jnp.where(jnp.isneginf(vals), -1, idx)


@jax.jit
def dedup_ranked(
    values: jax.Array, ids: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Deduplicate a descending-ranked (values, ids) top-k list per row.

    A spilled IVF layout stores some documents in two clusters, so a
    probe covering both returns the same id twice (identical scores).
    Keep the best-scoring slot per id, demote later duplicates to
    (-inf, -1), and re-compact so real entries stay a dense descending
    prefix. -1 ids (unfilled slots) are never merged with each other.

    values/ids: [..., k]. Pure XLA (three variadic sorts over the k
    axis) — cheap at serving k. Equal-score ties between DISTINCT ids
    may reorder relative to the input (sort by id breaks ties by id).
    """
    big = jnp.int32(2**30)
    key_id = jnp.where(ids < 0, big, ids)
    # Pass 1: group by id (ascending), best score first within a group.
    sid, sval = jax.lax.sort(
        (key_id, -values), dimension=-1, num_keys=2, is_stable=True
    )
    first = jnp.concatenate(
        [
            jnp.ones_like(sid[..., :1], jnp.bool_),
            sid[..., 1:] != sid[..., :-1],
        ],
        axis=-1,
    ) & (sid < big)
    nval = jnp.where(first, -sval, -jnp.inf)
    nid = jnp.where(first, sid, -1)
    # Pass 2: back to descending-score order, survivors first.
    fval, fid = jax.lax.sort(
        (-nval, nid), dimension=-1, num_keys=1, is_stable=True
    )
    return -fval, fid
