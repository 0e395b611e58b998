"""Streaming dense top-k: the route choice and the plain blocked form.

A streaming top-k never holds the ``[B, N]`` score matrix. It matters
once that matrix outgrows the corpus itself: at 10.5M x 1024 int8 and
B=256 the scores are 10.7 GB against a 10.7 GB corpus.

:func:`choose_route` is the one place that decides, from the platform
and the shape, whether a call streams and whether it streams through the
Pallas kernel (:mod:`ops.pallas.stream_topk`) or the plain blocked form
here (:func:`blocked_top_k`: per doc chunk a matmul and ``top_k``, then
one exact merge). The retrievers and :func:`ops.dense.dense_top_k_auto`
call it; nothing else looks at the platform.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from a_nice_rag_tpu.ops.pallas.stream_topk import (
    MAX_K,
    merge_candidates,
    stream_top_k,
)
from a_nice_rag_tpu.ops.quantized import QuantizedDense, quantize_queries

# Doc count from which "auto" streams on the GPU. Not calibrated on the
# H100: the score matrix's bytes pass the corpus's there at any D <= 512
# for B >= 128, which is where the serving batches sit.
STREAM_THRESHOLD = 1 << 19

# Bytes of f32 scores one step of the blocked form may hold.
_CHUNK_BYTES = 1 << 28


class Route(NamedTuple):
    stream: bool  # never materialize [B, N] scores
    kernel: bool  # the Pallas kernel (else the plain blocked form)
    interpret: bool = False  # run the kernel in the Pallas interpreter


def choose_route(
    n_docs: int,
    k: int,
    backend: str = "auto",
    platform: Optional[str] = None,
    interpret: bool = False,
) -> Route:
    """Route of a dense top-k over ``n_docs`` documents.

    backend: "auto" streams on the GPU from :data:`STREAM_THRESHOLD`
    docs and materializes elsewhere; "xla" always materializes; "stream"
    always streams. A streaming call takes the kernel on the GPU (k up
    to :data:`ops.pallas.stream_topk.MAX_K`), or anywhere when the caller
    passes ``interpret=True``; otherwise the plain blocked form.
    """
    if backend not in ("auto", "xla", "stream"):
        raise ValueError(
            f"dense backend must be auto, xla or stream, got {backend!r}"
        )
    platform = platform or jax.default_backend()
    if backend == "auto":
        stream = platform == "gpu" and n_docs >= STREAM_THRESHOLD
    else:
        stream = backend == "stream"
    kernel = stream and k <= MAX_K and (platform == "gpu" or interpret)
    return Route(stream, kernel, kernel and interpret)


def _chunk_scores(rows, scales, q, qs):
    """f32 scores [B, R] of one chunk: bf16/int8 products accumulate in
    f32/int32; f32 operands at HIGHEST precision."""
    if scales is not None:
        acc = jax.lax.dot_general(
            q, rows, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.int32,
        )
        return acc.astype(jnp.float32) * qs[:, None] * scales[None, :]
    return jax.lax.dot_general(
        q, rows, (((1,), (1,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST
        if rows.dtype == jnp.float32 else None,
        preferred_element_type=jnp.float32,
    )


def _chunk_top_k(sc, ok, ids, k):
    sc = jnp.where(ok, sc, -jnp.inf)
    v, i = jax.lax.top_k(sc, min(k, sc.shape[-1]))
    gid = jnp.take_along_axis(jnp.broadcast_to(ids, sc.shape), i, axis=-1)
    return v, jnp.where(jnp.isneginf(v), -1, gid)


def blocked_top_k(
    rows: jax.Array,
    queries: jax.Array,
    k: int,
    *,
    row_scales: Optional[jax.Array] = None,
    q_scales: Optional[jax.Array] = None,
    mask: Optional[jax.Array] = None,
    tiles: Optional[jax.Array] = None,
    tile_n: int = 0,
    n_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Plain-XLA streaming top-k, with the same operands and results as
    :func:`ops.pallas.stream_topk.stream_top_k`: a sequential map over
    doc chunks (or over chunks of the tile table), each a matmul and a
    ``top_k``, then one exact merge. Holds one chunk's scores at a time.
    """
    n, d = rows.shape
    b = queries.shape[0]
    nv = jnp.asarray(n if n_valid is None else n_valid, jnp.int32)
    chunk = max(256, _CHUNK_BYTES // (4 * b))
    if tiles is None:
        c = min(n, chunk)
        n_full = n // c

        def part(r0, size):
            rr = jax.lax.dynamic_slice_in_dim(rows, r0, size)
            ss = (None if row_scales is None
                  else jax.lax.dynamic_slice_in_dim(row_scales, r0, size))
            ids = r0 + jnp.arange(size, dtype=jnp.int32)
            ok = ids < nv
            if mask is not None:
                ok = ok & jax.lax.dynamic_slice_in_dim(mask, r0, size)
            sc = _chunk_scores(rr, ss, queries, q_scales)
            return _chunk_top_k(sc, ok[None, :], ids[None, :], k)

        vs, is_ = jax.lax.map(
            lambda i: part(i * c, c), jnp.arange(n_full, dtype=jnp.int32)
        )
        vals = [jnp.moveaxis(vs, 0, 1).reshape(b, -1)]
        ids = [jnp.moveaxis(is_, 0, 1).reshape(b, -1)]
        if n_full * c < n:
            tv, ti = part(n_full * c, n - n_full * c)
            vals.append(tv)
            ids.append(ti)
        return merge_candidates(
            jnp.concatenate(vals, -1), jnp.concatenate(ids, -1), k
        )
    n_tiles = n // tile_n
    ct = max(1, min(tiles.shape[0], chunk // tile_n))
    n_chunks = -(-tiles.shape[0] // ct)
    table = jnp.pad(tiles, (0, n_chunks * ct - tiles.shape[0]),
                    constant_values=-1).reshape(n_chunks, ct)
    tiled = rows.reshape(n_tiles, tile_n, d)
    tscales = (None if row_scales is None
               else row_scales.reshape(n_tiles, tile_n))

    def step(t):
        tc = jnp.clip(t, 0, n_tiles - 1)
        rr = jnp.take(tiled, tc, axis=0).reshape(ct * tile_n, d)
        ss = (None if tscales is None
              else jnp.take(tscales, tc, axis=0).reshape(-1))
        ids = (t[:, None] * tile_n
               + jnp.arange(tile_n, dtype=jnp.int32)).reshape(-1)
        ok = jnp.repeat(t >= 0, tile_n) & (ids < nv)
        if mask is not None:
            ok = ok & jnp.take(mask, jnp.clip(ids, 0, n - 1))
        sc = _chunk_scores(rr, ss, queries, q_scales)
        return _chunk_top_k(sc, ok[None, :], ids[None, :], k)

    vs, is_ = jax.lax.map(step, table)
    return merge_candidates(
        jnp.moveaxis(vs, 0, 1).reshape(b, -1),
        jnp.moveaxis(is_, 0, 1).reshape(b, -1), k,
    )


def dense_stream_top_k(
    mat,
    queries: jax.Array,
    k: int,
    route: Route,
    *,
    mask: Optional[jax.Array] = None,
    tiles: Optional[jax.Array] = None,
    tile_n: int = 0,
    n_valid=None,
) -> Tuple[jax.Array, jax.Array]:
    """Streaming top-k over a float matrix or a :class:`QuantizedDense`
    (float queries are quantized on the fly), by ``route``."""
    if isinstance(mat, QuantizedDense):
        qv, qs = quantize_queries(queries)
        args = dict(rows=mat.values, queries=qv, row_scales=mat.scales,
                    q_scales=qs)
    else:
        args = dict(rows=mat, queries=queries.astype(mat.dtype))
    args.update(mask=mask, tiles=tiles, tile_n=tile_n, n_valid=n_valid)
    if route.kernel:
        return stream_top_k(k=k, interpret=route.interpret, **args)
    return blocked_top_k(k=k, **args)
