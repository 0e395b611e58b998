"""On-device spherical k-means for IVF coarse quantization.

The reference has no ANN structure at all — its dense search is a full
``np.dot`` over the corpus (src/search_engine.py:128-138). The rebuild
adds an IVF (inverted-file) layer on top of the exact streaming top-k: cluster the corpus once at build time, then probe only the
top-``p`` clusters per query. This module is the build-time half.

Design: Lloyd iterations are expressed entirely as matmuls — assignment
is ``argmax(X @ C^T)`` (cosine == dot on unit-norm rows) and the
centroid update is ``onehot(A)^T @ X`` — streamed over row chunks inside
one jit per iteration. No scatter, no host round-trips inside an
iteration, static shapes throughout.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _compute_dtype(x):
    """Matmul dtype for a chunk: floats pass through; int8 corpora
    (ops.quantized layout) compute in bf16 — casting PER CHUNK keeps
    the 4x-compressed matrix as the only full-size resident array."""
    return x.dtype if jnp.issubdtype(x.dtype, jnp.floating) else jnp.bfloat16


@functools.partial(jax.jit, static_argnames=("chunk",))
def _lloyd_iter(x, cent, n_valid, chunk: int):
    """One Lloyd iteration. x [Np, D] (rows >= n_valid are padding),
    cent [C, D] f32 unit-norm. Returns (new_cent [C, D], counts [C])."""
    npad, d = x.shape
    c = cent.shape[0]
    cdt = _compute_dtype(x)
    cent_t = cent.astype(cdt).T  # [D, C]

    def body(i, carry):
        sums, counts = carry
        xc = jax.lax.dynamic_slice(x, (i * chunk, 0), (chunk, d))
        xc = xc.astype(cdt)
        scores = jnp.dot(
            xc, cent_t, preferred_element_type=jnp.float32
        )  # [chunk, C]
        a = jnp.argmax(scores, axis=1)  # [chunk]
        row = i * chunk + jnp.arange(chunk)
        valid = row < n_valid
        onehot = (
            (a[:, None] == jnp.arange(c)[None, :]) & valid[:, None]
        ).astype(cdt)  # [chunk, C]
        sums = sums + jnp.dot(
            onehot.T, xc, preferred_element_type=jnp.float32
        )
        counts = counts + jnp.sum(onehot, axis=0, dtype=jnp.float32)
        return sums, counts

    sums = jnp.zeros((c, d), jnp.float32)
    counts = jnp.zeros((c,), jnp.float32)
    sums, counts = jax.lax.fori_loop(0, npad // chunk, body, (sums, counts))
    # Empty clusters keep their previous centroid (deterministic; they
    # simply attract no probes).
    norm = jnp.sqrt(jnp.sum(sums * sums, axis=1, keepdims=True))
    new = jnp.where(
        (counts[:, None] > 0) & (norm > 0), sums / jnp.maximum(norm, 1e-12),
        cent,
    )
    return new, counts


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign(x, cent, chunk: int):
    """Final hard assignment. Returns [Np] int32 cluster ids."""
    npad, d = x.shape
    cdt = _compute_dtype(x)
    cent_t = cent.astype(cdt).T

    def body(i, out):
        xc = jax.lax.dynamic_slice(x, (i * chunk, 0), (chunk, d))
        xc = xc.astype(cdt)
        scores = jnp.dot(xc, cent_t, preferred_element_type=jnp.float32)
        a = jnp.argmax(scores, axis=1).astype(jnp.int32)
        return jax.lax.dynamic_update_slice(out, a, (i * chunk,))

    out = jnp.zeros((npad,), jnp.int32)
    return jax.lax.fori_loop(0, npad // chunk, body, out)


def spherical_kmeans(
    x: jax.Array,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    chunk: int = 8192,
) -> Tuple[jax.Array, jax.Array]:
    """Cluster unit-norm rows by cosine. Returns
    (centroids [C, D] f32 unit-norm, assignments [N] int32).

    ``x`` may be any float dtype; rows need not be exactly unit-norm
    (argmax of dot is what IVF probing uses either way). Rows are padded
    to a chunk multiple internally; padding never contributes.
    """
    n, d = x.shape
    c = int(n_clusters)
    assert c >= 1 and n >= c, (n, c)
    chunk = min(chunk, -(-n // 256) * 256)  # small inputs: one chunk
    npad = -(-n // chunk) * chunk
    if npad != n:
        x = jnp.pad(x, ((0, npad - n), (0, 0)))

    # Init: a random row subset (k-means++ costs C sequential passes —
    # with 10 Lloyd iterations behind it, random init measures the same
    # on planted-cluster synthetics).
    rows = jax.random.choice(
        jax.random.PRNGKey(seed), n, shape=(c,), replace=False
    )
    cent = jnp.take(x, rows, axis=0).astype(jnp.float32)
    cent = cent / jnp.maximum(
        jnp.sqrt(jnp.sum(cent * cent, axis=1, keepdims=True)), 1e-12
    )

    n_valid = jnp.int32(n)
    for _ in range(n_iters):
        cent, _ = _lloyd_iter(x, cent, n_valid, chunk)
    assign = _assign(x, cent, chunk)[:n]
    return cent, assign


@functools.partial(jax.jit, static_argnames=("top", "chunk"))
def _assign_top(x, cent, top: int, chunk: int):
    """Top-``top`` cluster assignment with scores. Returns
    (ids [Np, top] int32 by descending score, scores [Np, top] f32)."""
    npad, d = x.shape
    cdt = _compute_dtype(x)
    cent_t = cent.astype(cdt).T

    def body(i, carry):
        ids, scs = carry
        xc = jax.lax.dynamic_slice(x, (i * chunk, 0), (chunk, d))
        xc = xc.astype(cdt)
        scores = jnp.dot(xc, cent_t, preferred_element_type=jnp.float32)
        v, a = jax.lax.top_k(scores, top)
        ids = jax.lax.dynamic_update_slice(
            ids, a.astype(jnp.int32), (i * chunk, 0)
        )
        scs = jax.lax.dynamic_update_slice(scs, v, (i * chunk, 0))
        return ids, scs

    ids = jnp.zeros((npad, top), jnp.int32)
    scs = jnp.zeros((npad, top), jnp.float32)
    return jax.lax.fori_loop(0, npad // chunk, body, (ids, scs))


def assign_clusters(
    x: jax.Array, cent: jax.Array, top: int = 1, chunk: int = 8192
) -> Tuple[jax.Array, jax.Array]:
    """Top-``top`` hard assignments of rows to the given centroids
    (cosine == dot for unit-norm rows), chunk-streamed like the Lloyd
    iterations. Used by the IVF spill layout (secondary assignments).
    Returns (cluster ids [N, top], scores [N, top])."""
    n, d = x.shape
    chunk = min(chunk, -(-n // 256) * 256)
    npad = -(-n // chunk) * chunk
    if npad != n:
        x = jnp.pad(x, ((0, npad - n), (0, 0)))
    ids, scs = _assign_top(x, cent, min(top, cent.shape[0]), chunk)
    return ids[:n], scs[:n]


def kmeans_init_rows(n: int, c: int, seed: int) -> np.ndarray:
    """The row subset :func:`spherical_kmeans` initializes from."""
    return np.asarray(
        jax.random.choice(
            jax.random.PRNGKey(seed), n, shape=(c,), replace=False
        )
    )


@functools.partial(jax.jit, static_argnames=("chunk",))
def _lloyd_iter_batched(xs, cents, n_valids, chunk: int):
    return jax.vmap(
        lambda x, c, nv: _lloyd_iter(x, c, nv, chunk)
    )(xs, cents, n_valids)


@functools.partial(jax.jit, static_argnames=("chunk",))
def _assign_batched(xs, cents, chunk: int):
    return jax.vmap(lambda x, c: _assign(x, c, chunk))(xs, cents)


def spherical_kmeans_batched(
    xs: jax.Array,
    n_valids: np.ndarray,
    n_clusters: int,
    n_iters: int = 10,
    seed: int = 0,
    chunk: int = 8192,
    init: "np.ndarray | None" = None,
) -> Tuple[jax.Array, jax.Array]:
    """Cluster S independent row sets in ONE device program per Lloyd
    iteration (vmap over the leading axis) — the per-shard IVF build's
    k-means, which run sequentially would leave the chip idle S-1/S of
    the time. xs [S, Np, D] (rows >= n_valids[s] are padding; Np must
    be a chunk multiple after the internal clamp), n_valids [S] int.
    Shards with n_valids[s] == 0 keep zero centroids and their
    assignments are meaningless (callers slice [:0] anyway).

    Seeding matches :func:`spherical_kmeans` per shard (seed + s), so a
    shard's result is the same clustering problem, vmapped. Pass
    ``init`` ([S, C, D], unit rows) to skip the default host gather of
    ``xs`` — callers that already hold the rows host-side (shard_ivf)
    should, so a mesh-sharded ``xs`` never round-trips to the host.
    """
    s_cnt, npad, d = xs.shape
    c = int(n_clusters)
    chunk = min(chunk, npad)
    while npad % chunk:
        chunk //= 2

    if init is None:
        cents = np.zeros((s_cnt, c, d), np.float32)
        xs_np = None
        for s in range(s_cnt):
            real = int(n_valids[s])
            if real <= 0:
                continue
            assert real >= c, (real, c)
            rows = kmeans_init_rows(real, c, seed + s)
            if xs_np is None:
                xs_np = np.asarray(xs)
            ini = xs_np[s, rows].astype(np.float32)
            norm = np.linalg.norm(ini, axis=1, keepdims=True)
            cents[s] = ini / np.maximum(norm, 1e-12)
    else:
        cents = np.asarray(init, np.float32)

    cents = jnp.asarray(cents)
    nv = jnp.asarray(np.asarray(n_valids, np.int32))
    for _ in range(n_iters):
        cents, _ = _lloyd_iter_batched(xs, cents, nv, chunk)
    assign = _assign_batched(xs, cents, chunk)
    return cents, assign
