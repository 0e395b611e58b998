"""Million-document corpora, generated on the device from a seed.

Shared by ``bench.py``, ``chip_smoke.py`` and the route comparison
script. Every large array is made on the device; only the CSR postings
of the 2M hybrid are built on the host (V x DF int32, 8 MB at full
size). Sizes are arguments so the same code rehearses at a tiny size on
the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.index.array_index import ArrayIndex, CorpusMeta
from a_nice_rag_tpu.ops.bm25 import Bm25Arrays
from a_nice_rag_tpu.ops.quantized import QuantizedDense

MODEL = "voyage-3-large"


class ScaleCorpus(NamedTuple):
    index: ArrayIndex
    queries: jax.Array  # [B, D] f32, unit-norm
    terms: jax.Array  # [B, T] int32 (or None: dense-only)
    gold: np.ndarray  # [B] planted gold doc rows
    centers: jax.Array = None  # planted cluster centers, where planted


def _unit(x):
    return x * jax.lax.rsqrt(jnp.sum(x * x, axis=-1, keepdims=True) + 1e-12)


def _meta(n):
    return CorpusMeta(ids=[], sources=[], contents=[], urls=[], n_docs=n,
                      n_docs_padded=n)


def hybrid_2m(n=1 << 21, d=256, b=256, t=16, vocab=1 << 17, df=16,
              seed=11) -> ScaleCorpus:
    """2M x 256 bf16 unit vectors plus CSR BM25 with uniform df (max_df
    == df exactly); query b's terms all carry its gold document, and its
    embedding is a noisy copy of the gold row (cosine ~0.53 against
    ~0.34 for the best random doc at full size)."""
    rng = np.random.default_rng(seed)
    emb = jax.jit(lambda k: _unit(
        jax.random.normal(k, (n, d), jnp.float32)).astype(jnp.bfloat16)
    )(jax.random.PRNGKey(seed + 1))
    gold = rng.integers(0, n, size=b).astype(np.int32)
    q = jax.jit(lambda e, g, k: _unit(
        jnp.take(e, g, axis=0).astype(jnp.float32)
        + 0.10 * jax.random.normal(k, (b, d), jnp.float32))
    )(emb, jnp.asarray(gold), jax.random.PRNGKey(seed + 2))
    doc_mat = rng.integers(0, n, size=(vocab, df)).astype(np.int32)
    doc_mat[np.arange(b * t), 0] = np.repeat(gold, t)
    doc_mat.sort(axis=1)
    impact = rng.uniform(0.5, 1.5, size=(vocab, df)).astype(np.float32)
    bm25 = Bm25Arrays(
        indptr=jnp.asarray(np.arange(vocab + 1, dtype=np.int32) * df),
        doc_ids=jnp.asarray(np.append(doc_mat.reshape(-1), n).astype(np.int32)),
        impact=jnp.asarray(np.append(impact.reshape(-1), 0.0)
                           .astype(np.float32)),
        n_docs_padded=n,
    )
    index = ArrayIndex(
        meta=_meta(n), dense={MODEL: emb}, bm25=bm25, vocab=None,
        bm25_stats={"max_df": float(df)},
        bm25_doc_mask=np.ones(n, dtype=bool), bm25_dense=None,
    )
    terms = jnp.asarray(np.arange(b * t, dtype=np.int32).reshape(b, t))
    return ScaleCorpus(index, q, terms, gold)


def int8_10m(n=10_485_760, d=1024, b=256, clusters=4096, chunks=40,
             seed=23) -> ScaleCorpus:
    """10.5M x 1024 int8 rows with per-row scales, clustered and stored
    cluster-major (within-cluster cosine ~0.6); made chunk by chunk into
    donated buffers, since the f32 matrix would be 43 GB. Queries are
    noisy copies of gold rows (cosine ~0.78)."""
    rng = np.random.default_rng(seed)
    gold = rng.integers(0, n, size=b).astype(np.int32)
    per = n // clusters
    chunk = n // chunks
    cent = jax.jit(lambda k: _unit(
        jax.random.normal(k, (clusters, d), jnp.float32))
    )(jax.random.PRNGKey(seed + 1))

    @functools.partial(jax.jit, donate_argnums=(0, 1))
    def add_chunk(vals, scales, cent, key, row0):
        which = (row0 + jnp.arange(chunk, dtype=jnp.int32)) // per
        e = jnp.take(cent, which, axis=0)
        e = e + 0.042 * jax.random.normal(key, (chunk, d), jnp.float32)
        s = jnp.max(jnp.abs(e), axis=1) / 127.0
        q8 = jnp.clip(jnp.round(e / s[:, None]), -127, 127).astype(jnp.int8)
        vals = jax.lax.dynamic_update_slice(vals, q8, (row0, 0))
        scales = jax.lax.dynamic_update_slice(scales, s, (row0,))
        return vals, scales

    vals = jnp.zeros((n, d), jnp.int8)
    scales = jnp.zeros((n,), jnp.float32)
    key = jax.random.PRNGKey(seed + 2)
    for i in range(chunks):
        key, sub = jax.random.split(key)
        vals, scales = add_chunk(vals, scales, cent, sub,
                                 jnp.int32(i * chunk))
    q = jax.jit(lambda v, s, g, k: _unit(_unit(
        jnp.take(v, g, axis=0).astype(jnp.float32)
        * jnp.take(s, g)[:, None])
        + 0.025 * jax.random.normal(k, (b, d), jnp.float32))
    )(vals, scales, jnp.asarray(gold), jax.random.PRNGKey(seed + 3))
    index = ArrayIndex(
        meta=_meta(n), dense={}, bm25=None, vocab=None, bm25_stats=None,
        dense_q={MODEL: QuantizedDense(values=vals, scales=scales)},
    )
    return ScaleCorpus(index, q, None, gold, cent)


def clustered_2m(n=1 << 21, d=256, b=16, centers=2048, seed=31
                 ) -> ScaleCorpus:
    """2M x 256 bf16 with planted cluster structure (2048 centers,
    within-cluster cosine ~0.61): the premise IVF works on. Queries are
    noisy copies of gold rows (cosine ~0.78)."""
    rng = np.random.default_rng(seed)

    @jax.jit
    def gen(key):
        kc, ka, kn = jax.random.split(key, 3)
        cent = _unit(jax.random.normal(kc, (centers, d), jnp.float32))
        e = jnp.take(cent, jax.random.randint(ka, (n,), 0, centers), axis=0)
        e = e + 0.08 * jax.random.normal(kn, (n, d), jnp.float32)
        return _unit(e).astype(jnp.bfloat16)

    emb = gen(jax.random.PRNGKey(seed + 1))
    gold = rng.integers(0, n, size=b).astype(np.int32)
    q = jax.jit(lambda e, g, k: _unit(
        jnp.take(e, g, axis=0).astype(jnp.float32)
        + 0.05 * jax.random.normal(k, (b, d), jnp.float32))
    )(emb, jnp.asarray(gold), jax.random.PRNGKey(seed + 2))
    index = ArrayIndex(meta=_meta(n), dense={MODEL: emb}, bm25=None,
                       vocab=None, bm25_stats=None)
    return ScaleCorpus(index, q, None, gold)
