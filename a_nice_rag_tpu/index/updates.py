"""Online index updates: tombstone deletes and frozen-stats appends.

The reference rebuilds its SQLite/pickle artifacts offline (incremental
only by skipping existing ids — create_database.py:87-97). A serving
framework needs cheaper paths:

* ``delete_documents`` — O(1) tombstones: the rows stay in the device
  arrays but every candidate mask excludes them from that point on
  (scores are masked to -inf before any top-k). Exact immediately.
* ``append_documents`` — adds documents WITHOUT touching existing
  postings: dense matrices extend by concatenation (appended dense
  scores are exact), and the BM25 CSR extends under FROZEN corpus
  statistics — idf/avgdl/corpus_size stay as built, so every existing
  impact is bit-identical and new documents score consistently under
  the same statistics. The statistics drift from the true corpus as
  appends accumulate (standard IR practice); rebuild periodically via
  ``build_index`` to re-true them. Statistics provenance is recorded in
  ``bm25_stats["appended_docs"]``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.index.array_index import (
    ArrayIndex,
    Bm25Arrays,
    CorpusMeta,
    _pad_to,
    dense_impact_from_csr,
)
from a_nice_rag_tpu.ops.quantized import QuantizedDense, quantize_embeddings


def delete_documents(index: ArrayIndex, doc_ids: Sequence[str]) -> int:
    """Tombstone documents by id; returns how many were newly deleted.

    Unknown ids are ignored. The update is visible to every retrieval
    path that consumes ``filter_mask`` (all of them): derived-mask
    caches (FusedRetriever, ShardedIndex) are version-keyed and refresh
    on their next call.
    """
    n_new = 0
    for d in doc_ids:
        row = index.meta.id_to_row.get(d)
        if row is not None and not index.meta.deleted[row]:
            index.meta.deleted[row] = True
            n_new += 1
    if n_new:
        index._filter_cache.clear()
        index._version += 1
    return n_new


def undelete_documents(index: ArrayIndex, doc_ids: Sequence[str]) -> int:
    """Clear tombstones; returns how many were restored."""
    n_new = 0
    for d in doc_ids:
        row = index.meta.id_to_row.get(d)
        if row is not None and index.meta.deleted[row]:
            index.meta.deleted[row] = False
            n_new += 1
    if n_new:
        index._filter_cache.clear()
        index._version += 1
    return n_new


def _frozen_idf(df: int, stats: Dict[str, float]) -> float:
    num = stats["corpus_size"] - df + 0.5
    # df at or beyond the frozen corpus size (possible when appends
    # outgrow the original build) means raw idf <= 0: epsilon floor.
    raw = math.log(num) - math.log(df + 0.5) if num > 0 else -1.0
    if raw < 0:
        return stats["epsilon"] * stats["average_idf"]
    return raw


def _ensure_average_idf(stats: Dict[str, float], indptr) -> None:
    """Imported stats dicts (reference BM25 pickles) lack average_idf;
    derive it from the frozen df distribution so the epsilon floor
    works for appended postings too."""
    if "average_idf" in stats:
        return
    df = np.diff(np.asarray(indptr)).astype(np.float64)
    df = df[df > 0]
    cs = stats["corpus_size"]
    raw = np.log(np.maximum(cs - df + 0.5, 1e-9)) - np.log(df + 0.5)
    stats["average_idf"] = float(raw.mean()) if raw.size else 1.0


def append_documents(
    index: ArrayIndex,
    ids: Sequence[str],
    sources: Sequence[str],
    contents: Sequence[str],
    embeddings: Dict[str, np.ndarray],
    urls: Optional[Sequence[str]] = None,
    token_lists: Optional[Sequence[Sequence[str]]] = None,
    pad_multiple: int = 128,
    bm25_dense_max_bytes: int = 4 << 30,
) -> ArrayIndex:
    """A new ArrayIndex with the documents appended (see module doc).

    ``embeddings`` must cover the same models as the index;
    ``token_lists`` is required when the index has a BM25 component.
    Existing rows (embeddings, postings, impacts) are preserved
    bit-for-bit; tombstones carry over.
    """
    m = len(ids)
    if m == 0:
        return index
    dup = [d for d in ids if d in index.meta.id_to_row]
    if dup:
        raise ValueError(f"ids already present: {dup[:5]}")
    if len(set(ids)) != m:
        seen = set()
        repeats = [d for d in ids if d in seen or seen.add(d)]
        raise ValueError(f"duplicate ids within batch: {repeats[:5]}")
    old_n = index.meta.n_docs
    n = old_n + m
    n_pad = _pad_to(n, pad_multiple)

    meta = CorpusMeta(
        ids=index.meta.ids + list(ids),
        sources=index.meta.sources + list(sources),
        contents=index.meta.contents + list(contents),
        urls=index.meta.urls + (
            list(urls) if urls is not None else ["Unknown"] * m
        ),
        n_docs=n,
        n_docs_padded=n_pad,
    )
    meta.deleted[:old_n] = index.meta.deleted

    dense: Dict[str, jnp.ndarray] = {}
    for model, emb in index.dense.items():
        if model not in embeddings:
            raise ValueError(f"missing embeddings for model {model!r}")
        new = np.asarray(embeddings[model], dtype=np.float32)
        if new.shape != (m, emb.shape[1]):
            raise ValueError(
                f"{model}: expected {(m, emb.shape[1])}, got {new.shape}"
            )
        old = np.asarray(emb)[:old_n]
        stacked = np.zeros((n_pad, emb.shape[1]), dtype=old.dtype)
        stacked[:old_n] = old
        stacked[old_n:n] = new.astype(old.dtype)
        dense[model] = jnp.asarray(stacked)

    dense_q = None
    if index.dense_q:
        dense_q = {}
        for model, qd in index.dense_q.items():
            if model not in embeddings:
                raise ValueError(f"missing embeddings for model {model!r}")
            d = qd.values.shape[1]
            new = np.asarray(embeddings[model], dtype=np.float32)
            if new.shape != (m, d):
                raise ValueError(
                    f"{model}: expected {(m, d)}, got {new.shape}"
                )
            # Per-row scales make the quantization row-local, so old
            # rows carry over bit-for-bit; only the new rows quantize.
            new_q = quantize_embeddings(jnp.asarray(new))
            vals = np.zeros((n_pad, d), dtype=np.int8)
            scales = np.zeros((n_pad,), dtype=np.float32)
            vals[:old_n] = np.asarray(qd.values)[:old_n]
            scales[:old_n] = np.asarray(qd.scales)[:old_n]
            vals[old_n:n] = np.asarray(new_q.values)
            scales[old_n:n] = np.asarray(new_q.scales)
            dense_q[model] = QuantizedDense(
                values=jnp.asarray(vals), scales=jnp.asarray(scales)
            )

    bm25 = index.bm25
    vocab = index.vocab
    stats = index.bm25_stats
    bm25_doc_mask = index.bm25_doc_mask
    bm25_dense = index.bm25_dense
    if index.bm25 is not None:
        if token_lists is None:
            raise ValueError(
                "index has a BM25 component; token_lists required"
            )
        stats = dict(index.bm25_stats)
        _ensure_average_idf(stats, index.bm25.indptr)
        k1, b = stats["k1"], stats["b"]
        avgdl = stats["avgdl"]

        # Per-appended-doc term frequencies and lengths.
        vocab = dict(index.vocab)
        new_postings: Dict[int, Dict[int, int]] = {}
        dl = np.zeros(m, dtype=np.float64)
        for j, toks in enumerate(token_lists):
            dl[j] = len(toks)
            seen: Dict[str, int] = {}
            for t in toks:
                seen[t] = seen.get(t, 0) + 1
            for t, c in seen.items():
                ti = vocab.setdefault(t, len(vocab))
                new_postings.setdefault(ti, {})[old_n + j] = c

        old_ptr = np.asarray(index.bm25.indptr)
        old_ids = np.asarray(index.bm25.doc_ids)
        old_imp = np.asarray(index.bm25.impact)
        old_v = old_ptr.shape[0] - 1
        old_nnz = int(old_ptr[-1])
        v = len(vocab)
        denom = k1 * (1.0 - b + b * dl / avgdl)

        ids_parts, imp_parts = [], []
        indptr = np.zeros(v + 1, dtype=np.int32)
        for ti in range(v):
            if ti < old_v:
                lo, hi = int(old_ptr[ti]), int(old_ptr[ti + 1])
                ids_parts.append(old_ids[lo:hi])
                imp_parts.append(old_imp[lo:hi])
                count = hi - lo
            else:
                count = 0
            post = new_postings.get(ti)
            if post:
                # New rows are > every existing row, so per-term doc
                # order is preserved by appending.
                docs = np.fromiter(post.keys(), np.int32, len(post))
                order = np.argsort(docs, kind="stable")
                docs = docs[order]
                tf = np.fromiter(
                    post.values(), np.float64, len(post))[order]
                # Frozen statistics: an EXISTING term's new postings use
                # the idf its old postings were built with (df as of the
                # original build) so the term is internally consistent;
                # a brand-new term gets idf from its appended df.
                df_for_idf = count if count > 0 else len(post)
                idf = _frozen_idf(df_for_idf, stats)
                imp = (
                    idf * tf * (k1 + 1.0)
                    / (tf + denom[docs - old_n])
                ).astype(np.float32)
                ids_parts.append(docs)
                imp_parts.append(imp)
                count += len(post)
            indptr[ti + 1] = indptr[ti] + count
        nnz = int(indptr[-1])
        doc_ids = np.empty(nnz + 1, dtype=np.int32)
        impact = np.empty(nnz + 1, dtype=np.float32)
        if nnz:
            doc_ids[:nnz] = np.concatenate(ids_parts)
            impact[:nnz] = np.concatenate(imp_parts)
        doc_ids[nnz] = n_pad
        impact[nnz] = 0.0
        bm25 = Bm25Arrays(
            indptr=jnp.asarray(indptr),
            doc_ids=jnp.asarray(doc_ids),
            impact=jnp.asarray(impact),
            n_docs_padded=n_pad,
        )
        stats["nnz"] = nnz
        stats["max_df"] = int((indptr[1:] - indptr[:-1]).max()) if nnz else 0
        stats["appended_docs"] = (
            int(stats.get("appended_docs", 0)) + m
        )

        old_mask = (
            index.bm25_doc_mask
            if index.bm25_doc_mask is not None
            else np.ones(index.meta.n_docs_padded, bool)
        )
        bm25_doc_mask = np.zeros(n_pad, dtype=bool)
        bm25_doc_mask[:old_n] = old_mask[:old_n]
        bm25_doc_mask[old_n:n] = dl > 0

        # Same size gate as build_index: the dense matmul fast path is a
        # convenience, not worth OOMing an online append over.
        dense_bytes = len(vocab) * n_pad * 4
        if (index.bm25_dense is not None
                and dense_bytes <= bm25_dense_max_bytes):
            bm25_dense = dense_impact_from_csr(
                bm25, dtype=str(index.bm25_dense.impact.dtype)
            )
        else:
            bm25_dense = None

    return ArrayIndex(
        meta=meta,
        dense=dense,
        bm25=bm25,
        vocab=vocab,
        bm25_stats=stats,
        bm25_doc_mask=bm25_doc_mask,
        bm25_dense=bm25_dense,
        dense_q=dense_q,
    )
