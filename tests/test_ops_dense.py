"""Parity tests: dense ops vs the NumPy reference algorithm."""

import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.ops import dense_top_k, hierarchical_top_k, merge_top_k
from a_nice_rag_tpu.testing import golden_dense_top_k, synth_corpus


def test_dense_top_k_matches_golden():
    c = synth_corpus(n_docs=300, dim=64, n_queries=16, seed=1)
    emb = c.embeddings["voyage-3-large"]
    q = c.query_embeddings["voyage-3-large"]
    k = 25
    vals, idx = dense_top_k(jnp.asarray(emb), jnp.asarray(q), k)
    vals, idx = np.asarray(vals), np.asarray(idx)
    for b in range(q.shape[0]):
        g_vals, g_idx = golden_dense_top_k(emb, q[b], k)
        # XLA and NumPy matmuls accumulate in different orders, so scores
        # agree only to ~1e-4; documents whose gold scores are separated by
        # more than that noise must be selected in identical order, and
        # near-ties may swap but must select equivalently-scored documents.
        np.testing.assert_allclose(vals[b], g_vals, rtol=2e-3, atol=5e-4)
        scores64 = (q[b].astype(np.float64) @ emb.astype(np.float64).T)
        np.testing.assert_allclose(
            scores64[idx[b]], scores64[g_idx], rtol=2e-3, atol=5e-4
        )
        gaps = -np.diff(g_vals)
        stable = np.concatenate([[True], gaps > 1e-3]) & np.concatenate(
            [gaps > 1e-3, [True]]
        )
        np.testing.assert_array_equal(idx[b][stable], g_idx[stable])


def test_dense_top_k_with_mask():
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((200, 32)).astype(np.float32)
    q = rng.standard_normal((4, 32)).astype(np.float32)
    mask = np.zeros(200, dtype=bool)
    mask[50:100] = True
    vals, idx = dense_top_k(jnp.asarray(emb), jnp.asarray(q), 10, mask=jnp.asarray(mask))
    idx = np.asarray(idx)
    assert ((idx >= 50) & (idx < 100)).all()
    # Masked search equals brute force over the allowed slice.
    scores = q @ emb.T
    for b in range(4):
        allowed = scores[b][50:100]
        expect = np.sort(allowed)[::-1][:10]
        np.testing.assert_allclose(np.asarray(vals)[b], expect, rtol=1e-3, atol=1e-5)


def test_hierarchical_top_k_matches_full_sort():
    rng = np.random.default_rng(2)
    scores = rng.standard_normal((3, 4096)).astype(np.float32)
    vals, idx = hierarchical_top_k(jnp.asarray(scores), k=17, tile=512)
    for b in range(3):
        expect_idx = np.argsort(scores[b])[::-1][:17]
        np.testing.assert_allclose(
            np.asarray(vals)[b], scores[b][expect_idx], rtol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(idx)[b], expect_idx)


def test_merge_top_k():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal((2, 4, 8)).astype(np.float32)  # [B, S, k]
    idx = rng.integers(0, 10_000, size=(2, 4, 8)).astype(np.int32)
    mv, mi = merge_top_k(jnp.asarray(vals), jnp.asarray(idx), k=5)
    for b in range(2):
        flat_v = vals[b].reshape(-1)
        flat_i = idx[b].reshape(-1)
        order = np.argsort(flat_v)[::-1][:5]
        np.testing.assert_allclose(np.asarray(mv)[b], flat_v[order], rtol=1e-6)
        np.testing.assert_array_equal(np.asarray(mi)[b], flat_i[order])
