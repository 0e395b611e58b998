"""End-to-end learning check: contrastive training of the on-device encoder
must improve retrieval quality on a synthetic paired corpus."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_nice_rag_tpu.models import (
    EncoderConfig,
    HashingTokenizer,
    init_encoder,
    make_train_step,
)
from a_nice_rag_tpu.ops.dense import dense_top_k, dense_top_k_auto


def _recall_at_1(model, params, tok, docs, queries):
    d = model.apply(params, jnp.asarray(tok.encode_batch(docs)))
    q = model.apply(params, jnp.asarray(tok.encode_batch(queries)))
    _, idx = dense_top_k(d, q, 1)
    return float(np.mean(np.asarray(idx)[:, 0] == np.arange(len(queries))))


@pytest.mark.slow
def test_training_improves_retrieval():
    cfg = EncoderConfig(
        vocab_size=512, dim=64, n_layers=2, n_heads=2, max_len=16, out_dim=64
    )
    model, params = init_encoder(cfg, seed=7)
    tok = HashingTokenizer(vocab_size=cfg.vocab_size, max_len=16)
    # Query/document pairs share topic words; distractor structure makes
    # untrained (random-projection) retrieval imperfect.
    n = 24
    docs = [f"topic{i} alpha{i} beta{i % 3} gamma{i % 5} common words" for i in range(n)]
    queries = [f"asking about topic{i} and gamma{i % 5}" for i in range(n)]
    before = _recall_at_1(model, params, tok, docs, queries)

    step, opt = make_train_step(model)
    opt_state = opt.init(params)
    q_ids = jnp.asarray(tok.encode_batch(queries))
    d_ids = jnp.asarray(tok.encode_batch(docs))
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, q_ids, d_ids)
    after = _recall_at_1(model, params, tok, docs, queries)
    assert after >= max(before, 0.9), (before, after)


def test_dense_top_k_auto_routes_xla_on_cpu():
    rng = np.random.default_rng(5)
    emb = jnp.asarray(rng.standard_normal((256, 32)).astype(np.float32))
    q = jnp.asarray(rng.standard_normal((4, 32)).astype(np.float32))
    v_auto, i_auto = dense_top_k_auto(emb, q, 5)
    v_ref, i_ref = dense_top_k(emb, q, 5)
    np.testing.assert_array_equal(np.asarray(i_auto), np.asarray(i_ref))
    # A forced streaming route (its kernel interpreted) must agree.
    emb2 = jnp.asarray(rng.standard_normal((512, 32)).astype(np.float32))
    q2 = jnp.asarray(rng.standard_normal((64, 32)).astype(np.float32))
    v_p, i_p = dense_top_k_auto(emb2, q2, 5, backend="stream",
                                interpret=True)
    v_x, i_x = dense_top_k(emb2, q2, 5)
    np.testing.assert_array_equal(np.asarray(i_p), np.asarray(i_x))
