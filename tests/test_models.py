"""On-device models: encoder forward, reranker, contrastive training
(single-device and dp x tp sharded on the virtual mesh)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_nice_rag_tpu.models import (
    EncoderConfig,
    HashingTokenizer,
    OnDeviceEmbedder,
    OnDeviceReranker,
    contrastive_loss,
    init_encoder,
    make_sharded_train_step,
    make_train_step,
)
from a_nice_rag_tpu.parallel import make_mesh

CFG = EncoderConfig(
    vocab_size=1024, dim=64, n_layers=2, n_heads=2, max_len=32, out_dim=64
)


def test_encoder_forward_unit_norm():
    model, params = init_encoder(CFG)
    tok = HashingTokenizer(vocab_size=CFG.vocab_size, max_len=16)
    ids = jnp.asarray(tok.encode_batch(["hello world", "hypertension in adults"]))
    out = model.apply(params, ids)
    assert out.shape == (2, 64)
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(out), axis=1), 1.0, rtol=1e-5
    )
    # Deterministic: same text -> same embedding.
    out2 = model.apply(params, ids)
    np.testing.assert_allclose(np.asarray(out), np.asarray(out2), rtol=1e-6)


def test_hashing_tokenizer_deterministic_and_padded():
    tok = HashingTokenizer(vocab_size=512, max_len=8)
    a = tok.encode("stage 2 hypertension")
    b = tok.encode("stage 2 hypertension")
    assert a == b
    batch = tok.encode_batch(["one", "a much longer sentence with many words"])
    assert batch.shape == (2, 8)
    assert batch[0, 1] == 0  # padding
    pairs = tok.encode_pairs(["q"], ["d"])
    assert (pairs[0] == 511).sum() == 1  # separator present


def test_on_device_embedder_and_reranker():
    emb = OnDeviceEmbedder(CFG)
    vecs = emb.embed_queries(["question one", "question two"])
    assert vecs.shape == (2, 64)
    rr = OnDeviceReranker(CFG)
    docs = [{"id": "a", "document": "text a"}, {"id": "b", "document": "text b"}]
    out = rr.rerank("some query", docs, top_k=1)
    assert len(out) == 1 and "rerank_score" in out[0]
    out2 = rr.rerank("some query", docs)
    scores = [d["rerank_score"] for d in out2]
    assert scores == sorted(scores, reverse=True)


@pytest.mark.slow
def test_contrastive_training_reduces_loss():
    model, params = init_encoder(CFG, seed=1)
    tok = HashingTokenizer(vocab_size=CFG.vocab_size, max_len=16)
    queries = [f"question about topic {i}" for i in range(8)]
    docs = [f"document describing topic {i} in detail" for i in range(8)]
    q_ids = jnp.asarray(tok.encode_batch(queries))
    d_ids = jnp.asarray(tok.encode_batch(docs))
    step, opt = make_train_step(model)
    opt_state = opt.init(params)
    losses = []
    for _ in range(12):
        params, opt_state, loss = step(params, opt_state, q_ids, d_ids)
        losses.append(float(loss))
    assert losses[-1] < losses[0] * 0.8, losses


@pytest.mark.slow
def test_sharded_train_step_matches_single_device():
    mesh = make_mesh(shape=(4, 2), axis_names=("dp", "tp"))
    model, params = init_encoder(CFG, seed=2)
    tok = HashingTokenizer(vocab_size=CFG.vocab_size, max_len=16)
    q_ids = jnp.asarray(tok.encode_batch([f"q {i}" for i in range(8)]))
    d_ids = jnp.asarray(tok.encode_batch([f"d {i}" for i in range(8)]))

    # Single-device reference loss for the same initial params.
    def loss_fn(p):
        return contrastive_loss(model.apply(p, q_ids), model.apply(p, d_ids))

    ref_loss = float(loss_fn(params))

    step, s_params, s_opt, batch_sharding = make_sharded_train_step(
        model, params, mesh
    )
    q_s = jax.device_put(q_ids, batch_sharding)
    d_s = jax.device_put(d_ids, batch_sharding)
    s_params, s_opt, loss0 = step(s_params, s_opt, q_s, d_s)
    # bf16 activations + resharded reductions shift the loss slightly.
    assert float(loss0) == pytest.approx(ref_loss, rel=0.05)
    _, _, loss1 = step(s_params, s_opt, q_s, d_s)
    assert float(loss1) < float(loss0)


def test_checkpoint_roundtrip(tmp_path):
    from a_nice_rag_tpu.models.checkpoint import (
        latest_step,
        restore_checkpoint,
        save_checkpoint,
    )

    model, params = init_encoder(CFG, seed=5)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, 0, params)
    save_checkpoint(path, 10, params)
    assert latest_step(path) == 10
    step, restored, opt = restore_checkpoint(path)
    assert step == 10 and opt is None
    a = jax.tree.leaves(params)
    b = jax.tree.leaves(restored)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.slow
def test_trainer_end_to_end_with_resume(tmp_path):
    from a_nice_rag_tpu.models.trainer import train_encoder

    queries = [f"question on topic {i} area {i % 4}" for i in range(48)]
    docs = [f"document covering topic {i} within area {i % 4}" for i in range(48)]
    ckpt = str(tmp_path / "enc")
    r1 = train_encoder(
        queries, docs, cfg=CFG, batch_size=16, epochs=2,
        checkpoint_dir=ckpt, checkpoint_every=3, eval_every=0,
    )
    assert r1.steps == 6
    assert r1.losses[-1] < r1.losses[0]
    final_recall = r1.eval_recall[-1][1]
    assert final_recall > 0.5
    # Resume: picks up at step 6 and continues.
    r2 = train_encoder(
        queries, docs, cfg=CFG, batch_size=16, epochs=1,
        checkpoint_dir=ckpt, checkpoint_every=100, eval_every=0,
    )
    assert r2.steps == 9
