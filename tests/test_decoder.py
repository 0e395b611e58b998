"""Decoder LM: KV-cache decode parity, causality, memorization fit,
and the streaming text generator (models/decoder.py).

The decode path must be numerically the same computation as the full
causal forward — prefill + per-token cached steps reproduce the full
forward's next-token choices exactly. Replaces the reference's
SaaS-only generation hop (src/query_rag.py:434-513) with an on-device
path.
"""

import jax
import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.models.decoder import (
    ByteDecoder,
    ByteTokenizer,
    generate_stream,
    generate_text_stream,
    init_caches,
    init_decoder,
    lm_logits,
    lm_loss,
    small_lm_config,
    train_lm_steps,
)


def _setup(seed=0):
    cfg = small_lm_config()
    model, params = init_decoder(cfg, seed=seed)
    return cfg, model, params


def test_bytetokenizer_roundtrip():
    tok = ByteTokenizer()
    for s in ["hello", "naïve café ☕", "диагноз", ""]:
        ids = tok.encode(s, add_bos=False)
        assert tok.decode(ids) == s
    dec = ByteDecoder()
    out = ""
    for t in tok.encode("café ☕", add_bos=False):
        out += dec.feed(t)
    out += dec.flush()
    assert out == "café ☕"


def test_kv_cache_matches_full_forward():
    """prefill(3 tokens) + 5 cached single-token steps == the full
    forward over the 8-token sequence, position by position."""
    cfg, model, params = _setup()
    rng = np.random.default_rng(5)
    seq = jnp.asarray(rng.integers(0, 255, (1, 8)), jnp.int32)
    full = lm_logits(model, params, seq)  # [1, 8, V]

    kc, vc = init_caches(cfg, 1, 8)
    pre, kc, vc = model.apply(params, seq[:, :3], kc, vc, jnp.int32(0))
    np.testing.assert_allclose(
        np.asarray(pre), np.asarray(full[:, :3]), rtol=2e-4, atol=2e-4
    )
    for t in range(3, 8):
        out, kc, vc = model.apply(
            params, seq[:, t:t + 1], kc, vc, jnp.int32(t)
        )
        np.testing.assert_allclose(
            np.asarray(out[:, 0]), np.asarray(full[:, t]),
            rtol=2e-4, atol=2e-4,
        )


def test_causality():
    """Changing a future token must not change earlier logits."""
    cfg, model, params = _setup()
    rng = np.random.default_rng(7)
    seq = np.asarray(rng.integers(0, 255, (1, 10)), np.int32)
    seq2 = seq.copy()
    seq2[0, 7:] = (seq2[0, 7:] + 13) % 255
    a = lm_logits(model, params, jnp.asarray(seq))
    b = lm_logits(model, params, jnp.asarray(seq2))
    np.testing.assert_allclose(
        np.asarray(a[:, :7]), np.asarray(b[:, :7]), rtol=1e-5, atol=1e-5
    )
    assert not np.allclose(np.asarray(a[:, 8]), np.asarray(b[:, 8]))


def test_memorization_and_streaming_generation():
    """A tiny LM fits a repeated phrase; greedy decode then reproduces
    its continuation through the streaming generator — training path
    and KV-cache decode path agree end to end."""
    tok = ByteTokenizer()
    phrase = "the dose is 42 mg daily. "
    text = phrase * 6
    ids = tok.encode(text)
    cfg = small_lm_config(hidden_size=96, num_layers=2)
    model, params = init_decoder(cfg, seed=1, max_len=len(ids))
    batch = jnp.asarray(ids, jnp.int32)[None, :]
    params, losses = train_lm_steps(model, params, batch, n_steps=150)
    assert losses[-1] < 0.25 * losses[0], (losses[0], losses[-1])

    prompt = tok.encode(phrase * 2)
    got = ""
    for piece in generate_text_stream(
        model, params, phrase * 2, max_new_tokens=len(phrase),
    ):
        got += piece
    assert phrase.strip() in (phrase * 2 + got), got
    # The continuation must reproduce the memorized loop.
    assert got.startswith(phrase[: max(8, len(got) and 8)]) or (
        phrase in got
    ), got


def test_generate_stream_stops_at_eos():
    cfg, model, params = _setup()
    toks = list(generate_stream(model, params, [256, 10, 20],
                                max_new_tokens=12))
    assert len(toks) <= 12
    assert all(t != 257 for t in toks)  # EOS is never yielded


def test_local_llm_in_rag_stream():
    """End-to-end RAG with the on-device decoder as the LLM: the
    query_rag_stream 4-tuple contract streams deltas generated by the
    KV-cached LM — no SaaS anywhere (embedding is precomputed, BM25
    local, generation local)."""
    from a_nice_rag_tpu.config import InfoSource
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.rag.providers import LocalLLMClient, route_model
    from a_nice_rag_tpu.rag.system import RAGSystem
    from a_nice_rag_tpu.retrieval.embed import PrecomputedEmbedder
    from a_nice_rag_tpu.retrieval.rerank import IdentityReranker
    from a_nice_rag_tpu.testing import synth_corpus

    c = synth_corpus(n_docs=128, dim=32, n_queries=2, seed=9)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      urls=c.urls, embeddings=c.embeddings,
                      token_lists=c.tokens)
    cfg = small_lm_config(hidden_size=64, num_layers=1)
    model, params = init_decoder(cfg, seed=3, max_len=1200)
    local = LocalLLMClient(model, params, max_new_tokens=24,
                              max_prompt_tokens=512)
    assert route_model("local", {"local": local}) is not None
    table = {"question 0": c.query_embeddings["voyage-3-large"][0]}
    system = RAGSystem(
        indexes={InfoSource.NICE: idx},
        embedder=PrecomputedEmbedder(table),
        reranker=IdentityReranker(),
        llm_clients={"local": local},
    )
    chunks, s_data = [], None
    for chunk, _, _, s_data in system.query_rag_stream(
        "question 0", "local", use_hybrid_search=True
    ):
        chunks.append(chunk)
    assert len(chunks) >= 1  # untrained weights still stream tokens
    assert c.gold_ids[0] in (d["section_id"] for d in s_data)


def test_decoder_matches_hf_causal_lm():
    """Weight-exact Qwen3 runtime: convert a (random-init) HF
    Qwen3ForCausalLM with tied embeddings and pin (a) full-forward
    logits and (b) greedy KV-cache decode against transformers. The
    real 0.6B checkpoint is not downloadable here; architecture parity
    uses the full feature set (GQA, decoupled head_dim, q/k norms)."""
    import pytest as _pytest

    torch = _pytest.importorskip("torch")
    _pytest.importorskip("transformers")
    from transformers import Qwen3Config as HFConfig
    from transformers import Qwen3ForCausalLM

    from a_nice_rag_tpu.models.decoder import DecoderLM
    from a_nice_rag_tpu.models.qwen3 import Qwen3Config, convert_hf_qwen3

    torch.manual_seed(3)
    hf_cfg = HFConfig(
        vocab_size=211, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, head_dim=24,
        intermediate_size=112, rope_theta=1_000_000.0,
        rms_norm_eps=1e-6, attention_dropout=0.0,
        tie_word_embeddings=True,
    )
    hf = Qwen3ForCausalLM(hf_cfg)
    hf.eval()

    cfg = Qwen3Config.from_hf(hf_cfg, dtype=jnp.float32)
    params = convert_hf_qwen3(hf.state_dict(), cfg)
    lm = DecoderLM(cfg)

    rng = np.random.default_rng(11)
    ids = rng.integers(1, 200, size=(2, 9)).astype(np.int64)
    with torch.no_grad():
        ref = hf(input_ids=torch.tensor(ids)).logits.numpy()

    kc, vc = init_caches(cfg, 2, 9)
    got, _, _ = lm.apply(params, jnp.asarray(ids, jnp.int32), kc, vc,
                         jnp.int32(0))
    np.testing.assert_allclose(np.asarray(got), ref, rtol=3e-4, atol=3e-4)

    # Greedy continuation parity through the KV-cache decode path.
    with torch.no_grad():
        hf_out = hf.generate(
            torch.tensor(ids[:1]), max_new_tokens=6, do_sample=False,
            pad_token_id=0,
        ).numpy()[0, 9:]
    ours = list(generate_stream(lm, params, [int(t) for t in ids[0]],
                                max_new_tokens=6, eos_id=-999))
    np.testing.assert_array_equal(np.asarray(ours), hf_out)


def test_sampling_knobs():
    """top-k masks everything outside the k best; top-p keeps the
    smallest nucleus; temperature 0 is exact argmax."""
    from a_nice_rag_tpu.models.decoder import sample_logits

    key = jax.random.PRNGKey(0)
    logits = jnp.asarray(
        [[2.0, 1.0, 0.5, -1.0, -5.0]], jnp.float32
    )
    assert int(sample_logits(logits, key, temperature=0.0)[0]) == 0
    # top_k=2: only ids {0, 1} can ever be drawn.
    draws = {
        int(sample_logits(logits, jax.random.PRNGKey(s),
                          temperature=1.5, top_k=2)[0])
        for s in range(40)
    }
    assert draws <= {0, 1} and len(draws) == 2
    # top_p tiny: collapses to the argmax regardless of temperature.
    draws_p = {
        int(sample_logits(logits, jax.random.PRNGKey(s),
                          temperature=2.0, top_p=0.05)[0])
        for s in range(20)
    }
    assert draws_p == {0}
    # Seeded sampled generation is reproducible.
    cfg, model, params = _setup()
    a = list(generate_stream(model, params, [256, 5], max_new_tokens=8,
                             temperature=0.8, top_k=40, seed=7))
    b = list(generate_stream(model, params, [256, 5], max_new_tokens=8,
                             temperature=0.8, top_k=40, seed=7))
    assert a == b


def test_chunked_decode_parity():
    """chunk>1 moves the decode loop on-device (lax.scan over cached
    steps, sampling inside); the emitted stream must be token-for-token
    identical to the per-token path in every sampling mode, including
    when max_new_tokens is not a multiple of the chunk size."""
    cfg, model, params = _setup()
    prompt = list(range(10, 30))
    for kw in (
        dict(),
        dict(temperature=0.8, top_k=40, seed=3),
        dict(temperature=1.0, top_p=0.9, seed=7),
    ):
        ref = list(generate_stream(model, params, prompt,
                                   max_new_tokens=33, **kw))
        for ch in (4, 16):
            got = list(generate_stream(model, params, prompt,
                                       max_new_tokens=33, chunk=ch, **kw))
            assert got == ref, (kw, ch)


def test_chunked_decode_eos_mid_chunk():
    """EOS raised inside a chunk truncates the stream exactly where the
    per-token path stops: use the first generated token as the EOS id,
    so generation must end after yielding nothing past it."""
    cfg, model, params = _setup()
    prompt = [256, 9, 17, 33]
    ref = list(generate_stream(model, params, prompt, max_new_tokens=16))
    fake_eos = ref[5]
    a = list(generate_stream(model, params, prompt, max_new_tokens=16,
                             eos_id=fake_eos))
    b = list(generate_stream(model, params, prompt, max_new_tokens=16,
                             eos_id=fake_eos, chunk=8))
    assert a == b
    assert len(a) < len(ref) and fake_eos not in a


def test_generate_batch_matches_single_stream():
    """Batched generation over ragged prompts (right-padded prefill +
    per-row cache offsets) reproduces each prompt's single-stream
    greedy continuation exactly, including per-row EOS stopping."""
    from a_nice_rag_tpu.models.decoder import generate_batch

    cfg, model, params = _setup()
    prompts = [list(range(10, 25)), [256, 40, 41], list(range(60, 90))]
    batch = generate_batch(model, params, prompts, max_new_tokens=21,
                           chunk=8)
    refs = [list(generate_stream(model, params, p, max_new_tokens=21))
            for p in prompts]
    assert batch == refs
    # Per-row EOS: row 0 stops early, the others run to the cap.
    e = refs[0][4]
    batch = generate_batch(model, params, prompts, max_new_tokens=21,
                           chunk=8, eos_id=e)
    refs = [list(generate_stream(model, params, p, max_new_tokens=21,
                                 eos_id=e)) for p in prompts]
    assert batch == refs
    assert len(batch[0]) == 4


def test_sample_logits_dynamic_matches_static():
    """Per-row runtime knobs (sample_logits_dynamic) must reproduce the
    static program's decision bit-for-bit when every row carries the
    same knobs, must take the argmax on greedy rows, and must respect
    each row's own truncation in a mixed batch."""
    from a_nice_rag_tpu.models.decoder import (
        sample_logits,
        sample_logits_dynamic,
        truncated_logits,
        truncated_logits_dynamic,
    )

    rng = np.random.default_rng(3)
    logits = jnp.asarray(rng.normal(size=(6, 64)).astype(np.float32))
    full = lambda v, dt: jnp.full((6,), v, dt)  # noqa: E731
    for t, k, p in [(0.0, 0, 0.0), (1.0, 0, 0.0), (0.7, 8, 0.0),
                    (1.3, 0, 0.9), (0.9, 16, 0.8)]:
        key = jax.random.PRNGKey(int(t * 100 + k))
        a = sample_logits(logits, key, t, k, p)
        b = sample_logits_dynamic(logits, key, full(t, jnp.float32),
                                  full(k, jnp.int32), full(p, jnp.float32))
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b)), (t, k, p)
        if t > 0:
            ta = truncated_logits(logits, t, k, p)
            tb = truncated_logits_dynamic(
                logits, full(t, jnp.float32), full(k, jnp.int32),
                full(p, jnp.float32))
            np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    # Mixed batch: row 0 greedy, row 1 top_k=1 (== argmax even when
    # sampled), row 2 tiny top_p (== argmax), row 3 top_k=4.
    temp = jnp.asarray([0.0, 1.0, 2.0, 1.5, 0.0, 1.0], jnp.float32)
    topk = jnp.asarray([0, 1, 0, 4, 0, 0], jnp.int32)
    topp = jnp.asarray([0.0, 0.0, 1e-6, 0.0, 0.0, 0.0], jnp.float32)
    am = np.asarray(jnp.argmax(logits, axis=-1))
    top4 = np.argsort(np.asarray(logits), axis=-1)[:, ::-1][:, :4]
    for s in range(30):
        out = np.asarray(sample_logits_dynamic(
            logits, jax.random.PRNGKey(s), temp, topk, topp))
        assert out[0] == am[0] and out[4] == am[4]  # greedy rows
        assert out[1] == am[1]                       # top_k=1 row
        assert out[2] == am[2]                       # tiny-nucleus row
        assert out[3] in top4[3]                     # top_k=4 row
