"""Integration: serve CLI stack (index -> scheduler pool -> HTTP),
including the sharded + health-monitored path and live retriever swap."""

import json
import urllib.request

import jax
import numpy as np
import pytest

from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.serving.serve_cli import build_state, serve_state
from a_nice_rag_tpu.testing import synth_corpus


def _search(port, payload, expect_status=200):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/v1/search",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == expect_status
            return json.loads(resp.read())
    except urllib.error.HTTPError as e:
        assert e.code == expect_status, (e.code, expect_status)
        return json.loads(e.read())


def _get(port, path):
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{path}", timeout=30
    ) as resp:
        return json.loads(resp.read())


@pytest.fixture(scope="module")
def corpus_index():
    c = synth_corpus(n_docs=512, dim=32, n_queries=8, seed=21)
    idx = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                      embeddings=c.embeddings, token_lists=c.tokens)
    return c, idx


def test_serve_cli_single_device(corpus_index):
    c, idx = corpus_index
    state = build_state(idx, ("voyage-3-large",), use_bm25=True)
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        port = srv.server_address[1]
        assert _get(port, "/v1/health")["status"] == "ok"
        out = _search(port, {
            "query_embedding":
                c.query_embeddings["voyage-3-large"][0].tolist(),
            "terms": idx.pad_term_ids(c.query_tokens, 16)[0].tolist(),
        })
        assert out["results"][0]["id"] == c.gold_ids[0]
        stats = _get(port, "/v1/stats")
        served = sum(s["queries_served"]
                     for s in stats["schedulers"].values())
        assert served >= 1
    finally:
        srv.shutdown()


def test_serve_cli_sharded_with_health_swap(corpus_index):
    c, idx = corpus_index
    state = build_state(idx, ("voyage-3-large",), use_bm25=True, shards=4,
                        two_tier_common=8)
    # Inject a probe so the monitor sees device 3 die on demand.
    dead = set()
    state.monitor.probe_fn = lambda d, t: d not in dead
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        port = srv.server_address[1]
        q = {"query_embedding":
             c.query_embeddings["voyage-3-large"][0].tolist(),
             "terms": idx.pad_term_ids(c.query_tokens, 16)[0].tolist()}
        out = _search(port, q)
        assert out["results"][0]["id"] == c.gold_ids[0]
        # Kill a device; recovery swaps retriever + pool live.
        dead.add(jax.devices()[3])
        assert state.monitor.check_and_recover() is True
        assert state.retriever.sidx.n_shards == 3
        out2 = _search(port, q)
        assert out2["results"][0]["id"] == c.gold_ids[0]
        assert [r["id"] for r in out2["results"]] == \
               [r["id"] for r in out["results"]]
    finally:
        srv.shutdown()


def test_serve_cli_quantized_index(corpus_index):
    """The serve stack accepts an int8-quantized index (no f32 matrix
    kept) on both single-device and sharded paths."""
    c, _ = corpus_index
    idx_q = build_index(ids=c.ids, sources=c.sources, contents=c.contents,
                        embeddings=c.embeddings, token_lists=c.tokens,
                        quantize_dense=True)
    for shards in (1, 4):
        state = build_state(idx_q, ("voyage-3-large",), use_bm25=True,
                            shards=shards)
        srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                          port=0, background=True)
        try:
            port = srv.server_address[1]
            out = _search(port, {
                "query_embedding":
                    c.query_embeddings["voyage-3-large"][0].tolist(),
                "terms": idx_q.pad_term_ids(c.query_tokens, 16)[0].tolist(),
            })
            assert out["results"][0]["id"] == c.gold_ids[0]
        finally:
            srv.shutdown()


def test_serve_cli_ivf_nprobe(corpus_index):
    """nprobe>0 serves the IVF ANN route on both paths (building the
    layout at startup) and survives a device loss on the sharded path —
    reshard_surviving re-clusters and the retriever keeps its nprobe."""
    c, idx = corpus_index
    q = {"query_embedding":
         c.query_embeddings["voyage-3-large"][0].tolist(),
         "terms": idx.pad_term_ids(c.query_tokens, 16)[0].tolist()}
    # Single-device: attach_ivf at startup + FusedRetriever(nprobe=...).
    state = build_state(idx, ("voyage-3-large",), use_bm25=True, nprobe=8)
    assert idx.ivf and "voyage-3-large" in idx.ivf
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        out = _search(srv.server_address[1], q)
        assert out["results"][0]["id"] == c.gold_ids[0]
    finally:
        srv.shutdown()
    # Sharded: shard_ivf at startup + ShardedRetriever(nprobe=...).
    state = build_state(idx, ("voyage-3-large",), use_bm25=True, shards=4,
                        nprobe=8)
    assert state.retriever.use_ivf
    dead = set()
    state.monitor.probe_fn = lambda d, t: d not in dead
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        port = srv.server_address[1]
        out = _search(port, q)
        assert out["results"][0]["id"] == c.gold_ids[0]
        dead.add(jax.devices()[3])
        assert state.monitor.check_and_recover() is True
        assert state.retriever.sidx.n_shards == 3
        assert state.retriever.use_ivf
        out2 = _search(port, q)
        assert out2["results"][0]["id"] == c.gold_ids[0]
    finally:
        srv.shutdown()


def test_serve_cli_ivf_cache_roundtrip(corpus_index, tmp_path):
    """--ivf-cache persists the clustering at first startup and reuses
    it on the next (no k-means rerun: loaded layout arrays identical)."""
    import os

    c, idx = corpus_index
    cache = os.path.join(tmp_path, "ivf.npz")
    s1 = build_state(idx, ("voyage-3-large",), use_bm25=True, shards=4,
                     nprobe=8, ivf_cache=cache)
    assert os.path.exists(cache)
    s2 = build_state(idx, ("voyage-3-large",), use_bm25=True, shards=4,
                     nprobe=8, ivf_cache=cache)
    np.testing.assert_array_equal(
        np.asarray(s1.retriever.sidx.ivf_perm),
        np.asarray(s2.retriever.sidx.ivf_perm),
    )
    assert s2.retriever.use_ivf


def test_serve_cli_text_query_with_embedder():
    """Raw-text /v1/search: on-device embedder + index-vocab BM25 terms
    (the reference outsources this hop to the Voyage API,
    src/search_engine.py:148-159). Corpus embedded by the same model,
    so querying a document's own text must return that document."""
    import jax.numpy as jnp

    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.text.preprocess import preprocess_text

    contents = [
        f"guideline about condition {i} treatment plan alpha{i}"
        for i in range(64)
    ]
    emb_model = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=32, vocab_size=1024, n_heads=2,
        dtype=jnp.float32,
    ))
    doc_emb = np.asarray(
        emb_model.embed_documents(contents), np.float32
    )
    tokens = [preprocess_text(c, use_lemmatization=True) for c in contents]
    idx = build_index(
        ids=[f"id{i}" for i in range(64)],
        sources=["CG1"] * 64,
        contents=contents,
        embeddings={"local": doc_emb},
        token_lists=tokens,
        normalize=True,
    )
    state = build_state(idx, ("local",), use_bm25=True, embedder=emb_model)
    srv = serve_state(state, {"local": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        port = srv.server_address[1]
        out = _search(port, {"query": contents[7]})
        assert out["results"][0]["id"] == "id7"
        # Embedding-free server still requires a precomputed embedding.
        state.embedder = None
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/search",
            data=json.dumps({"query": "anything"}).encode(),
            headers={"Content-Type": "application/json"},
        )
        try:
            urllib.request.urlopen(req, timeout=30)
            raise AssertionError("expected HTTP 400")
        except urllib.error.HTTPError as e:
            assert e.code == 400
    finally:
        srv.shutdown()


def test_serve_cli_local_llm_surface(corpus_index):
    """--llm local equivalent: one port serves scheduler-batched
    /v1/search PLUS the RAG surface (/v1/rag via the on-device decoder
    through the continuous-batching GenerationServer) and raw
    /v1/generate completion, no SaaS anywhere."""
    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.serving.serve_cli import build_local_llm_api

    c, idx = corpus_index
    emb_dim = int(idx.dense_matrix("voyage-3-large").shape[1])
    embedder = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=emb_dim, vocab_size=1024, n_heads=2,
    ))
    state = build_state(idx, ("voyage-3-large",), use_bm25=True,
                        embedder=embedder)
    api = build_local_llm_api(idx, state, embedder, ("voyage-3-large",),
                              gen_slots=2, gen_chunk=4, gen_max_len=640)
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True, api=api)
    try:
        port = srv.server_address[1]
        # Scheduler-batched search still works on the same port.
        out = _search(port, {
            "query_embedding":
                c.query_embeddings["voyage-3-large"][0].tolist(),
            "terms": idx.pad_term_ids(c.query_tokens, 16)[0].tolist(),
        })
        assert out["results"][0]["id"] == c.gold_ids[0]
        # Raw completion over the continuous-batching server.
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({"prompt": "hello", "max_tokens": 8}).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            gen = json.loads(resp.read())
        assert isinstance(gen["text"], str)
        # Full RAG with the local decoder as the LLM.
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/rag",
            data=json.dumps({
                "query": "question 0", "llm_model": "local",
                "use_hybrid_search": True, "use_reranker": False,
            }).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=300) as resp:
            rag = json.loads(resp.read())
        assert "answer" in rag and isinstance(rag["sources"], list)
        # Browser UI delegated from the same port.
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/ui", timeout=30
        ) as resp:
            assert b"<html" in resp.read()[:200].lower()
        # /v1/stats merges scheduler counters with generation-server
        # counters (slots/tokens/cancellations) on the shared port.
        with urllib.request.urlopen(
            f"http://127.0.0.1:{port}/v1/stats", timeout=30
        ) as resp:
            stats = json.loads(resp.read())
        assert "schedulers" in stats
        g = stats["generation"]
        assert g["slots"] == 2 and g["tokens_emitted"] >= 8
        assert g["active"] == 0 and g["cancelled"] == 0
    finally:
        api.gen_server.stop()
        srv.shutdown()


def test_serve_cli_draft_ckpt_wiring(corpus_index, monkeypatch, tmp_path):
    """--draft-ckpt plumbs a draft model into the GenerationServer
    (speculative mode) and enforces vocab match with the target."""
    from a_nice_rag_tpu.models import qwen3 as qwen3_mod
    from a_nice_rag_tpu.models.decoder import (
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.serving.serve_cli import build_local_llm_api

    c, idx = corpus_index
    emb_dim = int(idx.dense_matrix("voyage-3-large").shape[1])
    embedder = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=emb_dim, vocab_size=1024, n_heads=2,
    ))
    state = build_state(idx, ("voyage-3-large",), use_bm25=True,
                        embedder=embedder)

    dcfg = small_lm_config(num_layers=1, hidden_size=64, num_heads=2,
                           num_kv_heads=1, head_dim=32,
                           intermediate_size=128)
    _, dparams = init_decoder(dcfg, seed=3)

    def fake_loader(path, **kw):
        assert path == "fake-draft-dir"
        return dcfg, None, dparams

    monkeypatch.setattr(qwen3_mod, "load_qwen3_checkpoint_dir",
                        fake_loader)
    api = build_local_llm_api(idx, state, embedder, ("voyage-3-large",),
                              gen_slots=2, gen_chunk=4, gen_max_len=640,
                              draft_ckpt="fake-draft-dir", gamma=3)
    gen = api.gen_server
    try:
        assert gen.draft is not None and gen.gamma == 3
        # The demo target and the draft share the byte vocab, so the
        # spec tick really decodes.
        text = "".join(gen.stream_text("hello", max_new_tokens=6))
        assert isinstance(text, str)
    finally:
        gen.stop()

    # Vocab mismatch is refused.
    bad_cfg = small_lm_config(vocab_size=512, num_layers=1,
                              hidden_size=64, num_heads=2,
                              num_kv_heads=1, head_dim=32,
                              intermediate_size=128)
    _, bad_params = init_decoder(bad_cfg, seed=4)
    monkeypatch.setattr(qwen3_mod, "load_qwen3_checkpoint_dir",
                        lambda path, **kw: (bad_cfg, None, bad_params))
    import pytest

    with pytest.raises(SystemExit):
        build_local_llm_api(idx, state, embedder, ("voyage-3-large",),
                            gen_slots=2, gen_chunk=4, gen_max_len=640,
                            draft_ckpt="fake-draft-dir")


def test_serve_cli_json_mode(corpus_index):
    """--json-mode registers JSON guided decoding: /v1/generate with
    response_format json_object returns text that starts a JSON object
    and (on natural stop) parses."""
    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.serving.serve_cli import build_local_llm_api

    c, idx = corpus_index
    emb_dim = int(idx.dense_matrix("voyage-3-large").shape[1])
    embedder = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=emb_dim, vocab_size=1024, n_heads=2,
    ))
    state = build_state(idx, ("voyage-3-large",), use_bm25=True,
                        embedder=embedder)
    api = build_local_llm_api(idx, state, embedder, ("voyage-3-large",),
                              gen_slots=2, gen_chunk=4, gen_max_len=640,
                              json_mode=True, json_depth=3)
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True, api=api)
    try:
        port = srv.server_address[1]
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/v1/generate",
            data=json.dumps({
                "prompt": "emit", "max_tokens": 16, "temperature": 1.0,
                "response_format": {"type": "json_object"},
            }).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=120) as resp:
            gen = json.loads(resp.read())
        assert gen["text"].lstrip(" \t\n\r")[:1] == "{"
        stats = api.gen_server.stats()
        assert set(stats["constraints"]) == {
            "json", "json_object", "json_array"
        }
    finally:
        api.gen_server.stop()
        srv.shutdown()


def test_serve_cli_json_mode_real_ckpt_tokenizer(corpus_index,
                                                 monkeypatch, tmp_path):
    """--json-mode with --llm-ckpt: the grammar is lowered onto the
    checkpoint's OWN tokenizer (multi-byte BPE pieces via
    tokenizer.json) and the server decodes to the checkpoint's
    eos_token_id, not the demo byte-tokenizer's."""
    from a_nice_rag_tpu.models import qwen3 as qwen3_mod
    from a_nice_rag_tpu.models.decoder import (
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.models.hf_tokenizer import bytes_to_unicode
    from a_nice_rag_tpu.serving.serve_cli import build_local_llm_api

    c, idx = corpus_index
    emb_dim = int(idx.dense_matrix("voyage-3-large").shape[1])
    embedder = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=emb_dim, vocab_size=1024, n_heads=2,
    ))
    state = build_state(idx, ("voyage-3-large",), use_bm25=True,
                        embedder=embedder)

    lcfg = small_lm_config()
    _, lparams = init_decoder(lcfg, seed=5)
    monkeypatch.setattr(qwen3_mod, "load_qwen3_checkpoint_dir",
                        lambda path, **kw: (lcfg, None, lparams))
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    (ckpt / "config.json").write_text(json.dumps(
        {"eos_token_id": 77}
    ))
    b2u = bytes_to_unicode()
    tok_str = lambda bs: "".join(b2u[b] for b in bs)  # noqa: E731
    pieces = {10: b'{"', 11: b'a"', 12: b": ", 13: b"1", 15: b"}",
              19: b'":'}
    (ckpt / "tokenizer.json").write_text(json.dumps({
        "pre_tokenizer": {"type": "ByteLevel"},
        "decoder": {"type": "ByteLevel"},
        "added_tokens": [],
        "model": {"type": "BPE",
                  "vocab": {tok_str(b): i for i, b in pieces.items()}},
    }))
    api = build_local_llm_api(idx, state, embedder, ("voyage-3-large",),
                              llm_ckpt=str(ckpt), gen_slots=2,
                              gen_chunk=4, gen_max_len=640,
                              json_mode=True, json_depth=3)
    gen = api.gen_server
    try:
        assert gen.eos_id == 77
        con = gen._cons[gen._cname_to_id["json_object"]]
        # Multi-byte lowering: the '{"' piece opens an object; raw
        # byte ids (not in the tokenizer) stay forbidden.
        assert con.table[0, 10] >= 0
        assert con.table[0, ord("{")] == -1
        assert con.table[0, 15] == -1  # can't open with '}'
    finally:
        gen.stop()


def test_serve_cli_real_ckpt_serves_with_hf_tokenizer(corpus_index,
                                                      monkeypatch,
                                                      tmp_path):
    """A checkpoint with a runtime-valid tokenizer.json is served with
    its OWN tokenizer everywhere: the ServingAPI generation endpoints
    and the RAG-local client encode prompts with the checkpoint
    vocabulary (not the demo byte tokenizer)."""
    pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    from a_nice_rag_tpu.models import qwen3 as qwen3_mod
    from a_nice_rag_tpu.models.decoder import init_decoder, small_lm_config
    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.models.hf_tokenizer import HFTokenizer
    from a_nice_rag_tpu.serving.serve_cli import build_local_llm_api

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        ["what dose of metformin does NICE recommend"] * 40,
        trainers.BpeTrainer(
            vocab_size=300, special_tokens=["<|endoftext|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False,
        ),
    )
    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    tok.save(str(ckpt / "tokenizer.json"))
    (ckpt / "config.json").write_text(json.dumps({"eos_token_id": 0}))

    lcfg = small_lm_config(
        vocab_size=tok.get_vocab_size(with_added_tokens=True)
    )
    _, lparams = init_decoder(lcfg, seed=5)
    monkeypatch.setattr(qwen3_mod, "load_qwen3_checkpoint_dir",
                        lambda path, **kw: (lcfg, None, lparams))

    c, idx = corpus_index
    emb_dim = int(idx.dense_matrix("voyage-3-large").shape[1])
    embedder = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=emb_dim, vocab_size=1024, n_heads=2,
    ))
    state = build_state(idx, ("voyage-3-large",), use_bm25=True,
                        embedder=embedder)
    api = build_local_llm_api(idx, state, embedder, ("voyage-3-large",),
                              llm_ckpt=str(ckpt), gen_slots=2,
                              gen_chunk=4, gen_max_len=256)
    try:
        assert isinstance(api.tokenizer, HFTokenizer)
        local = api.rag_system.llm_clients["local"]
        assert local.tokenizer is api.tokenizer
        # Generation encodes the prompt with the checkpoint vocabulary:
        # the submitted ids are BPE pieces, and the response decodes
        # through the byte map.
        out = api.generate({"prompt": "what dose of metformin",
                            "max_tokens": 4})
        assert isinstance(out["text"], str)
        ids = api.tokenizer.encode("what dose of metformin")
        assert all(i < lcfg.vocab_size for i in ids)
        assert len(ids) < len("what dose of metformin".encode())
    finally:
        api.gen_server.stop()


def test_serve_cli_batched_b64_search(corpus_index):
    """Batched RPC form of /v1/search: base64 f32 embeddings + i32
    terms, every row micro-batched through the scheduler, top ids per
    row (the form bench.py's served-QPS stage drives)."""
    import base64

    c, idx = corpus_index
    state = build_state(idx, ("voyage-3-large",), use_bm25=True)
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        port = srv.server_address[1]
        q = np.asarray(c.query_embeddings["voyage-3-large"][:8],
                       np.float32)
        terms = np.asarray(idx.pad_term_ids(c.query_tokens[:8], 16),
                           np.int32)
        out = _search(port, {
            "query_embeddings_b64":
                base64.b64encode(q.tobytes()).decode(),
            "shape": list(q.shape),
            "terms_b64": base64.b64encode(terms.tobytes()).decode(),
            "terms_shape": list(terms.shape),
        })
        rows = np.frombuffer(
            base64.b64decode(out["rows_b64"]), np.int32
        ).reshape(out["out_shape"])
        assert rows.shape[0] == 8
        hits = sum(
            c.gold_ids[b] in [idx.meta.ids[r] for r in rows[b] if r >= 0]
            for b in range(8)
        )
        assert hits >= 6, hits
    finally:
        srv.shutdown()


def test_serve_cli_batched_b64_search_bf16(corpus_index):
    """dtype="bf16" on the batched RPC: half-width rows ride the
    scheduler in bf16 end to end (the coalesced device buffer stays
    bf16 when all entries are bf16 — serving/scheduler.py), and the
    ranking matches the f32 form up to bf16 query rounding. A bad
    dtype gets a 400, not a decode crash."""
    import base64

    import ml_dtypes

    c, idx = corpus_index
    state = build_state(idx, ("voyage-3-large",), use_bm25=True)
    srv = serve_state(state, {"voyage-3-large": 5.0, "BM25": 1.0},
                      port=0, background=True)
    try:
        port = srv.server_address[1]
        qf = np.asarray(c.query_embeddings["voyage-3-large"][:8],
                        np.float32)
        qb = qf.astype(ml_dtypes.bfloat16)
        terms = np.asarray(idx.pad_term_ids(c.query_tokens[:8], 16),
                           np.int32)
        body = {
            "query_embeddings_b64":
                base64.b64encode(qb.tobytes()).decode(),
            "shape": list(qb.shape),
            "dtype": "bf16",
            "terms_b64": base64.b64encode(terms.tobytes()).decode(),
            "terms_shape": list(terms.shape),
        }
        out = _search(port, body)
        rows = np.frombuffer(
            base64.b64decode(out["rows_b64"]), np.int32
        ).reshape(out["out_shape"])
        assert rows.shape[0] == 8
        hits = sum(
            c.gold_ids[b] in [idx.meta.ids[r] for r in rows[b] if r >= 0]
            for b in range(8)
        )
        assert hits >= 6, hits
        bad = dict(body, dtype="f16")
        err = _search(port, bad, expect_status=400)
        assert "dtype" in err.get("error", "")
    finally:
        srv.shutdown()
