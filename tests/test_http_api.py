"""HTTP serving API: health/search/rag endpoints over a live server."""

import json
import urllib.error
import urllib.request

import numpy as np
import pytest

from a_nice_rag_tpu.config import InfoSource
from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.rag import FakeLLMClient, RAGSystem
from a_nice_rag_tpu.serving.http_api import serve
from a_nice_rag_tpu.testing import synth_corpus


@pytest.fixture(scope="module")
def server(tmp_path_factory):
    from a_nice_rag_tpu.serving.feedback import FeedbackLog

    c = synth_corpus(n_docs=120, dim=16, n_queries=4, seed=201)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents, urls=c.urls,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    rag = RAGSystem(
        indexes={InfoSource.NICE: idx},
        llm_clients={"fake": FakeLLMClient()},
    )
    fb = FeedbackLog(
        str(tmp_path_factory.mktemp("fb") / "query_feedback.json")
    )
    srv = serve(rag, port=0, background=True, feedback_log=fb)
    yield c, srv, srv.server_address[1], fb
    srv.shutdown()


def _post(port, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def test_health(server):
    c, srv, port, fb = server
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/v1/health", timeout=30
    ) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok"
    assert out["sources"]["nice"]["n_docs"] == 120
    assert out["sources"]["nice"]["bm25"] is True


def test_search_with_precomputed_embedding(server):
    c, srv, port, fb = server
    out = _post(port, "/v1/search", {
        "query": "anything",
        "query_embedding": c.query_embeddings["voyage-3-large"][0].tolist(),
        "model_weights": {"voyage-3-large": 1.0},
        "common_sections_n": 5,
    })
    assert len(out["results"]) == 5
    assert out["results"][0]["id"] == c.gold_ids[0]
    assert "document" in out["results"][0]


def test_rag_endpoint(server):
    c, srv, port, fb = server
    # No embedder configured -> search inside RAG falls back to BM25-less
    # dense skip; use hybrid BM25 via query text.
    out = _post(port, "/v1/rag", {
        "query": " ".join(c.query_tokens[1][:4]),
        "llm_model": "fake-llm",
        "model_weights": {"voyage-3-large": 0.0, "BM25": 1.0},
        "use_hybrid_search": True,
        "use_reranker": False,
    })
    assert out["answer"].startswith("[fake:fake-llm]")
    assert out["sources"]


def test_error_paths(server):
    c, srv, port, fb = server
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/search", {})
    assert e.value.code == 400
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/nope", {"x": 1})
    assert e.value.code == 404


class _GatedClient:
    """Streams a chunk, then blocks until the test releases the gate —
    proves SSE deltas reach the client BEFORE generation completes."""

    def __init__(self):
        import threading
        self.gate = threading.Event()
        self.finished = False
        self.aborted = False

    def stream_chat(self, model, messages, **params):
        try:
            yield "first-part "
            assert self.gate.wait(30), "test never released the gate"
            yield "second-part"
            self.finished = True
        except GeneratorExit:
            self.aborted = True
            raise


def _open_stream(port, payload, path="/v1/rag/stream"):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"},
    )
    return urllib.request.urlopen(req, timeout=30)


def _sse_events(fp):
    """Yield (event, data) pairs from an SSE byte stream, incrementally."""
    event = None
    for raw in fp:
        line = raw.decode().rstrip("\n")
        if line.startswith("event: "):
            event = line[len("event: "):]
        elif line.startswith("data: "):
            yield event, line[len("data: "):]
            event = None


@pytest.fixture()
def gated_server():
    c = synth_corpus(n_docs=60, dim=16, n_queries=2, seed=77)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents, urls=c.urls,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    client = _GatedClient()
    rag = RAGSystem(
        indexes={InfoSource.NICE: idx}, llm_clients={"fake": client},
    )
    srv = serve(rag, port=0, background=True)
    yield c, client, srv.server_address[1]
    srv.shutdown()


def test_rag_sse_streams_before_generation_completes(gated_server):
    c, client, port = gated_server
    resp = _open_stream(port, {
        "query": " ".join(c.query_tokens[0][:4]),
        "llm_model": "fake-llm",
        "model_weights": {"voyage-3-large": 0.0, "BM25": 1.0},
        "use_hybrid_search": True, "use_reranker": False,
    })
    assert resp.headers["Content-Type"] == "text/event-stream"
    events = _sse_events(resp)
    ev, data = next(events)
    assert ev == "sources" and json.loads(data)["sources"]
    ev, data = next(events)
    # First delta arrives while the generator is still gated: streaming.
    assert json.loads(data)["delta"] == "first-part "
    assert client.finished is False
    client.gate.set()
    rest = list(events)
    assert rest[-1][1] == "[DONE]"
    deltas = [json.loads(d)["delta"] for e, d in rest[:-1]]
    assert "second-part" in "".join(deltas)
    assert client.finished is True


def test_rag_sse_client_abandonment_aborts_generation(gated_server):
    import time
    c, client, port = gated_server
    resp = _open_stream(port, {
        "query": " ".join(c.query_tokens[0][:4]),
        "llm_model": "fake-llm",
        "model_weights": {"voyage-3-large": 0.0, "BM25": 1.0},
        "use_hybrid_search": True, "use_reranker": False,
        "stream": True,
    }, path="/v1/rag")
    events = _sse_events(resp)
    next(events)  # sources
    next(events)  # first delta
    resp.close()  # abandon mid-generation
    client.gate.set()  # let the generator hit the broken pipe
    for _ in range(100):
        if client.aborted or client.finished:
            break
        time.sleep(0.1)
    # The server must close the upstream generator instead of running
    # the LLM call to completion for a vanished client.
    assert client.aborted is True or client.finished is False


def test_ui_page_served(server):
    c, srv, port, fb = server
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/", timeout=30
    ) as resp:
        assert resp.headers["Content-Type"].startswith("text/html")
        html = resp.read().decode()
    assert "NICE Guidelines RAG" in html
    # Boot blob carries deployment config: fake client -> fake-llm option.
    boot = json.loads(
        html.split('<script id="boot" type="application/json">')[1]
        .split("</script>")[0]
    )
    assert boot["llm_options"] == ["fake-llm"]
    assert boot["suggested_queries"]
    assert boot["defaults"]["similarity_k"] == 15
    # The page drives the production endpoints.
    assert "v1/rag/stream" in html and "v1/feedback" in html
    # /ui is an alias.
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/ui", timeout=30
    ) as resp:
        assert resp.status == 200


def test_feedback_endpoint(server):
    c, srv, port, fb = server
    out = _post(port, "/v1/feedback", {
        "query": "what about hypertension?",
        "response": "answer text",
        "rating": "up",
        "llm_model": "fake-llm",
        "sources": [{"source": "NG136", "section_id": "NG136_x", "url": "u"}],
    })
    assert out["status"] == "recorded"
    entries = fb.entries()
    assert entries and entries[-1]["rating"] == "up"
    assert entries[-1]["query"] == "what about hypertension?"
    assert entries[-1]["sources"][0]["source"] == "NG136"
    with pytest.raises(urllib.error.HTTPError) as e:
        _post(port, "/v1/feedback", {"query": "q", "rating": "sideways"})
    assert e.value.code == 400


def test_stats_endpoint(server):
    """/v1/stats without a generation server reports just the status;
    the generation block appears only when a GenerationServer is
    mounted (covered in test_serve_cli)."""
    c, srv, port, fb = server
    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}/v1/stats", timeout=30
    ) as resp:
        out = json.loads(resp.read())
    assert out["status"] == "ok" and "generation" not in out


def test_generate_backpressure_maps_to_429():
    """ServerBusy from the generation server surfaces as HTTP 429."""
    import threading
    from http.server import ThreadingHTTPServer

    from a_nice_rag_tpu.serving.genserver import ServerBusy
    from a_nice_rag_tpu.serving.http_api import ServingAPI, _make_handler

    class _BusyServer:
        def stream_text(self, *a, **kw):
            raise ServerBusy("pending queue full (1); retry later")

    api = ServingAPI(None, gen_server=_BusyServer())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        try:
            _post(port, "/v1/generate", {"prompt": "x"})
            raise AssertionError("expected HTTP error")
        except urllib.error.HTTPError as e:
            assert e.code == 429
            assert "retry later" in json.loads(e.read())["error"]
    finally:
        httpd.shutdown()


def test_generate_payload_stop_plumbed():
    """'stop' (string or list) and 'stop_token_ids' payload keys reach
    GenerationServer.stream_text."""
    import threading
    from http.server import ThreadingHTTPServer

    from a_nice_rag_tpu.serving.http_api import ServingAPI, _make_handler

    seen = {}

    class _Recorder:
        def stream_text(self, prompt, max_new_tokens, **kw):
            seen.update(kw, prompt=prompt, max_new_tokens=max_new_tokens)
            yield "ok"

    api = ServingAPI(None, gen_server=_Recorder())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        out = _post(port, "/v1/generate", {
            "prompt": "x", "max_tokens": 7, "stop": "\n\n",
            "stop_token_ids": [5, 9], "temperature": 0.5,
        })
        assert out["text"] == "ok"
        assert seen["stop"] == ["\n\n"]
        assert seen["stop_token_ids"] == [5, 9]
        assert seen["temperature"] == 0.5 and seen["max_new_tokens"] == 7
    finally:
        httpd.shutdown()


def test_embeddings_endpoint():
    """OpenAI-compatible /v1/embeddings over the on-device embedder:
    unit-norm rows, list/string inputs, and a clear error without an
    embedder."""
    from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
    from a_nice_rag_tpu.models.encoder import EncoderConfig

    c = synth_corpus(n_docs=64, dim=16, n_queries=2, seed=77)
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents, urls=c.urls,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    emb = OnDeviceEmbedder(EncoderConfig(
        n_layers=1, dim=32, out_dim=16, vocab_size=512, n_heads=2,
    ))
    rag = RAGSystem(indexes={InfoSource.NICE: idx}, embedder=emb,
                    llm_clients={"fake": FakeLLMClient()})
    srv = serve(rag, port=0, background=True)
    try:
        port = srv.server_address[1]
        out = _post(port, "/v1/embeddings",
                    {"input": ["first query", "second query"]})
        assert out["object"] == "list" and len(out["data"]) == 2
        v0 = np.asarray(out["data"][0]["embedding"], np.float32)
        v1 = np.asarray(out["data"][1]["embedding"], np.float32)
        assert v0.shape == (16,)
        assert abs(float(np.linalg.norm(v0, axis=-1)) - 1.0) < 1e-3
        assert not np.allclose(v0, v1)
        # Single-string input; deterministic with the list form.
        one = _post(port, "/v1/embeddings", {"input": "first query"})
        assert np.allclose(
            np.asarray(one["data"][0]["embedding"], np.float32), v0
        )
    finally:
        srv.shutdown()
    # Without an embedder: 400 with a clear message.
    rag2 = RAGSystem(indexes={InfoSource.NICE: idx},
                     llm_clients={"fake": FakeLLMClient()})
    srv2 = serve(rag2, port=0, background=True)
    try:
        port2 = srv2.server_address[1]
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(port2, "/v1/embeddings", {"input": "x"})
        assert err.value.code == 400
    finally:
        srv2.shutdown()


def test_chat_completions_param_plumbing():
    """OpenAI chat payload knobs (max_completion_tokens, temperature,
    top_p, stop, response_format) reach the generation server; the
    response carries the chat.completion shape + usage accounting."""
    import threading
    from http.server import ThreadingHTTPServer

    from a_nice_rag_tpu.serving.http_api import ServingAPI, _make_handler

    seen = {}

    class _Recorder:
        def stream_text(self, prompt, max_new_tokens, **kw):
            seen.update(kw, prompt=prompt, max_new_tokens=max_new_tokens)
            yield "hi"

        def complete(self, prompt_ids, max_new_tokens, **kw):
            seen.update(kw, prompt_ids=prompt_ids,
                        max_new_tokens=max_new_tokens)
            return {"tokens": [104, 105], "logprobs": [0.0, 0.0],
                    "finish_reason": "length"}

    api = ServingAPI(None, gen_server=_Recorder())
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        msgs = [{"role": "system", "content": "be brief"},
                {"role": "user", "content": "hello"}]
        # complete() path: no string stop -> true finish_reason + usage.
        out = _post(port, "/v1/chat/completions", {
            "model": "local-demo", "messages": msgs,
            "max_completion_tokens": 9, "temperature": 0.25,
            "response_format": {"type": "json_object"},
        })
        assert out["object"] == "chat.completion"
        assert out["model"] == "local-demo"
        assert out["choices"][0]["message"] == {
            "role": "assistant", "content": "hi"}
        assert out["choices"][0]["finish_reason"] == "length"
        assert out["usage"]["completion_tokens"] == 2
        assert out["usage"]["total_tokens"] == (
            out["usage"]["prompt_tokens"] + 2)
        assert seen["max_new_tokens"] == 9
        assert seen["temperature"] == 0.25
        assert seen["constraint"] == "json_object"
        # The chat template is the LocalLLMClient one.
        from a_nice_rag_tpu.models.decoder import ByteTokenizer
        from a_nice_rag_tpu.serving.http_api import render_chat_messages

        assert seen["prompt_ids"] == ByteTokenizer().encode(
            render_chat_messages(msgs))
        # stop -> text-level stream aggregation path.
        out = _post(port, "/v1/chat/completions", {
            "messages": msgs, "stop": "\n", "top_p": 0.9, "max_tokens": 5,
        })
        assert out["choices"][0]["message"]["content"] == "hi"
        assert out["choices"][0]["finish_reason"] == "stop"
        assert seen["stop"] == ["\n"] and seen["top_p"] == 0.9
        assert seen["max_new_tokens"] == 5
        # Bad payloads -> 400.
        for bad in ({}, {"messages": []}, {"messages": [{"role": "u"}]}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(port, "/v1/chat/completions", bad)
            assert err.value.code == 400
    finally:
        httpd.shutdown()


def test_chat_completions_serves_own_provider_client():
    """The full local loop over the OpenAI wire protocol: the RAG
    layer's OpenAICompatClient pointed at this server streams from the
    on-device GenerationServer, both raw and through query_rag_stream
    (zero client changes vs the reference's SaaS providers)."""
    import threading
    from http.server import ThreadingHTTPServer

    from a_nice_rag_tpu.models.decoder import (
        generate_text_stream,
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu.rag.providers import OpenAICompatClient
    from a_nice_rag_tpu.serving.genserver import GenerationServer
    from a_nice_rag_tpu.serving.http_api import (
        ServingAPI,
        _make_handler,
        render_chat_messages,
    )

    model, params = init_decoder(small_lm_config())
    # max_len sized for the RAG prompt below (~3k byte tokens of system
    # prompt + retrieved sections) plus the decode budget.
    gsrv = GenerationServer(model, params, slots=2, max_len=4096, chunk=4)
    api = ServingAPI(None, gen_server=gsrv)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), _make_handler(api))
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    try:
        port = httpd.server_address[1]
        client = OpenAICompatClient(
            "local-key", base_url=f"http://127.0.0.1:{port}/v1/",
            timeout=120.0,
        )
        msgs = [{"role": "user", "content": "name one NICE guideline"}]
        got = "".join(client.stream_chat(
            "local", msgs, max_tokens=12, stream_options=None))
        want = "".join(generate_text_stream(
            model, params, render_chat_messages(msgs), max_new_tokens=12,
        ))
        assert got == want and got  # greedy-exact over the wire

        # And through the RAG pipeline: retrieval local, generation via
        # the OpenAI-protocol hop back into this same server.
        c = synth_corpus(n_docs=64, dim=16, n_queries=2, seed=31)
        idx = build_index(
            ids=c.ids, sources=c.sources, contents=c.contents, urls=c.urls,
            embeddings=c.embeddings, token_lists=c.tokens,
        )
        rag = RAGSystem(indexes={InfoSource.NICE: idx},
                        llm_clients={"openai": client})
        chunks, sources = [], None
        for chunk, _, _, sources in rag.query_rag_stream(
            " ".join(c.query_tokens[0][:4]), "gpt-4.1-mini",
            model_weights={"voyage-3-large": 0.0, "BM25": 1.0},
            use_hybrid_search=True, use_reranker=False,
            common_sections_n=3,
        ):
            chunks.append(chunk)
        assert "".join(chunks)  # generated text arrived over the wire
        assert sources  # retrieval ran locally
    finally:
        httpd.shutdown()
        gsrv.stop()
