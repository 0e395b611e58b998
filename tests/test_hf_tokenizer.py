"""HF tokenizer.json byte maps (models/hf_tokenizer.py) and guided
decoding lowered onto a MULTI-BYTE vocabulary: the constraint table is
built by walking each token's byte string, so a model whose tokens are
BPE pieces (not raw bytes) still can only emit grammar-valid byte
sequences.
"""

import json

import pytest

from a_nice_rag_tpu.models.constrain import (
    Constraint,
    compile_constraint,
    json_dfa,
)
from a_nice_rag_tpu.models.hf_tokenizer import (
    bytes_to_unicode,
    hf_token_bytes,
    load_token_bytes,
)

B2U = bytes_to_unicode()


def _tok_str(data: bytes) -> str:
    return "".join(B2U[b] for b in data)


def _fixture(vocab_bytes, specials=()):
    """Minimal ByteLevel-BPE tokenizer.json."""
    vocab = {_tok_str(b): i for i, b in vocab_bytes.items()}
    for tid, name in specials:
        vocab[name] = tid
    return {
        "pre_tokenizer": {"type": "ByteLevel"},
        "decoder": {"type": "ByteLevel"},
        "added_tokens": [
            {"id": tid, "content": name} for tid, name in specials
        ],
        "model": {"type": "BPE", "vocab": vocab},
    }


VOCAB = {
    10: b'{"',
    11: b'a"',
    12: b": ",
    13: b"1",
    14: b"23",
    15: b"}",
    16: b'"yes"',
    17: b" ",
    18: b"\xc3\xa9",  # multi-byte UTF-8 ('e' acute) as one token
    19: b'":',
}


def test_byte_map_roundtrip():
    tok = _fixture(VOCAB, specials=[(500, "<|im_end|>")])
    tb, specials = hf_token_bytes(tok)
    assert tb == VOCAB
    assert 500 in specials and 500 not in tb


def test_non_byte_level_rejected():
    tok = {"pre_tokenizer": {"type": "Metaspace"},
           "decoder": {"type": "Metaspace"},
           "model": {"type": "BPE", "vocab": {}}}
    with pytest.raises(NotImplementedError):
        hf_token_bytes(tok)


def test_load_from_dir(tmp_path):
    tok = _fixture(VOCAB)
    (tmp_path / "tokenizer.json").write_text(json.dumps(tok))
    tb, _ = load_token_bytes(str(tmp_path))
    assert tb[10] == b'{"'


def test_multibyte_guided_generation():
    """End to end: a model over a BPE-piece vocabulary, JSON-object
    constrained — the concatenated BYTES of the emitted token ids are
    always a live prefix of strict JSON, and parse on natural stop."""
    from a_nice_rag_tpu.models.decoder import (
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu.serving.genserver import GenerationServer

    eos = 257
    dfa = json_dfa(top_level="object")
    model, params = init_decoder(small_lm_config())
    con = compile_constraint(dfa, model.cfg.vocab_size, eos,
                             token_bytes=VOCAB, name="json_object")
    assert isinstance(con, Constraint)
    srv = GenerationServer(model, params, slots=2, max_len=96, chunk=4,
                           eos_id=eos, constraints={"json_object": con})
    try:
        for i in range(3):
            out = srv.complete([100 + i, 101], 16,
                               constraint="json_object",
                               temperature=1.0)
            data = b"".join(VOCAB[t] for t in out["tokens"])
            s = 0
            for b in data:
                s = int(dfa.next[s, b])
                assert s >= 0, (out["tokens"], data)
            if out["finish_reason"] == "stop":
                json.loads(data.decode())
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# HFTokenizer: exact encode + streaming decode for real fast-tokenizer
# checkpoints (a REAL trained ByteLevel BPE, not a hand-built fixture).
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def trained_tok_path(tmp_path_factory):
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    corpus = [
        "NICE recommends offering antibiotics for suspected sepsis.",
        "The committee agreed the evidence on café-au-lait spots.",
        "metformin 500 mg twice daily with meals — see section 1.3",
        "{\"dose\": 500, \"unit\": \"mg\", \"ok\": true}",
        "中文文本 and emoji \U0001f600 mixed content",
    ] * 50
    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=420,
        special_tokens=["<|endoftext|>", "<|im_end|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    tok.train_from_iterator(corpus, trainer)
    path = tmp_path_factory.mktemp("hftok") / "tokenizer.json"
    tok.save(str(path))
    return str(path)


TEXTS = [
    "offer antibiotics for sepsis",
    "café-au-lait — 500 mg",
    "{\"dose\": 500, \"ok\": true}",
    "中文 \U0001f600 tail",
]


def test_hf_tokenizer_encode_matches_runtime_and_roundtrips(
    trained_tok_path,
):
    from tokenizers import Tokenizer

    from a_nice_rag_tpu.models.hf_tokenizer import HFTokenizer

    hf = HFTokenizer(trained_tok_path)
    rt = Tokenizer.from_file(trained_tok_path)
    for text in TEXTS:
        ids = hf.encode(text)
        assert ids == list(rt.encode(text, add_special_tokens=False).ids)
        assert hf.decode(ids) == text  # byte-map decode is exact
        # Multi-token: BPE actually merged (not a byte fallback walk).
    assert len(hf.encode(TEXTS[0])) < len(TEXTS[0].encode("utf-8"))
    assert hf.vocab_size == rt.get_vocab_size(with_added_tokens=True)


def test_hf_stream_decoder_incremental_equals_full(trained_tok_path):
    """Feeding ids one at a time must concatenate to the full decode,
    even when a codepoint is split across BPE pieces; specials decode
    to ''."""
    from a_nice_rag_tpu.models.hf_tokenizer import HFTokenizer

    hf = HFTokenizer(trained_tok_path)
    for text in TEXTS:
        ids = hf.encode(text)
        dec = hf.stream_decoder()
        got = "".join(filter(None, (dec.feed(i) for i in ids)))
        got += dec.flush()
        assert got == text
    # Specials carry no bytes.
    dec = hf.stream_decoder()
    assert all(dec.feed(s) == "" for s in hf.specials)
    # A codepoint split across two ids buffers until complete: feed the
    # raw bytes of é via two single-byte tokens if present in the vocab.
    two = [i for i, b in hf.token_bytes.items() if b == b"\xc3"]
    cont = [i for i, b in hf.token_bytes.items() if b == b"\xa9"]
    if two and cont:
        dec = hf.stream_decoder()
        assert dec.feed(two[0]) == ""
        assert dec.feed(cont[0]) == "é"


def test_genserver_streams_text_through_hf_tokenizer(trained_tok_path):
    """stream_text(tokenizer=HFTokenizer) encodes the prompt with the
    checkpoint vocabulary and decodes the emitted ids through the byte
    map — token-for-token consistent with the raw id stream."""
    from a_nice_rag_tpu.models.decoder import (
        generate_stream,
        init_decoder,
        small_lm_config,
    )
    from a_nice_rag_tpu.models.hf_tokenizer import HFTokenizer
    from a_nice_rag_tpu.serving.genserver import GenerationServer

    hf = HFTokenizer(trained_tok_path)
    cfg = small_lm_config(vocab_size=hf.vocab_size)
    model, params = init_decoder(cfg)
    srv = GenerationServer(model, params, slots=2, max_len=128, chunk=4,
                           eos_id=0)
    try:
        prompt = "offer antibiotics for sepsis"
        text = "".join(srv.stream_text(prompt, max_new_tokens=10,
                                       tokenizer=hf))
        ids = list(generate_stream(model, params, hf.encode(prompt),
                                   max_new_tokens=10))
        assert text == hf.decode(ids)
    finally:
        srv.stop()


def test_chatml_rendering_lowers_onto_special_ids(tmp_path):
    """A tokenizer carrying <|im_start|>/<|im_end|> specials flips chat
    rendering to ChatML, and encoding the rendered prompt maps each
    marker to its single special id (instruct-checkpoint turn
    structure)."""
    tokenizers = pytest.importorskip("tokenizers")
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    from a_nice_rag_tpu.models.hf_tokenizer import (
        HFTokenizer,
        render_chatml,
        supports_chatml,
    )
    from a_nice_rag_tpu.serving.http_api import render_chat_messages

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        ["offer antibiotics for sepsis"] * 30,
        trainers.BpeTrainer(
            vocab_size=300,
            special_tokens=["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False,
        ),
    )
    path = tmp_path / "tokenizer.json"
    tok.save(str(path))
    hf = HFTokenizer(str(path))
    assert supports_chatml(hf)

    msgs = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "sepsis?"}]
    rendered = render_chat_messages(msgs, tokenizer=hf)
    assert rendered == render_chatml(msgs)
    ids = hf.encode(rendered)
    im_s, im_e = hf.token_to_id("<|im_start|>"), hf.token_to_id("<|im_end|>")
    assert ids.count(im_s) == 3 and ids.count(im_e) == 2
    # The prompt ends with an OPEN assistant turn: the last im_start
    # comes after the last im_end.
    last_s = len(ids) - 1 - ids[::-1].index(im_s)
    last_e = len(ids) - 1 - ids[::-1].index(im_e)
    assert ids[0] == im_s and last_s > last_e

    # Demo byte tokenizer (no specials): plain role-prefix template.
    from a_nice_rag_tpu.models.decoder import ByteTokenizer

    assert not supports_chatml(ByteTokenizer())
    plain = render_chat_messages(msgs, tokenizer=ByteTokenizer())
    assert plain.endswith("assistant: ") and "<|im_start|>" not in plain


def _train_marker_tok(tmp_path):
    from tokenizers import Tokenizer, decoders, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token=None))
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(
        ["offer antibiotics for sepsis"] * 30,
        trainers.BpeTrainer(
            vocab_size=300,
            special_tokens=["<|endoftext|>", "<|im_start|>", "<|im_end|>"],
            initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
            show_progress=False,
        ),
    )
    tok.save(str(tmp_path / "tokenizer.json"))


def test_supports_chatml_prefers_declared_chat_template(tmp_path):
    """The checkpoint's chat_template (tokenizer_config.json) — not
    marker presence in the vocab — decides the prompt format: Qwen BASE
    tokenizers carry <|im_start|>/<|im_end|> as specials without being
    instruction-trained on them."""
    pytest.importorskip("tokenizers")
    from a_nice_rag_tpu.models.hf_tokenizer import (
        HFTokenizer,
        supports_chatml,
    )

    _train_marker_tok(tmp_path)

    # No config at all: the marker heuristic applies.
    assert supports_chatml(HFTokenizer(str(tmp_path)))

    # A tokenizer_config.json WITHOUT chat_template = base checkpoint.
    cfg_p = tmp_path / "tokenizer_config.json"
    cfg_p.write_text(json.dumps({"model_max_length": 1024}))
    hf = HFTokenizer(str(tmp_path))
    assert hf.chat_template is None and not supports_chatml(hf)

    # Declared ChatML template wins.
    cfg_p.write_text(json.dumps(
        {"chat_template": "{% for m in messages %}<|im_start|>"
                          "{{ m.role }}\n{{ m.content }}<|im_end|>\n"
                          "{% endfor %}"}
    ))
    hf = HFTokenizer(str(tmp_path))
    assert "<|im_start|>" in hf.chat_template and supports_chatml(hf)

    # Declared NON-ChatML template: role markers exist in the vocab but
    # the checkpoint was trained on a different format -> plain.
    cfg_p.write_text(json.dumps(
        {"chat_template": "{% for m in messages %}[INST] {{ m.content }}"
                          " [/INST]{% endfor %}"}
    ))
    assert not supports_chatml(HFTokenizer(str(tmp_path)))

    # Explicit override (serve_cli --chat-template) beats everything.
    hf = HFTokenizer(str(tmp_path))
    hf.force_chatml = True
    assert supports_chatml(hf)
    cfg_p.unlink()
    hf = HFTokenizer(str(tmp_path))
    hf.force_chatml = False
    assert not supports_chatml(hf)


def test_local_client_truncation_preserves_chatml_ids(tmp_path):
    """rag/providers.LocalLLMClient must truncate long prompts at
    the ID level: a decode/re-encode round-trip strips the ChatML
    special ids (HFStreamDecoder renders specials as ''), silently
    destroying the turn structure. The ids handed to the decode path
    must keep the trailing open-assistant <|im_start|> marker."""
    pytest.importorskip("tokenizers")
    from a_nice_rag_tpu.models import decoder as decoder_mod
    from a_nice_rag_tpu.models.hf_tokenizer import HFTokenizer
    from a_nice_rag_tpu.rag.providers import LocalLLMClient

    _train_marker_tok(tmp_path)
    cfg_p = tmp_path / "tokenizer_config.json"
    cfg_p.write_text(json.dumps({"chat_template": "<|im_start|>chatml"}))
    hf = HFTokenizer(str(tmp_path))

    captured = {}
    orig = decoder_mod.generate_stream

    def fake_generate_stream(model, params, prompt_ids, **kw):
        captured["ids"] = list(prompt_ids)
        return iter([])

    decoder_mod.generate_stream = fake_generate_stream
    try:
        client = LocalLLMClient(None, None, tokenizer=hf,
                                   max_prompt_tokens=24)
        msgs = [{"role": "user",
                 "content": "offer antibiotics for sepsis " * 40}]
        list(client.stream_chat("local", msgs))
    finally:
        decoder_mod.generate_stream = orig

    ids = captured["ids"]
    assert len(ids) <= 24
    im_s = hf.token_to_id("<|im_start|>")
    im_e = hf.token_to_id("<|im_end|>")
    # The tail-kept window still carries the open assistant turn:
    # the final <|im_start|> survives AND comes after any <|im_end|>.
    assert im_s in ids
    last_s = len(ids) - 1 - ids[::-1].index(im_s)
    assert im_e not in ids or last_s > len(ids) - 1 - ids[::-1].index(im_e)
    # Round-trip: the window is EXACTLY the tail of the full encoding —
    # id-level truncation, no decode/re-encode drift (a re-encode strips
    # the specials, so equality here is the regression being pinned).
    from a_nice_rag_tpu.models.hf_tokenizer import render_chatml

    full = hf.encode(render_chatml(msgs))
    assert ids == full[-len(ids):]
