"""Fully-local pipeline: no SaaS anywhere — on-device encoder embeds the
corpus AND the queries, on-device cross-encoder reranks, fake LLM answers.
This is the configuration the reference cannot run at all (it requires
VoyageAI for both embedding and rerank)."""

import numpy as np

from a_nice_rag_tpu.config import InfoSource
from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.models import EncoderConfig, OnDeviceEmbedder, OnDeviceReranker
from a_nice_rag_tpu.rag import FakeLLMClient, RAGSystem
from a_nice_rag_tpu.text import preprocess_text


def test_fully_local_rag_pipeline():
    cfg = EncoderConfig(
        vocab_size=2048, dim=64, n_layers=2, n_heads=2, max_len=64,
        out_dim=64,
    )
    embedder = OnDeviceEmbedder(cfg)
    reranker = OnDeviceReranker(cfg)

    docs = [
        f"Guideline section {i} about condition {i % 7} and treatment {i % 5}"
        for i in range(60)
    ]
    ids = [f"NG{i % 9 + 1}_Section {i}" for i in range(60)]
    sources = [f"NG{i % 9 + 1}" for i in range(60)]
    emb = embedder.embed_documents(docs)
    index = build_index(
        ids=ids,
        sources=sources,
        contents=docs,
        embeddings={"voyage-3-large": emb},
        token_lists=[preprocess_text(d, True) for d in docs],
    )

    rag = RAGSystem(
        indexes={InfoSource.NICE: index},
        embedder=embedder,
        reranker=reranker,
        llm_clients={"fake": FakeLLMClient()},
    )
    query = "Guideline section 13 about condition 6 and treatment 3"
    # Without rerank: the encoder embeds identical text identically, so
    # the exact-match document must surface at the top of the fused list.
    chunks, s_data = [], []
    for chunk, _, _, s_data in rag.query_rag_stream(
        query, "fake-llm", use_hybrid_search=True, use_reranker=False,
    ):
        chunks.append(chunk)
    assert chunks and "".join(chunks)
    assert s_data[0]["section_id"] == "NG5_Section 13"

    # With the on-device cross-encoder: stage runs and truncates to top_k
    # (ordering is untrained-random here; training is models/train.py).
    _, s_data2 = [], []
    for chunk, _, _, s_data2 in rag.query_rag_stream(
        query, "fake-llm", use_hybrid_search=True, use_reranker=True,
        reranker_top_k=5,
    ):
        pass
    assert len(s_data2) == 5
    assert all(d["section_id"] for d in s_data2)
