"""Fully-local RAG: no SaaS anywhere (no API keys, no network).

The reference needs three external services per query — Voyage for
query embedding, Voyage for rerank, an LLM API for generation
(reference src/query_rag.py:263-527). This example runs the whole loop
on device:

  corpus -> on-device embedder (models/embedder.py)
         -> hybrid dense+BM25 retrieval (fused device program)
         -> on-device cross-encoder reranker (models/reranker.py route
            via IdentityReranker here for speed)
         -> on-device decoder LM generation, streamed
            (models/decoder.py, KV-cache decode)

The demo LM is trained in-process for a few seconds to give non-random
text; swap in converted Qwen3 weights (models/qwen3.convert_hf_qwen3)
for real quality. Run on a CPU-only machine with:

    python examples/fully_local_rag.py --cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from a_nice_rag_tpu.config import InfoSource
from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.models.decoder import (
    ByteTokenizer,
    init_decoder,
    small_lm_config,
    train_lm_steps,
)
from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder
from a_nice_rag_tpu.models.encoder import EncoderConfig
from a_nice_rag_tpu.rag.providers import LocalLLMClient
from a_nice_rag_tpu.rag.system import RAGSystem
from a_nice_rag_tpu.retrieval.rerank import IdentityReranker
from a_nice_rag_tpu.text.preprocess import preprocess_text

# --- 1. a tiny corpus, embedded on device ---------------------------------
contents = [
    f"Guideline NG{i}: for condition {i} give medication m{i} "
    f"at {5 * (i + 1)} mg daily and review after {i + 2} weeks."
    for i in range(48)
]
embedder = OnDeviceEmbedder(EncoderConfig(
    n_layers=1, dim=64, out_dim=64, vocab_size=4096, n_heads=2,
    dtype=jnp.float32,
))
doc_emb = np.asarray(embedder.embed_documents(contents), np.float32)
index = build_index(
    ids=[f"NG{i}_s1" for i in range(48)],
    sources=[f"NG{i}" for i in range(48)],
    contents=contents,
    embeddings={"local-embedder": doc_emb},
    token_lists=[preprocess_text(c, use_lemmatization=True)
                 for c in contents],
    normalize=True,
)

# --- 2. a tiny LM, fitted in-process so the demo streams real text --------
tok = ByteTokenizer()
answer_style = "give medication as prescribed and review. "
cfg = small_lm_config(hidden_size=96)
ids = tok.encode(answer_style * 6)
lm, lm_params = init_decoder(cfg, seed=0, max_len=2048)
lm_params, losses = train_lm_steps(
    lm, lm_params, jnp.asarray(ids, jnp.int32)[None, :], n_steps=120
)
print(f"demo LM fitted: loss {losses[0]:.2f} -> {losses[-1]:.4f}")

# --- 3. wire the RAG system with only local components --------------------
system = RAGSystem(
    indexes={InfoSource.NICE: index},
    embedder=embedder,
    reranker=IdentityReranker(),
    llm_clients={"local": LocalLLMClient(lm, lm_params,
                                            max_new_tokens=48,
                                            max_prompt_tokens=768)},
)

question = contents[7].split(":")[1].strip()
print(f"\nQ: {question}\n")
answer, sources = [], None
for delta, sources, _, s_data in system.query_rag_stream(
    question, "local",
    model_weights={"local-embedder": 5.0, "BM25": 1.0},
    use_hybrid_search=True,
):
    answer.append(delta)
    print(delta, end="", flush=True)
print("\n\nretrieved sources:")
print(sources)
gold = "NG7_s1"
got = [d["section_id"] for d in s_data]
print(f"\ngold section {gold} retrieved: {gold in got}")
assert gold in got
