"""Runnable end-to-end quickstart (no accelerator or API keys required).

Builds a synthetic corpus, indexes it, runs hybrid retrieval through
every API level (engine, fused program, sharded mesh, RAG stream, HTTP
server), and prints what it found. On a CPU-only machine run with:

    python examples/quickstart.py --cpu
"""

import argparse
import json
import os
import sys
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

parser = argparse.ArgumentParser()
parser.add_argument("--cpu", action="store_true",
                    help="force an 8-device virtual CPU mesh")
args = parser.parse_args()

import jax

if args.cpu:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", 8)

from a_nice_rag_tpu.config import InfoSource
from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.parallel import make_mesh, shard_index
from a_nice_rag_tpu.parallel.sharded import ShardedRetriever
from a_nice_rag_tpu.rag import FakeLLMClient, RAGSystem
from a_nice_rag_tpu.retrieval import FusedRetriever, SearchEngine
from a_nice_rag_tpu.retrieval.embed import PrecomputedEmbedder
from a_nice_rag_tpu.serving.http_api import serve
from a_nice_rag_tpu.testing import synth_corpus

print(f"devices: {jax.devices()}")

# 1. Build the index (synthetic corpus; swap in your chunks/embeddings).
c = synth_corpus(n_docs=1000, dim=256, n_queries=4, seed=1)
index = build_index(
    ids=c.ids, sources=c.sources, contents=c.contents, urls=c.urls,
    embeddings=c.embeddings, token_lists=c.tokens,
)
print(f"indexed {index.n_docs} docs, vocab {len(index.vocab)}")

# 2. Engine-level hybrid retrieval.
engine = SearchEngine(index)
ids = engine.retrieve(
    query_embeddings={"voyage-3-large": c.query_embeddings["voyage-3-large"]},
    query_token_lists=c.query_tokens,
    model_weights={"voyage-3-large": 5.0, "BM25": 1.0},
    use_hybrid_search=True,
)
print(f"engine: gold ranked #1 for q0: {ids[0][0] == c.gold_ids[0]}")

# 3. One-XLA-program fused path.
fr = FusedRetriever(index, ("voyage-3-large",), use_bm25=True)
terms = index.pad_term_ids(c.query_tokens, 32)
fids, fvals, _ = fr(
    {"voyage-3-large": c.query_embeddings["voyage-3-large"]},
    terms, {"voyage-3-large": 5.0, "BM25": 1.0},
)
print(f"fused: top doc q0 = {index.meta.ids[fids[0, 0]]}")

# 4. Mesh-sharded (corpus split over devices, ICI merge).
n_dev = len(jax.devices())
mesh = make_mesh(shape=(1, n_dev), axis_names=("dp", "corpus"))
sidx = shard_index(index, mesh)
sr = ShardedRetriever(sidx, ("voyage-3-large",), use_bm25=True)
_, s_ids = sr(
    {"voyage-3-large": c.query_embeddings["voyage-3-large"]},
    terms, {"voyage-3-large": 5.0, "BM25": 1.0},
)
print(f"sharded over {sidx.n_shards} shards: same top doc: "
      f"{s_ids[0, 0] == fids[0, 0]}")

# 5. Streaming RAG (offline fake LLM; set OPENAI_API_KEY etc. for real).
query = "What does the guideline say?"
rag = RAGSystem(
    indexes={InfoSource.NICE: index},
    embedder=PrecomputedEmbedder(
        {query: c.query_embeddings["voyage-3-large"][0]}
    ),
    llm_clients={"fake": FakeLLMClient()},
)
answer = "".join(
    chunk for chunk, *_ in rag.query_rag_stream(query, "fake-llm",
                                                use_hybrid_search=True)
)
print(f"rag: {answer[:60]}...")

# 6. HTTP API.
server = serve(rag, port=0, background=True)
port = server.server_address[1]
req = urllib.request.Request(
    f"http://127.0.0.1:{port}/v1/search",
    data=json.dumps({
        "query": query,
        "query_embedding": c.query_embeddings["voyage-3-large"][0].tolist(),
        "model_weights": {"voyage-3-large": 1.0},
    }).encode(),
    headers={"Content-Type": "application/json"},
)
with urllib.request.urlopen(req, timeout=30) as resp:
    out = json.loads(resp.read())
print(f"http: /v1/search returned {len(out['results'])} results")
server.shutdown()

# 7. Online index updates: O(1) tombstone deletes, frozen-stats appends.
from a_nice_rag_tpu.index import append_documents, delete_documents

delete_documents(index, [c.ids[0]])
index2 = append_documents(
    index,
    ["new_doc"], ["NG999"], ["a brand new guideline chunk"],
    {"voyage-3-large": c.embeddings["voyage-3-large"][:1]},
    token_lists=[c.tokens[0]],
)
print(f"updates: deleted 1, appended 1 -> {index2.meta.n_docs} docs")
print("quickstart OK")
