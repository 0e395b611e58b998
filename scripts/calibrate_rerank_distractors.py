"""Calibrate add_hard_distractors + the lite-tier reranker capacity.

Goal: on the distractor-augmented synthetic
corpus the rerank benchmark must not saturate — rerank R@1 mid-range,
rerank-2 (full) > rerank-2-lite > unreranked hybrid, mirroring the
reference's tier separation (0.810 vs 0.779 vs 0.699).

Runs at CPU scale; prints a grid over (emb_cos, token_overlap).
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np

from a_nice_rag_tpu.evals.retrieval_eval import (
    STANDARD_CONFIGURATIONS,
    RetrievalEvaluator,
)
from a_nice_rag_tpu.index import build_index
from a_nice_rag_tpu.models.encoder import EncoderConfig
from a_nice_rag_tpu.models.rerank_train import (
    mine_candidates,
    train_cross_encoder_reranker,
)
from a_nice_rag_tpu.models.tokenizer import HashingTokenizer
from a_nice_rag_tpu.retrieval import MultiModelReranker, SearchEngine
from a_nice_rag_tpu.retrieval.rerank import IdentityReranker
from a_nice_rag_tpu.testing import (
    add_hard_distractors,
    calibrated_quality_corpus,
    calibrated_sample_queries,
)

HYBRID = STANDARD_CONFIGURATIONS[5]
LITE = STANDARD_CONFIGURATIONS[7]
FULL = STANDARD_CONFIGURATIONS[8]


def train_tier(c, idx, n_train, cfg, epochs, max_len, seed):
    gold, toks, q_emb, texts = calibrated_sample_queries(
        c, n_train, vocab_size=6000, seed=seed
    )
    engine = SearchEngine(idx, reranker=IdentityReranker())
    got = engine.retrieve(
        query_embeddings={"voyage-3-large": q_emb["voyage-3-large"]},
        query_texts=texts,
        query_token_lists=toks,
        similarity_k=25, common_sections_n=15, wrrf_k=40.0,
        model_weights={"voyage-3-large": 5.0, "BM25": 1.0},
        filename_type_filter=None,
        use_hybrid_search=True, use_reranker=False,
    )
    row_of = idx.meta.id_to_row
    ranked = np.full((n_train, 15), -1, np.int64)
    for i, ids_ in enumerate(got):
        for j, d in enumerate(ids_[:15]):
            ranked[i, j] = row_of.get(d, -1)
    qs, cands = mine_candidates(
        texts, list(gold), ranked, c.contents, n_negatives=5, seed=0
    )
    return train_cross_encoder_reranker(
        qs, cands, cfg=cfg, epochs=epochs, batch_size=32, seed=0,
        tokenizer=HashingTokenizer(vocab_size=cfg.vocab_size,
                                   max_len=max_len),
    )


def main():
    base = calibrated_quality_corpus(
        n_docs=1024, dim=128, n_queries=192, vocab_size=6000, seed=42
    )
    for emb_cos in (0.90, 0.95):
        for overlap in (0.65, 0.8):
            c = add_hard_distractors(
                base, n_per_gold=2, emb_cos=emb_cos,
                token_overlap=overlap,
            )
            idx = build_index(
                ids=c.ids, sources=c.sources, contents=c.contents,
                embeddings=c.embeddings, token_lists=c.tokens,
            )
            full_cfg = EncoderConfig(n_layers=2, dim=128, n_heads=4,
                                     max_len=96)
            lite_cfg = EncoderConfig(n_layers=1, dim=48, n_heads=2,
                                     max_len=48)
            full = train_tier(c, idx, 288, full_cfg, 2, 96, seed=99)
            lite = train_tier(c, idx, 288, lite_cfg, 1, 48, seed=99)
            rr = MultiModelReranker({
                "rerank-2": full.reranker,
                "rerank-2-lite": lite.reranker,
            })
            ev_b = RetrievalEvaluator(
                idx, SearchEngine(idx, reranker=IdentityReranker()))
            ev_r = RetrievalEvaluator(idx, SearchEngine(idx, reranker=rr))
            texts = c.texts()
            args = (c.query_embeddings, c.gold_ids, c.query_tokens,
                    texts, None)
            m_h = ev_b.evaluate_config(HYBRID, *args)
            m_l = ev_r.evaluate_config(LITE, *args)
            m_f = ev_r.evaluate_config(FULL, *args)
            print(
                f"cos={emb_cos} ov={overlap} "
                f"holdout full={full.holdout_accuracy:.3f} "
                f"lite={lite.holdout_accuracy:.3f} | R@1 "
                f"hybrid={m_h['recall@1']:.3f} "
                f"lite={m_l['recall@1']:.3f} "
                f"full={m_f['recall@1']:.3f} | R@10 "
                f"hybrid={m_h['recall@10']:.3f} "
                f"full={m_f['recall@10']:.3f}",
                flush=True,
            )


if __name__ == "__main__":
    main()
