"""Run the full 9-configuration retrieval evaluation on a synthetic
corpus at reference scale.

The reference's quality CSVs (results/retrieval_evaluation_results.csv)
cannot be replayed bit-for-bit here — its embedding DBs and corpus
chunks are not in the mounted data — so this sweep demonstrates the
harness end-to-end on a calibrated synthetic corpus with the same shape
(~9.7k docs, four dense models, BM25) and the same nine configurations
(src/retrieval_eval.py:131-255 parity), seed-42 split, CSV append.

The corpus is augmented with HARD DISTRACTORS (two near-duplicates per
eval gold at embedding cosine ~0.9 / ~65% token overlap,
testing.add_hard_distractors) so rank fusion cannot saturate the task,
and the two reranker configurations run through on-device cross-encoders
of DIFFERENT capacity (models/reranker.py), listwise-trained on a
disjoint draw of queries with hard negatives mined from the hybrid
retriever's own top-k (models/rerank_train.py) — mirroring the
reference's structure where reranking lifts R@1 over unreranked hybrid
and the tiers separate (reference CSV rows 9-10: hybrid 0.699 ->
lite 0.779 -> full 0.810).

Writes results/retrieval_evaluation_results_synthetic.csv.
"""
import functools
import os
import sys

print = functools.partial(print, flush=True)

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def train_rerank_tiers(c, idx, engine, n_train=3072, seed=1234):
    """Train BOTH cross-encoder tiers on mined hard negatives (one
    fresh disjoint query draw, shared candidate lists)."""
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.models.rerank_train import (
        mine_candidates, train_cross_encoder_reranker,
    )
    from a_nice_rag_tpu.models.tokenizer import HashingTokenizer
    from a_nice_rag_tpu.retrieval import MultiModelReranker
    from a_nice_rag_tpu.testing import calibrated_sample_queries

    tr_gold, tr_toks, tr_qe, tr_texts = calibrated_sample_queries(
        c, n_train, seed=seed)
    got = engine.retrieve(
        query_embeddings={"voyage-3-large": tr_qe["voyage-3-large"]},
        query_texts=tr_texts,
        query_token_lists=tr_toks,
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
    qs, cands = mine_candidates(tr_texts, list(tr_gold), ranked,
                                c.contents, n_negatives=7, seed=0)
    # Capacities calibrated at CPU scale
    # (scripts/calibrate_rerank_distractors.py): the lite tier at half
    # the width/window lands between unreranked hybrid and the full
    # tier, the reference's row 9-10 structure.
    full_cfg = EncoderConfig(n_layers=2, dim=128, n_heads=4, max_len=96)
    lite_cfg = EncoderConfig(n_layers=1, dim=64, n_heads=2, max_len=64)
    tiers = {}
    for name, cfg, epochs in (("rerank-2", full_cfg, 3),
                              ("rerank-2-lite", lite_cfg, 2)):
        res = train_cross_encoder_reranker(
            qs, cands, cfg=cfg, epochs=epochs, batch_size=32, seed=0,
            tokenizer=HashingTokenizer(vocab_size=cfg.vocab_size,
                                       max_len=cfg.max_len),
        )
        print(f"{name} holdout gold-first acc: "
              f"{res.holdout_accuracy:.3f}")
        tiers[name] = res.reranker
    return MultiModelReranker(tiers, default="rerank-2")


def main() -> None:
    import jax

    # Quality numbers do not depend on the platform; --cpu runs them on
    # the CPU backend.
    if "--cpu" in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from a_nice_rag_tpu.evals.retrieval_eval import (
        STANDARD_CONFIGURATIONS,
        RetrievalEvaluator,
        seed42_split,
    )
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.retrieval import SearchEngine
    from a_nice_rag_tpu.retrieval.rerank import IdentityReranker
    from a_nice_rag_tpu.testing import calibrated_quality_corpus

    print("platform:", jax.devices()[0].platform)
    models = [
        "voyage-3-large", "voyage-3.5", "text-embedding-3-large", "Qwen3",
    ]
    # Calibrated per-model noise reproduces the reference's qualitative
    # quality structure (dense spread, dense > BM25, fusion lifts,
    # rerank lifts R@1) — see testing.synth.REFERENCE_QUALITY_NOISE and
    # tests/test_quality_gate.py.
    from a_nice_rag_tpu.testing import add_hard_distractors

    base = calibrated_quality_corpus(
        n_docs=9728, dim=256, n_queries=2048, vocab_size=20000, seed=42,
    )
    c = add_hard_distractors(
        base, n_per_gold=2, emb_cos=0.90, token_overlap=0.65,
    )
    print(f"corpus: {len(base.ids)} base + "
          f"{len(c.ids) - len(base.ids)} distractor docs")
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=c.contents,
        embeddings=c.embeddings, token_lists=c.tokens,
    )
    mine_engine = SearchEngine(idx, reranker=IdentityReranker())
    reranker = train_rerank_tiers(c, idx, mine_engine)
    ev = RetrievalEvaluator(idx, SearchEngine(idx, reranker=reranker))
    # The reference evaluates the LARGER seed-42 partition
    # (src/retrieval_eval.py:273-274, :338).
    eval_idx, _ = seed42_split(len(c.gold_ids))
    q_embs = {m: c.query_embeddings[m][eval_idx] for m in models}
    gold = [c.gold_ids[i] for i in eval_idx]
    tokens = [c.query_tokens[i] for i in eval_idx]
    all_texts = c.texts()
    texts = [all_texts[i] for i in eval_idx]

    out = os.path.join(
        os.path.dirname(__file__), "..", "results",
        "retrieval_evaluation_results_synthetic.csv",
    )
    results = ev.run(
        STANDARD_CONFIGURATIONS,
        q_embs,
        gold,
        query_token_lists=tokens,
        query_texts=texts,
        filename_type_filter=None,
        output_csv=out,
    )
    for name, m in results.items():
        print(f"{name:45s} MRR={m['mrr']:.3f} R@1={m['recall@1']:.3f} "
              f"R@10={m['recall@10']:.3f}")


if __name__ == "__main__":
    main()
