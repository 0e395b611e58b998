"""Prove the local RAGAS faithfulness stack DISCRIMINATES (round-4
verdict weak #3): a grounded extractive responder vs a corrupted one
must separate cleanly under the fully-local judge pipeline.

The round-4 fully-local judged run
(results/ragas_evaluation_results_local_judge.csv) scored ~0.0 on both
metrics because the RAG LLM was a random-init byte LM emitting noise —
it proved the plumbing, not the measurement. This run fixes the
responder side and validates the measuring side:

* responder (a), GROUNDED: answers are sentences COPIED from the
  retrieved chunks — faithful by construction;
* responder (b), CORRUPTED: answers are sentences from UNRELATED
  chunks plus negation-corrupted in-context sentences — unfaithful by
  construction;
* judge stack: the reference's FaithfulnesswithHHEM metric
  (ragas_modified/metrics/_faithfulness.py:214 — faithfulness with a
  LOCAL NLI verdict stage instead of a judge-LLM NLI round-trip),
  backed by the on-device cross-encoder NLI scorer trained on this
  corpus (models/nli.py); statement extraction is deterministic
  sentence splitting (the statement prompt's contract on extractive
  answers is exactly sentence decomposition).

All 70 NICEQA questions run through the REAL RAG path
(RAGSystem.query_rag_stream -> retrieval -> responder), twice. The
pinned expectation (also tested at tests/test_judge_discrimination.py):
faithfulness(grounded) >= 0.8, faithfulness(corrupted) <= 0.3.

Writes results/ragas_local_judge_discrimination.csv.
"""
import csv
import functools
import os
import re
import sys
import time

print = functools.partial(print, flush=True)
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

NICEQA = "/root/reference/data/NICEQA.csv"


def sentenceify(tokens, words_per_sentence=9):
    """Token soup -> 'sentence'-structured text so sentence splitters
    and the NLI pair generator (models/nli._sentences) see real
    sentence boundaries."""
    out = []
    for i in range(0, len(tokens), words_per_sentence):
        out.append(" ".join(tokens[i:i + words_per_sentence]) + ".")
    return " ".join(out)


def context_sentences(messages):
    """Pull the chunk TEXTS out of the RAG user prompt and split them
    into sentences (the extractive responders' source material). Each
    chunk is rendered as 'Source Information: [...]\nContext: <text>'
    (rag/prompts.py) — only the text after each Context: marker is
    quotable; header lines glued into a "sentence" read as
    hallucinated to the NLI stage (measured: exactly 1 of 3 grounded
    statements unsupported -> faithfulness 0.676)."""
    user = messages[-1]["content"]
    out = []
    for seg in user.split("Context:")[1:]:
        seg = seg.split("Source Information", 1)[0].split("\n", 1)[0]
        out.extend(s.strip() for s in re.split(r"(?<=\.)\s+", seg)
                   if len(s.strip()) > 25)
    return out


def main() -> None:
    import jax

    if "--device" not in sys.argv:
        jax.config.update("jax_platforms", "cpu")

    from a_nice_rag_tpu.config import InfoSource
    from a_nice_rag_tpu.evals.ragas import EvaluationDataset, evaluate
    from a_nice_rag_tpu.evals.ragas.llm import FakeJudgeLLM
    from a_nice_rag_tpu.evals.ragas.metrics import FaithfulnesswithHHEM
    from a_nice_rag_tpu.evals.run_ragas_eval import (
        collect_rag_answers,
        load_niceqa_csv,
    )
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.models.encoder import EncoderConfig
    from a_nice_rag_tpu.models.nli import nli_scorer_for_corpus
    from a_nice_rag_tpu.rag import RAGSystem
    from a_nice_rag_tpu.rag.providers import FakeLLMClient
    from a_nice_rag_tpu.testing import calibrated_quality_corpus

    # The fake-judge statement responder: deterministic sentence split
    # (reused; the verdict stage below is the trained NLI model).
    from run_ragas_fake_judge import fake_judge_responder

    t0 = time.time()
    if os.path.exists(NICEQA):
        questions = [r["Question"] for r in load_niceqa_csv(NICEQA)]
        qa_source = "NICEQA.csv (70 real questions)"
    else:
        questions = [f"What does guidance section {i} recommend?"
                     for i in range(20)]
        qa_source = "synthetic fallback questions"
    print(f"questions: {len(questions)} from {qa_source}")

    c = calibrated_quality_corpus(
        n_docs=2048, dim=128, n_queries=8, vocab_size=8000, seed=42
    )
    contents = [sentenceify(t) for t in c.tokens]
    idx = build_index(
        ids=c.ids, sources=c.sources, contents=contents,
        embeddings=c.embeddings, token_lists=c.tokens, urls=c.urls,
    )

    rng = np.random.default_rng(17)

    def grounded_rag_llm(messages) -> str:
        sents = context_sentences(messages)
        return " ".join(sents[:3]) if sents else "No context."

    def corrupted_rag_llm(messages) -> str:
        # Sentences from unrelated chunks + a negation-corrupted
        # in-context sentence: the two hallucination modes the NLI
        # trainer plants (models/nli.synth_nli_pairs kinds 2-3).
        from a_nice_rag_tpu.models.nli import _negate, _sentences

        picks = []
        for _ in range(2):
            d = contents[int(rng.integers(0, len(contents)))]
            s = _sentences(d)
            if s:
                picks.append(s[int(rng.integers(0, len(s)))])
        ctx = context_sentences(messages)
        if ctx:
            picks.append(_negate(ctx[0], rng))
        return " ".join(picks) if picks else "Unrelated."

    class _HashEmbedder:
        model = "voyage-3-large"

        def embed_queries(self, texts):
            rows = [
                np.random.default_rng(abs(hash(t)) % (2**32))
                .standard_normal(128).astype(np.float32)
                for t in texts
            ]
            v = np.stack(rows)
            return v / np.linalg.norm(v, axis=-1, keepdims=True)

    print("training the NLI verdict model on the corpus "
          f"({time.time()-t0:.0f}s)...")
    nli = nli_scorer_for_corpus(
        contents[:512], n_pairs=1024, seed=0,
        cfg=EncoderConfig(n_layers=2, dim=128, max_len=256),
        epochs=6, batch_size=32,
    )
    print(f"NLI holdout AUC {nli.holdout_auc:.3f} "
          f"({time.time()-t0:.0f}s)")

    rows_out = []
    for label, responder in (("grounded", grounded_rag_llm),
                             ("corrupted", corrupted_rag_llm)):
        rag = RAGSystem(
            indexes={InfoSource.NICE: idx},
            embedder=_HashEmbedder(),
            llm_clients={"openai": FakeLLMClient(responder=responder)},
        )
        rows = collect_rag_answers(
            rag, questions, "gpt-4.1-mini", use_reranker=False
        )
        result = evaluate(
            EvaluationDataset.from_list(rows),
            [FaithfulnesswithHHEM(nli_scorer=nli.scorer)],
            llm=FakeJudgeLLM(fake_judge_responder),
            show_progress=False,
        )
        agg = result.aggregate()
        f = agg.get("faithfulness_with_hhem", float("nan"))
        print(f"{label}: faithfulness {f:.4f} ({time.time()-t0:.0f}s)")
        rows_out.append((label, f, len(rows)))

    g, b = rows_out[0][1], rows_out[1][1]
    assert g >= 0.8, f"grounded faithfulness {g:.3f} below 0.8"
    assert b <= 0.3, f"corrupted faithfulness {b:.3f} above 0.3"

    out = os.path.join(
        os.path.dirname(__file__), "..", "results",
        "ragas_local_judge_discrimination.csv",
    )
    with open(out, "w", newline="", encoding="utf-8") as fh:
        w = csv.writer(fh)
        w.writerow(["responder", "evaluation_stack", "n_questions",
                    "nli_holdout_auc", "faithfulness"])
        for label, f, n in rows_out:
            w.writerow([
                label,
                "FaithfulnesswithHHEM(on-device NLI cross-encoder) + "
                "sentence-split statements",
                n, f"{nli.holdout_auc:.3f}", f"{f:.4f}",
            ])
    print(f"wrote {os.path.normpath(out)} in {time.time()-t0:.1f}s; "
          f"separation {g:.3f} vs {b:.3f}")


if __name__ == "__main__":
    main()
