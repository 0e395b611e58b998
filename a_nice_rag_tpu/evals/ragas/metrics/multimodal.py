"""Multimodal + local-NLI metric variants.

* MultiModalFaithfulness / MultiModalRelevance
  (ragas_modified/metrics/_multi_modal_*.py): judge the response against
  mixed text+image contexts. Image references are passed through to the
  judge as markdown links; a text-only judge sees the URLs (and can use
  captions/alt text), a multimodal judge can fetch them.
* FaithfulnesswithHHEM (_faithfulness.py:214): faithfulness with the NLI
  verdict stage replaced by a LOCAL hallucination-detection classifier
  instead of a judge-LLM call — here any callable
  ``(premise, hypothesis) -> score in [0,1]`` works, e.g. the on-device
  cross-encoder from a_nice_rag_tpu.models after NLI fine-tuning.
"""

from __future__ import annotations

from typing import Callable, ClassVar, List

import numpy as np
from pydantic import BaseModel, Field

from a_nice_rag_tpu.evals.ragas.dataset import SingleTurnSample
from a_nice_rag_tpu.evals.ragas.metrics.base import (
    MetricWithLLM,
    SingleTurnMetric,
)
from a_nice_rag_tpu.evals.ragas.metrics.faithfulness import (
    Faithfulness,
    StatementsIn,
)
from a_nice_rag_tpu.evals.ragas.prompt import StructuredPrompt


def _render_contexts(contexts: List[str]) -> str:
    """Render mixed contexts; image URLs become markdown image refs."""
    out = []
    for c in contexts:
        if c.startswith(("http://", "https://")) and c.rsplit(".", 1)[-1] in (
            "png", "jpg", "jpeg", "gif", "webp"
        ):
            out.append(f"![image]({c})")
        else:
            out.append(c)
    return "\n".join(out)


class MMJudgeIn(BaseModel):
    question: str
    context: str
    answer: str


class MMJudgeOut(BaseModel):
    reason: str
    verdict: int = Field(description="1 = yes, 0 = no")


class MMFaithfulnessPrompt(StructuredPrompt[MMJudgeIn, MMJudgeOut]):
    instruction = (
        "Is the answer faithful to the provided context (text and/or "
        "images)? Verdict 1 if every claim is supported, else 0."
    )
    input_model = MMJudgeIn
    output_model = MMJudgeOut
    examples = []


class MMRelevancePrompt(StructuredPrompt[MMJudgeIn, MMJudgeOut]):
    instruction = (
        "Is the answer relevant to the question given the provided "
        "context (text and/or images)? Verdict 1 or 0."
    )
    input_model = MMJudgeIn
    output_model = MMJudgeOut
    examples = []


class MultiModalFaithfulness(MetricWithLLM, SingleTurnMetric):
    name: ClassVar[str] = "faithful_rate"
    required_columns: ClassVar[set] = {
        "user_input", "response", "retrieved_contexts",
    }

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = MMFaithfulnessPrompt()

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        out = await self.prompt.generate(
            self.llm,
            MMJudgeIn(
                question=sample.user_input,
                context=_render_contexts(sample.retrieved_contexts),
                answer=sample.response,
            ),
        )
        return float(int(out.verdict))


class MultiModalRelevance(MultiModalFaithfulness):
    name: ClassVar[str] = "relevance_rate"

    def __init__(self, llm=None):
        self.llm = llm
        self.prompt = MMRelevancePrompt()


class FaithfulnesswithHHEM(Faithfulness):
    """Faithfulness with a local NLI scorer for the verdict stage."""

    name: ClassVar[str] = "faithfulness_with_hhem"

    def __init__(
        self,
        llm=None,
        nli_scorer: Callable[[str, str], float] = None,
        threshold: float = 0.5,
        per_context: bool = True,
    ):
        super().__init__(llm=llm)
        if nli_scorer is None:
            raise ValueError(
                "FaithfulnesswithHHEM needs nli_scorer(premise, hypothesis) "
                "-> [0,1]; e.g. an NLI-tuned "
                "a_nice_rag_tpu.models.OnDeviceReranker.score"
            )
        self.nli_scorer = nli_scorer
        self.threshold = threshold
        # per_context (default): a statement is supported iff SOME
        # retrieved chunk entails it (max over per-chunk scores). The
        # joined-premise form truncates at the local scorer's window —
        # chunks past ~2 vanish and their statements read as
        # hallucinated — and shifts off the scorer's single-document
        # training distribution (models/nli.synth_nli_pairs).
        self.per_context = per_context

    async def _single_turn_ascore(self, sample: SingleTurnSample) -> float:
        statements = (
            await self.statement_prompt.generate(
                self.llm,
                StatementsIn(
                    question=sample.user_input, answer=sample.response
                ),
            )
        ).statements
        if not statements:
            return float("nan")
        contexts = sample.retrieved_contexts or [""]
        batch = getattr(self.nli_scorer, "score_batch", None)
        if self.per_context:
            if batch is not None:
                # One model invocation for ALL (context, statement)
                # pairs: the pairwise python loop was len(statements) x
                # len(contexts) sequential batch-1 forwards (~10x the
                # joined-premise cost at 10 chunks).
                prem = [c for _ in statements for c in contexts]
                hyp = [s for s in statements for _ in contexts]
                scores = np.asarray(batch(prem, hyp)).reshape(
                    len(statements), len(contexts)
                )
                per_stmt = scores.max(axis=1)
            else:
                per_stmt = np.asarray([
                    max(self.nli_scorer(c, s) for c in contexts)
                    for s in statements
                ])
        else:
            premise = "\n".join(contexts)
            if batch is not None:
                per_stmt = np.asarray(
                    batch([premise] * len(statements), list(statements))
                )
            else:
                per_stmt = np.asarray(
                    [self.nli_scorer(premise, s) for s in statements]
                )
        supported = int((per_stmt >= self.threshold).sum())
        return supported / len(statements)
