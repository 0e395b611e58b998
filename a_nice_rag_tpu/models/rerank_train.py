"""Train the on-device cross-encoder reranker on retrieval candidates.

The reference's best configuration is hybrid retrieval + the Voyage
rerank-2 API, lifting Recall@1 from 0.699 to 0.810 (reference
src/retrieval_eval.py:131-255; results/retrieval_evaluation_results.csv
rows 9-10). This module is the local analog: a listwise-trained
CrossEncoderReranker that drops into the same ``SearchEngine`` rerank
stage via ``OnDeviceReranker`` and demonstrably lifts R@1 over the
unreranked hybrid (tests/test_rerank_lift.py, the synthetic sweep).

Training objective: per query, softmax cross-entropy over the scores of
[gold ; K hard negatives] — exactly the decision the rerank stage makes
at serving time (order a small candidate pool), so the objective matches
deployment.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from a_nice_rag_tpu.models.encoder import EncoderConfig
from a_nice_rag_tpu.models.reranker import CrossEncoderReranker, OnDeviceReranker
from a_nice_rag_tpu.models.tokenizer import HashingTokenizer


@dataclass
class RerankTrainResult:
    reranker: OnDeviceReranker
    losses: List[float]
    holdout_accuracy: float  # gold-ranked-first rate on held-out lists


def train_cross_encoder_reranker(
    queries: Sequence[str],
    candidates: Sequence[Sequence[str]],  # per query: [gold, neg1..negK]
    cfg: Optional[EncoderConfig] = None,
    batch_size: int = 16,
    epochs: int = 4,
    lr: float = 1e-3,
    seed: int = 0,
    holdout_fraction: float = 0.15,
    tokenizer: Optional[HashingTokenizer] = None,
    use_match_features: bool = True,
) -> RerankTrainResult:
    """Listwise fine-tune; the gold candidate must be listed first.

    All candidate lists must share one length (static shapes keep the
    whole train step one compiled XLA program).
    """
    cfg = cfg or EncoderConfig(n_layers=2)
    tok = tokenizer or HashingTokenizer(vocab_size=cfg.vocab_size)
    model = CrossEncoderReranker(cfg, use_match_features=use_match_features)
    rng = np.random.default_rng(seed)

    n = len(queries)
    k = len(candidates[0])
    assert all(len(cs) == k for cs in candidates), "ragged candidate lists"
    flat_q = [q for q, cs in zip(queries, candidates) for _ in cs]
    flat_d = [d for cs in candidates for d in cs]
    ids = jnp.asarray(tok.encode_pairs(flat_q, flat_d)).reshape(n, k, -1)

    perm = rng.permutation(n)
    n_hold = max(1, int(n * holdout_fraction))
    hold, train = perm[:n_hold], perm[n_hold:]

    params = model.init(jax.random.PRNGKey(seed), ids[0, :1])
    optimizer = optax.adamw(lr)
    opt_state = optimizer.init(params)

    @jax.jit
    def step(params, opt_state, batch_ids):
        def loss_fn(p):
            b, kk, ln = batch_ids.shape
            logits = model.apply(p, batch_ids.reshape(b * kk, ln))
            logits = logits.reshape(b, kk)
            # Gold sits at slot 0 of every list.
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, jnp.zeros(b, jnp.int32)
            ).mean()

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses: List[float] = []
    for _ in range(epochs):
        order = rng.permutation(train)
        for i in range(0, len(order) - batch_size + 1, batch_size):
            b = jnp.asarray(order[i : i + batch_size])
            params, opt_state, loss = step(params, opt_state, ids[b])
            losses.append(float(loss))

    score = jax.jit(lambda p, x: model.apply(p, x))
    h = ids[jnp.asarray(hold)]
    logits = np.asarray(
        score(params, h.reshape(len(hold) * k, -1))
    ).reshape(len(hold), k)
    acc = float(np.mean(np.argmax(logits, axis=1) == 0))
    return RerankTrainResult(
        reranker=OnDeviceReranker(cfg, params, tok,
                                  use_match_features=use_match_features),
        losses=losses,
        holdout_accuracy=acc,
    )


def mine_candidates(
    query_texts: Sequence[str],
    gold_rows: Sequence[int],
    ranked_rows: np.ndarray,  # [Q, >=k] retrieval rows per query
    contents: Sequence[str],
    n_negatives: int = 7,
    seed: int = 0,
) -> Tuple[List[str], List[List[str]]]:
    """Build [gold ; hard negatives] training lists from retrieval output.

    Hard negatives are the retriever's own top-ranked non-gold documents
    — the exact confusions the rerank stage must fix at serving time.
    Short lists are topped up with random corpus rows.
    """
    rng = np.random.default_rng(seed)
    out_q: List[str] = []
    out_c: List[List[str]] = []
    n_docs = len(contents)
    for qi, (qt, g) in enumerate(zip(query_texts, gold_rows)):
        negs = [int(r) for r in ranked_rows[qi] if 0 <= r != g][:n_negatives]
        while len(negs) < n_negatives:
            r = int(rng.integers(0, n_docs))
            if r != g and r not in negs:
                negs.append(r)
        out_q.append(qt)
        out_c.append([contents[g]] + [contents[r] for r in negs])
    return out_q, out_c
