"""On-device model family: embedding encoder, cross-encoder reranker, and
their contrastive training loop.

The reference delegates embedding and reranking to SaaS APIs (VoyageAI,
OpenAI; src/search_engine.py:148-203). This package provides the
fully-local alternative: a flax transformer encoder producing unit-norm
embeddings (drop-in for the dense index), a cross-encoder scoring
(query, document) pairs for the rerank stage, a hashing tokenizer for
hermetic operation, and dp x tp sharded training steps.
"""

from a_nice_rag_tpu.models.encoder import (  # noqa: F401
    EncoderConfig,
    TransformerEncoder,
    init_encoder,
)
from a_nice_rag_tpu.models.reranker import (  # noqa: F401
    CrossEncoderReranker,
    OnDeviceReranker,
)
from a_nice_rag_tpu.models.tokenizer import HashingTokenizer  # noqa: F401
from a_nice_rag_tpu.models.train import (  # noqa: F401
    contrastive_loss,
    make_sharded_train_step,
    make_train_step,
)
from a_nice_rag_tpu.models.embedder import OnDeviceEmbedder  # noqa: F401
from a_nice_rag_tpu.models.nli import (  # noqa: F401
    NliScorer,
    nli_scorer_for_corpus,
    synth_nli_pairs,
    train_nli_scorer,
)
from a_nice_rag_tpu.models.moe import (  # noqa: F401
    MoEEncoderConfig,
    MoETransformerEncoder,
    init_moe_encoder,
    make_moe_train_step,
)
from a_nice_rag_tpu.models.pipeline import (  # noqa: F401
    make_pipeline_forward,
    make_pipeline_train_step,
    merge_pipeline_params,
    split_pipeline_params,
)
from a_nice_rag_tpu.models.rerank_train import (  # noqa: F401
    RerankTrainResult,
    mine_candidates,
    train_cross_encoder_reranker,
)
from a_nice_rag_tpu.models.qwen3 import (  # noqa: F401
    Qwen3Config,
    Qwen3Encoder,
    convert_hf_qwen3,
    load_hf_qwen3_encoder,
    load_qwen3_checkpoint_dir,
)
