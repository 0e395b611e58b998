"""Faithful Qwen3 encoder (flax) + HuggingFace weight import.

The reference serves precomputed ``Qwen3-Embedding-0.6B`` vectors as one
of its four dense retrieval models (SURVEY.md §2.1; reference
src/query_rag_retrieval.py:38-111). This module makes that model family
runnable ON the device: a weight-exact flax reimplementation of the Qwen3
decoder stack (GQA, decoupled head_dim, per-head q/k RMSNorm, rope_theta
from config, SwiGLU MLP, causal attention) with last-token pooling and
L2 normalization as used by the Qwen3-Embedding models, plus a converter
from a HuggingFace ``Qwen3Model`` state dict.

Weights are converted once on host; inference is a single jitted
bfloat16 forward with float32 accumulation (every matmul is
[B*S, d] x [d, d']). Parity with the torch reference implementation
is pinned by tests/test_qwen3_parity.py on a locally-constructed
random-init model (the hermetic image cannot download the real
checkpoint; the mapping is architecture-complete either way).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    intermediate_size: int
    rope_theta: float = 1_000_000.0
    rms_eps: float = 1e-6
    dtype: Any = jnp.float32

    @classmethod
    def from_hf(cls, hf_config, dtype=jnp.float32) -> "Qwen3Config":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            num_kv_heads=hf_config.num_key_value_heads,
            head_dim=getattr(hf_config, "head_dim", None)
            or hf_config.hidden_size // hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            rope_theta=hf_config.rope_theta,
            rms_eps=hf_config.rms_norm_eps,
            dtype=dtype,
        )


class _RMSNorm(nn.Module):
    dim: int
    eps: float

    @nn.compact
    def __call__(self, x):
        scale = self.param("scale", nn.initializers.ones, (self.dim,))
        var = jnp.mean(
            jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True
        )
        y = x.astype(jnp.float32) * jax.lax.rsqrt(var + self.eps)
        return (y * scale.astype(jnp.float32)).astype(x.dtype)


def _rope(x: jax.Array, positions: jax.Array, theta: float) -> jax.Array:
    """HF rotate_half-convention RoPE. x: [B, S, H, D], positions [B, S]."""
    d = x.shape[-1]
    half = d // 2
    freqs = 1.0 / (
        theta ** (jnp.arange(half, dtype=jnp.float32) / half)
    )
    ang = positions[:, :, None].astype(jnp.float32) * freqs[None, None, :]
    cos = jnp.cos(ang)[:, :, None, :]
    sin = jnp.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    x1f, x2f = x1.astype(jnp.float32), x2.astype(jnp.float32)
    return jnp.concatenate(
        [x1f * cos - x2f * sin, x2f * cos + x1f * sin], axis=-1
    ).astype(x.dtype)


class _Qwen3Block(nn.Module):
    cfg: Qwen3Config

    @nn.compact
    def __call__(self, x, mask, positions):
        cfg = self.cfg
        hd, nh, nkv = cfg.head_dim, cfg.num_heads, cfg.num_kv_heads
        b, s, _ = x.shape

        h = _RMSNorm(cfg.hidden_size, cfg.rms_eps, name="input_norm")(x)
        q = nn.Dense(nh * hd, use_bias=False, dtype=cfg.dtype,
                     name="q_proj")(h).reshape(b, s, nh, hd)
        k = nn.Dense(nkv * hd, use_bias=False, dtype=cfg.dtype,
                     name="k_proj")(h).reshape(b, s, nkv, hd)
        v = nn.Dense(nkv * hd, use_bias=False, dtype=cfg.dtype,
                     name="v_proj")(h).reshape(b, s, nkv, hd)
        # Qwen3's per-head RMSNorm on q/k, applied BEFORE RoPE.
        q = _RMSNorm(hd, cfg.rms_eps, name="q_norm")(q)
        k = _RMSNorm(hd, cfg.rms_eps, name="k_norm")(k)
        q = _rope(q, positions, cfg.rope_theta)
        k = _rope(k, positions, cfg.rope_theta)
        # GQA: every kv head serves num_heads // num_kv_heads query
        # heads. The group axis folds into the query side so the k/v
        # tensors are never materialized repeated (identical per-head
        # dot products; see models/decoder._CachedBlock for the
        # measured decode cost of the repeat copies).
        rep = nh // nkv
        qg = q.reshape(b, s, nkv, rep, hd)
        attn = jnp.einsum(
            "bsnrd,bknd->bnrsk", qg, k, preferred_element_type=jnp.float32
        ) / np.sqrt(hd)  # [B, nkv, rep, s, s]
        causal = (
            jnp.arange(s)[None, :] <= jnp.arange(s)[:, None]
        )  # [q, k]
        keep = causal[None, None, None, :, :] & mask[:, None, None, None, :]
        attn = jnp.where(keep, attn, -1e30)
        attn = jax.nn.softmax(attn, axis=-1).astype(cfg.dtype)
        out = jnp.einsum("bnrsk,bknd->bsnrd", attn, v).reshape(b, s, nh * hd)
        x = x + nn.Dense(cfg.hidden_size, use_bias=False, dtype=cfg.dtype,
                         name="o_proj")(out)

        h = _RMSNorm(cfg.hidden_size, cfg.rms_eps, name="post_attn_norm")(x)
        gate = nn.Dense(cfg.intermediate_size, use_bias=False,
                        dtype=cfg.dtype, name="gate_proj")(h)
        up = nn.Dense(cfg.intermediate_size, use_bias=False,
                      dtype=cfg.dtype, name="up_proj")(h)
        x = x + nn.Dense(cfg.hidden_size, use_bias=False, dtype=cfg.dtype,
                         name="down_proj")(nn.silu(gate) * up)
        return x


class Qwen3Encoder(nn.Module):
    """Qwen3 decoder stack as an embedding encoder.

    pool: "last" (Qwen3-Embedding convention: the final non-padded
    token's hidden state), "mean" (masked mean), or "none" (full
    [B, S, H] hidden states). normalize L2-normalizes pooled outputs.
    """

    cfg: Qwen3Config
    pool: str = "last"
    normalize: bool = True

    @nn.compact
    def __call__(self, token_ids, mask=None):
        cfg = self.cfg
        if mask is None:
            mask = token_ids >= 0
        token_ids = jnp.maximum(token_ids, 0)
        x = nn.Embed(cfg.vocab_size, cfg.hidden_size, dtype=cfg.dtype,
                     name="embed")(token_ids)
        # Mask-aware positions: left- and right-padding both get
        # contiguous positions over real tokens (pass the same
        # position_ids to the HF reference for bit-parity).
        positions = jnp.maximum(
            jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1, 0
        )
        for i in range(cfg.num_layers):
            x = _Qwen3Block(cfg, name=f"layer_{i}")(x, mask, positions)
        x = _RMSNorm(cfg.hidden_size, cfg.rms_eps, name="final_norm")(x)
        if self.pool == "none":
            return x
        if self.pool == "mean":
            w = mask.astype(jnp.float32)[:, :, None]
            pooled = (x.astype(jnp.float32) * w).sum(1) / jnp.maximum(
                w.sum(1), 1.0
            )
        else:  # last non-padded token (left- or right-padding)
            last_col = mask.shape[1] - 1 - jnp.argmax(
                mask[:, ::-1].astype(jnp.int32), axis=-1
            )
            pooled = jnp.take_along_axis(
                x.astype(jnp.float32), last_col[:, None, None], axis=1
            )[:, 0]
        if self.normalize:
            pooled = pooled / jnp.linalg.norm(
                pooled, axis=-1, keepdims=True
            ).clip(1e-6)
        return pooled


def convert_hf_qwen3(
    state_dict: Dict[str, Any],
    cfg: Qwen3Config,
) -> Dict:
    """Map a HuggingFace Qwen3Model state dict to Qwen3Encoder params.

    Accepts tensors from either ``Qwen3Model`` (keys ``layers.N...``) or
    ``Qwen3ForCausalLM`` (keys ``model.layers.N...``). torch Linear
    stores [out, in]; flax Dense expects [in, out] — transposed here.
    """
    def g(key):
        for prefix in ("", "model."):
            if prefix + key in state_dict:
                t = state_dict[prefix + key]
                return np.asarray(
                    t.detach().cpu().numpy() if hasattr(t, "detach") else t
                )
        raise KeyError(key)

    def lin(key):
        return {"kernel": g(key + ".weight").T}

    def norm(key):
        return {"scale": g(key + ".weight")}

    params: Dict[str, Any] = {
        "embed": {"embedding": g("embed_tokens.weight")},
        "final_norm": norm("norm"),
    }
    for i in range(cfg.num_layers):
        p = f"layers.{i}."
        params[f"layer_{i}"] = {
            "input_norm": norm(p + "input_layernorm"),
            "q_proj": lin(p + "self_attn.q_proj"),
            "k_proj": lin(p + "self_attn.k_proj"),
            "v_proj": lin(p + "self_attn.v_proj"),
            "q_norm": norm(p + "self_attn.q_norm"),
            "k_norm": norm(p + "self_attn.k_norm"),
            "o_proj": lin(p + "self_attn.o_proj"),
            "post_attn_norm": norm(p + "post_attention_layernorm"),
            "gate_proj": lin(p + "mlp.gate_proj"),
            "up_proj": lin(p + "mlp.up_proj"),
            "down_proj": lin(p + "mlp.down_proj"),
        }
    return {"params": params}


def load_qwen3_checkpoint_dir(
    path: str,
    dtype=jnp.bfloat16,
    pool: str = "last",
) -> Tuple[Qwen3Config, "Qwen3Encoder", Dict]:
    """Load a Qwen3 checkpoint directory without instantiating torch.

    ``path`` is a HF-format directory: ``config.json`` plus one or more
    ``*.safetensors`` weight files (sharded checkpoints with a
    ``model.safetensors.index.json`` are handled by just reading every
    shard). Tensors are read straight into numpy (bf16 via ml_dtypes),
    so loading a multi-GB embedding model never materializes a torch
    module — the reference instead loads four SaaS/torch embedding
    models per process (reference src/query_rag_retrieval.py:38-111).

    Returns (cfg, flax module, params ready for ``module.apply``).
    """
    import glob
    import json as _json
    import os
    from types import SimpleNamespace

    from safetensors import numpy as _stn

    with open(os.path.join(path, "config.json"), "r", encoding="utf-8") as f:
        hf_cfg = SimpleNamespace(**_json.load(f))
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=dtype)
    state_dict: Dict[str, np.ndarray] = {}
    shards = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not shards:
        raise FileNotFoundError(f"no *.safetensors under {path}")
    for shard in shards:
        for key, arr in _stn.load_file(shard).items():
            # ml_dtypes bf16 arrays convert fine via np.asarray(float32)
            state_dict[key] = np.asarray(arr, dtype=np.float32)
    params = convert_hf_qwen3(state_dict, cfg)
    return cfg, Qwen3Encoder(cfg, pool=pool), params


def load_hf_qwen3_encoder(
    name: str = "Qwen/Qwen3-Embedding-0.6B",
    dtype=jnp.bfloat16,
    pool: str = "last",
) -> Tuple[Any, Qwen3Encoder, Dict]:
    """Load + convert a cached HF Qwen3 checkpoint for on-device inference.

    Returns (tokenizer, flax module, params). Requires the model in the
    local HF cache (hermetic environments cannot download).
    """
    from transformers import AutoConfig, AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(name, local_files_only=True)
    hf_cfg = AutoConfig.from_pretrained(name, local_files_only=True)
    model = AutoModel.from_pretrained(name, local_files_only=True)
    cfg = Qwen3Config.from_hf(hf_cfg, dtype=dtype)
    params = convert_hf_qwen3(model.state_dict(), cfg)
    return tok, Qwen3Encoder(cfg, pool=pool), params
