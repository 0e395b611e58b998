"""Flax transformer embedding encoder.

A compact Qwen3-embedding-style architecture: token embedding, rotary
position encoding, pre-RMSNorm attention/SwiGLU blocks, masked mean
pooling, and L2 normalization — so its outputs plug directly into the
dense index (unit-norm dot product = cosine). All matmuls have
dims that are multiples of 128 by default and run in bfloat16 with
float32 accumulation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int = 32768
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512
    out_dim: int = 256
    dtype: Any = jnp.bfloat16


def _rope(x: jax.Array, positions: jax.Array) -> jax.Array:
    """Rotary position embedding over the last dim (pairs)."""
    b, s, h, d = x.shape
    half = d // 2
    freqs = 1.0 / (10000 ** (jnp.arange(half, dtype=jnp.float32) / half))
    angles = positions[:, :, None].astype(jnp.float32) * freqs[None, None, :]
    cos = jnp.cos(angles)[:, :, None, :]
    sin = jnp.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return jnp.concatenate(
        [x1 * cos - x2 * sin, x2 * cos + x1 * sin], axis=-1
    ).astype(x.dtype)


class RMSNorm(nn.Module):
    dim: int

    @nn.compact
    def __call__(self, x):
        scale = self.param("scale", nn.initializers.ones, (self.dim,))
        var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
        return (x * jax.lax.rsqrt(var + 1e-6)).astype(x.dtype) * scale


def attention_sublayer(cfg, x, mask, positions):
    """Pre-norm multi-head attention + residual.

    Must be called inside an ``nn.compact`` ``__call__``; submodule
    creation order (RMSNorm, qkv Dense, proj Dense) fixes the parameter
    names, shared by the dense Block and the MoE block so the attention
    numerics live in exactly one place.
    """
    head_dim = cfg.dim // cfg.n_heads
    h = RMSNorm(cfg.dim)(x)
    qkv = nn.Dense(3 * cfg.dim, use_bias=False, dtype=cfg.dtype)(h)
    q, k, v = jnp.split(qkv, 3, axis=-1)
    b, s, _ = q.shape
    q = _rope(q.reshape(b, s, cfg.n_heads, head_dim), positions)
    k = _rope(k.reshape(b, s, cfg.n_heads, head_dim), positions)
    v = v.reshape(b, s, cfg.n_heads, head_dim)
    attn = jnp.einsum(
        "bqhd,bkhd->bhqk", q, k, preferred_element_type=jnp.float32
    ) / jnp.sqrt(head_dim)
    attn = jnp.where(mask[:, None, None, :], attn, -1e30)
    attn = jax.nn.softmax(attn, axis=-1).astype(cfg.dtype)
    out = jnp.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, s, cfg.dim)
    return x + nn.Dense(cfg.dim, use_bias=False, dtype=cfg.dtype)(out)


def pooled_projection(cfg, x, mask):
    """Final RMSNorm + masked mean pool + projection + L2 normalize
    (shared by the dense and MoE encoders; compact-context only)."""
    x = RMSNorm(cfg.dim)(x)
    w = mask.astype(jnp.float32)[:, :, None]
    pooled = (x.astype(jnp.float32) * w).sum(1) / jnp.maximum(w.sum(1), 1.0)
    out = nn.Dense(cfg.out_dim, use_bias=False, dtype=jnp.float32)(pooled)
    return out / jnp.linalg.norm(out, axis=-1, keepdims=True).clip(1e-6)


class Block(nn.Module):
    cfg: EncoderConfig

    @nn.compact
    def __call__(self, x, mask, positions):
        cfg = self.cfg
        x = attention_sublayer(cfg, x, mask, positions)
        h = RMSNorm(cfg.dim)(x)
        gate = nn.Dense(cfg.mlp_ratio * cfg.dim, use_bias=False, dtype=cfg.dtype)(h)
        up = nn.Dense(cfg.mlp_ratio * cfg.dim, use_bias=False, dtype=cfg.dtype)(h)
        h = nn.silu(gate) * up
        x = x + nn.Dense(cfg.dim, use_bias=False, dtype=cfg.dtype)(h)
        return x


class TransformerEncoder(nn.Module):
    cfg: EncoderConfig

    @nn.compact
    def __call__(self, token_ids: jax.Array, mask: Optional[jax.Array] = None):
        cfg = self.cfg
        if mask is None:
            mask = token_ids > 0
        x = nn.Embed(cfg.vocab_size, cfg.dim, dtype=cfg.dtype)(token_ids)
        positions = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
        for _ in range(cfg.n_layers):
            x = Block(cfg)(x, mask, positions)
        return pooled_projection(cfg, x, mask)


def init_encoder(
    cfg: EncoderConfig, seed: int = 0
) -> Tuple[TransformerEncoder, Dict]:
    model = TransformerEncoder(cfg)
    rng = jax.random.PRNGKey(seed)
    tokens = jnp.ones((1, 8), jnp.int32)
    params = model.init(rng, tokens)
    return model, params


def load_hf_encoder(name: str = "Qwen/Qwen3-Embedding-0.6B"):
    """Load a HuggingFace Qwen3 embedding model for on-device inference.

    Converts the cached checkpoint to the weight-exact flax
    implementation (models/qwen3.py) and returns (tokenizer, module,
    params) — the module runs jitted on the device. Requires the model files in
    the local HF cache (hermetic environments cannot download); raises
    with guidance otherwise.
    """
    try:
        from a_nice_rag_tpu.models.qwen3 import load_hf_qwen3_encoder

        return load_hf_qwen3_encoder(name)
    except Exception as e:  # noqa: BLE001
        raise RuntimeError(
            f"HF model {name} is not in the local cache; pre-download it "
            "or use the native TransformerEncoder with trained weights"
        ) from e
