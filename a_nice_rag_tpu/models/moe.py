"""Mixture-of-experts encoder with expert parallelism (the ``ep`` axis).

Completes the parallelism-axis family (dp x tp: models/train.py,
dp x pp: models/pipeline.py). The FFN of every block becomes a top-1
routed mixture of SwiGLU experts with GShard-style EINSUM dispatch —
one-hot combine/dispatch tensors contracted as matmuls, no
gather/scatter — and expert weights stacked [E, ...] shard over the
``ep`` mesh axis. Sharding is GSPMD-style: parameters carry
NamedShardings and XLA inserts the all-to-alls; the model code stays a
plain jitted function.

Capacity: each expert processes at most ``capacity_factor * T / E``
tokens per row; overflow tokens fall back to the residual stream
(standard GShard semantics). A load-balance auxiliary loss keeps the
router from collapsing onto one expert.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Any, Dict, Optional, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from a_nice_rag_tpu.models.encoder import (
    RMSNorm,
    attention_sublayer,
    pooled_projection,
)
from a_nice_rag_tpu.models.train import contrastive_loss


@dataclasses.dataclass(frozen=True)
class MoEEncoderConfig:
    vocab_size: int = 32768
    dim: int = 256
    n_layers: int = 4
    n_heads: int = 4
    mlp_ratio: int = 4
    max_len: int = 512
    out_dim: int = 256
    n_experts: int = 4
    capacity_factor: float = 1.25
    dtype: Any = jnp.bfloat16


class MoEFFN(nn.Module):
    """Top-1 routed SwiGLU experts with einsum dispatch/combine."""

    cfg: MoEEncoderConfig

    @nn.compact
    def __call__(
        self, x: jax.Array, valid: jax.Array
    ) -> Tuple[jax.Array, jax.Array]:
        cfg = self.cfg
        b, s, d = x.shape
        e = cfg.n_experts
        hidden = cfg.mlp_ratio * d
        cap = max(1, int(cfg.capacity_factor * s / e))

        logits = nn.Dense(e, use_bias=False, dtype=jnp.float32,
                          name="router")(x.astype(jnp.float32))
        probs = jax.nn.softmax(logits, axis=-1)  # [B, S, E]
        expert = jnp.argmax(probs, axis=-1)  # [B, S]
        gate = jnp.max(probs, axis=-1)  # [B, S]

        # Padding tokens are not routed: they consume no capacity, get
        # zero combine weight (residual passthrough), and are excluded
        # from the balance statistics so the router is not trained to
        # balance garbage positions.
        valid_f = valid.astype(jnp.float32)
        onehot = jax.nn.one_hot(expert, e, dtype=jnp.float32)
        onehot = onehot * valid_f[..., None]
        gate = gate * valid_f
        n_valid = jnp.maximum(valid_f.sum(), 1.0)

        # Load-balance aux loss (GShard eq. 4): mean prob * mean count
        # over VALID tokens.
        frac_tokens = onehot.sum(axis=(0, 1)) / n_valid
        frac_probs = (
            probs * valid_f[..., None]
        ).sum(axis=(0, 1)) / n_valid
        aux = e * jnp.sum(frac_tokens * frac_probs)

        # Position of each token within its expert's capacity buffer.
        pos = jnp.cumsum(onehot, axis=1) * onehot  # 1-based where routed
        pos = (pos.sum(axis=-1) - 1.0).astype(jnp.int32)  # [B, S]
        keep = (pos < cap) & (pos >= 0)
        # dispatch [B, S, E, C]: one-hot over (expert, slot).
        slot_oh = jax.nn.one_hot(
            jnp.where(keep, pos, cap), cap, dtype=cfg.dtype
        )  # overflow -> one_hot of cap == all zeros
        dispatch = onehot.astype(cfg.dtype)[..., None] * slot_oh[:, :, None, :]
        # Route tokens: [B, E, C, D] expert inputs.
        xin = jnp.einsum("bsec,bsd->becd", dispatch, x.astype(cfg.dtype))

        wg = self.param(
            "w_gate", nn.initializers.lecun_normal(), (e, d, hidden)
        ).astype(cfg.dtype)
        wu = self.param(
            "w_up", nn.initializers.lecun_normal(), (e, d, hidden)
        ).astype(cfg.dtype)
        wo = self.param(
            "w_out", nn.initializers.lecun_normal(), (e, hidden, d)
        ).astype(cfg.dtype)
        g = jnp.einsum("becd,edh->bech", xin, wg)
        u = jnp.einsum("becd,edh->bech", xin, wu)
        h = nn.silu(g) * u
        out = jnp.einsum("bech,ehd->becd", h, wo)  # [B, E, C, D]

        # Combine back to token order, weighted by the router gate.
        combine = dispatch * gate.astype(cfg.dtype)[..., None, None]
        y = jnp.einsum("bsec,becd->bsd", combine, out)
        return y.astype(x.dtype), aux


class MoEBlock(nn.Module):
    cfg: MoEEncoderConfig

    @nn.compact
    def __call__(self, x, mask, positions):
        cfg = self.cfg
        x = attention_sublayer(cfg, x, mask, positions)
        h = RMSNorm(cfg.dim)(x)
        y, aux = MoEFFN(cfg)(h, mask)
        return x + y, aux


class MoETransformerEncoder(nn.Module):
    """Unit-norm embedding encoder whose FFNs are routed experts."""

    cfg: MoEEncoderConfig

    @nn.compact
    def __call__(self, token_ids, mask: Optional[jax.Array] = None):
        cfg = self.cfg
        if mask is None:
            mask = token_ids > 0
        x = nn.Embed(cfg.vocab_size, cfg.dim, dtype=cfg.dtype)(token_ids)
        positions = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
        aux_total = 0.0
        for _ in range(cfg.n_layers):
            x, aux = MoEBlock(cfg)(x, mask, positions)
            aux_total = aux_total + aux
        out = pooled_projection(cfg, x, mask)
        return out, aux_total / cfg.n_layers


def init_moe_encoder(
    cfg: MoEEncoderConfig, seed: int = 0
) -> Tuple[MoETransformerEncoder, Dict]:
    model = MoETransformerEncoder(cfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.ones((1, 8), jnp.int32))
    return model, params


def moe_param_shardings(params, mesh: Mesh, ep_axis: str = "ep"):
    """Expert parallelism: the stacked expert tensors [E, ...] shard
    over ``ep`` on their leading axis; everything else replicates. XLA
    inserts the dispatch/combine all-to-alls."""
    ep = mesh.shape[ep_axis]

    def rule(path, leaf):
        names = [getattr(p, "key", "") for p in path]
        if any(n in ("w_gate", "w_up", "w_out") for n in names) \
                and leaf.ndim == 3 and leaf.shape[0] % ep == 0:
            return NamedSharding(mesh, P(ep_axis, None, None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(rule, params)


def make_moe_train_step(
    model: MoETransformerEncoder,
    params: Dict,
    mesh: Mesh,
    optimizer: Optional[optax.GradientTransformation] = None,
    temperature: float = 0.05,
    aux_weight: float = 0.01,
    dp_axis: str = "dp",
    ep_axis: str = "ep",
):
    """Contrastive training with expert-parallel FFNs (GSPMD)."""
    optimizer = optimizer or optax.adamw(1e-3)
    p_shard = moe_param_shardings(params, mesh, ep_axis)
    params = jax.device_put(params, p_shard)
    opt_state = jax.jit(optimizer.init)(params)
    batch_sharding = NamedSharding(mesh, P(dp_axis, None))

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, q_ids, d_ids):
        def loss_fn(p):
            q, aux_q = model.apply(p, q_ids)
            d, aux_d = model.apply(p, d_ids)
            loss = contrastive_loss(q, d, temperature)
            return loss + aux_weight * (aux_q + aux_d), loss

        (total, loss), grads = jax.value_and_grad(
            loss_fn, has_aux=True
        )(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, params, opt_state, batch_sharding
