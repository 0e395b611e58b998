"""Contrastive training for the encoder (and cross-encoder) on device.

Training objective: symmetric InfoNCE with in-batch negatives — the
standard recipe for embedding models. Multi-chip execution is GSPMD
style: the query/document batches shard over the ``dp`` mesh axis and
2D parameter matrices shard over ``tp``; the [B, B] logits matrix then
induces the cross-device all-gathers automatically (collectives ride
ICI via XLA, never host code).
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def contrastive_loss(
    q_emb: jax.Array, d_emb: jax.Array, temperature: float = 0.05
) -> jax.Array:
    """Symmetric InfoNCE; positives are the matching (q_i, d_i) pairs."""
    logits = (q_emb @ d_emb.T) / temperature
    labels = jnp.arange(logits.shape[0])
    loss_qd = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    loss_dq = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
    return (loss_qd.mean() + loss_dq.mean()) / 2.0


def make_train_step(
    model,
    optimizer: Optional[optax.GradientTransformation] = None,
    temperature: float = 0.05,
) -> Tuple[Callable, optax.GradientTransformation]:
    """Single-device jitted train step:
    (params, opt_state, q_ids, d_ids) -> (params, opt_state, loss)."""
    optimizer = optimizer or optax.adamw(1e-3)

    @jax.jit
    def step(params, opt_state, q_ids, d_ids):
        def loss_fn(p):
            q = model.apply(p, q_ids)
            d = model.apply(p, d_ids)
            return contrastive_loss(q, d, temperature)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, optimizer


def param_shardings(params, mesh: Mesh, tp_axis: str = "tp"):
    """Tensor-parallel layout rule: shard every 2D matrix along its
    largest dim over ``tp`` (column/row parallel as appropriate); biases,
    norms, and small leaves stay replicated. XLA's SPMD partitioner
    inserts the matching collectives."""
    tp = mesh.shape[tp_axis]

    def rule(leaf):
        if leaf.ndim == 2 and max(leaf.shape) % tp == 0:
            if leaf.shape[0] >= leaf.shape[1]:
                return NamedSharding(mesh, P(tp_axis, None))
            return NamedSharding(mesh, P(None, tp_axis))
        return NamedSharding(mesh, P())

    return jax.tree.map(rule, params)


def make_sharded_train_step(
    model,
    params,
    mesh: Mesh,
    optimizer: Optional[optax.GradientTransformation] = None,
    temperature: float = 0.05,
    dp_axis: str = "dp",
    tp_axis: str = "tp",
    sp_axis: Optional[str] = None,
):
    """dp x tp (x optionally sp) sharded train step.

    Returns (step, sharded_params, sharded_opt_state). Batches passed to
    ``step`` must be shardable over ``dp`` (leading dim divisible by the
    dp axis size); put them on device with the returned ``batch_sharding``.

    ``sp_axis`` additionally shards the SEQUENCE dimension of the token
    batch (sequence parallelism, GSPMD-style): XLA propagates the
    seq-dim sharding through embedding/norm/FFN and inserts the
    all-gathers attention needs — activation memory per device drops by
    the sp factor for the elementwise portions.
    """
    optimizer = optimizer or optax.adamw(1e-3)
    p_shard = param_shardings(params, mesh, tp_axis)
    params = jax.device_put(params, p_shard)
    opt_state = jax.jit(
        optimizer.init, out_shardings=None
    )(params)
    batch_sharding = NamedSharding(mesh, P(dp_axis, sp_axis))

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(params, opt_state, q_ids, d_ids):
        def loss_fn(p):
            q = model.apply(p, q_ids)
            d = model.apply(p, d_ids)
            return contrastive_loss(q, d, temperature)

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, params, opt_state, batch_sharding
