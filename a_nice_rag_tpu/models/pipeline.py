"""GPipe-style pipeline-parallel training for the embedding encoder.

Completes the parallelism axes (dp x tp live in models/train.py): the
block stack is split into ``pp`` stages whose parameters live on their
stage's devices only, and a microbatched schedule streams activations
stage-to-stage with ``lax.ppermute`` inside ``lax.scan`` under
``shard_map``. The schedule is differentiable end to end (JAX
transposes ppermute to the reverse permute), so the training step is
plain ``value_and_grad`` + optax over the pipelined forward; a ``dp``
mesh axis shards the batch as usual.

Layout choices:

* embed lookup and the final norm/pool/projection are replicated — they
  are a tiny fraction of FLOPs and keeping them off the pipeline makes
  every stage uniform (``layers_per_stage`` identical blocks);
* stage parameters are the encoder's Block params STACKED
  [n_stages, layers_per_stage, ...] and sharded over ``pp`` on the
  leading axis; each device scans its own layer group;
* activations move with a single ring ppermute per schedule step; the
  bubble is the standard (n_stages - 1) / (n_micro + n_stages - 1)
  fraction.

``split_pipeline_params`` / ``merge_pipeline_params`` convert to and
from the standard ``TransformerEncoder`` tree, so checkpoints and the
single-device path interoperate.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Optional

import jax
import jax.numpy as jnp
import optax
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from a_nice_rag_tpu.models.encoder import Block, EncoderConfig
from a_nice_rag_tpu.models.train import contrastive_loss


def split_pipeline_params(params: Dict, n_stages: int):
    """(head, stacked_blocks, tail) from a TransformerEncoder tree.

    stacked_blocks leaves get shape [n_stages, layers_per_stage, ...].
    """
    p = params["params"]
    block_keys = sorted(
        (k for k in p if k.startswith("Block_")),
        key=lambda k: int(k.split("_")[1]),
    )
    n_layers = len(block_keys)
    assert n_layers % n_stages == 0, (n_layers, n_stages)
    per = n_layers // n_stages
    blocks = [p[k] for k in block_keys]
    stacked = jax.tree.map(
        lambda *leaves: jnp.stack(leaves).reshape(
            (n_stages, per) + leaves[0].shape
        ),
        *blocks,
    )
    head = {"Embed_0": p["Embed_0"]}
    tail = {"RMSNorm_0": p["RMSNorm_0"], "Dense_0": p["Dense_0"]}
    return head, stacked, tail


def merge_pipeline_params(head: Dict, stacked, tail: Dict) -> Dict:
    """Inverse of split_pipeline_params (standard encoder tree)."""
    leaves = jax.tree.leaves(stacked)
    n_stages, per = leaves[0].shape[:2]
    p = {"Embed_0": head["Embed_0"], **tail}
    for s in range(n_stages):
        for j in range(per):
            p[f"Block_{s * per + j}"] = jax.tree.map(
                lambda x: x[s, j], stacked
            )
    return {"params": p}


def _tail_apply(tail: Dict, x, mask):
    """Final RMSNorm + masked mean pool + projection + L2 norm —
    numerics identical to TransformerEncoder's tail."""
    scale = tail["RMSNorm_0"]["scale"]
    var = jnp.mean(jnp.square(x.astype(jnp.float32)), axis=-1, keepdims=True)
    x = (x * jax.lax.rsqrt(var + 1e-6)).astype(x.dtype) * scale
    w = mask.astype(jnp.float32)[:, :, None]
    pooled = (x.astype(jnp.float32) * w).sum(1) / jnp.maximum(w.sum(1), 1.0)
    out = pooled @ tail["Dense_0"]["kernel"].astype(jnp.float32)
    return out / jnp.linalg.norm(out, axis=-1, keepdims=True).clip(1e-6)


def make_pipeline_forward(
    cfg: EncoderConfig,
    mesh: Mesh,
    n_micro: int,
    dp_axis: str = "dp",
    pp_axis: str = "pp",
):
    """Jittable pipelined embedding forward over a (dp, pp) mesh.

    Returns ``forward(head, stacked_blocks, tail, tokens) -> [B, out]``
    with tokens sharded over ``dp`` and block params over ``pp``.
    """
    n_stages = mesh.shape[pp_axis]
    block_mod = Block(cfg)

    def _device_fn(head, blocks, tail, tokens):
        # blocks leaves arrive as [1, layers_per_stage, ...]
        my_blocks = jax.tree.map(lambda l: l[0], blocks)
        stage = jax.lax.axis_index(pp_axis)
        mask = tokens > 0
        positions = jnp.cumsum(mask.astype(jnp.int32), axis=-1) - 1
        table = head["Embed_0"]["embedding"]
        x0 = table[tokens].astype(cfg.dtype)

        b_local, seq = tokens.shape
        assert b_local % n_micro == 0, (b_local, n_micro)
        mb = b_local // n_micro
        xm = x0.reshape(n_micro, mb, seq, cfg.dim)
        maskm = mask.reshape(n_micro, mb, seq)
        posm = positions.reshape(n_micro, mb, seq)

        def apply_stage(x, m, pos):
            def body(xc, layer):
                return block_mod.apply({"params": layer}, xc, m, pos), None

            x, _ = jax.lax.scan(body, x, my_blocks)
            return x

        perm = [(i, (i + 1) % n_stages) for i in range(n_stages)]
        t_steps = n_micro + n_stages - 1

        def sched(carry, t):
            prev_out, outs = carry
            recv = jax.lax.ppermute(prev_out, pp_axis, perm)
            # Stage s processes microbatch (t - s) at step t.
            my_mb = jnp.clip(t - stage, 0, n_micro - 1)
            inp = jnp.where(
                stage == 0, jnp.take(xm, my_mb, axis=0), recv
            )
            m = jnp.take(maskm, my_mb, axis=0)
            pos = jnp.take(posm, my_mb, axis=0)
            out = apply_stage(inp, m, pos)
            out_mb = t - (n_stages - 1)
            collect = (
                (stage == n_stages - 1)
                & (out_mb >= 0)
                & (out_mb < n_micro)
            )
            slot = jnp.clip(out_mb, 0, n_micro - 1)
            outs = outs.at[slot].set(
                jnp.where(collect, out, outs[slot])
            )
            return (out, outs), None

        init = (
            jnp.zeros((mb, seq, cfg.dim), cfg.dtype),
            jnp.zeros((n_micro, mb, seq, cfg.dim), cfg.dtype),
        )
        (_, outs), _ = jax.lax.scan(
            sched, init, jnp.arange(t_steps, dtype=jnp.int32)
        )
        # Only the last stage holds real outputs; replicate over pp.
        outs = jax.lax.psum(
            jnp.where(stage == n_stages - 1, outs, 0.0), pp_axis
        )
        x = outs.reshape(b_local, seq, cfg.dim)
        return _tail_apply(tail, x, mask)

    def forward(head, blocks, tail, tokens):
        in_specs = (
            jax.tree.map(lambda _: P(), head),
            jax.tree.map(lambda _: P(pp_axis), blocks),
            jax.tree.map(lambda _: P(), tail),
            P(dp_axis, None),
        )
        return shard_map(
            _device_fn,
            mesh=mesh,
            in_specs=in_specs,
            out_specs=P(dp_axis, None),
            check_vma=False,
        )(head, blocks, tail, tokens)

    return forward


def make_pipeline_train_step(
    cfg: EncoderConfig,
    params: Dict,
    mesh: Mesh,
    n_micro: int = 2,
    optimizer: Optional[optax.GradientTransformation] = None,
    temperature: float = 0.05,
    dp_axis: str = "dp",
    pp_axis: str = "pp",
):
    """Contrastive training with pipeline-parallel blocks.

    Returns (step, pipeline_params, opt_state, batch_sharding); step is
    ``(pipe_params, opt_state, q_ids, d_ids) -> (params, opt, loss)``.
    ``pipeline_params = (head, stacked_blocks, tail)`` — convert back
    with merge_pipeline_params for checkpoints/inference.
    """
    optimizer = optimizer or optax.adamw(1e-3)
    n_stages = mesh.shape[pp_axis]
    head, blocks, tail = split_pipeline_params(params, n_stages)
    # head/tail are VIEWS into the caller's tree and the step donates
    # its params; copy so donation can never invalidate the caller's
    # arrays (stacked blocks are already fresh arrays).
    head = jax.tree.map(lambda x: jnp.array(x, copy=True), head)
    tail = jax.tree.map(lambda x: jnp.array(x, copy=True), tail)
    rep = NamedSharding(mesh, P())
    blk_sh = jax.tree.map(
        lambda _: NamedSharding(mesh, P(pp_axis)), blocks
    )
    head = jax.device_put(head, rep)
    tail = jax.device_put(tail, rep)
    blocks = jax.device_put(blocks, blk_sh)
    pipe_params = (head, blocks, tail)
    opt_state = jax.jit(optimizer.init)(pipe_params)
    batch_sharding = NamedSharding(mesh, P(dp_axis, None))
    forward = make_pipeline_forward(
        cfg, mesh, n_micro, dp_axis=dp_axis, pp_axis=pp_axis
    )

    @partial(jax.jit, donate_argnums=(0, 1))
    def step(pipe_params, opt_state, q_ids, d_ids):
        def loss_fn(pp):
            h, bl, tl = pp
            q = forward(h, bl, tl, q_ids)
            d = forward(h, bl, tl, d_ids)
            return contrastive_loss(q, d, temperature)

        loss, grads = jax.value_and_grad(loss_fn)(pipe_params)
        updates, opt_state = optimizer.update(grads, opt_state, pipe_params)
        pipe_params = optax.apply_updates(pipe_params, updates)
        return pipe_params, opt_state, loss

    return step, pipe_params, opt_state, batch_sharding
