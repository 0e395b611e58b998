"""Tensor-parallel placement for the decoder-LM serving path.

The reference has no on-device generation at all (its LLM hop is a
per-request SaaS stream, reference src/query_rag.py:434-513); this
module is part of the net-new device serving stack. models/decoder.py is
written as a plain single-device flax module — tensor parallelism here
is pure GSPMD *placement*: we shard the weight matrices and KV caches
with `jax.device_put(NamedSharding(...))` and let XLA propagate the
shardings through the (unchanged) jitted prefill/decode programs,
inserting the ICI collectives (one all-reduce after o_proj / down_proj
per block, the Megatron pattern) itself.

Layout (mesh axis ``tp``):

* ``q_proj / k_proj / v_proj / gate_proj / up_proj`` kernels
  ``[in, out]`` are sharded on the OUTPUT column axis → every device
  computes its own head/MLP slice locally;
* ``o_proj / down_proj`` kernels are sharded on the INPUT row axis →
  the following matmul is a partial sum, combined with one psum
  (inserted by XLA at the residual add);
* KV caches ``[S, Smax, nkv, hd]`` are sharded on the kv-head axis, so
  cache reads/writes and the GQA attention stay device-local;
* embeddings / norms / lm_head stay replicated (the tied embed.attend
  matmul is small next to the block matmuls at serving batch sizes).

Exactness: the sharded program computes the same floating-point sums
as the single-device program up to reduction order; greedy decode
streams are pinned bit-identical in the multichip dryrun
(__graft_entry__ stage 7) and tests/test_genserver_tp.py.
"""

from __future__ import annotations

from typing import Optional

import jax
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

__all__ = [
    "lm_param_pspec",
    "shard_lm_params",
    "lm_cache_sharding",
    "shard_lm_caches",
    "validate_tp_config",
]

_COL_SHARDED = ("q_proj", "k_proj", "v_proj", "gate_proj", "up_proj")
_ROW_SHARDED = ("o_proj", "down_proj")


def lm_param_pspec(path, tp_axis: str = "tp") -> P:
    """PartitionSpec for one decoder parameter, keyed by its tree path
    (a tuple of pytree keys, as produced by tree_map_with_path)."""
    s = "/".join(str(getattr(p, "key", p)) for p in path)
    if "kernel" in s and any(k in s for k in _COL_SHARDED):
        return P(None, tp_axis)
    if "kernel" in s and any(k in s for k in _ROW_SHARDED):
        return P(tp_axis, None)
    return P()


def validate_tp_config(cfg, mesh: Mesh, tp_axis: str = "tp") -> int:
    """Check a Qwen3Config divides evenly over the tp axis; returns the
    tp degree."""
    if tp_axis not in mesh.axis_names:
        raise ValueError(
            f"mesh {mesh.axis_names} has no axis {tp_axis!r}"
        )
    tp = mesh.shape[tp_axis]
    for name in ("num_heads", "num_kv_heads", "intermediate_size"):
        v = getattr(cfg, name)
        if v % tp != 0:
            raise ValueError(
                f"{name}={v} is not divisible by tp={tp}; pick a tp "
                f"degree that divides the head/MLP dimensions"
            )
    return tp


def shard_lm_params(params, mesh: Mesh, tp_axis: str = "tp",
                    cfg=None):
    """Place a decoder param tree onto ``mesh`` with the Megatron
    column/row layout (replicated elsewhere)."""
    if cfg is not None:
        validate_tp_config(cfg, mesh, tp_axis)
    return jax.tree_util.tree_map_with_path(
        lambda path, leaf: jax.device_put(
            leaf, NamedSharding(mesh, lm_param_pspec(path, tp_axis))
        ),
        params,
    )


def lm_cache_sharding(mesh: Mesh, tp_axis: str = "tp",
                      batch_axis: Optional[str] = None) -> NamedSharding:
    """Sharding for a KV cache [B, Smax, nkv, hd]: kv heads over tp
    (optionally batch over ``batch_axis`` for data-parallel decode)."""
    return NamedSharding(mesh, P(batch_axis, None, tp_axis, None))


def shard_lm_caches(kcaches, vcaches, mesh: Mesh, tp_axis: str = "tp",
                    batch_axis: Optional[str] = None):
    """Place per-layer cache lists onto the mesh."""
    sh = lm_cache_sharding(mesh, tp_axis, batch_axis)
    kc = [jax.device_put(c, sh) for c in kcaches]
    vc = [jax.device_put(c, sh) for c in vcaches]
    return kc, vc
