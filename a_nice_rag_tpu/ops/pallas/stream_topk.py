"""Streaming dense top-k kernel for Hopper (Pallas, Triton route).

The plain form of dense top-k writes the whole ``[B, N]`` score matrix to
device memory and reads it back for ``top_k``. At 2M x 256 bf16 and B=256
that is 2.1 GB each way against a 1.07 GB corpus. This kernel reads the
corpus once per query block and never writes scores: each program scores
doc tiles on the tensor cores and folds them into a running top-k held in
registers.

Layout of the work:

* The grid is (query block, doc split). Blocks run in parallel on the
  SMs, so nothing carries between them: each program walks its own run of
  doc tiles in an inner loop and writes ``k_pad`` candidates per query.
  One exact merge (:func:`merge_candidates`) turns the
  ``[B, splits * k_pad]`` candidates into the top-k.
* Scores: bf16 x bf16 and int8 x int8 go to the tensor cores with f32 and
  int32 accumulation; f32 operands use IEEE f32 (``Precision.HIGHEST``),
  never TF32. int8 scores are ``f32(acc) * q_scale * doc_scale``, the same
  expression as :func:`ops.quantized.quantized_dense_scores`.
* Fold: a tile is folded only where its row maximum beats the running
  k-th value. Each fold step moves the tile's best entry into the slot of
  the worst running entry (largest id among equal worst values). Tiles
  are walked in increasing doc order, so a strict ``>`` keeps the lower
  id on exact ties, as the reference does.
* Optional operands: a candidate mask ``[N]`` and a tile table (IVF's
  probed tiles, ``index.ivf.build_tile_table``): each program loads its
  own run of table entries; ``-1`` entries are skipped and rows at or past
  ``n_valid`` never score.

``interpret=True`` runs the kernel in the Pallas interpreter; tests pass
it on the CPU. The route choice lives in :mod:`ops.streaming`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

MAX_K = 128
_NEG = float("-inf")
# Enough programs for several waves over the H100's 132 SMs.
_TARGET_PROGRAMS = 4 * 132


def _pow2_at_least(x: int) -> int:
    return 1 << max(0, int(x) - 1).bit_length()


class Plan(NamedTuple):
    """Block shapes and launch parameters, derived from shapes alone."""

    bq: int  # queries per program
    bn: int  # docs per tile
    bk: int  # contraction chunk
    kp: int  # running top-k width (power of two >= k)
    per_split: int  # units (tiles, or table entries) per program
    splits: int
    num_warps: int
    num_stages: int


def plan(b: int, n_units: int, d: int, k: int, bn: int) -> Plan:
    """Pick blocks for ``b`` queries over ``n_units`` units of work."""
    bq = 16 if b <= 16 else (32 if b <= 32 else 64)
    bk = min(128, max(16, _pow2_at_least(d)))
    kp = _pow2_at_least(max(k, 1))
    nq = -(-b // bq)
    want = max(1, _TARGET_PROGRAMS // nq)
    per_split = max(1, -(-n_units // want))
    splits = max(1, -(-n_units // per_split))
    return Plan(bq, bn, bk, kp, per_split, splits,
                num_warps=8 if bq >= 64 else 4, num_stages=3)


def _kernel(*refs, int8: bool, has_mask: bool, has_table: bool, f32: bool,
            p: Plan, d: int, n_rows: int, n_units: int, subs: int):
    it = iter(refs)
    q_ref = next(it)
    qs_ref = next(it) if int8 else None
    e_ref = next(it)
    es_ref = next(it) if int8 else None
    mask_ref = next(it) if has_mask else None
    table_ref = next(it) if has_table else None
    nvalid_ref = next(it)
    vals_ref = next(it)
    ids_ref = next(it)

    bq, bn, bk, kp = p.bq, p.bn, p.bk, p.kp
    qb = pl.program_id(0)
    first = pl.program_id(1) * p.per_split
    n_valid = nvalid_ref[0]
    if has_table:
        span = _pow2_at_least(p.per_split)
        pos = first + jnp.arange(span)
        ents = plgpu.load(
            table_ref.at[pl.ds(first, span)],
            mask=(jnp.arange(span) < p.per_split) & (pos < n_units),
            other=-1,
        )
        # Real entries come first in a table, so the live ones of this
        # run are a prefix of it.
        trip = jnp.sum((ents >= 0).astype(jnp.int32)) * subs
    else:
        trip = jnp.minimum(p.per_split, n_units - first)
    q0 = qb * bq
    qs = plgpu.load(qs_ref.at[pl.ds(q0, bq)]) if int8 else None
    col_iota = jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 1)
    slot_iota = jax.lax.broadcasted_iota(jnp.int32, (bq, kp), 1)
    n_k = -(-d // bk)
    acc_dtype = jnp.int32 if int8 else jnp.float32
    precision = jax.lax.Precision.HIGHEST if f32 else None

    def tile(j, carry):
        rv, ri, rmin = carry
        if has_table:
            if subs == 1:
                doc0 = table_ref[first + j] * bn
            else:
                t = table_ref[first + jax.lax.div(j, subs)]
                doc0 = t * (subs * bn) + jax.lax.rem(j, subs) * bn
        else:
            doc0 = (first + j) * bn
        rows = doc0 + jnp.arange(bn)
        row_ok = rows < n_rows

        def kstep(kk, acc):
            ks = kk * bk + jnp.arange(bk)
            k_ok = ks < d
            qk = plgpu.load(
                q_ref.at[pl.ds(q0, bq), pl.ds(kk * bk, bk)],
                mask=k_ok[None, :], other=0,
            )
            ek = plgpu.load(
                e_ref.at[pl.ds(doc0, bn), pl.ds(kk * bk, bk)],
                mask=row_ok[:, None] & k_ok[None, :], other=0,
            )
            return acc + pl.dot(qk, ek, trans_b=True, precision=precision)

        acc = jax.lax.fori_loop(
            0, n_k, kstep, jnp.zeros((bq, bn), acc_dtype)
        )
        if int8:
            es = plgpu.load(es_ref.at[pl.ds(doc0, bn)], mask=row_ok,
                            other=0.0)
            sc = acc.astype(jnp.float32) * qs[:, None] * es[None, :]
        else:
            sc = acc
        ok = row_ok & (rows < n_valid)
        if has_mask:
            mk = plgpu.load(mask_ref.at[pl.ds(doc0, bn)], mask=row_ok,
                            other=0)
            ok = ok & (mk != 0)
        sc = jnp.where(ok[None, :], sc, _NEG)

        def more(c):
            _, _, _, m, lo = c
            return jnp.sum((m > lo).astype(jnp.int32)) > 0

        def fold(c):
            sc, rv, ri, m, lo = c
            hit = m > lo
            col = jnp.argmax(sc, axis=1).astype(jnp.int32)
            # Evict the worst running entry; among equal worst values the
            # one with the largest id.
            slot = jnp.argmax(
                jnp.where(rv == lo[:, None], ri, -2), axis=1
            ).astype(jnp.int32)
            put = hit[:, None] & (slot_iota == slot[:, None])
            rv = jnp.where(put, m[:, None], rv)
            ri = jnp.where(put, (doc0 + col)[:, None], ri)
            sc = jnp.where(hit[:, None] & (col_iota == col[:, None]),
                           _NEG, sc)
            return sc, rv, ri, jnp.max(sc, axis=1), jnp.min(rv, axis=1)

        _, rv, ri, _, rmin = jax.lax.while_loop(
            more, fold, (sc, rv, ri, jnp.max(sc, axis=1), rmin)
        )
        return rv, ri, rmin

    rv, ri, _ = jax.lax.fori_loop(
        0, trip, tile,
        (jnp.full((bq, kp), _NEG, jnp.float32),
         jnp.full((bq, kp), -1, jnp.int32),
         jnp.full((bq,), _NEG, jnp.float32)),
    )
    vals_ref[...] = rv
    ids_ref[...] = jnp.where(rv == _NEG, -1, ri)


def merge_candidates(vals: jax.Array, ids: jax.Array,
                     k: int) -> Tuple[jax.Array, jax.Array]:
    """Exact top-k of candidate lists along the last axis: values
    descending, ties to the lower id; (-inf, -1) where fewer than k."""
    big = jnp.int32(2**31 - 1)
    key = jnp.where(ids < 0, big, ids)
    nv, si = jax.lax.sort((-vals, key), dimension=-1, num_keys=2)
    v = -nv[..., :k]
    return v, jnp.where(jnp.isneginf(v), -1, si[..., :k])


@functools.partial(
    jax.jit, static_argnames=("k", "tile_n", "interpret"),
)
def stream_top_k(
    rows: jax.Array,
    queries: jax.Array,
    k: int,
    *,
    row_scales: Optional[jax.Array] = None,
    q_scales: Optional[jax.Array] = None,
    mask: Optional[jax.Array] = None,
    tiles: Optional[jax.Array] = None,
    tile_n: int = 0,
    n_valid=None,
    interpret: bool = False,
) -> Tuple[jax.Array, jax.Array]:
    """Top-k of ``queries @ rows.T`` without materializing scores.

    rows [N, D] (bf16, f32, or int8 with ``row_scales`` [N] and int8
    ``queries`` with ``q_scales`` [B]); queries [B, D]; mask: optional
    [N] bool (True = candidate). With ``tiles`` (int32 [T], -1 padded,
    real entries first and ascending) only rows of those ``tile_n``-row
    tiles are scored. ``n_valid`` (int or int32 scalar, default N): rows
    at or past it never score. Returns (values [B, k] desc f32, row ids
    [B, k], (-inf, -1) where fewer than k rows qualify).
    """
    n, d = rows.shape
    b = queries.shape[0]
    if k > MAX_K:
        raise ValueError(f"k={k} above the kernel's limit {MAX_K}")
    int8 = row_scales is not None
    f32 = rows.dtype == jnp.float32
    if tiles is not None:
        bn = min(128, tile_n)
        if tile_n % bn or bn < 16 or bn & (bn - 1):
            raise ValueError(f"tile_n={tile_n} must be a power of two >= 16")
        n_units, subs = tiles.shape[0], tile_n // bn
    else:
        bn, subs = 128, 1
        n_units = -(-n // bn)
    p = plan(b, n_units, d, k, bn)
    bp = -(-b // p.bq) * p.bq
    if bp != b:
        queries = jnp.pad(queries, ((0, bp - b), (0, 0)))
        if int8:
            q_scales = jnp.pad(q_scales, (0, bp - b))
    nv = jnp.asarray(n if n_valid is None else n_valid, jnp.int32)
    operands = [queries]
    if int8:
        operands.append(q_scales.astype(jnp.float32))
    operands.append(rows)
    if int8:
        operands.append(row_scales.astype(jnp.float32))
    if mask is not None:
        operands.append(mask.astype(jnp.int8))
    if tiles is not None:
        operands.append(tiles.astype(jnp.int32))
    operands.append(nv.reshape(1))
    kernel = functools.partial(
        _kernel, int8=int8, has_mask=mask is not None,
        has_table=tiles is not None, f32=f32, p=p, d=d, n_rows=n,
        n_units=n_units, subs=subs,
    )
    out_block = pl.BlockSpec((None, p.bq, p.kp), lambda i, s: (s, i, 0))
    vals, ids = pl.pallas_call(
        kernel,
        grid=(bp // p.bq, p.splits),
        in_specs=[pl.no_block_spec] * len(operands),
        out_specs=[out_block, out_block],
        out_shape=[
            jax.ShapeDtypeStruct((p.splits, bp, p.kp), jnp.float32),
            jax.ShapeDtypeStruct((p.splits, bp, p.kp), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(
            num_warps=p.num_warps, num_stages=p.num_stages,
        ),
        interpret=interpret,
        name="stream_top_k",
    )(*operands)
    vals = jnp.moveaxis(vals, 0, 1).reshape(bp, -1)[:b]
    ids = jnp.moveaxis(ids, 0, 1).reshape(bp, -1)[:b]
    return merge_candidates(vals, ids, k)
