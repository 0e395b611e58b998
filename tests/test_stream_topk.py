"""Streaming dense top-k: the Pallas kernel (interpreted on the CPU), the
plain blocked form, the route choice and the exact merge, all against
``testing.golden.golden_top_k``.

Most data is integer-valued so every score is exact in f32 and bf16:
kernel, blocked form and reference then agree bit for bit, exact ties
included (ties go to the lower doc id). The ``gpu`` cases compile the
kernel for the card; ``chip_smoke.py`` runs them there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from a_nice_rag_tpu.ops.pallas.stream_topk import (
    MAX_K,
    merge_candidates,
    plan,
    stream_top_k,
)
from a_nice_rag_tpu.ops.streaming import (
    STREAM_THRESHOLD,
    Route,
    blocked_top_k,
    choose_route,
    dense_stream_top_k,
)
from a_nice_rag_tpu.testing import golden_top_k

DTYPES = ("bfloat16", "float32", "int8")


def _corpus(dtype, n, d, b, seed, dup_every=0):
    """Integer-valued docs and queries, with exact per-row int8 scales
    (powers of two) so int8 scores are exact too. ``dup_every`` copies
    row 0 to every dup_every-th row: exact score ties."""
    rng = np.random.default_rng(seed)
    e = rng.integers(-3, 4, size=(n, d), dtype=np.int8)
    q = rng.integers(-3, 4, size=(b, d), dtype=np.int8)
    if dup_every:
        e[::dup_every] = e[0]
    # Exact in f32: every dot product is an integer below 2**24.
    dots = (q.astype(np.float32) @ e.T.astype(np.float32)).astype(np.float64)
    if dtype == "int8":
        es = (2.0 ** rng.integers(-3, 2, size=n)).astype(np.float32)
        qs = (2.0 ** rng.integers(-3, 2, size=b)).astype(np.float32)
        scores = dots * qs[:, None] * es[None, :]
        args = dict(rows=jnp.asarray(e, jnp.int8),
                    queries=jnp.asarray(q, jnp.int8),
                    row_scales=jnp.asarray(es), q_scales=jnp.asarray(qs))
    else:
        scores = dots
        args = dict(rows=jnp.asarray(e, dtype), queries=jnp.asarray(q, dtype))
    return args, scores


def _check(got, want_v, want_i):
    v, i = (np.asarray(x) for x in got)
    np.testing.assert_array_equal(i, want_i)
    np.testing.assert_array_equal(v, want_v.astype(np.float32))


# --- the kernel, interpreted -------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1000, 1024])  # ragged and tile-aligned N
@pytest.mark.parametrize("masked", [False, True])
def test_kernel_matches_golden(dtype, n, masked):
    args, scores = _corpus(dtype, n, 48, 20, seed=n + masked)
    mask = np.random.default_rng(7).random(n) < 0.6 if masked else None
    got = stream_top_k(k=10, mask=None if mask is None else jnp.asarray(mask),
                       interpret=True, **args)
    _check(got, *golden_top_k(scores, 10, mask))


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_all_masked_gives_minus_one(dtype):
    args, _ = _corpus(dtype, 300, 32, 5, seed=3)
    v, i = stream_top_k(k=8, mask=jnp.zeros((300,), bool), interpret=True,
                        **args)
    assert (np.asarray(i) == -1).all()
    assert np.isneginf(np.asarray(v)).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_k_above_valid_docs(dtype):
    args, scores = _corpus(dtype, 200, 32, 6, seed=4)
    mask = np.zeros(200, bool)
    mask[[5, 17, 150]] = True
    got = stream_top_k(k=16, mask=jnp.asarray(mask), interpret=True, **args)
    want_v, want_i = golden_top_k(scores, 16, mask)
    _check(got, want_v, want_i)
    assert (np.asarray(got[1])[:, 3:] == -1).all()


@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_exact_ties_go_to_lower_id(dtype):
    # Every 7th row equals row 0, and tiles hold other ties too: the
    # running top-k must keep the lowest ids among equal scores.
    args, scores = _corpus(dtype, 700, 16, 9, seed=5, dup_every=7)
    got = stream_top_k(k=24, interpret=True, **args)
    _check(got, *golden_top_k(scores, 24))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("tile_n", [32, 256])  # one and several sub-tiles
def test_kernel_tile_table(dtype, tile_n):
    """Only the tabled tiles score; -1 entries are skipped and rows at or
    past n_valid (the ragged last tile) never score."""
    n = 8 * tile_n
    n_valid = n - tile_n // 2
    args, scores = _corpus(dtype, n, 32, 7, seed=tile_n)
    table = np.array([0, 2, 3, 7, -1, -1], np.int32)
    rows = np.concatenate(
        [np.arange(t * tile_n, (t + 1) * tile_n) for t in table if t >= 0]
    )
    keep = np.zeros(n, bool)
    keep[rows[rows < n_valid]] = True
    got = stream_top_k(k=12, tiles=jnp.asarray(table), tile_n=tile_n,
                       n_valid=n_valid, interpret=True, **args)
    _check(got, *golden_top_k(scores, 12, keep))


def test_kernel_f32_continuous_scores():
    """Non-integer f32 data: the kernel contracts at HIGHEST precision,
    so scores match a float64 reference to f32 rounding."""
    rng = np.random.default_rng(11)
    e = rng.standard_normal((900, 40)).astype(np.float32)
    q = rng.standard_normal((12, 40)).astype(np.float32)
    v, i = stream_top_k(jnp.asarray(e), jnp.asarray(q), 10, interpret=True)
    want_v, want_i = golden_top_k(q.astype(np.float64) @ e.T, 10)
    np.testing.assert_allclose(np.asarray(v), want_v, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(i), want_i)


def test_kernel_rejects_k_above_limit():
    with pytest.raises(ValueError):
        stream_top_k(jnp.zeros((64, 16)), jnp.zeros((2, 16)), MAX_K + 1,
                     interpret=True)


# --- the plain blocked form --------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("masked", [False, True])
def test_blocked_matches_golden(dtype, masked):
    args, scores = _corpus(dtype, 1000, 32, 9, seed=21 + masked,
                           dup_every=9)
    mask = np.random.default_rng(8).random(1000) < 0.5 if masked else None
    got = blocked_top_k(k=15, mask=None if mask is None else jnp.asarray(mask),
                        **args)
    _check(got, *golden_top_k(scores, 15, mask))


@pytest.mark.parametrize("dtype", DTYPES)
def test_blocked_tile_table(dtype):
    tile_n, n = 64, 640
    args, scores = _corpus(dtype, n, 24, 5, seed=31)
    table = np.array([1, 4, 9, -1], np.int32)
    keep = np.zeros(n, bool)
    for t in table[table >= 0]:
        keep[t * tile_n:(t + 1) * tile_n] = True
    keep[600:] = False
    got = blocked_top_k(k=20, tiles=jnp.asarray(table), tile_n=tile_n,
                        n_valid=600, **args)
    _check(got, *golden_top_k(scores, 20, keep))


def test_blocked_chunks_with_ragged_tail(monkeypatch):
    """Several full chunks plus a static tail chunk."""
    import a_nice_rag_tpu.ops.streaming as streaming

    monkeypatch.setattr(streaming, "_CHUNK_BYTES", 4 * 8 * 256)
    args, scores = _corpus("float32", 1000, 16, 8, seed=41)
    got = streaming.blocked_top_k(k=10, **args)
    _check(got, *golden_top_k(scores, 10))


def test_dense_stream_top_k_quantized_queries_on_the_fly():
    from a_nice_rag_tpu.ops.quantized import (
        quantize_embeddings,
        quantized_dense_top_k,
    )

    rng = np.random.default_rng(51)
    qd = quantize_embeddings(jnp.asarray(rng.standard_normal((500, 32))))
    q = jnp.asarray(rng.standard_normal((6, 32)).astype(np.float32))
    want_v, want_i = quantized_dense_top_k(qd, q, 9)
    for route in (Route(True, False), Route(True, True, True)):
        v, i = dense_stream_top_k(qd, q, 9, route)
        np.testing.assert_array_equal(np.asarray(i), np.asarray(want_i))
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want_v))


# --- merge, plan and route ---------------------------------------------

def test_merge_candidates_orders_ties_by_id_and_pads():
    vals = jnp.asarray([[1.0, 3.0, 3.0, -jnp.inf, 2.0]])
    ids = jnp.asarray([[4, 9, 2, -1, 7]], jnp.int32)
    v, i = merge_candidates(vals, ids, 5)
    np.testing.assert_array_equal(np.asarray(i), [[2, 9, 7, 4, -1]])
    assert np.isneginf(np.asarray(v)[0, -1])


@pytest.mark.parametrize("b,n_units,d,k", [
    (1, 16384, 256, 25), (16, 300, 256, 25), (256, 81920, 1024, 25),
    (300, 10, 2048, 128),
])
def test_plan_blocks_are_powers_of_two(b, n_units, d, k):
    p = plan(b, n_units, d, k, 128)
    for x in (p.bq, p.bn, p.bk, p.kp):
        assert x >= 1 and x & (x - 1) == 0
    assert p.kp >= k and p.bq >= 16 and p.bk >= 16
    assert p.per_split * p.splits >= n_units
    assert (p.splits - 1) * p.per_split < n_units


@pytest.mark.parametrize("n,k,backend,platform,interpret,want", [
    (STREAM_THRESHOLD, 25, "auto", "gpu", False, (True, True, False)),
    (STREAM_THRESHOLD - 1, 25, "auto", "gpu", False, (False, False, False)),
    (10_485_760, 25, "auto", "cpu", False, (False, False, False)),
    (10_485_760, 200, "auto", "gpu", False, (True, False, False)),
    (100, 25, "stream", "cpu", False, (True, False, False)),
    (100, 25, "stream", "cpu", True, (True, True, True)),
    (100, 25, "stream", "gpu", False, (True, True, False)),
    (10_485_760, 25, "xla", "gpu", False, (False, False, False)),
])
def test_choose_route(n, k, backend, platform, interpret, want):
    assert choose_route(n, k, backend, platform, interpret) == want


def test_choose_route_rejects_unknown_backend():
    with pytest.raises(ValueError):
        choose_route(100, 5, "pallas", "cpu")


@pytest.mark.parametrize("emb_dtype", ["bfloat16", "float32"])
def test_routes_agree_on_one_index(emb_dtype):
    """f32 queries against one index: the materializing route, the
    blocked form and the kernel score at one precision (queries rounded
    to the index dtype), so all three return the same ids."""
    from a_nice_rag_tpu.index import build_index
    from a_nice_rag_tpu.retrieval import FusedRetriever

    rng = np.random.default_rng(61)
    n, d, b = 3000, 64, 24
    e = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    idx = build_index(ids=[f"d{i}" for i in range(n)], sources=["CG"] * n,
                      contents=[""] * n, embeddings={"m": e},
                      emb_dtype=emb_dtype, normalize=True)
    got = {}
    for backend, interpret in (("xla", False), ("stream", False),
                               ("stream", True)):
        fr = FusedRetriever(idx, ("m",), use_bm25=False, similarity_k=20,
                            common_sections_n=20, dense_backend=backend,
                            interpret=interpret)
        got[fr.route] = np.asarray(fr({"m": q}, None, {"m": 1.0})[0])
    assert len(got) == 3
    xla = got[Route(False, False)]
    for ids in got.values():
        np.testing.assert_array_equal(ids, xla)


# --- compiled for the card (skips on the CPU) --------------------------

GPU_CASES = [
    # (dtype, n, d, b, k, masked, table)
    ("bfloat16", 200_003, 256, 64, 25, False, False),
    ("bfloat16", 200_003, 256, 64, 25, True, False),
    ("float32", 50_000, 128, 16, 10, False, False),
    ("int8", 100_003, 1024, 32, 25, True, False),
    ("bfloat16", 1 << 18, 256, 16, 25, False, True),
    ("int8", 1 << 18, 1024, 64, 25, False, True),
]


def check_compiled_kernel(device, case):
    """Compile the kernel for ``device`` and compare it with the golden
    top-k (exact: integer-valued data)."""
    dtype, n, d, b, k, masked, table = case
    with jax.default_device(device):
        args, scores = _corpus(dtype, n, d, b, seed=n)
        mask = (np.random.default_rng(1).random(n) < 0.5) if masked else None
        kw = {}
        if table:
            tile_n = 1024
            t = np.array(list(range(0, n // tile_n, 3)) + [-1] * 5, np.int32)
            keep = np.zeros(n, bool)
            for x in t[t >= 0]:
                keep[x * tile_n:(x + 1) * tile_n] = True
            kw = dict(tiles=jnp.asarray(t), tile_n=tile_n)
            mask_ref = keep
        else:
            mask_ref = mask
            if mask is not None:
                kw = dict(mask=jnp.asarray(mask))
        got = jax.jit(lambda a: stream_top_k(k=k, **a, **kw))(args)
        _check(got, *golden_top_k(scores, k, mask_ref))


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_CASES)
def test_kernel_compiled_for_the_card(gpu_device, case):
    check_compiled_kernel(gpu_device, case)
