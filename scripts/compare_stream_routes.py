"""End-to-end time of FusedRetriever on each dense route, on one GPU.

For the 2M x 256 bf16 hybrid (B=256), the 10.5M x 1024 int8 corpus
(B=256) and IVF on a clustered 2M corpus (B=16), times
``retrieve_device`` with ``block_until_ready`` on:

* ``kernel``: the streaming route through the Pallas kernel (what the
  route choice picks on the GPU);
* ``blocked``: the streaming route through the plain blocked form
  (per chunk a matmul and ``top_k``, then one merge);
* ``materialize``: the plain XLA route that writes [B, N] scores
  (exact stages only, and only below 2**31 score elements, past which
  XLA rejects the shape).

Routes take turns (kernel, blocked, materialize, then the reverse) in
one process, so both see the same card. Prints one JSON line per stage,
then one with the card. Usage: ``python scripts/compare_stream_routes.py``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

MODEL = "voyage-3-large"


def _blocked_route(*args, **kwargs):
    """The streaming route with the kernel swapped for the plain form."""
    from a_nice_rag_tpu.ops.streaming import Route

    return Route(stream=True, kernel=False)


def _retrievers(make):
    """{route name: retriever}; ``make(**kw)`` builds one."""
    import a_nice_rag_tpu.retrieval.engine as engine

    out = {"kernel": make()}
    real = engine.choose_route
    engine.choose_route = _blocked_route
    try:
        out["blocked"] = make()
    finally:
        engine.choose_route = real
    return out


def _time(calls, reps=5):
    """Median ms per route, routes taking turns."""
    import jax

    for fn in calls.values():
        jax.block_until_ready(fn())
    ts = {name: [] for name in calls}
    order = list(calls)
    for rep in range(reps):
        for name in (order if rep % 2 == 0 else order[::-1]):
            t0 = time.perf_counter()
            jax.block_until_ready(calls[name]())
            ts[name].append((time.perf_counter() - t0) * 1e3)
    return {name: round(float(np.median(v)), 4) for name, v in ts.items()}


def main():
    import gc

    import jax

    from a_nice_rag_tpu.index.ivf import attach_ivf
    from a_nice_rag_tpu.retrieval import FusedRetriever
    from a_nice_rag_tpu.testing.scale import clustered_2m, hybrid_2m, int8_10m
    from a_nice_rag_tpu.utils.compile_cache import enable_compile_cache

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit("compare_stream_routes: needs a GPU")
    enable_compile_cache()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()

    stages = (
        ("stream-2m hybrid B=256", hybrid_2m, True, 32, None),
        ("stream-int8-10m B=256", int8_10m, False, 25, None),
        ("ivf-2m B=16 nprobe=16", lambda: clustered_2m(b=16), False, 10, 16),
    )
    for name, gen, bm25, k, nprobe in stages:
        c = gen()
        if nprobe:
            attach_ivf(c.index, MODEL, tile_n=1024, n_iters=10, seed=0)
        w = {MODEL: 5.0, "BM25": 1.0} if bm25 else {MODEL: 1.0}
        qd = {MODEL: c.queries}

        def make(backend="auto"):
            return FusedRetriever(c.index, (MODEL,), use_bm25=bm25,
                                  similarity_k=k, common_sections_n=k,
                                  budget=1024, nprobe=nprobe,
                                  dense_backend=backend)

        retrs = _retrievers(make)
        n = c.index.n_docs
        if not nprobe and c.queries.shape[0] * n < 2**31:
            retrs["materialize"] = make("xla")
        ids = {r: np.asarray(x.retrieve_device(qd, c.terms, w)[0])
               for r, x in retrs.items()}
        ms = _time({r: (lambda x=x: x.retrieve_device(qd, c.terms, w)[0])
                    for r, x in retrs.items()})
        print(json.dumps({
            "stage": name, "ms": ms,
            "rows_equal_to_kernel": {
                r: int((v == ids["kernel"]).all(axis=1).sum())
                for r, v in ids.items()},
            "batch": int(c.queries.shape[0]),
        }), flush=True)
        del c, retrs, ids
        gc.collect()
    print(json.dumps({"card": card, "device_kind": dev.device_kind}))


if __name__ == "__main__":
    main()
