"""Native binary serving front: C++ socket layer + one Python dispatcher.

``NativeRetrievalFront`` starts the native server (native/anr_serve.cpp)
and a single Python dispatch thread. The native threads own accept /
frame parsing / batching / reply framing; Python wakes once per BATCH:

    poll (fills preallocated buffers, GIL released while waiting)
      -> pad to the power-of-two bucket
      -> FusedRetriever.retrieve_device (ONE fused program launch)
      -> reply per frame (native code frames + writes the sockets)

This replaces the Python HTTP front's per-request work (HTTP parse,
JSON, base64) with native parsing, so the host layer stops being the
ceiling of the serving path (not measured on the H100). It is the on-device analog of
the reference's serving hop (reference src/app.py:200-229 one query per
Streamlit callback): batch formation happens at the socket layer.

The front serves the production single-dense-model (+BM25) retrieval
configuration with fixed weights/filter/wrrf_k — one compiled program
family per front. Richer knobs stay on the HTTP surface.
"""

from __future__ import annotations

import ctypes
import logging
import socket
import struct
import threading
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_MAGIC_REQ = 0x51524E41  # "ANRQ"
_MAGIC_REP = 0x50524E41  # "ANRP"
_MAGIC_ERR = 0x45524E41  # "ANRE"


class NativeFrontUnavailable(RuntimeError):
    """No C++ toolchain: callers should fall back to the HTTP front."""


class NativeRetrievalFront:
    def __init__(
        self,
        retriever,
        weights: Dict[str, float],
        host: str = "127.0.0.1",
        port: int = 0,
        t_max: int = 32,
        max_batch: int = 512,
        wait_ms: float = 2.0,
        filename_type_filter: Optional[str] = None,
        wrrf_k: float = 40.0,
        max_frame_rows: int = 2048,
        inflight: int = 4,
        collect_ms: float = 2.0,
        max_queued_rows: Optional[int] = None,
        wire_dtype: str = "f32",
    ):
        """``inflight`` dispatch threads pipeline poll -> device ->
        reply: while one batch's results download, the next batch
        launches. Device execution
        serializes; the overlap hides host<->device transfer, same as
        BatchScheduler(max_inflight=). ``collect_ms`` is the native
        batch-formation window: once a frame arrives, the poll keeps
        collecting stragglers that long (or until max_batch rows wait)
        before dispatching — the scheduler's max_wait_ms analog.
        ``max_queued_rows`` caps the native request queue (default
        8 x max_batch); past it readers block, so a client pipelining
        faster than the device drains hits TCP backpressure instead of
        growing server memory without bound.

        ``wire_dtype``: "f32" (default) or "bf16". bf16 halves the
        bytes per row on BOTH hops of the serving path — the client
        socket frame and, because the dispatcher uploads the polled
        rows as-is, the host->device transfer (4.26 MB per batch of 512
        at D=2048 in f32; the effect on served throughput is not
        measured on the H100). Scores are then computed from
        bf16-rounded query embeddings — equivalent to serving a query
        quantized one step, NOT a rounded comparison: ranking is still exact
        f32 ordering OF the rounded query's scores. Clients must send
        matching frames (NativeFrontClient(wire_dtype=...)); the
        server rejects mismatched frames with a clear error.

        "int8" quarters the bytes per row: each wire row is dim int8
        components + one trailing f32 per-row scale (stride dim+4;
        client encodes scale = max|x|/127, so precision adapts to the
        row's magnitude — essential for high-dim unit-norm embeddings
        whose components are ~1/sqrt(D)). The dispatcher uploads the
        int8 rows + scales AS-IS and dequantizes on device (one fused
        jit), so the host->device hop also ships a quarter of the f32
        bytes. Like bf16, ranking is the exact f32 ordering of the
        quantized query's scores; per-query positive scaling leaves
        dense rankings unchanged, and the restored magnitudes keep
        threshold semantics."""
        from a_nice_rag_tpu.native.build import load_serve_lib

        lib = load_serve_lib()
        if lib is None:
            raise NativeFrontUnavailable(
                "native serving front unavailable (no C++ toolchain); "
                "use the HTTP front (serving.serve_cli)"
            )
        if len(retriever.model_names) != 1:
            raise ValueError(
                "the native front serves the single-dense-model "
                f"configuration; got models {retriever.model_names!r}"
            )
        self._lib = lib
        self.retriever = retriever
        self.model = retriever.model_names[0]
        self.weights = dict(weights)
        self.filename_type_filter = filename_type_filter
        self.wrrf_k = float(wrrf_k)
        self.t_max = int(t_max)
        self.max_batch = int(max_batch)
        self.wait_ms = float(wait_ms)
        self.collect_ms = float(collect_ms)
        # Scoring-operand dim, covering every retriever flavor: a
        # FusedRetriever's model lives in index.dense OR (int8) in
        # index.dense_q (dense_matrix handles both; QuantizedDense
        # carries [N, D] .values); a ShardedRetriever holds a
        # ShardedIndex at .sidx instead of .index.
        sidx = getattr(retriever, "sidx", None)
        if sidx is not None:
            mat = sidx.dense[self.model]
            self._dp = int(sidx.mesh.shape[sidx.data_axis])
        else:
            mat = retriever.index.dense_matrix(self.model)
            self._dp = 1
        self.dim = int(getattr(mat, "values", mat).shape[-1])
        if wire_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                "wire_dtype must be 'f32', 'bf16', or 'int8', "
                f"got {wire_dtype!r}"
            )
        self.wire_dtype = wire_dtype
        self._wire_esz = {"f32": 4, "bf16": 2, "int8": 1}[wire_dtype]
        if wire_dtype == "int8":
            import jax
            import jax.numpy as jnp

            # Device-side dequant: i8 * per-row scale, exact in f32.
            # Keeping it on device is the point — the polled int8
            # rows + [B] scales are what crosses the host->device
            # link.
            self._dequant = jax.jit(
                lambda i8, s: i8.astype(jnp.float32) * s[:, None]
            )
        self._h = lib.anr_serve_start(
            host.encode(), int(port), self.dim, self.t_max,
            int(min(max_frame_rows, max_batch)),
            int(max_queued_rows if max_queued_rows is not None
                else 8 * self.max_batch),
            self._wire_esz,
        )
        if not self._h:
            raise OSError(f"native front failed to bind {host}:{port}")
        self.port = int(lib.anr_serve_port(self._h))
        self.host = host
        self._max_frames = self.max_batch  # 1-row frames worst case
        self.batches_run = 0
        self.rows_served = 0
        self._count_mu = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(
                target=self._dispatch_loop, daemon=True,
                name=f"native-front-{i}",
            )
            for i in range(max(1, int(inflight)))
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------

    def _bucket(self, n: int) -> int:
        b = 1
        while b < n:
            b <<= 1
        # Sharded retrievers need batches divisible by the mesh's dp
        # axis; lift the power-of-two bucket to a dp multiple.
        if self._dp > 1:
            b = max(b, self._dp)
            if b % self._dp:
                b = (b // self._dp + 1) * self._dp
        return b

    def _dispatch_loop(self) -> None:
        lib = self._lib
        # Per-thread poll buffers: each dispatch thread owns one set,
        # so polls from different threads never alias. In bf16 wire
        # mode the buffer holds raw bf16 rows (ml_dtypes view) so the
        # device upload ships half the bytes.
        if self.wire_dtype == "bf16":
            import ml_dtypes

            emb_buf = np.empty((self.max_batch, self.dim),
                               ml_dtypes.bfloat16)
        elif self.wire_dtype == "int8":
            # Raw wire rows: dim int8 components + trailing f32 scale.
            emb_buf = np.empty((self.max_batch, self.dim + 4), np.uint8)
        else:
            emb_buf = np.empty((self.max_batch, self.dim), np.float32)
        terms_buf = np.empty((self.max_batch, self.t_max), np.int32)
        tokens = (ctypes.c_uint64 * self._max_frames)()
        frame_counts = (ctypes.c_int32 * self._max_frames)()
        emb_p = ctypes.c_void_p(emb_buf.ctypes.data)
        terms_p = terms_buf.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        while not self._stop.is_set():
            n = lib.anr_serve_poll(
                self._h, self.max_batch, self.wait_ms, emb_p, terms_p,
                tokens, frame_counts, self._max_frames, self.collect_ms,
            )
            if n < 0:
                break
            if n == 0:
                continue
            counts = [int(frame_counts[i]) for i in range(n)]
            toks = [int(tokens[i]) for i in range(n)]
            try:
                rows, scores = self._run_batch(
                    emb_buf, terms_buf, sum(counts)
                )
            except Exception as e:  # noqa: BLE001 — serving boundary
                logger.exception("native front dispatch failed")
                msg = str(e)[:200].encode()
                for tok in toks:
                    lib.anr_serve_reply_error(self._h, tok, msg)
                continue
            n_out = rows.shape[1]
            off = 0
            for tok, c in zip(toks, counts):
                r = np.ascontiguousarray(rows[off:off + c], np.int32)
                s = np.ascontiguousarray(scores[off:off + c], np.float32)
                lib.anr_serve_reply(
                    self._h, tok, c, n_out,
                    r.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    s.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                )
                off += c
            with self._count_mu:
                self.batches_run += 1
                self.rows_served += off

    def _run_batch(
        self, emb_buf: np.ndarray, terms_buf: np.ndarray, rows: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        b_pad = self._bucket(rows)
        if self.wire_dtype == "int8":
            # [rows, dim+4] uint8 -> int8 rows + f32 scales; pad and
            # dequantize ON DEVICE (self._dequant) so the upload ships
            # 1 byte per component.
            q_i8 = np.zeros((b_pad, self.dim), np.int8)
            q_i8[:rows] = emb_buf[:rows, : self.dim].view(np.int8)
            sc = np.zeros((b_pad,), np.float32)
            sc[:rows] = (
                emb_buf[:rows, self.dim:].copy().view(np.float32).ravel()
            )
            q = self._dequant(q_i8, sc)
        else:
            q = np.zeros((b_pad, self.dim), emb_buf.dtype)
            q[:rows] = emb_buf[:rows]
        terms = None
        if self.retriever.use_bm25:
            terms = np.full((b_pad, self.t_max), -1, np.int32)
            terms[:rows] = terms_buf[:rows]
        d_rows, d_scores, _ = self.retriever.retrieve_device(
            {self.model: q}, terms, self.weights,
            self.filename_type_filter, self.wrrf_k,
        )
        return np.asarray(d_rows), np.asarray(d_scores)

    # ------------------------------------------------------------------

    def stats(self) -> Dict[str, int]:
        if self._h is None:
            return {"batches_run": self.batches_run,
                    "rows_served": self.rows_served}
        frames = ctypes.c_uint64()
        rows = ctypes.c_uint64()
        bad = ctypes.c_uint64()
        self._lib.anr_serve_stats(
            self._h, ctypes.byref(frames), ctypes.byref(rows),
            ctypes.byref(bad),
        )
        return {
            "frames_in": frames.value,
            "rows_in": rows.value,
            "bad_frames": bad.value,
            "batches_run": self.batches_run,
            "rows_served": self.rows_served,
        }

    def stop(self) -> None:
        if self._stop.is_set():
            return
        self._stop.set()
        # Two-phase: stop wakes every blocked poll (handle stays
        # valid), free releases it once no dispatch thread can be
        # inside a lib call. The handle stays NON-None while any
        # dispatch thread is alive — a thread stuck in a long device
        # dispatch (a first compile) will still call
        # anr_serve_reply afterwards, which must see a live handle
        # (the C entry points also null-guard as a second line).
        self._lib.anr_serve_stop(self._h)
        for t in self._threads:
            t.join(timeout=30)
        alive = [t for t in self._threads if t.is_alive()]
        if alive:
            logger.warning(
                "native front: %d dispatch thread(s) still in flight "
                "at stop(); leaking the server handle rather than "
                "freeing under them", len(alive),
            )
            return
        self._lib.anr_serve_free(self._h)
        self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class NativeFrontClient:
    """Minimal blocking client for the binary front (tests + bench).

    One TCP connection; ``search`` sends a [B, D] query block (and
    optional [B, T] term ids) as one frame and blocks for its reply.
    Thread-safe for one in-flight request per client instance.
    """

    def __init__(self, host: str, port: int, timeout_s: float = 60.0,
                 wire_dtype: str = "f32"):
        if wire_dtype not in ("f32", "bf16", "int8"):
            raise ValueError(
                "wire_dtype must be 'f32', 'bf16', or 'int8', "
                f"got {wire_dtype!r}"
            )
        self.wire_dtype = wire_dtype
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._req_id = 0

    def _recv_all(self, n: int) -> bytes:
        chunks = []
        while n > 0:
            b = self._sock.recv(min(n, 1 << 20))
            if not b:
                raise ConnectionError("native front closed the connection")
            chunks.append(b)
            n -= len(b)
        return b"".join(chunks)

    def search(
        self,
        q: np.ndarray,
        terms: Optional[np.ndarray] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        if self.wire_dtype == "bf16":
            import ml_dtypes

            q = np.ascontiguousarray(q, ml_dtypes.bfloat16)
        else:
            q = np.ascontiguousarray(q, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        n_rows = q.shape[0]
        self._req_id += 1
        flags = {"f32": 0, "bf16": 2, "int8": 4}[self.wire_dtype]
        if self.wire_dtype == "int8":
            # Per-row symmetric quantization: scale = max|x|/127 so
            # precision tracks the row's magnitude. Wire row =
            # dim int8 + trailing f32 scale (stride dim+4).
            dim = q.shape[1]
            mx = np.max(np.abs(q), axis=1)
            scale = np.where(mx > 0, mx / 127.0, 1.0).astype(np.float32)
            i8 = np.clip(
                np.rint(q / scale[:, None]), -127, 127
            ).astype(np.int8)
            wire = np.empty((n_rows, dim + 4), np.uint8)
            wire[:, :dim] = i8.view(np.uint8)
            wire[:, dim:] = scale.view(np.uint8).reshape(n_rows, 4)
            body = wire.tobytes()
        else:
            body = q.tobytes()
        if terms is not None:
            t = np.ascontiguousarray(terms, np.int32)
            if t.ndim == 1:
                t = t[None, :]
            flags |= 1
            body += t.tobytes()
        payload = struct.pack("<IHH", self._req_id, n_rows, flags) + body
        self._sock.sendall(
            struct.pack("<II", _MAGIC_REQ, len(payload)) + payload
        )
        magic, plen = struct.unpack("<II", self._recv_all(8))
        payload = self._recv_all(plen)
        if magic == _MAGIC_ERR:
            raise RuntimeError(
                f"native front error: {payload[4:].decode(errors='replace')}"
            )
        if magic != _MAGIC_REP:
            raise ConnectionError(f"bad reply magic {magic:#x}")
        rid, nr, n_out = struct.unpack("<IHH", payload[:8])
        if rid != self._req_id:
            raise ConnectionError("reply req_id mismatch")
        nbytes = nr * n_out * 4
        rows = np.frombuffer(payload[8:8 + nbytes], np.int32)
        scores = np.frombuffer(payload[8 + nbytes:8 + 2 * nbytes], np.float32)
        return rows.reshape(nr, n_out), scores.reshape(nr, n_out)

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
