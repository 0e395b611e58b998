"""Device health monitoring + automatic shard recovery.

The reference's failure handling is app-level graceful degradation
(SURVEY.md §5: rerank fallback, missing-BM25 => dense-only; reference
src/search_engine.py:201-203, src/query_rag.py:100-106). The on-device
analog guards the hardware layer: a monitor probes every device in the
serving mesh with a tiny roundtrip computation, and when a chip stops
answering it rebuilds the sharded index over the surviving pool
(parallel.sharded.reshard_surviving) and hands the fresh ShardedIndex to
a rebuild callback so the caller can recreate its retrievers. Spare
devices may sit in the pool unused by the active mesh; they join
automatically on the next recovery ("warm spares").

Fault injection (absent in the reference, noted in SURVEY.md §5) comes
for free: pass ``probe_fn`` to fake any device's death in tests.
"""

from __future__ import annotations

import concurrent.futures
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

logger = logging.getLogger(__name__)


def default_probe(device, timeout_s: float) -> bool:
    """True iff the device answers a tiny computation within timeout.

    Forces a VALUE read (not block_until_ready) so a wedged device
    cannot report healthy.
    """
    import jax
    import jax.numpy as jnp

    def attempt():
        x = jax.device_put(jnp.arange(8, dtype=jnp.float32), device)
        return float((x * 2.0).sum())

    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(attempt)
        try:
            return fut.result(timeout=timeout_s) == 56.0
        except Exception:  # noqa: BLE001 — any failure means unhealthy
            return False


class DeviceHealthMonitor:
    """Probe the device pool; reshard the corpus over survivors on failure.

    Args:
        sidx: the live ShardedIndex being served.
        rebuild: callback receiving the recovered ShardedIndex; recreate
            retrievers there. Called on the monitor thread.
        pool: candidate devices (default: the active mesh's devices).
            Devices beyond the active mesh act as warm spares.
        dp: data-parallel axis size to preserve on recovery.
        probe_timeout_s / probe_interval_s: failure detector knobs.
        probe_fn: (device, timeout_s) -> bool; injectable for tests.
    """

    def __init__(
        self,
        sidx,
        rebuild: Callable[[object], None],
        pool: Optional[Sequence] = None,
        dp: int = 1,
        probe_timeout_s: float = 10.0,
        probe_interval_s: float = 30.0,
        probe_fn: Callable = default_probe,
    ):
        self.sidx = sidx
        self.rebuild = rebuild
        self.pool: List = list(
            pool if pool is not None else np.asarray(sidx.mesh.devices).ravel()
        )
        self.dp = dp
        self.probe_timeout_s = probe_timeout_s
        self.probe_interval_s = probe_interval_s
        self.probe_fn = probe_fn
        self.events: List[Dict] = []  # audit log of probes + recoveries
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------

    def probe(self) -> Dict:
        """One-shot health check of the pool: device -> healthy bool."""
        return {
            d: self.probe_fn(d, self.probe_timeout_s) for d in self.pool
        }

    def active_devices(self) -> List:
        return list(np.asarray(self.sidx.mesh.devices).ravel())

    def check_and_recover(self) -> bool:
        """Probe; if any ACTIVE device died, reshard over healthy pool
        devices (spares included). Returns True when a recovery ran."""
        health = self.probe()
        dead_active = [
            d for d in self.active_devices() if not health.get(d, False)
        ]
        self.events.append(
            {
                "ts": time.time(),
                "healthy": sum(health.values()),
                "dead_active": len(dead_active),
            }
        )
        if not dead_active:
            return False
        survivors = [d for d in self.pool if health[d]]
        usable = (len(survivors) // self.dp) * self.dp
        if usable < self.dp:
            logger.error(
                "health: %d dead, only %d survivors — cannot reshard",
                len(dead_active), len(survivors),
            )
            self.events[-1]["recovered"] = False
            return False
        from a_nice_rag_tpu.parallel.sharded import reshard_surviving

        logger.warning(
            "health: %d active device(s) dead; resharding over %d survivors",
            len(dead_active), usable,
        )
        self.sidx = reshard_surviving(
            self.sidx, survivors[:usable], dp=self.dp
        )
        self.rebuild(self.sidx)
        self.events[-1]["recovered"] = True
        self.events[-1]["n_shards"] = self.sidx.n_shards
        return True

    # ------------------------------------------------------------------

    def start(self) -> None:
        """Run check_and_recover on a background thread every interval."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(self.probe_interval_s):
                try:
                    self.check_and_recover()
                except RuntimeError as e:
                    if "interpreter shutdown" in str(e):
                        return  # process exiting; wind the daemon down
                    logger.exception("health: probe cycle failed")
                except Exception:  # noqa: BLE001 — keep the monitor alive
                    logger.exception("health: probe cycle failed")

        self._thread = threading.Thread(
            target=loop, name="device-health", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
