"""MVCC garbage collection worker.

Reference parity: pkg/store/gcworker/gc_worker.go — compute a safe point
(now - gc life time), resolve stale locks below it, then drop unreachable
versions. Single-process build runs it on a daemon thread or on demand
(tests call run_once)."""

from __future__ import annotations

import threading
import time
from typing import Optional

from tidb_tpu_torch.kv.kv import TimestampOracle
from tidb_tpu_torch.kv.memstore import MemStore


class GCWorker:
    def __init__(self, store: MemStore, life_ms: int = 600_000, interval_s: float = 600.0):
        self.store = store
        self.life_ms = life_ms
        self.interval_s = interval_s
        self.safe_point = 0
        self.runs = 0
        self.last_pruned = 0
        # background-loop failure visibility (the loop itself never dies)
        self.sweep_errors = 0
        self.last_error = ""
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def compute_safe_point(self) -> int:
        now_ms = int(time.time() * 1000)
        return max(0, (now_ms - self.life_ms)) << TimestampOracle._PHYSICAL_SHIFT

    def run_once(self, safe_point: Optional[int] = None) -> int:
        """One GC cycle: resolve expired locks under the safe point, then
        prune versions. Returns pruned version count."""
        sp = self.compute_safe_point() if safe_point is None else safe_point
        # service safepoints (log-backup checkpoints) pin GC — versions the
        # change feed has not captured yet must survive (ref: PD service
        # safepoints registered by br log backup)
        svc = self.store.min_service_safepoint()
        if svc is not None:
            sp = min(sp, svc)
        # resolve abandoned locks first (ref: gc_worker resolveLocks phase)
        with self.store._mu:
            stale = [
                (k, lock) for k, lock in self.store._locks.items() if lock.start_ts < sp and lock.expired()
            ]
        for k, lock in stale:
            self.store.resolve_lock(k, lock)
        pruned = self.store.gc(sp)
        self.safe_point = max(self.safe_point, sp)
        self.runs += 1
        self.last_pruned = pruned
        return pruned

    def start(self) -> None:
        if self._thread is not None:
            return

        def loop():
            while not self._stop.wait(self.interval_s):
                try:
                    self.run_once()
                except Exception as e:
                    # GC must never take the server down, but a failing sweep
                    # must be visible (sys_snapshot ships the registry)
                    self.sweep_errors += 1
                    self.last_error = f"{type(e).__name__}: {e}"

        self._thread = threading.Thread(target=loop, name="gc-worker", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1)
            self._thread = None
