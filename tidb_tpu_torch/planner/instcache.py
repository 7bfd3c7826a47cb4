"""Instance-level (cross-session) plan cache.

Reference parity: the ``tidb_enable_instance_plan_cache`` plan cache
(pkg/planner/core/plan_cache_instance.go) — one LRU shared by every session
of the SQL instance, so short-lived connections reuse the warm parse/plan
state a long-lived session would have accumulated. Here "instance" is the
:class:`~tidb_tpu.session.DB` handle (one embedded SQL node); the DB owns
two of these — statement-text → AST entries and prepared-plan templates.

Concurrency: the LRU is lock-striped — each key hashes to one of N
independent (lock, OrderedDict) stripes, so concurrent sessions contend
only when their statements land on the same stripe, not on one global
mutex. Entries carry their own validity epochs in the KEY (schema/stats/
binding versions, session-shaped knobs), so an invalidated entry is simply
never looked up again and ages out of its stripe's LRU tail.

Values must be safe to SHARE across sessions: ASTs are reused read-only
(planning never mutates its input), and plan templates are immutable — each
execution clones the mutable leaves (``prepcache.instantiate``) before
rebinding parameters.
"""

from __future__ import annotations

import threading
from collections import OrderedDict


class InstancePlanCache:
    """Lock-striped LRU: capacity splits evenly across the stripes (each
    stripe evicts independently, so the total stays bounded by ``capacity``
    without a global lock on every touch)."""

    def __init__(self, capacity: int = 512, stripes: int = 8):
        stripes = max(int(stripes), 1)
        self._per_cap = max(int(capacity) // stripes, 1)
        self._stripes = [
            (threading.Lock(), OrderedDict()) for _ in range(stripes)
        ]

    def _stripe(self, key):
        return self._stripes[hash(key) % len(self._stripes)]

    def get(self, key):
        lock, od = self._stripe(key)
        with lock:
            v = od.get(key)
            if v is not None:
                od.move_to_end(key)
            return v

    def put(self, key, value) -> None:
        lock, od = self._stripe(key)
        with lock:
            od[key] = value
            od.move_to_end(key)
            while len(od) > self._per_cap:
                od.popitem(last=False)

    def pop(self, key):
        lock, od = self._stripe(key)
        with lock:
            return od.pop(key, None)

    def clear(self) -> None:
        for lock, od in self._stripes:
            with lock:
                od.clear()

    def __len__(self) -> int:
        n = 0
        for lock, od in self._stripes:
            with lock:
                n += len(od)
        return n

    def values(self) -> list:
        """Snapshot of every cached value (tests / diagnostics)."""
        out = []
        for lock, od in self._stripes:
            with lock:
                out.extend(od.values())
        return out
