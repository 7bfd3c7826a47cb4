"""Memory tracking with OOM actions (ref: pkg/util/memory/tracker.go:77).

A Tracker tree mirrors the executor tree: children consume() bytes, the
deltas propagate to the root (the per-query tracker holding the quota from
``tidb_mem_quota_query``). On quota excess the tracker fires its registered
actions in priority order — spill callbacks first (ref: SpillDiskAction),
then cancel (ref: PanicOnExceed, the tidb_mem_oom_action=CANCEL default).
"""

from __future__ import annotations

import threading
from typing import Callable, Optional


class QueryOOMError(RuntimeError):
    """Out Of Memory Quota! (ref: memory usage exceeds quota cancel message)"""


class QueryKilledError(RuntimeError):
    """Query interrupted (ref: sqlkiller / max_execution_time)."""


class Tracker:
    def __init__(self, label: str, limit: int = -1, parent: Optional["Tracker"] = None):
        self.label = label
        self.limit = limit  # bytes; -1 = unlimited
        self.parent = parent
        self._mu = threading.Lock()
        self.consumed = 0
        self.max_consumed = 0
        # spill actions, tried largest-win first before cancelling
        self._spill_actions: list[Callable[[], int]] = []

    def child(self, label: str, limit: int = -1) -> "Tracker":
        return Tracker(label, limit, parent=self)

    def register_spill(self, action: Callable[[], int]) -> None:
        """``action() -> bytes freed``; fired on quota excess (root-first)."""
        self._spill_actions.append(action)

    def unregister_spill(self, action: Callable[[], int]) -> None:
        if action in self._spill_actions:
            self._spill_actions.remove(action)

    def consume(self, n: int) -> None:
        t: Optional[Tracker] = self
        while t is not None:
            with t._mu:
                t.consumed += n
                t.max_consumed = max(t.max_consumed, t.consumed)
                over = t.limit >= 0 and t.consumed > t.limit
            if over:
                t._on_exceed()
            t = t.parent

    def release(self, n: int) -> None:
        self.consume(-n)

    def _on_exceed(self) -> None:
        # spill until under the limit; each action reports bytes it freed
        for action in list(self._spill_actions):
            if self.consumed <= self.limit:
                return
            action()
        if self.consumed > self.limit:
            raise QueryOOMError(
                f"Out Of Memory Quota! [{self.label}] consumed={self.consumed} limit={self.limit}"
            )


def chunk_bytes(chunk) -> int:
    """Approximate host memory a Chunk pins (column data + validity)."""
    total = 0
    for c in chunk.columns:
        data = getattr(c, "data", None)
        if data is not None and hasattr(data, "nbytes"):
            total += data.nbytes
        v = getattr(c, "validity", None)
        if v is not None and hasattr(v, "nbytes"):
            total += v.nbytes
    return total
