"""Wait-for-graph deadlock detector for pessimistic locking.

Reference parity: pkg/store/mockstore/unistore/tikv/detector.go — a digraph
of start_ts → start_ts wait edges; a lock request that would close a cycle is
rejected with DeadlockError (the requester is the victim, matching TiKV's
first-in-wins policy).
"""

from __future__ import annotations

import threading

from tidb_tpu_torch.kv.kv import DeadlockError


class DeadlockDetector:
    def __init__(self):
        self._mu = threading.Lock()
        # waiter start_ts → {holder start_ts: key}
        self._edges: dict[int, dict[int, bytes]] = {}

    def register(self, waiter: int, holder: int, key: bytes) -> None:
        """Add a wait edge; raises DeadlockError if it closes a cycle."""
        with self._mu:
            # path holder →* waiter already? then waiter → holder closes it
            if self._reaches(holder, waiter):
                raise DeadlockError(waiter, holder, key)
            self._edges.setdefault(waiter, {})[holder] = key

    def _reaches(self, src: int, dst: int) -> bool:
        stack, seen = [src], set()
        while stack:
            n = stack.pop()
            if n == dst:
                return True
            if n in seen:
                continue
            seen.add(n)
            stack.extend(self._edges.get(n, ()))
        return False

    def unregister(self, waiter: int, holder: int | None = None) -> None:
        with self._mu:
            if holder is None:
                self._edges.pop(waiter, None)
            else:
                edges = self._edges.get(waiter)
                if edges is not None:
                    edges.pop(holder, None)
                    if not edges:
                        del self._edges[waiter]

    def clean_up(self, txn_ts: int) -> None:
        """Txn finished: drop all its edges (as waiter)."""
        self.unregister(txn_ts)
