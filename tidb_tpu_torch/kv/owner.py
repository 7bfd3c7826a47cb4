"""Owner election (ref: pkg/owner/manager.go:49 — etcd campaign-based
singleton election for DDL/stats owners).

In the embedded single-process deployment the election is trivially local,
but the seam matters: every would-be owner (DDL worker, stats owner, TTL
coordinator) campaigns through this interface, so a multi-process build
swaps the backend (etcd/raft lease) without touching the callers — exactly
how the reference keeps `owner.Manager` pluggable."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Optional


@dataclass
class _Election:
    owner_id: Optional[str] = None
    lease_deadline: float = 0.0
    term: int = 0
    lease_s: Optional[float] = None  # per-election override of the default


class OwnerManager:
    """Campaign/resign/retire API compatible with the reference's usage."""

    def __init__(self, lease_s: float = 10.0):
        self._mu = threading.Lock()
        self._elections: dict[str, _Election] = {}
        self.lease_s = lease_s

    def campaign(
        self,
        key: str,
        node_id: str,
        lease_s: Optional[float] = None,
        term: Optional[int] = None,
    ) -> bool:
        """Try to become the owner of ``key``; re-campaigning refreshes the
        lease. ``lease_s`` overrides the lease duration for THIS election
        only (other keys keep the manager default). Returns True when
        ``node_id`` is (now) the owner.

        With ``term`` given this is a FENCED RENEWAL (the term-checked grant
        path): it refreshes only while ``node_id`` still owns the key at
        exactly that term — after a failover bumped the term, the deposed
        owner's renewals are rejected even once the new lease expires, so a
        stale owner can never silently resume (kv/election.py runs the same
        rule against the quorum keyspace)."""
        now = time.monotonic()
        with self._mu:
            el = self._elections.setdefault(key, _Election())
            if lease_s is not None:
                el.lease_s = lease_s
            if term is not None:
                if el.owner_id != node_id or el.term != term or now > el.lease_deadline:
                    return False
                el.lease_deadline = now + (el.lease_s if el.lease_s is not None else self.lease_s)
                return True
            if el.owner_id is None or el.owner_id == node_id or now > el.lease_deadline:
                if el.owner_id != node_id:
                    el.term += 1
                el.owner_id = node_id
                el.lease_deadline = now + (el.lease_s if el.lease_s is not None else self.lease_s)
                return True
            return False

    def is_owner(self, key: str, node_id: str) -> bool:
        with self._mu:
            el = self._elections.get(key)
            return (
                el is not None
                and el.owner_id == node_id
                and time.monotonic() <= el.lease_deadline
            )

    def owner(self, key: str) -> Optional[str]:
        with self._mu:
            el = self._elections.get(key)
            if el is None or time.monotonic() > el.lease_deadline:
                return None
            return el.owner_id

    def resign(self, key: str, node_id: str) -> None:
        with self._mu:
            el = self._elections.get(key)
            if el is not None and el.owner_id == node_id:
                el.owner_id = None
                el.lease_deadline = 0.0

    def term(self, key: str) -> int:
        with self._mu:
            el = self._elections.get(key)
            return el.term if el else 0

    def snapshot(self) -> dict:
        """Observability: {key: {owner, term, lease_remaining_s}} (the same
        shape QuorumElection.snapshot() serves on the status port)."""
        now = time.monotonic()
        with self._mu:
            out = {}
            for key, el in self._elections.items():
                live = el.owner_id is not None and now <= el.lease_deadline
                out[key] = {
                    "owner": el.owner_id if live else None,
                    "term": el.term,
                    "lease_remaining_s": round(max(0.0, el.lease_deadline - now), 3) if live else 0.0,
                }
            return out
