"""Client-side transaction: membuffer + two-phase commit driver.

Reference parity: pkg/session/txn.go (LazyTxn membuffer with per-statement
staging), tikv/client-go 2PC (prewrite primary-first → TSO commit_ts → commit
primary → commit secondaries), pkg/store/driver/txn. Single-process build
commits synchronously; the secondary-commit fan-out is where a multi-node
deployment parallelizes.
"""

from __future__ import annotations

import threading
from typing import Optional

from tidb_tpu_torch.kv.kv import (
    KeyLockedError,
    KeyRange,
    TxnAbortedError,
    UndeterminedError,
    WriteConflictError,
)
from tidb_tpu_torch.kv.memstore import MemStore, Mutation, OP_DEL, OP_PUT, Snapshot


class MemBuffer:
    """Uncommitted writes with statement staging (ref: LazyTxn staging,
    session/txn.go:128 flushStmtBuf)."""

    def __init__(self):
        self._buf: dict[bytes, tuple[str, bytes]] = {}
        self._stages: list[dict[bytes, tuple[str, bytes] | None]] = []

    def put(self, key: bytes, value: bytes) -> None:
        self._record(key)
        self._buf[key] = (OP_PUT, value)

    def delete(self, key: bytes) -> None:
        self._record(key)
        self._buf[key] = (OP_DEL, b"")

    def get(self, key: bytes):
        ent = self._buf.get(key)
        if ent is None:
            return None
        return None if ent[0] == OP_DEL else ent[1]

    def contains(self, key: bytes) -> bool:
        return key in self._buf

    def _record(self, key: bytes) -> None:
        if self._stages:
            st = self._stages[-1]
            if key not in st:
                st[key] = self._buf.get(key)

    # statement staging: begin at stmt start, rollback on stmt error
    def stage(self) -> None:
        self._stages.append({})

    def release_stage(self) -> None:
        self._stages.pop()

    def rollback_stage(self) -> None:
        for key, old in self._stages.pop().items():
            if old is None:
                self._buf.pop(key, None)
            else:
                self._buf[key] = old

    def mutations(self) -> list[Mutation]:
        return [Mutation(op, k, v) for k, (op, v) in sorted(self._buf.items())]

    def __len__(self) -> int:
        return len(self._buf)


def retry_locked(store, fn, max_retries: int = 16):
    """Run ``fn``, resolving any pending lock it trips over and backing off
    while the lock's holder is still alive — the reader-side
    Backoffer+ResolveLocks loop every kv read path needs (ref: client-go's
    snapshot reads under BoTxnLock; a reader surfacing KeyLocked raw would
    make every scan race concurrent writers)."""
    from tidb_tpu_torch.utils.backoff import Backoffer, BackoffExhausted, boTxnLock

    bo = Backoffer(budget_ms=2000)
    for i in range(max_retries):
        try:
            return fn()
        except KeyLockedError as e:
            store.resolve_lock(e.key, e.lock)
            if i > 0:
                try:
                    bo.backoff(boTxnLock)  # holder still alive: wait it out
                except BackoffExhausted:
                    break
    raise TxnAbortedError("lock resolution did not converge")


class Txn:
    """One transaction. Reads go to a start_ts snapshot overlaid with the
    membuffer; commit runs percolator 2PC against the store. In pessimistic
    mode, lock_keys acquires statement-time locks (ref: client-go
    LockKeys + sessiontxn/isolation pessimistic provider)."""

    def __init__(self, store: MemStore, start_ts: Optional[int] = None, pessimistic: bool = False):
        self.store = store
        self.start_ts = start_ts if start_ts is not None else store.tso.ts()
        self.snapshot = store.get_snapshot(self.start_ts)
        self.membuf = MemBuffer()
        self.commit_ts: Optional[int] = None
        self._done = False
        self.pessimistic = pessimistic
        self.for_update_ts = self.start_ts
        self._locked_keys: set[bytes] = set()
        self._pess_primary: Optional[bytes] = None
        self._primary: Optional[bytes] = None  # recorded at commit for resolve_undetermined
        # write-side accounting set by commit() (WRU metering inputs): unique
        # keys/bytes this txn wrote, from the prewrite response headers when
        # the store reports them, else computed client-side
        self.write_keys = 0
        self.write_bytes = 0

    # -- pessimistic locking ------------------------------------------------
    def lock_keys(self, keys, wait_timeout_ms: int = 3000) -> None:
        """Acquire pessimistic locks at a fresh for_update_ts. No-op for
        optimistic txns (commit-time conflict detection covers them)."""
        if not self.pessimistic or not keys:
            return
        new = [k for k in keys if k not in self._locked_keys]
        if not new:
            return
        if self._pess_primary is None:
            self._pess_primary = new[0]
        # a conflicting commit can land while we wait on its lock; refresh
        # for_update_ts and retry (ref: pessimistic lock retry in
        # session/txn pessimistic mode — the statement, not the txn, restarts)
        last: Exception | None = None
        for _ in range(8):
            self.for_update_ts = self.store.tso.ts()
            try:
                self.store.acquire_pessimistic_lock(
                    new, self._pess_primary, self.start_ts, self.for_update_ts, wait_timeout_ms
                )
                self._locked_keys.update(new)
                return
            except WriteConflictError as e:
                last = e
        raise last  # type: ignore[misc]

    # -- reads -------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        if self.membuf.contains(key):
            return self.membuf.get(key)
        return self._retry_locked(lambda: self.snapshot.get(key))

    def batch_get(self, keys) -> list:
        """Membuffer-overlaid batched point reads: snapshot misses coalesce
        through the store's cross-session point-get batcher (one batched
        dispatch instead of a per-key lookup — the dirty-txn gap PERF.md
        named). Values in key order; membuffer deletes come back as None."""
        out: list = [None] * len(keys)
        miss: list[tuple[int, bytes]] = []
        for i, k in enumerate(keys):
            if self.membuf.contains(k):
                out[i] = self.membuf.get(k)
            else:
                miss.append((i, k))
        if miss:
            from tidb_tpu_torch.copr.client import batched_point_get

            vals = self._retry_locked(
                lambda: batched_point_get(self.store, self.start_ts, [k for _, k in miss])
            )
            for (i, _), v in zip(miss, vals):
                out[i] = v
        return out

    def scan(self, kr: KeyRange, limit: int = 2**63, read_ts: Optional[int] = None) -> list[tuple[bytes, bytes]]:
        snap = self.snapshot if read_ts is None else self.store.get_snapshot(read_ts)
        # membuf DELs can only shrink the snapshot result: limit+ndel snapshot
        # rows always cover the first `limit` merged rows (keeps LIMIT-k scans
        # of bulk-loaded tables O(k), e.g. the DDL backfill batches)
        ndel = 0
        if limit < 2**63:
            ndel = sum(
                1
                for k, (op, _) in self.membuf._buf.items()
                if op == OP_DEL and kr.start <= k < kr.end
            )
        base = dict(self._retry_locked(lambda: snap.scan(kr, limit=min(limit + ndel, 2**63))))
        for k, (op, v) in self.membuf._buf.items():
            if kr.start <= k < kr.end:
                if op == OP_DEL:
                    base.pop(k, None)
                else:
                    base[k] = v
        return sorted(base.items())[:limit]

    def _retry_locked(self, fn, max_retries: int = 16):
        return retry_locked(self.store, fn, max_retries)

    # -- writes ------------------------------------------------------------
    def put(self, key: bytes, value: bytes) -> None:
        self.membuf.put(key, value)

    def delete(self, key: bytes) -> None:
        self.membuf.delete(key)

    # -- 2PC ---------------------------------------------------------------
    def commit(self) -> int:
        if self._done:
            raise RuntimeError("txn already finished")
        self._done = True
        muts = self.membuf.mutations()
        if not muts:
            if self._locked_keys:
                self.store.pessimistic_rollback(list(self._locked_keys), self.start_ts)
            self.commit_ts = self.start_ts
            return self.commit_ts
        written = {m.key for m in muts}
        leftover = [k for k in self._locked_keys if k not in written]
        if leftover:  # locked but never written (e.g. FOR UPDATE only)
            self.store.pessimistic_rollback(leftover, self.start_ts)
        primary = muts[0].key
        if self.pessimistic and self._pess_primary is not None and self._pess_primary in written:
            primary = self._pess_primary  # keep lock primary stable across upgrade
        self._primary = primary
        try:
            counts = self.store.prewrite(muts, primary, self.start_ts)
        except KeyLockedError as e:
            self.store.resolve_lock(e.key, e.lock)
            # single retry after resolution; else surface the conflict
            counts = self.store.prewrite(muts, primary, self.start_ts)
        if isinstance(counts, dict) and "keys" in counts:
            self.write_keys = int(counts["keys"])
            self.write_bytes = int(counts.get("bytes", 0))
        else:  # store (or a wrapper) predates the accounting headers
            self.write_keys = len(muts)
            self.write_bytes = sum(len(m.key) + len(m.value) for m in muts)
        self.commit_ts = self.store.tso.ts()
        # commit primary first — the txn is durably decided once this returns.
        # An UndeterminedError here (commit sent, reply lost) propagates with
        # the resolver bound: retrying could misreport abort, rolling back
        # could erase a commit (ref: client-go undetermined-result rule), but
        # once the store answers again err.resolve() reports the truth.
        try:
            self.store.commit([primary], self.start_ts, self.commit_ts)
        except UndeterminedError as e:
            e.bind_resolver(self.resolve_undetermined)
            raise
        secondaries = [m.key for m in muts if m.key != primary]
        if secondaries:
            try:
                self.store.commit(secondaries, self.start_ts, self.commit_ts)
            except (ConnectionError, UndeterminedError):
                # the primary committed, so the txn IS committed; stranded
                # secondary locks roll forward lazily when a reader trips on
                # them (check_txn_status on the primary → resolve_lock), the
                # same path client-go relies on for async secondary commit
                pass
        try:
            self.store.detector.clean_up(self.start_ts)
        except ConnectionError:
            pass  # committed; detector hygiene must not fail the txn
        return self.commit_ts

    def resolve_undetermined(self):
        """Resolve an ambiguous commit after the store returns (ref: the
        ROADMAP "undetermined-commit resolution" gap; client-go resolves via
        CheckTxnStatus on the primary). Consults the PRIMARY key's owner:

        → ``("committed", commit_ts)`` — the commit landed; ``self.commit_ts``
          is updated to the store's truth.
        → ``("rolled_back", 0)`` — it did not land (the prewrite lock
          expired or was rolled back); safe to re-run the transaction.
        → ``("locked", 0)`` — still undecided: the prewrite lock is alive
          (its TTL has not expired). Back off and call again.

        Raises ConnectionError while the store is still unreachable."""
        if self._primary is None:
            raise RuntimeError("transaction never reached the commit phase; nothing to resolve")
        status, commit_ts = self.store.check_txn_status(self._primary, self.start_ts)
        if status == "committed":
            self.commit_ts = commit_ts
        return status, commit_ts

    def rollback(self) -> None:
        if self._done:
            return
        self._done = True
        if self._locked_keys:
            self.store.pessimistic_rollback(list(self._locked_keys), self.start_ts)
        keys = [m.key for m in self.membuf.mutations()]
        if keys:
            self.store.rollback(keys, self.start_ts)
        self.store.detector.clean_up(self.start_ts)
