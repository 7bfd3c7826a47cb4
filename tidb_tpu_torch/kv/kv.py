"""KV abstraction layer (ref: pkg/kv/kv.go)."""

from __future__ import annotations

import enum
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Iterator, Optional, Protocol, Sequence


class StoreType(enum.Enum):
    """Which engine executes a pushed-down fragment (ref: kv.go:353
    StoreType{TiKV, TiFlash, TiDB}). HOST is the CPU reference engine
    (unistore-cophandler analog), GPU is the CUDA engine (TiFlash analog),
    ROOT means "execute in the SQL layer" (TiDB memtables)."""

    HOST = "host"
    GPU = "gpu"
    ROOT = "root"


class RequestType(enum.IntEnum):
    DAG = 103  # mirrors kv.ReqTypeDAG
    ANALYZE = 104
    CHECKSUM = 105


@dataclass(frozen=True)
class KeyRange:
    """Half-open [start, end)."""

    start: bytes
    end: bytes

    def intersect(self, other: "KeyRange") -> Optional["KeyRange"]:
        s = max(self.start, other.start)
        e = min(self.end, other.end)
        return KeyRange(s, e) if s < e else None


@dataclass
class Request:
    """A pushdown request (ref: kv.Request kv.go:533)."""

    tp: RequestType
    data: Any  # dagpb.DAGRequest (tidb_tpu.copr.dagpb)
    ranges: list[KeyRange]
    store_type: StoreType = StoreType.HOST
    start_ts: int = 0
    concurrency: int = 8
    keep_order: bool = False
    desc: bool = False
    paging: bool = True
    # partition pushdown: list of (physical_table_id, ranges) like
    # kv.Request.PartitionIDAndRanges (kv.go:544)
    partition_ranges: list[tuple[int, list[KeyRange]]] = field(default_factory=list)
    # per-statement warning sink ``warn(level, code, msg)`` — engine-side
    # warnings (cast truncation, division by 0) travel back to the session
    # like the reference's per-SelectResponse warnings (tipb.SelectResponse)
    warn: Any = None
    # the statement's live Tracer when TRACE is on (None = tracing off,
    # strictly zero cost): cop clients open per-task spans under it, ship
    # the trace context over the wire, and merge remote-recorded spans back
    tracer: Any = None


class Response(Protocol):
    """Streaming response (ref: kv.Response kv.go:648). Yields
    copr.CopResult items; exhausted when the iterator ends."""

    def __iter__(self) -> Iterator[Any]: ...

    def close(self) -> None: ...


class Client(Protocol):
    """ref: kv.Client kv.go:316."""

    def send(self, req: Request) -> Response: ...


class Storage(Protocol):
    """ref: kv.Storage. Concrete impl: tidb_tpu.kv.memstore.MemStore."""

    def get_client(self) -> Client: ...

    def current_ts(self) -> int: ...

    def get_snapshot(self, ts: int): ...

    def begin(self): ...


class TimestampOracle:
    """TSO: (physical_ms << 18) | logical, globally unique and monotonic
    (ref: PD TSO; pkg/store/mockstore/unistore/pd.go)."""

    _PHYSICAL_SHIFT = 18

    def __init__(self):
        self._lock = threading.Lock()
        self._last = 0

    def ts(self) -> int:
        with self._lock:
            phys = int(time.time() * 1000) << self._PHYSICAL_SHIFT
            if phys <= self._last:
                self._last += 1
            else:
                self._last = phys
            return self._last

    @staticmethod
    def physical_ms(ts: int) -> int:
        return ts >> TimestampOracle._PHYSICAL_SHIFT


class KVError(Exception):
    pass


class RegionError(Exception):
    """Stale region routing: the store no longer serves the region this task
    named (split/merge bumped the epoch, or the region moved). Retriable
    after re-resolving regions from PD (ref: errorpb.EpochNotMatch /
    RegionNotFound — client-go re-splits the task under BoRegionMiss).

    Deliberately NOT a KVError: the taxonomy (utils/backoff.classify) treats
    KVError subclasses as statement verdicts (fatal to the retry layer),
    while a region miss is pure routing staleness."""

    def __init__(self, region_id: int, msg: str = ""):
        super().__init__(msg or f"region {region_id} not served here (epoch changed?)")
        self.region_id = region_id


class UndeterminedError(KVError):
    """A commit request failed AFTER it may have reached the store: the
    transaction may be durably committed or not, and nothing client-side can
    tell which. Never blind-retry (a re-commit can hit 'lock not found' and
    misreport abort), never report abort (the write may be visible). Surface
    to the client, who must check (ref: client-go ErrResultUndetermined,
    terror CodeResultUndetermined — the 2PC safety rule).

    "Who must check" is automated: the transaction layer binds a
    ``check_txn_status``-driven resolver (``Txn.resolve_undetermined``), so
    once the store is reachable again ``err.resolve()`` reports which way
    the ambiguous commit actually went."""

    def __init__(self, msg: str):
        super().__init__(msg)
        self._resolver = None

    def bind_resolver(self, fn) -> "UndeterminedError":
        """Attach the layer-appropriate resolver (the txn that owns the
        primary key binds ``Txn.resolve_undetermined``)."""
        self._resolver = fn
        return self

    def resolve(self):
        """→ ("committed", commit_ts) | ("rolled_back", 0) | ("locked", 0).
        Consults the primary key's owner via check_txn_status once the store
        answers again; raises ConnectionError while it is still down, and
        RuntimeError when no resolver was bound (the error surfaced below
        the transaction layer)."""
        if self._resolver is None:
            raise RuntimeError(
                "no resolver bound to this UndeterminedError (it surfaced "
                "below the transaction layer); call check_txn_status on the "
                "transaction's primary key directly"
            )
        return self._resolver()


class WriteConflictError(KVError):
    def __init__(self, key: bytes, conflict_ts: int, start_ts: int):
        super().__init__(f"write conflict on {key!r}: commit_ts {conflict_ts} > start_ts {start_ts}")
        self.key, self.conflict_ts, self.start_ts = key, conflict_ts, start_ts


class KeyLockedError(KVError):
    def __init__(self, key: bytes, lock):
        super().__init__(f"key {key!r} locked by txn {lock.start_ts}")
        self.key, self.lock = key, lock


class TxnAbortedError(KVError):
    pass


class DeadlockError(KVError):
    """Raised to the waiter whose lock request closes a wait-for cycle
    (ref: unistore/tikv/detector.go, kvproto Deadlock)."""

    def __init__(self, waiter_ts: int, holder_ts: int, key: bytes):
        super().__init__(f"deadlock: txn {waiter_ts} waiting for txn {holder_ts} on {key!r}")
        self.waiter_ts, self.holder_ts, self.key = waiter_ts, holder_ts, key


class LockWaitTimeoutError(KVError):
    def __init__(self, key: bytes):
        super().__init__(f"lock wait timeout on {key!r}")
        self.key = key
