"""Multi-store-server topology: N storage processes, one kv.Storage.

Reference parity: the region-sharded TiKV fleet behind one SQL layer — PD
maps key ranges to store owners (pkg/store/copr/coprocessor.go:334 splits
cop tasks per region and the region cache routes each to its store), 2PC
spans stores with a single TSO authority, and MPP tasks are scheduled onto
the engine nodes that own the data (pkg/planner/core/fragment.go:116).

Placement here is TABLE-granular: every key routes by its table id (meta /
non-table keys live on shard 0, the PD-analog authority), so one query's cop
fan-out crosses store processes while each range still has exactly one
owner. Timestamps come from shard 0's wall-clock TSO; the other shards'
oracles run on the same physical-time layout ((ms << 18) | logical,
kv/kv.py:87), so same-host shards are mutually consistent to clock skew —
the deployment assumption is documented PD behavior, not an accident.

MPP placement rule: a gather is dispatched to the ONE store owning every
table it reads; a gather spanning owners raises MPPRetryExhausted and the
session re-plans without MPP (cop scans + host join), mirroring the
reference's fallback when no engine can serve the fragment set.

Percolator across shards: prewrite/commit/rollback group keys by owner; a
stuck lock resolves by consulting the PRIMARY key's owner (check_txn_status
there) and then committing/rolling back the lock on its own owner — the
cross-store resolve path of pkg/store/mockstore/unistore/tikv/mvcc.go.

Meta replication: the "m"/system keyspace (catalog, DDL jobs, sysvars)
REPLICATES to every shard on write and reads authoritatively from shard 0 —
the storage processes resolve MPP gathers against their own catalog copy,
exactly how TiFlash keeps a synced schema snapshot per engine node (ref:
the schema-sync the coprocessor's schema-version check relies on).
"""

from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from tidb_tpu_torch.kv import tablecodec
from tidb_tpu_torch.kv.kv import (
    KeyRange,
    RegionError,
    Request,
    RequestType,
    TxnAbortedError,
    UndeterminedError,
)
from tidb_tpu_torch.kv.memstore import Lock, Mutation
from tidb_tpu_torch.utils.backoff import Backoffer, BackoffExhausted, boRegionMiss, boStoreDown


class _FailoverTSO:
    """TSO authority with owner re-resolution: timestamps come from the
    current authority shard and fail over with it (the shards' oracles share
    the (ms << 18) | logical wall-clock layout — see the module docstring's
    deployment assumption, which is what makes the handoff safe)."""

    def __init__(self, store: "ShardedStore"):
        self._store = store

    def ts(self) -> int:
        return self._store._monotonic_ts(lambda st: st.tso.ts(), kind="tso")


class _FailoverDetector:
    def __init__(self, store: "ShardedStore"):
        self._store = store

    def clean_up(self, start_ts: int) -> None:
        self._store._authority_call(lambda st: st.detector.clean_up(start_ts), kind="detector")


class _ShardedPD:
    """Region lookup across shards: each owner answers for its own ranges;
    region ids are namespaced by shard AND the table's placement epoch so
    two stores' region 1s never collide — and a MIGRATED region's id never
    collides with the old owner's cached copy of it (fresh ids minted from
    the epoch, not just bit-packed shard indices: a consumer keying caches
    or routing state off the namespaced id sees a new identity after every
    move, ref: PD bumping RegionEpoch.version on transfer)."""

    _SHARD_BITS = 48
    _EPOCH_BITS = 56

    def __init__(self, store: "ShardedStore"):
        self._store = store

    def _mint(self, region_id: int, si: int, krs) -> int:
        epoch = 0
        if krs:
            k = krs[0].start
            if ShardedStore.is_table_key(k):
                from tidb_tpu_torch.utils import codec

                epoch = self._store.placement_epoch(codec.decode_int_raw(k, 1))
        return region_id | (si << self._SHARD_BITS) | (epoch << self._EPOCH_BITS)

    def regions_in_ranges(self, ranges: Sequence[KeyRange]):
        import copy as _copy

        out = []
        for si, sub in self._store.group_ranges(ranges):
            for region, krs in self._store.stores[si].pd.regions_in_ranges(sub):
                # namespace on a COPY: in-process stores hand out their live
                # Region objects, and mutating those would corrupt the
                # store's own metadata (cache keys, plan-cache versions)
                r2 = _copy.copy(region)
                r2.region_id = self._mint(region.region_id, si, krs)
                out.append((r2, krs))
        return out


class _ShardedSnapshot:
    def __init__(self, store: "ShardedStore", ts: int):
        self._store = store
        self.read_ts = ts

    def get(self, key: bytes) -> Optional[bytes]:
        if not ShardedStore.is_table_key(key):
            # meta keyspace: any live replica can answer (replicated catalog)
            return self._store._authority_call(
                lambda st: st.get_snapshot(self.read_ts).get(key)
            )
        # placement-routed read: a fenced ex-owner (the region moved) answers
        # RegionError → re-resolve placement and retry at the new owner
        return self._store._routed(
            "snap_get",
            lambda: self._store.store_for_key(key).get_snapshot(self.read_ts).get(key),
        )

    def scan(self, kr: KeyRange, limit: int = 2**63, reverse: bool = False):
        if not ShardedStore.is_table_key(kr.start):
            # meta keyspace reads come from the authority, failing over to a
            # surviving replica on store-down
            return self._store._authority_call(
                lambda st: st.get_snapshot(self.read_ts).scan(kr, limit=limit, reverse=reverse)
            )

        def run():
            one = self._store.single_owner(kr)
            if one is not None:
                # the whole range lives on one owner (the common per-table
                # scan): no reason to pay N-1 always-empty fan-out RPCs
                return self._store.stores[one].get_snapshot(self.read_ts).scan(
                    kr, limit=limit, reverse=reverse
                )
            outs = []
            for s in self._store.stores:
                outs.extend(s.get_snapshot(self.read_ts).scan(kr, limit=limit, reverse=reverse))
            outs.sort(key=lambda kv: kv[0], reverse=reverse)
            return outs[:limit] if limit < 2**62 else outs

        return self._store._routed("snap_scan", run)

    def scan_record_rows(self, kr: KeyRange):
        """Record scan feeding the coordinator's columnar cache — the hybrid
        shards × devices MPP path reads every owner from the SQL layer. A
        region's range lives on exactly one owner, so this routes (no
        fan-out); in-process members answer natively, wire members fall back
        to a visible-pairs scan packed into BulkRows (their stable rows ride
        the scan, and :meth:`ShardedStore.stable_parts` reports none for
        them, so nothing double-counts)."""

        def run():
            si = self._store.shard_of_key(kr.start)
            snap = self._store.stores[si].get_snapshot(self.read_ts)
            native = getattr(snap, "scan_record_rows", None)
            if native is not None:
                return native(kr)
            import numpy as np

            from tidb_tpu_torch.kv import tablecodec
            from tidb_tpu_torch.kv.memstore import BulkRows

            handles, chunks, starts, ends = [], [], [], []
            off = 0
            for k, v in snap.scan(kr):
                if not tablecodec.is_record_key(k):
                    continue
                handles.append(tablecodec.decode_record_key(k)[1])
                chunks.append(v)
                starts.append(off)
                off += len(v)
                ends.append(off)
            n = len(handles)
            return BulkRows(
                np.asarray(handles, dtype=np.int64),
                np.asarray(starts, dtype=np.int64),
                np.asarray(ends, dtype=np.int64),
                b"".join(chunks),
                put_ts=np.full(n, self.read_ts, dtype=np.int64),
            )

        return self._store._routed("snap_scan_rows", run)


class _ShardedCopClient:
    """Cop fan-out per range OWNER: consecutive same-owner ranges form one
    sub-request served by that store's own cop client; segment results are
    emitted in range order so keep-order semantics survive the split.

    Placement-aware: a RegionError (the fenced ex-owner of a MOVED table
    refusing the scan) or a dead owner re-resolves placement and
    re-dispatches the segment's ranges to whoever owns them now — the cop
    half of the boRegionMiss re-route. Both clients raise the fence verdict
    EAGERLY in send() (region resolution runs before any task), so the
    re-route fires before a single result streams; the rare mid-stream move
    (results already yielded when the error lands) surfaces typed instead —
    a silent retry there would duplicate rows. The happy path keeps the
    pre-placement streaming + cancel semantics (a satisfied LIMIT still
    cancels pending region tasks)."""

    def __init__(self, store: "ShardedStore"):
        self.store = store

    def _dispatch(self, req: Request, si: int, sub, subs: list):
        """Start one segment's sub-request; a synchronous refusal (the
        eager fence verdict) comes back as the exception VALUE so the
        consumer's re-route handler deals with it at consumption time."""
        try:
            resp = self.store.stores[si].get_client().send(self._sub(req, sub))
            subs.append(resp)
            return resp
        except (RegionError, ConnectionError) as e:
            return e

    def _consume(self, req: Request, si: int, sub, attempt, bo: Backoffer, subs: list):
        """Drain one segment's CopResults (a generator), re-routing on
        placement moves while nothing has streamed yet."""
        from tidb_tpu_torch.utils import metrics as _m

        while True:
            yielded = False
            try:
                if isinstance(attempt, Exception):
                    raise attempt
                for res in attempt:
                    yielded = True
                    yield res
                return
            except (RegionError, ConnectionError) as e:
                if yielded:
                    raise  # mid-stream move: typed, never silently re-read
                moved = self.store.placement_refresh()
                if isinstance(e, ConnectionError) and not moved:
                    raise  # dead owner and the region did not move: typed
                try:
                    bo.backoff(boRegionMiss, e)
                except BackoffExhausted:
                    raise e from None
                _m.PLACEMENT_REROUTE.inc(verb="cop")
                regrouped = self.store.group_ranges(sub, consecutive=True)
                if len(regrouped) == 1:
                    si, sub = regrouped[0]
                    attempt = self._dispatch(req, si, sub, subs)
                    continue
                # the refresh split this segment across owners
                for si2, sub2 in regrouped:
                    yield from self._consume(
                        req, si2, sub2, self._dispatch(req, si2, sub2, subs), bo, subs
                    )
                return

    def send(self, req: Request):
        from tidb_tpu_torch.copr.client import CopResponse

        if req.tp != RequestType.DAG:
            raise ValueError(f"sharded cop client handles DAG requests only, got {req.tp}")
        segments = self.store.group_ranges(req.ranges, consecutive=True)
        bo = Backoffer(budget_ms=2000)
        subs: list = []  # live sub-responses, for early-exit cancellation

        def cancel():
            for r in subs:
                r.close()

        # every segment dispatches EAGERLY (the stores start their cop work
        # concurrently, as before placement); results drain in range order
        started = [(si, sub, self._dispatch(req, si, sub, subs)) for si, sub in segments]

        def gen():
            try:
                for si, sub, attempt in started:
                    yield from self._consume(req, si, sub, attempt, bo, subs)
            finally:
                cancel()

        return CopResponse(gen(), cancel)

    @staticmethod
    def _sub(req: Request, ranges) -> Request:
        import copy as _copy

        sub = _copy.copy(req)
        sub.ranges = list(ranges)
        return sub


class ShardedStore:
    """kv.Storage over N store servers with table-granular placement."""

    def __init__(self, stores: list, placement: Optional[dict] = None):
        if not stores:
            raise ValueError("ShardedStore needs at least one store")
        self.stores = list(stores)
        # explicit table_id → shard index; unlisted tables hash by id
        self.placement = dict(placement or {})
        self.nonce = "sharded(" + ",".join(s.nonce for s in self.stores) + ")"
        # per-store cop-digest rings for IN-PROCESS members: wire members
        # record cop tasks into their server's StmtSummary, but embedded
        # MemStores share one process registry, so the balancer's hot-table
        # boost had no per-store signal. Each member gets its own ring; the
        # embedded cop client records into it and sys_report ships it in the
        # "statements" section exactly like a store server would.
        from tidb_tpu_torch.utils.stmtsummary import StmtSummary as _SS

        for st in self.stores:
            if not hasattr(st, "host") and getattr(st, "cop_ring", None) is None:
                try:
                    st.cop_ring = _SS(capacity=128, slow_capacity=64)
                except AttributeError:  # slotted/duck store: ring stays off
                    pass
        # single authority (the PD TSO role) with store-down failover: the
        # authority index advances to the next live shard when the current
        # one is unreachable, and meta reads follow it (every shard carries a
        # replicated meta keyspace, so any live replica can answer)
        self._auth_idx = 0
        # high-water mark over every timestamp this fleet has handed out:
        # failover moves the TSO stream to another shard whose oracle may sit
        # behind within the same millisecond (logical counter restarts) —
        # percolator's conflict checks assume ONE monotonic stream, so a
        # post-failover ts is never released until it clears this mark
        self._ts_hwm = 0
        self.tso = _FailoverTSO(self)
        self.detector = _FailoverDetector(self)
        self.pd = _ShardedPD(self)
        self._mu = threading.Lock()
        # owner election: lease/term state replicates to a MAJORITY of the
        # shards (kv/election.py), so losing any single store — including
        # shard 0 — neither halts the control plane nor risks split-brain
        from tidb_tpu_torch import config as _config
        from tidb_tpu_torch.kv.election import QuorumElection

        self.election = QuorumElection(self.stores, lease_s=_config.current().owner_lease_s)
        # elastic placement (kv/placement.py): epoch-versioned movable
        # table→shard bindings, quorum-replicated like the election keyspace.
        # The cached map serves the hot routing path; a RegionError from a
        # fenced ex-owner triggers placement_refresh — the boRegionMiss
        # re-resolve. Explicit constructor placement seeds at epoch 0.
        from tidb_tpu_torch.kv.placement import PlacementClient

        self.placement_cache = PlacementClient(self.stores, explicit=self.placement)
        # returning-replica anti-entropy: a shard that answers after being
        # marked down gets the majority's meta/election/placement records
        # replayed onto it BEFORE its votes count again (PR-2's carried gap)
        self.election.catchup_fn = self._replica_catchup

    @property
    def quorum(self) -> int:
        """Majority size — what replicated meta writes and election verbs
        need to succeed (minority shard loss is tolerated, minority
        partitions are refused)."""
        return len(self.stores) // 2 + 1

    def _authority_call(self, fn, kind: str = "meta"):
        """Run ``fn(store)`` against the authority shard, re-resolving the
        authority to the next live shard on store-down. Paced by a typed
        Backoffer (boStoreDown) so a flapping shard doesn't spin; when every
        replica is down the LAST ConnectionError surfaces — a typed error,
        not a hang."""
        from tidb_tpu_torch.utils import metrics as _m

        bo = Backoffer(budget_ms=2000)
        last: Exception | None = None
        start = self._auth_idx
        swept_ms = 0.0
        while True:
            t0 = time.monotonic()
            for i in range(len(self.stores)):
                j = (start + i) % len(self.stores)
                try:
                    out = fn(self.stores[j])
                except ConnectionError as e:
                    last = e
                    continue
                if j != self._auth_idx:
                    with self._mu:
                        self._auth_idx = j
                    _m.STORE_FAILOVER.inc(kind=kind)
                return out
            # a FULL sweep failed — every replica looked down this pass. The
            # backoff paces the next sweep, never the first attempt against
            # an untried shard (an alternative live replica costs nothing to
            # try immediately; sleeping before it is pure failover latency).
            # Sweep wall time charges the budget CUMULATIVELY: each dead
            # REMOTE shard burns its internal boRPC reconnect budget before
            # surfacing ConnectionError, so without the charge the nested
            # budgets would multiply into tens of seconds per call (total
            # block time here is bounded by ~budget + one sweep)
            swept_ms += (time.monotonic() - t0) * 1000.0
            if swept_ms >= bo.remaining_ms():
                raise last  # type: ignore[misc]
            try:
                bo.backoff(boStoreDown, last)
            except BackoffExhausted:
                raise last  # type: ignore[misc]

    def _monotonic_ts(self, fn, kind: str = "tso") -> int:
        """An authority timestamp that never regresses across failover: spin
        past the high-water mark when the new authority's oracle is behind
        (normally the same-millisecond logical overlap). The spin is
        BOUNDED: skew beyond the deployment assumption (same-host clocks)
        surfaces a typed error instead of issuing a regressed timestamp or
        hanging — the one thing this layer may never do is either."""
        deadline: Optional[float] = None
        while True:
            ts = self._authority_call(fn, kind=kind)
            with self._mu:
                if ts > self._ts_hwm:
                    self._ts_hwm = ts
                    return ts
                hwm = self._ts_hwm
            if deadline is None:
                deadline = time.monotonic() + 2.0
            elif time.monotonic() > deadline:
                raise ConnectionError(
                    f"TSO authority clock behind the fleet high-water mark "
                    f"({ts} <= {hwm}) beyond skew tolerance; refusing to issue "
                    "a regressed timestamp"
                )
            time.sleep(0.0005)

    # -- placement ----------------------------------------------------------
    def shard_of_table(self, table_id: int) -> int:
        """Owner shard for a table: the cached placement map (quorum
        bindings + explicit constructor pins) first, the stable hash for
        tables no migration ever touched."""
        got = self.placement_cache.shard_of(table_id)
        if got is not None:
            return got % len(self.stores)
        return table_id % len(self.stores)

    # the PD-client naming twin (routing callers say "owner", admin says
    # "shard"); one implementation
    owner_for = shard_of_table

    def placement_epoch(self, table_id: int) -> int:
        """The table's current placement epoch as this client has observed
        it (0 = never moved)."""
        return self.placement_cache.epoch_of(table_id)

    def placement_refresh(self) -> bool:
        """Re-resolve the placement map from a majority — what a routing
        caller runs after RegionError (fenced ex-owner) or after a dead
        owner (did the region move away before the store died?). False when
        nothing changed or the keyspace is below quorum (the stale cache
        keeps serving — it may still be right)."""
        try:
            return self.placement_cache.refresh()
        except ConnectionError:
            return False

    def placement_snapshot(self) -> dict:
        """Bindings + epochs + in-flight moves for the cluster_placement
        memtable; refreshes from the fleet first (best-effort) so the rows
        show quorum truth, not just this client's cache."""
        self.placement_refresh()
        return self.placement_cache.snapshot()

    def migrate_table(self, table_id: int, dst: int, **kw) -> dict:
        """Move one table's region to shard ``dst`` (kv/placement.py
        migrate_table): snapshot copy + change catch-up + fenced epoch-bump
        cutover; in-flight 2PC locks move with the region."""
        from tidb_tpu_torch.kv.placement import migrate_table as _migrate

        return _migrate(self, table_id, dst, **kw)

    def _routed(self, verb: str, fn, conn_reroute: bool = True):
        """Run a placement-routed operation with epoch-mismatch recovery:
        ``fn`` recomputes its routing from the cached map on every attempt,
        so after a RegionError (the fenced ex-owner's refusal) a
        placement_refresh re-routes the retry to the new owner — the
        boRegionMiss loop, applied to DATA verbs, which is what lets 2PC
        re-route mid-txn when a region moves between prewrite and commit.
        A ConnectionError (dead owner) retries only when the refresh
        actually moved something (``conn_reroute``; commit keeps its
        undetermined-result semantics and never re-routes on a dead wire)."""
        from tidb_tpu_torch.utils import metrics as _m

        bo = Backoffer(budget_ms=2000)
        while True:
            try:
                return fn()
            except RegionError as e:
                self.placement_refresh()
                try:
                    bo.backoff(boRegionMiss, e)
                except BackoffExhausted:
                    raise e from None
                _m.PLACEMENT_REROUTE.inc(verb=verb)
            except ConnectionError as e:
                if not conn_reroute or not self.placement_refresh():
                    raise
                try:
                    bo.backoff(boRegionMiss, e)
                except BackoffExhausted:
                    raise
                _m.PLACEMENT_REROUTE.inc(verb=verb)

    def _replica_catchup(self, si: int) -> None:
        """Anti-entropy for a RETURNING replica (killed → restarted empty):
        replay the meta keyspace from a healthy peer plus the majority's
        election and placement records onto shard ``si`` before its votes
        count toward quorum again. Best-effort — a failure here leaves the
        shard to lazy read-repair, exactly the pre-catchup behavior."""
        from tidb_tpu_torch.utils import metrics as _m

        st = self.stores[si]
        # 1. meta keyspace (catalog / DDL jobs / sysvars replicate to every
        #    shard): scan from the first healthy peer that is NOT the
        #    returner — its own blank copy must not be the source. Replay
        #    ONLY the keys the returner is MISSING: a shard that merely
        #    flapped (data intact, possibly NEWER than the source peer,
        #    which may itself have missed a tolerated-minority write) must
        #    not have stale values re-stamped over it at fresh timestamps —
        #    divergence on present keys stays with the lazy read-repair
        #    path, exactly as before this hook existed.
        pairs = None
        for j in range(len(self.stores)):
            if j == si:
                continue
            try:
                pairs = self.stores[j].raw_scan(KeyRange(b"", tablecodec.TABLE_PREFIX))
                break
            except ConnectionError:
                continue
        if pairs is not None:
            for k, v in pairs:
                if st.raw_get(k) is None:
                    st.raw_put(k, v)
        # 2. election records: the majority-resolved record per seen key
        #    (the replica accept rule keeps the higher term)
        with self.election._mu:
            keys = list(self.election._seen_terms)
        for key in keys:
            try:
                term, owner, deadline = self.election._read_majority(key)
            except ConnectionError:
                break
            if term > 0 and owner is not None:
                st.election_propose(key, owner, term, deadline)
        # 3. placement bindings (epoch accept rule keeps the higher epoch)
        self.placement_cache.repair_replica(si)
        _m.META_CATCHUP.inc()

    @staticmethod
    def is_table_key(key: bytes) -> bool:
        return key[:1] == tablecodec.TABLE_PREFIX and len(key) >= 9

    def shard_of_key(self, key: bytes) -> int:
        """Owner shard for reads: table keys by placement, meta keys by the
        authority (shard 0 holds the authoritative replica)."""
        if self.is_table_key(key):
            from tidb_tpu_torch.utils import codec

            return self.shard_of_table(codec.decode_int_raw(key, 1))
        return 0  # meta / system keyspace: authoritative copy on shard 0

    def write_shards(self, key: bytes) -> list[int]:
        """Shards a WRITE of ``key`` lands on: one owner for table keys,
        EVERY shard for meta keys (replicated catalog)."""
        if self.is_table_key(key):
            return [self.shard_of_key(key)]
        return list(range(len(self.stores)))

    def store_for_key(self, key: bytes):
        return self.stores[self.shard_of_key(key)]

    def single_owner(self, kr: KeyRange) -> Optional[int]:
        """The one shard owning the WHOLE range, or None when it spans
        tables on different owners (fan-out required)."""
        if not self.is_table_key(kr.start):
            return None
        from tidb_tpu_torch.utils import codec

        t0 = codec.decode_int_raw(kr.start, 1)
        if self.is_table_key(kr.end):
            t1 = codec.decode_int_raw(kr.end, 1)
            # the end bound may be the exclusive prefix of the NEXT table
            if t1 not in (t0, t0 + 1) and kr.end > tablecodec.table_prefix(t0 + 1):
                return None
        return self.shard_of_table(t0)

    def group_ranges(self, ranges: Sequence[KeyRange], consecutive: bool = False):
        """[(shard, [ranges])] — grouped by owner; with ``consecutive`` the
        original range order is preserved as same-owner runs (keep-order)."""
        out: list = []
        for kr in ranges:
            si = self.shard_of_key(kr.start)
            if out and out[-1][0] == si:
                out[-1][1].append(kr)
            elif not consecutive:
                for entry in out:
                    if entry[0] == si:
                        entry[1].append(kr)
                        break
                else:
                    out.append((si, [kr]))
            else:
                out.append((si, [kr]))
        return out

    # -- kv.Storage surface -------------------------------------------------
    def current_ts(self) -> int:
        return self._monotonic_ts(lambda st: st.current_ts(), kind="tso")

    def raw_get(self, key: bytes):
        if not self.is_table_key(key):
            return self._authority_call(lambda st: st.raw_get(key))
        return self._routed("raw_get", lambda: self.store_for_key(key).raw_get(key))

    def _meta_quorum_check(self, errs: list) -> None:
        """Replicated meta writes need a MAJORITY of replicas, not all of
        them: a dead minority is skipped (it re-bootstraps on return — a
        killed store process restarts empty) and counted, so the control
        plane keeps moving when any single shard dies. Below quorum the last
        ConnectionError surfaces — a minority partition must not believe it
        persisted cluster state it can no longer read back. Tolerable
        batches only exist for keys that fan to EVERY shard, so the quorum
        base is always the fleet size."""
        if not errs:
            return
        from tidb_tpu_torch.utils import metrics as _m

        if len(self.stores) - len(errs) < self.quorum:
            raise errs[-1]
        _m.STORE_FAILOVER.inc(n=len(errs), kind="meta_write")

    def _fanout_tolerant(self, items, call, tolerable) -> None:
        """Run ``call(si, payload)`` for each ``(si, payload)``; a
        ConnectionError from a batch where ``tolerable(payload)`` holds
        (every key replicated on other shards) is collected and judged by
        the meta quorum rule, anything else propagates (a table key has
        exactly one owner — its loss cannot be masked)."""
        errs: list = []
        for si, payload in items:
            try:
                call(si, payload)
            except ConnectionError as e:
                if not tolerable(payload):
                    raise
                errs.append(e)
        self._meta_quorum_check(errs)

    def raw_put(self, key: bytes, value: bytes) -> None:
        shards = self.write_shards(key)
        if len(shards) == 1:
            self._routed("raw_put", lambda: self.store_for_key(key).raw_put(key, value))
            return
        self._fanout_tolerant(
            [(si, None) for si in shards],
            lambda si, _: self.stores[si].raw_put(key, value),
            lambda _: True,
        )

    def raw_delete(self, key: bytes) -> None:
        shards = self.write_shards(key)
        if len(shards) == 1:
            self._routed("raw_delete", lambda: self.store_for_key(key).raw_delete(key))
            return
        self._fanout_tolerant(
            [(si, None) for si in shards],
            lambda si, _: self.stores[si].raw_delete(key),
            lambda _: True,
        )

    def raw_cas(self, key: bytes, expected, value: bytes) -> bool:
        # the authority decides; replicas follow on success (meta keys only).
        # The deciding replica follows the authority-failover order, so a
        # dead shard 0 no longer wedges catalog version bumps.
        shards = self.write_shards(key)
        if len(shards) == 1:
            return self._routed(
                "raw_cas", lambda: self.store_for_key(key).raw_cas(key, expected, value),
                conn_reroute=False,  # CAS shares commit's replay hazard
            )
        ok = self._authority_call(lambda st: st.raw_cas(key, expected, value))
        if ok:
            decider = self._auth_idx
            self._fanout_tolerant(
                [(si, None) for si in shards if si != decider],
                lambda si, _: self.stores[si].raw_put(key, value),
                lambda _: True,
            )
        return ok

    def raw_scan(self, kr: KeyRange, limit: int = 2**62):
        if not self.is_table_key(kr.start):
            # meta keyspace: one replica only (fanning would surface every
            # shard's copy of the same row); the authority first, survivors
            # on store-down
            return self._authority_call(lambda st: st.raw_scan(kr, limit=limit))
        def run():
            one = self.single_owner(kr)
            if one is not None:
                return self.stores[one].raw_scan(kr, limit=limit)
            outs = []
            for s in self.stores:
                outs.extend(s.raw_scan(kr, limit=limit))
            outs.sort(key=lambda kv: kv[0])
            return outs[:limit]

        return self._routed("raw_scan", run)

    def run_gc(self, safe_point=None, life_ms: int = 600_000):
        pruned = 0
        sp = None
        for s in self.stores:
            p, spt = s.run_gc(safe_point, life_ms)
            pruned += p
            sp = spt if sp is None else min(sp, spt)
        return pruned, sp or 0

    def get_snapshot(self, ts: int) -> _ShardedSnapshot:
        return _ShardedSnapshot(self, ts)

    def snap_batch_get(self, pairs) -> list:
        """Batched snapshot point reads across the fleet — placement-routed:
        a RegionError from a fenced ex-owner re-resolves and re-dispatches
        the whole (idempotent) batch at the new owners."""
        return self._routed("snap_batch_get", lambda: self._snap_batch_get_once(pairs))

    def _snap_batch_get_once(self, pairs) -> list:
        """One batched dispatch: table keys group by their owner shard and
        ride that shard's own batched verb (one RPC per remote shard per
        flush), outcomes scatter back in request order. Failures stay
        per-key/per-shard OUTCOMES — a dead shard or a locked key fails
        only its own sessions' reads, never the strangers coalesced into
        the same batch."""
        from tidb_tpu_torch.kv.kv import KeyLockedError

        out: list = [None] * len(pairs)
        groups: dict = {}
        for i, (ts, k) in enumerate(pairs):
            if not self.is_table_key(k):
                # meta keyspace: authority read with replica failover
                try:
                    out[i] = self._authority_call(
                        lambda st, ts=ts, k=k: st.get_snapshot(ts).get(k)
                    )
                except (KeyLockedError, ConnectionError, OSError) as e:
                    out[i] = e
                continue
            st = self.store_for_key(k)
            groups.setdefault(id(st), (st, []))[1].append((i, ts, k))
        for st, items in groups.values():
            sub = [(ts, k) for _, ts, k in items]
            try:
                bg = getattr(st, "snap_batch_get", None)
                if bg is not None:
                    vals = bg(sub)
                else:
                    vals = []
                    for ts, k in sub:
                        try:
                            vals.append(st.get_snapshot(ts).get(k))
                        except KeyLockedError as e:
                            vals.append(e)
            except (ConnectionError, OSError) as e:
                vals = [e] * len(sub)
            for (i, _, _), v in zip(items, vals):
                out[i] = v
        return out

    def begin(self):
        from tidb_tpu_torch.kv.txn import Txn

        return Txn(self)

    def get_client(self) -> _ShardedCopClient:
        return _ShardedCopClient(self)

    # -- percolator verbs, grouped by owner (meta writes fan to every
    # replica; the lock/commit state converges via the shared primary) ------
    def _group_keys(self, keys: Sequence[bytes]):
        by: dict[int, list] = {}
        for k in keys:
            for si in self.write_shards(k):
                by.setdefault(si, []).append(k)
        return by.items()

    def prewrite(self, mutations: Sequence[Mutation], primary: bytes, start_ts: int) -> dict:
        # placement-routed: the grouping recomputes per attempt, so a
        # region that moved between two attempts re-routes (prewrite is
        # idempotent under one start_ts — re-sending to the new owner is
        # safe even when an earlier shard already holds its locks)
        def once():
            by: dict[int, list] = {}
            for m in mutations:
                for si in self.write_shards(m.key):
                    by.setdefault(si, []).append(m)
            self._fanout_tolerant(
                by.items(),
                lambda si, muts: self.stores[si].prewrite(muts, primary, start_ts),
                lambda muts: all(not self.is_table_key(m.key) for m in muts),
            )
            # write accounting computed from the UNIQUE mutation list, not the
            # per-store replies: meta keys fan to every replica and would
            # otherwise count once per shard
            return {
                "keys": len(mutations),
                "bytes": sum(len(m.key) + len(m.value) for m in mutations),
            }

        return self._routed("prewrite", once)

    def commit(self, keys: Sequence[bytes], start_ts: int, commit_ts: int) -> None:
        # placement-routed on the TYPED refusal only: a fenced ex-owner
        # rejects the commit before touching state (its locks moved with
        # the region), so re-routing to the new owner — where the migrated
        # lock waits — is safe, and an idempotent re-commit of shards that
        # already applied is a no-op. A dead wire keeps the undetermined-
        # result semantics (conn_reroute=False): re-sending a commit whose
        # fate is unknown could double-decide.
        self._routed(
            "commit",
            lambda: self._commit_once(keys, start_ts, commit_ts),
            conn_reroute=False,
        )

    def _commit_once(self, keys: Sequence[bytes], start_ts: int, commit_ts: int) -> None:
        committed: list[int] = []
        meta_errs: list = []
        groups = list(self._group_keys(keys))
        for si, ks in groups:
            try:
                self.stores[si].commit(ks, start_ts, commit_ts)
            except UndeterminedError as e:
                # cross-shard 2PC: an ambiguous commit on ANY owner makes the
                # round undetermined — annotate the shard and surface (never
                # retried, never downgraded to abort)
                raise UndeterminedError(f"shard {si}: {e}") from e
            except TxnAbortedError as e:
                if all(not self.is_table_key(k) for k in ks):
                    # a meta REPLICA with no lock at commit time is a replica
                    # that missed the prewrite (down then, possibly restarted
                    # empty since — the tolerated-minority recovery model),
                    # not a verdict on the transaction: the quorum decides
                    # below. A genuine abort raises this from EVERY replica
                    # and still surfaces through the below-quorum path.
                    meta_errs.append(e)
                    continue
                raise
            except ConnectionError as e:
                if all(not self.is_table_key(k) for k in ks):
                    # pure-meta replica batch: a dead minority is tolerable —
                    # the round is decided once a MAJORITY of replicas commit
                    # (checked below); the straggler re-bootstraps on return
                    meta_errs.append(e)
                    continue
                if committed:
                    # an earlier shard already durably committed this round
                    # (replicated meta keys fan one commit over every shard):
                    # the round's outcome is decided, only this replica is
                    # unacked — reporting a plain failure would invite a
                    # blind re-run of a committed transaction
                    raise UndeterminedError(
                        f"shard {si}: commit unreachable after shard(s) "
                        f"{committed} committed: {e}"
                    ) from e
                raise
            committed.append(si)
        if meta_errs:
            if len(self.stores) - len(meta_errs) < self.quorum:
                if committed:
                    raise UndeterminedError(
                        f"meta commit below quorum after shard(s) {committed} "
                        f"committed: {meta_errs[-1]}"
                    ) from meta_errs[-1]
                raise meta_errs[-1]
            from tidb_tpu_torch.utils import metrics as _m

            _m.STORE_FAILOVER.inc(n=len(meta_errs), kind="meta_write")

    def rollback(self, keys: Sequence[bytes], start_ts: int) -> None:
        self._routed(
            "rollback",
            lambda: self._fanout_tolerant(
                self._group_keys(keys),
                lambda si, ks: self.stores[si].rollback(ks, start_ts),
                lambda ks: all(not self.is_table_key(k) for k in ks),
            ),
        )

    def check_txn_status(self, primary: bytes, start_ts: int):
        if not self.is_table_key(primary):
            # meta primaries are replicated: any live replica answers, the
            # authority order picks it (a dead shard 0 must not wedge
            # cross-shard lock resolution)
            return self._authority_call(lambda st: st.check_txn_status(primary, start_ts))
        # placement-routed: a fenced ex-owner must not answer "rolled_back"
        # from its stale copy — the truth (the migrated lock or the applied
        # commit) lives at the new owner
        return self._routed(
            "check_txn_status",
            lambda: self.store_for_key(primary).check_txn_status(primary, start_ts),
        )

    def resolve_lock(self, key: bytes, lock: Lock) -> None:
        def once():
            key_shard = self.shard_of_key(key)
            primary_shard = self.shard_of_key(lock.primary)
            if key_shard == primary_shard and self.is_table_key(key):
                self.stores[key_shard].resolve_lock(key, lock)
                return
            # cross-shard (or replicated meta): the primary's owner is the
            # source of truth; commit/rollback route back through the
            # quorum-aware verbs
            status, commit_ts = self.check_txn_status(lock.primary, lock.start_ts)
            if status == "committed":
                self.commit([key], lock.start_ts, commit_ts)
            elif status == "rolled_back":
                self.rollback([key], lock.start_ts)
            # "locked": primary still alive → caller backs off and retries

        self._routed("resolve_lock", once)

    def acquire_pessimistic_lock(self, keys, primary, start_ts, for_update_ts, wait_timeout_ms=3000):
        def once():
            by: dict[int, list] = {}
            for k in keys:
                by.setdefault(self.shard_of_key(k), []).append(k)
            for si, ks in by.items():
                self.stores[si].acquire_pessimistic_lock(
                    ks, primary, start_ts, for_update_ts, wait_timeout_ms
                )

        self._routed("acquire_lock", once)

    def pessimistic_rollback(self, keys: Sequence[bytes], start_ts: int) -> None:
        self._routed(
            "pessimistic_rollback",
            lambda: self._fanout_tolerant(
                self._group_keys(keys),
                lambda si, ks: self.stores[si].pessimistic_rollback(ks, start_ts),
                lambda ks: all(not self.is_table_key(k) for k in ks),
            ),
        )

    # -- bulk ingest --------------------------------------------------------
    def ingest(self, keys: Sequence[bytes], values: Sequence[bytes]) -> int:
        # NOT re-routed on ConnectionError: ingest mints a fresh commit_ts
        # per call, so a replay could double rows (same rule as the wire
        # layer's NON_REPLAYABLE); a typed RegionError still re-routes —
        # the fenced store refused before ingesting anything
        def once():
            by: dict[int, tuple[list, list]] = {}
            for k, v in zip(keys, values):
                e = by.setdefault(self.shard_of_key(k), ([], []))
                e[0].append(k)
                e[1].append(v)
            ts = 0
            for si, (ks, vs) in by.items():
                ts = max(ts, self.stores[si].ingest(ks, vs))
            return ts

        return self._routed("ingest", once, conn_reroute=False)

    def ingest_columnar(self, table_id: int, handles, cols, schema, dicts=None, on_existing=None) -> int:
        return self._routed(
            "ingest_columnar",
            lambda: self.stores[self.shard_of_table(table_id)].ingest_columnar(
                table_id, handles, cols, schema, dicts, on_existing
            ),
            conn_reroute=False,
        )

    def drop_stable(self, table_id: int) -> None:
        self._routed(
            "drop_stable",
            lambda: self.stores[self.shard_of_table(table_id)].drop_stable(table_id),
        )

    # -- owner election: quorum-replicated with fenced leases (kv/election.py,
    # the PD/etcd analog). campaign/renew/resign are majority writes carrying
    # the fencing token (term); owner reads resolve from a majority with
    # highest-term-wins; a minority partition can neither grant nor refresh a
    # lease (ConnectionError — owners keep their last verdict until the lease
    # runs out, then self-fence; ref: etcd quorum loss). Dead shards are
    # skipped under each store's own Backoffer and read-repaired on return. --
    def owner_campaign(
        self, key: str, node_id: str, lease_s: Optional[float] = None, term: Optional[int] = None
    ) -> bool:
        return self.election.campaign(key, node_id, lease_s, term=term)

    def owner_of(self, key: str):
        return self.election.owner(key)

    def owner_resign(self, key: str, node_id: str) -> None:
        self.election.resign(key, node_id)

    def owner_term(self, key: str) -> int:
        return self.election.term(key)

    def owner_granted_term(self, key: str, node_id: str):
        """Locally cached fencing token of ``node_id``'s last grant — spares
        a freshly granted owner the second majority sweep owner_term pays."""
        return self.election.granted_term(key, node_id)

    # -- fleet introspection (the sys_snapshot fan-out behind
    # information_schema.cluster_* and the StoreHealthRegistry) --------------
    @staticmethod
    def instance_name(st) -> str:
        """Stable display identity of one store: the wire address for remote
        stores, a nonce-derived tag for in-process MemStores."""
        if hasattr(st, "host") and hasattr(st, "port"):
            return f"{st.host}:{st.port}"
        return f"mem:{getattr(st, 'nonce', 'embedded')[:8]}"

    def sys_snapshot_all(self, hist=None, sections=None) -> list[dict]:
        """Fan the sys_snapshot introspection verb out to EVERY shard with
        dead-store tolerance: each remote call retries under that store's
        own boRPC Backoffer (RemoteStore._call), and a store that stays dead
        past its budget contributes a per-store failure OUTCOME — one dead
        instance must never fail the whole sweep (TiDB's cluster-memtable
        partial-result semantics). The probes run CONCURRENTLY (one short-
        lived thread per shard, joined before return), so a sweep over N
        dead stores stalls for max(budget), not the sum of N budgets.
        → [{"instance", "shard", "ok", "report" | "error"}] in shard
        order."""

        def probe(si: int, st) -> dict:
            addr = self.instance_name(st)
            fn = getattr(st, "sys_snapshot", None)
            try:
                if fn is not None:
                    rep = fn(hist=hist, sections=sections)
                else:
                    from tidb_tpu_torch.kv.remote import sys_report

                    rep = sys_report(store=st, hist=hist, sections=sections)
                return {"instance": addr, "shard": si, "ok": True, "report": rep}
            except (ConnectionError, OSError) as e:
                return {"instance": addr, "shard": si, "ok": False, "error": str(e)}

        if len(self.stores) == 1:
            return [probe(0, self.stores[0])]
        out: list = [None] * len(self.stores)

        def run(si: int, st) -> None:
            out[si] = probe(si, st)

        threads = [
            threading.Thread(target=run, args=(si, st), daemon=True, name=f"syssnap-{si}")
            for si, st in enumerate(self.stores)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    def log_search_all(
        self,
        since=None,
        until=None,
        min_level: int = 0,
        component=None,
        pattern=None,
        limit: int = 256,
        instances=None,
    ) -> list[dict]:
        """Fan the ``log_search`` verb out to every WIRE shard with the same
        concurrent dead-store-tolerant sweep as :meth:`sys_snapshot_all` —
        filters (time/level/component/regex/limit) apply server-side, and a
        dead store contributes a per-store failure outcome, never a failed
        sweep. In-process shards report zero rows with ``"local": True``:
        their events land in THIS process's ring, which the caller already
        reads directly (fanning out would duplicate every row per shard).
        ``instances`` (a set of instance names) restricts the sweep — the
        cluster_log INSTANCE-predicate pushdown.
        → [{"instance", "shard", "ok", "rows" | "error"}] in shard order."""

        def probe(si: int, st) -> dict:
            addr = self.instance_name(st)
            fn = getattr(st, "log_search", None)
            if fn is None:
                return {"instance": addr, "shard": si, "ok": True, "rows": [], "local": True}
            try:
                rows = fn(
                    since=since, until=until, min_level=min_level,
                    component=component, pattern=pattern, limit=limit,
                )
                return {"instance": addr, "shard": si, "ok": True, "rows": rows}
            except (ConnectionError, OSError) as e:
                return {"instance": addr, "shard": si, "ok": False, "error": str(e)}

        targets = [
            (si, st)
            for si, st in enumerate(self.stores)
            if instances is None or self.instance_name(st) in instances
        ]
        if len(targets) <= 1:
            return [probe(si, st) for si, st in targets]
        out: list = [None] * len(targets)

        def run(oi: int, si: int, st) -> None:
            out[oi] = probe(si, st)

        threads = [
            threading.Thread(
                target=run, args=(oi, si, st), daemon=True, name=f"logsearch-{si}"
            )
            for oi, (si, st) in enumerate(targets)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        return out

    # -- columnar-cache verbs for the hybrid shards × devices path ----------
    def stable_parts(self, table_id: int, kr, read_ts: int) -> list:
        """Stable-block slices from the range's owner (the coordinator's
        columnar cache merges them like an embedded store's). Wire members
        keep their blocks server-side and report none — their rows arrive
        via the scan fallback instead."""

        def run():
            st = self.store_for_key(kr.start)
            fn = getattr(st, "stable_parts", None)
            return fn(table_id, kr, read_ts) if fn is not None else []

        return self._routed("stable_parts", run)

    def note_region_read(self, region_id: int, table_id: int, keys: int, nbytes: int) -> None:
        """Cop-serve traffic (copr/colcache.get_split) lands on the range
        owner's rings — the store that answers for the table is the one
        whose heatmap should show it hot. Embedded members take the note
        directly; wire members note server-side when their cop verbs run,
        so nothing ships here. Advisory: a mid-move owner flip just
        attributes the serve to whichever store owns the table NOW."""
        try:
            st = self.stores[self.shard_of_table(table_id)]
        except Exception:  # graftcheck: off=except-swallow
            return
        fn = getattr(st, "note_region_read", None)
        if fn is not None:
            fn(region_id, table_id, keys, nbytes)

    def col_changes_since(self, region_id: int, table_id: int, after_ts: int):
        # coordinator-side region ids are minted (shard/epoch-namespaced), so
        # member change logs cannot be consulted by id — "span" tells the
        # cache to MERGE (full routed re-scan) and never delta-read: always
        # correct, merely conservative after writes
        return ("span", (0, 2**63 - 1))

    def col_changes_prune(self, region_id: int, table_id: int, upto_ts: int) -> None:
        return None  # nothing itemized coordinator-side, nothing to prune

    # -- MPP: single-owner placement ----------------------------------------
    def mpp_ndev(self) -> int:
        fn = getattr(self.stores[0], "mpp_ndev", None)
        if fn is None:
            # embedded fleet: the coordinator process owns the (one) mesh
            from tidb_tpu_torch.parallel import make_mesh

            return int(make_mesh().devices.size)
        return fn()

    def _mpp_owner(self, spec: dict) -> int:
        def tids_of(r: dict) -> list[int]:
            # subplan readers nest their table reader under "sub"; a staged
            # chain subplan reads EVERY chain table — all must co-locate,
            # or the serving store would see empty regions for the rest
            if "sub" in r:
                sp = r["sub"]
                if sp.get("chain"):
                    return [crp["tid"] for crp in sp["chain"]["readers"]]
                return [sp["reader"]["tid"]]
            return [r["tid"]]

        def owners() -> set[int]:
            return {
                self.shard_of_table(tid)
                for r in spec.get("readers", [])
                for tid in tids_of(r)
            }

        got = owners()
        if len(got) != 1 and self.placement_refresh():
            # a stale map can claim a straddle right after a co-locating
            # migration — re-resolve once before giving up on MPP
            got = owners()
        if len(got) != 1:
            from tidb_tpu_torch.parallel.probe import MPPStraddleError

            raise MPPStraddleError(
                f"MPP gather reads tables on {len(got)} store shards; "
                "single-owner placement unavailable (hybrid mesh or host join)"
            )
        return got.pop()

    def mpp_dispatch(self, spec: dict, read_ts: int, **kw) -> str:
        owner = self._mpp_owner(spec)
        fn = getattr(self.stores[owner], "mpp_dispatch", None)
        if fn is None:
            # embedded members run no task manager — the coordinator's own
            # mesh serves the gather (same hybrid path a straddle takes)
            from tidb_tpu_torch.parallel.probe import MPPStraddleError

            raise MPPStraddleError(
                "embedded fleet members dispatch no MPP tasks; "
                "coordinator mesh serves the gather"
            )
        return f"{owner}:{fn(spec, read_ts, **kw)}"

    def mpp_conn(self, task_id: str, check_killed=None, warn=None, **kw):
        owner, _, tid = task_id.partition(":")
        return self.stores[int(owner)].mpp_conn(tid, check_killed=check_killed, warn=warn, **kw)

    def mpp_cancel(self, task_id: str) -> None:
        owner, _, tid = task_id.partition(":")
        self.stores[int(owner)].mpp_cancel(tid)
