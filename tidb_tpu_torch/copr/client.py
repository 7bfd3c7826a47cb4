"""Coprocessor client: region split → worker fan-out → streamed results.

Reference parity: pkg/store/copr/coprocessor.go (buildCopTasks :334 splits
ranges by region; copIterator :684 runs a worker pool with keep-order
channels; :87 CopClient.Send). Concurrency here is a thread pool — numpy and
XLA release the GIL in their hot paths, so region tasks overlap for real.

The worker pool is ONE lazily-built process-wide executor (ref: the
reference's copIteratorWorker goroutines being cheap — spawning an OS thread
pool per request here cost ~1-2 ms of fixed tax on every multi-region
statement). Per-request concurrency is enforced by windowed submission, not
pool size: at most ``req.concurrency`` tasks of one request are in flight,
so a single request cannot monopolize the shared workers.
"""

from __future__ import annotations

import os
import threading
import time
from concurrent import futures
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Callable, Iterator, Optional

from tidb_tpu_torch.copr import dagpb
from tidb_tpu_torch.kv.kv import KeyRange, KVError, RegionError, Request, RequestType, StoreType
from tidb_tpu_torch.kv.memstore import MemStore, Region
from tidb_tpu_torch.utils import execdetails as _ed
from tidb_tpu_torch.utils import failpoint
from tidb_tpu_torch.utils import tracing as _tracing
from tidb_tpu_torch.utils.backoff import Backoffer, BackoffExhausted, boRegionMiss
from tidb_tpu_torch.utils.chunk import Chunk

# engine registry: StoreType → DAG executor over one region
# (ref: kvstore.Register in cmd/tidb-server/main.go:399-409); populated
# lazily from concurrent cop tasks, so the populate takes a lock
_ENGINES: dict[StoreType, Callable] = {}
_ENGINES_MU = threading.Lock()


def _engines():
    if not _ENGINES:
        from tidb_tpu_torch.copr import gpu_engine, host_engine

        # ONE dict.update installs both engines: a lock-free reader on the
        # fast path above must only ever observe {} or the full registry —
        # per-key inserts would let a concurrent cop task see one engine
        # and raise KeyError dispatching the other
        with _ENGINES_MU:
            if not _ENGINES:
                _ENGINES.update(
                    {
                        StoreType.HOST: host_engine.execute_dag,
                        StoreType.GPU: gpu_engine.execute_dag,
                    }
                )
    return _ENGINES


# -- shared cop worker pool -------------------------------------------------

_POOL_MU = threading.Lock()
_POOL: Optional[ThreadPoolExecutor] = None


def shared_cop_pool(concurrency_hint: int = 0) -> ThreadPoolExecutor:
    """The process-wide cop worker pool, built on first use. Sized from the
    first request's executor-concurrency hint (floored so concurrent
    sessions overlap even when the first request was narrow); per-request
    parallelism is throttled by submission windows, not pool size."""
    global _POOL
    with _POOL_MU:
        if _POOL is None:
            size = max(int(concurrency_hint), (os.cpu_count() or 4) * 2, 8)
            _POOL = ThreadPoolExecutor(max_workers=size, thread_name_prefix="cop-shared")
        return _POOL


def cop_pool_stats() -> tuple[int, int]:
    """→ (pool size, queued-task depth) of the shared cop pool — the
    queue-pressure signal the sys_snapshot health report ships fleet-wide
    (0, 0 when no cop request has built the pool yet). Reads executor
    internals (_work_queue), guarded so a stdlib change degrades to zeros
    rather than breaking introspection."""
    with _POOL_MU:
        pool = _POOL
    if pool is None:
        return 0, 0
    try:
        return pool._max_workers, pool._work_queue.qsize()
    except AttributeError:
        return 0, 0


def shutdown_shared_pool() -> None:
    """Idempotent teardown (tests / embedders); the pool lazily rebuilds on
    the next cop request."""
    global _POOL
    with _POOL_MU:
        pool, _POOL = _POOL, None
    if pool is not None:
        pool.shutdown(wait=True, cancel_futures=True)


def windowed_fanout(pool, run: Callable, items: list, window: int):
    """Run ``run(item)`` for every item on the shared pool with at most
    ``window`` of THIS request in flight, yielding results in item order.

    Work-conserving: ``window`` worker loops pull the next item the moment
    they finish one (a long task never idles the other workers, unlike
    consumer-driven admission), and the loops exit — releasing their pool
    slots — when the queue drains. Returns ``(iterator, cancel)``;
    ``cancel`` is idempotent and stops unstarted work. Shared by the
    embedded and remote cop clients."""
    from concurrent.futures import Future

    n = len(items)
    results = [Future() for _ in range(n)]
    mu = threading.Lock()
    state = {"next": 0, "closed": False}

    def worker():
        while True:
            with mu:
                if state["closed"] or state["next"] >= n:
                    return
                i = state["next"]
                state["next"] += 1
            try:
                results[i].set_result(run(items[i]))
            except BaseException as e:
                try:
                    results[i].set_exception(e)
                except futures.InvalidStateError:
                    pass  # consumer already cancelled this slot

    handles = [pool.submit(worker) for _ in range(min(window, n))]

    def cancel():
        with mu:
            state["closed"] = True
        for h in handles:
            h.cancel()
        for f in results:
            f.cancel()

    # a pool shutdown(cancel_futures=True) can cancel still-QUEUED worker
    # loops out from under us — without this hook the per-item result
    # futures would never resolve and the consumer would block forever
    def _handle_done(h):
        if h.cancelled():
            cancel()

    for h in handles:
        h.add_done_callback(_handle_done)

    def gen():
        try:
            for f in results:
                yield f.result()
        finally:
            cancel()

    return gen(), cancel


# -- cross-session point-get batcher ----------------------------------------


class PointGetBatcher:
    """Coalesces concurrent snapshot point reads against ONE store into
    batched multi-key lookups (ref: TiKV's batch-commands stream — client-go
    batch_client.go merges whatever is queued when the stream frees up).

    Opportunistic, zero added latency: the first arriving thread becomes the
    flusher and dispatches its keys immediately; readers that land while a
    flush is in flight queue up and ride the NEXT flush as one batch. N
    concurrent sessions therefore pay one RPC + one store dispatch instead
    of N, while an uncontended reader dispatches exactly as fast as before.
    An optional collection window ([perf] pointget-batch-window-us) lets the
    flusher sleep sub-ms per round to grow batches at a latency cost.

    Outcomes are delivered PER KEY (bytes | None | exception): one session's
    locked key or dead shard never fails the strangers sharing its batch.
    The flusher runs on the submitting thread — no background threads to
    leak (conftest thread-hygiene stays clean)."""

    def __init__(self, store, window_s: float = 0.0):
        self._store = store
        self._mu = threading.Lock()
        self._pending: list = []  # (read_ts, key, Future)
        self._flushing = False
        self.window_s = window_s

    def get_many(self, read_ts: int, keys: list) -> list:
        """Submit this session's keys; returns values in key order, raising
        the first per-key error (same surface as sequential snapshot gets)."""
        from concurrent.futures import Future

        futs = [Future() for _ in keys]
        with self._mu:
            self._pending.extend((read_ts, k, f) for k, f in zip(keys, futs))
            lead = not self._flushing
            if lead:
                self._flushing = True
        if lead:
            self._drain()
        out = []
        for f in futs:
            v = f.result()
            if isinstance(v, BaseException):
                raise v
            out.append(v)
        return out

    def _lookup(self, pairs) -> list:
        bg = getattr(self._store, "snap_batch_get", None)
        if bg is not None:
            return bg(pairs)
        # store without a batched verb: per-key reads, per-key outcomes
        out = []
        for ts, k in pairs:
            try:
                out.append(self._store.get_snapshot(ts).get(k))
            except Exception as e:
                out.append(e)
        return out

    def _drain(self) -> None:
        from tidb_tpu_torch.utils import metrics as _m

        while True:
            if self.window_s > 0:
                time.sleep(self.window_s)
            with self._mu:
                batch, self._pending = self._pending, []
                if not batch:
                    self._flushing = False
                    return
            try:
                vals = self._lookup([(ts, k) for ts, k, _ in batch])
            except BaseException as e:
                # whole-dispatch failure: every key in THIS flush shares it
                vals = [e] * len(batch)
            _m.POINTGET_BATCH.observe(len(batch))
            for (_, _, f), v in zip(batch, vals):
                f.set_result(v)


_BATCHER_MU = threading.Lock()


def point_batcher(store) -> PointGetBatcher:
    """The per-store batcher (lazily attached — sessions of one DB share the
    store object, so they share the batcher)."""
    b = getattr(store, "_pointget_batcher", None)
    if b is None:
        with _BATCHER_MU:
            b = getattr(store, "_pointget_batcher", None)
            if b is None:
                from tidb_tpu_torch import config as _config

                b = PointGetBatcher(
                    store, window_s=_config.current().pointget_batch_window_us / 1e6
                )
                store._pointget_batcher = b
    return b


def batched_point_get(store, read_ts: int, keys: list) -> list:
    """Snapshot point reads through the store's cross-session batcher."""
    return point_batcher(store).get_many(read_ts, keys)


@dataclass
class CopTask:
    region: Region
    ranges: list[KeyRange]
    task_id: int


@dataclass
class CopResult:
    chunk: Chunk
    task_id: int
    region_id: int
    # the task's ExecDetails sidecar (utils/execdetails.CopExecDetails);
    # always collected — EXPLAIN ANALYZE / slow log aggregate it
    details: object = None


def run_task_resilient(
    bo: Backoffer,
    run_one: Callable,
    resplit: Callable,
    region,
    ranges,
    store_type: StoreType,
    *,
    warn=None,
    degrade_reason: str,
    degrade_on: tuple,
    never_degrade: tuple = (),
    detail=None,
    trace_id=None,
) -> Chunk:
    """One cop task under the request's Backoffer — the single region-error /
    degrade policy shared by the embedded and remote cop clients.

    ``run_one(store_type, region, ranges) -> Chunk`` executes one attempt;
    ``resplit(ranges) -> [(region, ranges)]`` re-resolves routing. A
    RegionError re-splits RECURSIVELY: a second epoch change re-enters the
    same handler, bounded by the boRegionMiss budget, whose exhaustion
    surfaces the last region error typed (never the retry mechanism). A
    TPU-engine failure matching ``degrade_on`` (minus ``never_degrade``)
    falls back to the host engine for THIS task — through the same re-split
    handler, so a degrade retry never reuses stale routing.
    (ref: coprocessor.go buildCopTasks re-entry on region error)"""

    def attempt(st, region2, ranges2):
        try:
            return run_one(st, region2, ranges2)
        except RegionError as e:
            try:
                slept = bo.backoff(boRegionMiss, e)
            except BackoffExhausted as be:
                raise (be.last or e) from be
            if detail is not None:
                # sidecar attribution: the task's OWN sleeps/re-splits, never
                # the shared Backoffer's (other workers charge it too)
                detail.retries += 1
                detail.backoff_ms += slept
                detail.resplits += 1
            parts = [attempt(st, r2, k2) for r2, k2 in resplit(ranges2)]
            if not parts:
                # routing no longer covers these ranges at all (dropped
                # table, merged-away regions): surface the region verdict,
                # not a bare concat-of-nothing assertion
                raise e
            return Chunk.concat(parts) if len(parts) != 1 else parts[0]

    try:
        return attempt(store_type, region, ranges)
    except RegionError:
        raise  # exhausted re-splits: a routing verdict, not an engine failure
    except never_degrade:
        raise
    except degrade_on as e:
        if store_type != StoreType.GPU:
            raise
        # graceful degradation: one task's GPU-engine failure falls back to
        # the host engine for THAT task and is recorded — the query answers
        # instead of dying with the device
        if warn is not None:
            warn(1, 1105, f"GPU cop task on region {region.region_id} degraded to host: {e}")
        from tidb_tpu_torch.utils import eventlog as _ev
        from tidb_tpu_torch.utils import metrics as _m

        _m.COP_DEGRADED.inc(reason=degrade_reason)
        lg = _ev.on(_ev.WARN)
        if lg is not None:
            lg.emit(
                _ev.WARN,
                "copr",
                "degrade",
                trace_id=trace_id,
                region=region.region_id,
                reason=degrade_reason,
                cause=f"{type(e).__name__}: {e}",
            )
        if detail is not None:
            detail.degraded = f"{degrade_reason}:{type(e).__name__}"
        return attempt(StoreType.HOST, region, ranges)


class CopResponse:
    """Streaming response (kv.Response). Iterates CopResults; with
    keep_order the stream follows region order, else completion order."""

    def __init__(self, it: Iterator[CopResult], cancel: Optional[Callable] = None):
        self._it = it
        self._cancel = cancel
        self._closed = False

    def __iter__(self):
        return self._it

    def close(self):
        if not self._closed:
            self._closed = True
            if self._cancel is not None:
                # cancel this request's pending work only — the shared pool
                # serves other requests and must stay up
                self._cancel()


class CopClient:
    """kv.Client for the embedded store (both engines)."""

    def __init__(self, store: MemStore):
        self.store = store

    def send(self, req: Request) -> CopResponse:
        if req.tp != RequestType.DAG:
            raise ValueError(f"cop client handles DAG requests only, got {req.tp}")
        dag: dagpb.DAGRequest = req.data
        read_ts = req.start_ts or self.store.current_ts()

        tasks: list[CopTask] = []
        for region, ranges in self.store.pd.regions_in_ranges(req.ranges):
            tasks.append(CopTask(region, ranges, len(tasks)))
        if req.desc:
            tasks.reverse()

        if not tasks:
            return CopResponse(iter(()), None)

        concurrency = max(1, min(req.concurrency, len(tasks)))
        # one typed retry budget shared by every task of this request (ref:
        # copIterator's Backoffer per copTask batch; worker threads share it)
        bo = Backoffer(budget_ms=2000)

        def run_engine(store_type: StoreType, region: Region, ranges: list[KeyRange]) -> Chunk:
            # chaos seam: tests fault exact (task, engine) pairs (N-shot /
            # scripted) without touching the engines themselves
            failpoint.inject("cop_task_engine", region.region_id, store_type)
            return _engines()[store_type](self.store, dag, region, ranges, read_ts, warn=req.warn)

        from tidb_tpu_torch.utils.memory import QueryKilledError, QueryOOMError

        # sidecar timing baseline + cross-thread span parent, captured in
        # the requesting thread (queue wait = submit → worker pickup)
        t_submit = time.perf_counter()
        tracer = _tracing.effective(req.tracer)
        # with no statement tracer, the tasks' spans go to the window
        # (tracing.start_window) while one records
        rec = tracer if tracer is not None else _tracing.window()
        parent_span = rec.current() if rec is not None else None

        def run(task: CopTask) -> CopResult:
            det = _ed.CopExecDetails(task.region.region_id)
            det.queue_ms = (time.perf_counter() - t_submit) * 1000.0
            span = (
                rec.span(f"cop.r{task.region.region_id}", parent=parent_span)
                if rec is not None
                else _tracing.NULL_SPAN
            )
            t0 = time.perf_counter()
            with span, _ed.collecting(det, tracer=rec):
                chunk = run_task_resilient(
                    bo,
                    run_engine,
                    self.store.pd.regions_in_ranges,
                    task.region,
                    task.ranges,
                    req.store_type,
                    warn=req.warn,
                    degrade_reason="embedded",
                    # no device failure degrades: a CUDA error, a kernel
                    # build or launch failure surfaces to the statement (the
                    # engine itself answers the shapes it does not carry on
                    # the host engine, recorded as the task's degrade)
                    degrade_on=(),
                    # data/txn verdicts and kills: degrading engines would not help
                    never_degrade=(KVError, QueryKilledError, QueryOOMError),
                    detail=det,
                    trace_id=tracer.trace_id if tracer is not None else None,
                )
            # processing = task wall minus its own backoff sleeps
            det.proc_ms = max((time.perf_counter() - t0) * 1000.0 - det.backoff_ms, 0.0)
            ring = getattr(self.store, "cop_ring", None)
            if ring is not None:
                # per-store cop-digest ring (embedded fleet members only —
                # attached by ShardedStore): the same per-TABLE digest the
                # wire servers record, so the balancer's hot boost sees
                # embedded and wire fleets identically
                from tidb_tpu_torch import config as _config

                tid = dag.executors[0].table_id if dag.executors else 0
                ring.record(
                    f"cop table={tid} region={task.region.region_id}",
                    det.proc_ms / 1000.0,
                    len(chunk),
                    user="store",
                    slow_threshold_s=_config.current().store_slow_cop_ms / 1000.0,
                    digest_val=f"cop:{tid}|cop table={tid}",
                )
            return CopResult(chunk, task.task_id, task.region.region_id, det)

        if concurrency == 1 or len(tasks) == 1:
            def gen_serial():
                for t in tasks:
                    yield run(t)

            return CopResponse(gen_serial())

        # shared pool, windowed: at most ``concurrency`` tasks of THIS
        # request occupy workers at once. Yielding in task order (not
        # completion order) costs nothing — the reader gathers every result
        # before returning — and keeps ORDER BY tie-breaks deterministic
        # across runs and engines (a stable root sort preserves the concat
        # order of equal keys, so completion-order concat would make ties
        # racy)
        it, cancel = windowed_fanout(shared_cop_pool(concurrency), run, tasks, concurrency)
        return CopResponse(it, cancel)
