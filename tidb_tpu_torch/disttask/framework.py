"""Distributed task framework.

Reference parity (pkg/disttask/framework):
- task / subtask state machines persisted in system tables
  (mysql.tidb_global_task, mysql.tidb_background_subtask — framework/storage)
  so SQL can inspect them and pending work resumes after interruption;
- a Scheduler that asks the task type's SchedulerExt to plan subtasks per
  step and advances the task when all subtasks of a step finish
  (scheduler/scheduler.go:61);
- TaskExecutor worker threads ("nodes") claiming pending subtasks and
  running the registered StepExecutor (taskexecutor/interface.go:70);
- cancellation propagates to running subtasks; failed subtasks fail the
  task and remaining subtasks are cancelled (proto/task.go transitions).
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional


class TaskState:
    PENDING = "pending"
    RUNNING = "running"
    SUCCEED = "succeed"
    FAILED = "failed"
    CANCELLING = "cancelling"
    CANCELLED = "cancelled"


class SubtaskState:
    PENDING = "pending"
    RUNNING = "running"
    SUCCEED = "succeed"
    FAILED = "failed"
    CANCELED = "canceled"


@dataclass
class Subtask:
    id: int
    task_id: int
    step: int
    state: str
    exec_id: str
    meta: dict
    summary: dict
    lease: int = 0  # epoch ms the claim expires; 0 = unclaimed


@dataclass
class Task:
    id: int
    type: str
    state: str
    step: int
    concurrency: int
    meta: dict
    error: str = ""


class SchedulerExt:
    """Per-task-type planning hooks (ref: scheduler.Extension)."""

    #: step numbers, in order; the task succeeds after the last one
    steps: list[int] = [1]

    def plan_subtasks(self, task: Task, step: int, manager: "DistTaskManager") -> list[dict]:
        """→ subtask metas for this step. Metas must be self-contained JSON:
        they travel through the shared system tables to OTHER processes'
        executor nodes (ref: subtask meta bytes crossing nodes)."""
        raise NotImplementedError

    def on_done(self, task: Task, manager: "DistTaskManager") -> None:
        """Called once when the task reaches succeed."""


class StepExecutor:
    """Runs one subtask (ref: execute.StepExecutor.RunSubtask)."""

    def run_subtask(self, task: Task, subtask: Subtask, manager: "DistTaskManager") -> dict:
        """→ summary dict persisted on the subtask."""
        raise NotImplementedError


_REGISTRY: dict[str, tuple[SchedulerExt, StepExecutor]] = {}


def register_task_type(name: str, ext: SchedulerExt, executor: StepExecutor) -> None:
    # registration happens at setup time, before any scheduler thread runs
    _REGISTRY[name] = (ext, executor)  # graftcheck: off=shared-mutation


class DistTaskManager:
    """Owner-side scheduler + executor pool in one process (the reference
    splits these across nodes; the contracts are the same)."""

    def __init__(self, db, n_workers: int = 4, node_prefix: str = "exec", lease_ms: int = 10_000):
        self.db = db
        self.n_workers = n_workers
        self.node_prefix = node_prefix
        self.lease_ms = lease_ms
        self._mu = threading.Lock()
        self._cancel_flags: dict[int, threading.Event] = {}
        self._ensure_tables()

    # -- storage (system tables; ref: framework/storage) --------------------
    def _ensure_tables(self) -> None:
        s = self._session()
        for ddl in (
            "CREATE DATABASE IF NOT EXISTS mysql",
            "CREATE TABLE IF NOT EXISTS mysql.tidb_global_task (id BIGINT PRIMARY KEY, "
            "task_type VARCHAR(64), state VARCHAR(32), step BIGINT, concurrency BIGINT, "
            "meta TEXT, error TEXT)",
            "CREATE TABLE IF NOT EXISTS mysql.tidb_background_subtask (id BIGINT PRIMARY KEY, "
            "task_id BIGINT, step BIGINT, state VARCHAR(32), exec_id VARCHAR(64), "
            "meta TEXT, summary TEXT, lease BIGINT)",
        ):
            # managers in several processes bootstrap concurrently; the
            # catalog's optimistic versioning reloads and asks for a retry
            for attempt in range(5):
                try:
                    s.execute(ddl)
                    break
                except Exception as e:
                    if "retry the statement" not in str(e) or attempt == 4:
                        raise
                    time.sleep(0.05 * (attempt + 1))

    def _session(self):
        s = self.db.session()
        s.user, s.host = "root", "%"
        return s

    def _q(self, sql: str):
        return self._session().query(sql)

    def _x(self, sql: str):
        return self._session().execute(sql)

    @staticmethod
    def _esc(v: str) -> str:
        return v.replace("\\", "\\\\").replace("'", "\\'")

    def _next_id(self, table: str) -> int:
        r = self._q(f"SELECT MAX(id) FROM mysql.{table}")
        return (r[0][0] or 0) + 1

    # -- task API ------------------------------------------------------------
    def submit_task(self, task_type: str, meta: dict, concurrency: int = 4) -> int:
        if task_type not in _REGISTRY:
            raise ValueError(f"unknown task type {task_type!r}")
        with self._mu:
            tid = self._next_id("tidb_global_task")
            self._x(
                "INSERT INTO mysql.tidb_global_task VALUES "
                f"({tid}, '{task_type}', '{TaskState.PENDING}', 0, {concurrency}, "
                f"'{self._esc(json.dumps(meta))}', '')"
            )
        return tid

    def get_task(self, task_id: int) -> Optional[Task]:
        r = self._q(f"SELECT * FROM mysql.tidb_global_task WHERE id = {task_id}")
        if not r:
            return None
        tid, tp, state, step, conc, meta, err = r[0]
        return Task(tid, tp, state, step, conc, json.loads(meta), err or "")

    def subtasks(self, task_id: int, step: Optional[int] = None) -> list[Subtask]:
        cond = f"task_id = {task_id}" + (f" AND step = {step}" if step is not None else "")
        out = []
        for sid, tid, st, state, ex, meta, summary, lease in self._q(
            f"SELECT * FROM mysql.tidb_background_subtask WHERE {cond} ORDER BY id"
        ):
            out.append(
                Subtask(sid, tid, st, state, ex, json.loads(meta), json.loads(summary or "{}"), lease or 0)
            )
        return out

    def cancel_task(self, task_id: int) -> None:
        self._set_task_state(task_id, TaskState.CANCELLING)
        with self._mu:
            ev = self._cancel_flags.get(task_id)
        if ev is not None:
            ev.set()

    def is_cancelling(self, task_id: int) -> bool:
        with self._mu:
            ev = self._cancel_flags.get(task_id)
        return ev is not None and ev.is_set()

    def _set_task_state(self, task_id: int, state: str, error: str = "") -> None:
        self._x(
            f"UPDATE mysql.tidb_global_task SET state = '{state}', error = '{self._esc(error)}' "
            f"WHERE id = {task_id}"
        )

    def _set_subtask(self, sid: int, state: str, summary: Optional[dict] = None) -> None:
        extra = f", summary = '{self._esc(json.dumps(summary))}'" if summary is not None else ""
        self._x(
            f"UPDATE mysql.tidb_background_subtask SET state = '{state}'{extra} WHERE id = {sid}"
        )

    # -- scheduler + executor (ref: scheduleLoop + taskExecutor pool) --------
    def run_task(self, task_id: int) -> Task:
        """Drive one task to a terminal state (synchronous scheduler loop;
        the caller is the 'owner node')."""
        task = self.get_task(task_id)
        if task is None:
            raise ValueError(f"unknown task {task_id}")
        ext, _ = _REGISTRY[task.type]
        cancel = threading.Event()
        with self._mu:
            self._cancel_flags[task_id] = cancel
        try:
            self._set_task_state(task_id, TaskState.RUNNING)
            for step in ext.steps:
                task = self.get_task(task_id)
                existing = self.subtasks(task_id, step)
                if not existing:
                    metas = ext.plan_subtasks(task, step, self)
                    with self._mu:
                        base = self._next_id("tidb_background_subtask")
                        for i, m in enumerate(metas):
                            self._x(
                                "INSERT INTO mysql.tidb_background_subtask VALUES "
                                f"({base + i}, {task_id}, {step}, '{SubtaskState.PENDING}', '', "
                                f"'{self._esc(json.dumps(m))}', '{{}}', 0)"
                            )
                self._x(
                    f"UPDATE mysql.tidb_global_task SET step = {step} WHERE id = {task_id}"
                )
                ok, err = self._run_step(task_id, step, cancel)
                if not ok:
                    if err and err != "cancelled":
                        self._set_task_state(task_id, TaskState.FAILED, err)
                    else:
                        self._set_task_state(task_id, TaskState.CANCELLED, "cancelled by user")
                    return self.get_task(task_id)
            task = self.get_task(task_id)
            ext.on_done(task, self)
            self._set_task_state(task_id, TaskState.SUCCEED)
            return self.get_task(task_id)
        finally:
            with self._mu:
                self._cancel_flags.pop(task_id, None)

    # -- cross-process subtask claiming (ref: taskexecutor manager claiming
    # subtasks from shared storage; scheduler balanceSubtasks re-queueing
    # subtasks whose node died) ---------------------------------------------
    def claim_subtask(self, exec_id: str, lease_ms: int = 10_000, task_id: Optional[int] = None):
        """Atomically claim one pending subtask of a running task. The claim
        is an optimistic conditional UPDATE — two nodes racing the same row
        hit a write conflict and one loses cleanly. Returns (Task, Subtask)
        or None."""
        cond = f"AND t.id = {task_id}" if task_id is not None else ""
        # only claim task types REGISTERED in this process — a node must not
        # take work it cannot execute (ref: executors advertising task types)
        known = ", ".join(f"'{self._esc(k)}'" for k in _REGISTRY) or "''"
        rows = self._q(
            "SELECT s.id, s.task_id FROM mysql.tidb_background_subtask s, "
            "mysql.tidb_global_task t WHERE s.task_id = t.id AND "
            f"t.state = '{TaskState.RUNNING}' AND s.state = '{SubtaskState.PENDING}' "
            f"AND t.task_type IN ({known}) {cond} "
            "ORDER BY s.id LIMIT 4"
        )
        now_ms = int(time.time() * 1000)
        for sid, tid in rows:
            try:
                res = self._x(
                    f"UPDATE mysql.tidb_background_subtask SET state = '{SubtaskState.RUNNING}', "
                    f"exec_id = '{self._esc(exec_id)}', lease = {now_ms + lease_ms} "
                    f"WHERE id = {sid} AND state = '{SubtaskState.PENDING}'"
                )
            # write conflict: another node won the claim — the protocol, not
            # a failure (optimistic claim via conditional UPDATE)
            except Exception:  # graftcheck: off=except-swallow
                continue
            if getattr(res, "affected", 0) != 1:
                continue
            task = self.get_task(tid)
            st = next(s for s in self.subtasks(tid) if s.id == sid)
            return task, st
        return None

    def run_claimed(self, task: Task, st: Subtask) -> None:
        """Execute a claimed subtask and persist its terminal state.

        While the subtask runs, a heartbeat thread RENEWS the claim lease —
        a slow-but-alive node must not lose its claim to the scheduler's
        expiry sweep (ref: subtask heartbeat/balance). The terminal write is
        FENCED on still owning the claim: if the lease was lost anyway and
        the subtask re-queued, the stale worker's state write is discarded.
        Data side effects survive the fence, so executors must be idempotent
        under re-runs — the import executor writes deterministic handle
        ranges reserved at plan time (see tools/importer plan_subtasks)."""
        reg = _REGISTRY.get(task.type)
        if reg is None:  # claim filter should prevent this; never kill the node loop
            self._fenced_set(st, SubtaskState.FAILED, {"error": f"task type {task.type!r} not registered"})
            return
        _, executor = reg
        hb_stop = threading.Event()

        def heartbeat():
            while not hb_stop.wait(self.lease_ms / 3000.0):
                try:
                    self._x(
                        f"UPDATE mysql.tidb_background_subtask SET lease = "
                        f"{int(time.time() * 1000) + self.lease_ms} WHERE id = {st.id} "
                        f"AND state = '{SubtaskState.RUNNING}' AND exec_id = '{self._esc(st.exec_id)}'"
                    )
                # store briefly unreachable; the next beat retries the lease
                except Exception:  # graftcheck: off=except-swallow
                    pass

        hb = threading.Thread(target=heartbeat, daemon=True, name=f"disttask-hb-{st.id}")
        hb.start()
        try:
            summary = executor.run_subtask(task, st, self)
            self._fenced_set(st, SubtaskState.SUCCEED, summary or {})
        except Exception as e:
            self._fenced_set(st, SubtaskState.FAILED, {"error": str(e)})
        finally:
            hb_stop.set()
            hb.join()

    def _fenced_set(self, st: Subtask, state: str, summary: dict) -> bool:
        """Terminal subtask write, conditional on the claim still being
        ours — a re-queued claim makes the stale execution a no-op."""
        try:
            res = self._x(
                f"UPDATE mysql.tidb_background_subtask SET state = '{state}', "
                f"summary = '{self._esc(json.dumps(summary))}' WHERE id = {st.id} "
                f"AND state = '{SubtaskState.RUNNING}' AND exec_id = '{self._esc(st.exec_id)}'"
            )
            return getattr(res, "affected", 0) == 1
        except Exception:
            return False

    def _requeue_expired(self, task_id: int, step: int) -> int:
        """Running subtasks whose claim lease expired (node died mid-run)
        go back to pending for another node to pick up."""
        now_ms = int(time.time() * 1000)
        n = 0
        for st in self.subtasks(task_id, step):
            if st.state == SubtaskState.RUNNING and 0 < st.lease < now_ms:
                try:
                    res = self._x(
                        f"UPDATE mysql.tidb_background_subtask SET state = '{SubtaskState.PENDING}', "
                        f"exec_id = '', lease = 0 WHERE id = {st.id} AND state = '{SubtaskState.RUNNING}' "
                        f"AND lease = {st.lease}"
                    )
                    n += getattr(res, "affected", 0)
                # reclaim is best-effort: a missed subtask is retried by the
                # next expiry sweep (lease still expired)
                except Exception:  # graftcheck: off=except-swallow
                    pass
        return n

    def _run_step(self, task_id: int, step: int, cancel: threading.Event) -> tuple[bool, str]:
        """Drive one step to completion. Local worker threads AND executor
        nodes in other processes (TaskExecutorNode over the same store)
        claim subtasks from the shared tables; the owner loop re-queues
        expired claims and waits until every subtask is terminal."""
        task = self.get_task(task_id)
        stop_workers = threading.Event()

        def worker(node_id: int):
            from tidb_tpu_torch.utils import failpoint

            exec_id = f"{self.node_prefix}-{node_id}"
            failpoint.inject("disttask_local_worker_start", exec_id)
            idle = 0
            while not cancel.is_set() and not stop_workers.is_set():
                got = self.claim_subtask(exec_id, lease_ms=self.lease_ms, task_id=task_id)
                if got is None:
                    idle += 1
                    if idle > 2:
                        return  # no pending work left for this step
                    time.sleep(0.05)
                    continue
                idle = 0
                self.run_claimed(*got)

        n = min(max(task.concurrency, 1), self.n_workers)
        threads = [
            threading.Thread(target=worker, args=(i,), daemon=True, name=f"disttask-w{i}")
            for i in range(n)
        ]
        for t in threads:
            t.start()
        err = ""
        while True:
            sts = self.subtasks(task_id, step)
            failed = [s for s in sts if s.state == SubtaskState.FAILED]
            if failed:
                err = failed[0].summary.get("error", "subtask failed")
                cancel.set()
                break
            if cancel.is_set():
                break
            if all(s.state == SubtaskState.SUCCEED for s in sts):
                break
            # a remote node may have died mid-claim: expired leases re-queue,
            # and idle local workers restart to pick them up
            if self._requeue_expired(task_id, step) and all(not t.is_alive() for t in threads):
                threads = [
                    threading.Thread(target=worker, args=(i,), daemon=True, name=f"disttask-w{i}")
                    for i in range(n)
                ]
                for t in threads:
                    t.start()
            time.sleep(0.05)
        stop_workers.set()
        for t in threads:
            t.join()
        if err or cancel.is_set():
            for st in self.subtasks(task_id, step):
                if st.state == SubtaskState.PENDING:
                    self._set_subtask(st.id, SubtaskState.CANCELED)
            return False, err or "cancelled"
        return True, ""

    def start_executor_node(self, node_id: str, poll_s: float = 0.1) -> "TaskExecutorNode":
        node = TaskExecutorNode(self, node_id, poll_s=poll_s)
        node.start()
        return node

    def resume_pending(self) -> list[int]:
        """Re-drive tasks left non-terminal (crash recovery — ref: disttask
        resuming from system-table state after restart)."""
        out = []
        for (tid,) in self._q(
            "SELECT id FROM mysql.tidb_global_task WHERE state = 'pending' OR state = 'running'"
        ):
            self.run_task(tid)
            out.append(tid)
        return out


class TaskExecutorNode:
    """A subtask-executing node — typically running in ANOTHER process
    attached to the same store (the storage-server process, a worker pod)
    (ref: taskexecutor.Manager, taskexecutor/manager.go — nodes poll shared
    storage for claimable subtasks; no dispatch RPC exists, the tables ARE
    the dispatch)."""

    def __init__(self, manager: DistTaskManager, node_id: str, poll_s: float = 0.1):
        self.manager = manager
        self.node_id = node_id
        self.poll_s = poll_s
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=f"disttask-{node_id}")
        self.executed = 0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                got = self.manager.claim_subtask(self.node_id, lease_ms=self.manager.lease_ms)
            except Exception:
                got = None  # store briefly unreachable: keep polling
            if got is None:
                time.sleep(self.poll_s)
                continue
            self.manager.run_claimed(*got)
            self.executed += 1
