"""Online asynchronous DDL: job queue + owner worker + F1 state machine.

Reference parity: pkg/ddl — jobs are enqueued into a persisted queue
(ref: job_submitter.go), a single owner worker steps each job's schema
state one transaction at a time (ref: jobScheduler.scheduleLoop
job_scheduler.go:265, worker.runOneJobStep job_worker.go:773), bumping the
global schema version per step so concurrent DML always observes a state at
most one step away. ADD INDEX walks none → delete-only → write-only →
write-reorg → public with a batched, checkpointed backfill
(ref: ddl/backfilling.go; reorg checkpoint ref: ddl/ingest/checkpoint.go).
DROP INDEX walks the states in reverse. In this single-process framework the
owner election is trivial (one worker thread per store ≡ the etcd-elected
owner, ref: pkg/owner/manager.go:49).

Failpoints (tests drive concurrent DML between states through these):
  ddl/afterStateSwitch(job)   — after each schema-state bump
  ddl/beforeBackfillBatch(job) — before each backfill batch txn
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass, field
from typing import Optional

from tidb_tpu_torch.kv import KeyRange, tablecodec
from tidb_tpu_torch.kv.kv import WriteConflictError
from tidb_tpu_torch.kv.rowcodec import RowSchema, decode_row
from tidb_tpu_torch.utils import failpoint

JOB_PREFIX = b"m:ddl_job:"  # one key per job: O(1) checkpoint writes
REORG_BATCH = 256


class DDLError(Exception):
    pass


@dataclass
class DDLJob:
    id: int
    tp: str  # add_index / drop_index
    db: str
    table_id: int
    args: dict
    state: str = "queued"  # queued → running → done | failed
    schema_state: str = "none"  # none/delete_only/write_only/write_reorg/public
    reorg_handle: Optional[int] = None  # backfill checkpoint: next handle
    error: str = ""

    def to_pb(self) -> dict:
        return self.__dict__.copy()

    @staticmethod
    def from_pb(pb: dict) -> "DDLJob":
        return DDLJob(**pb)


class DDLWorker:
    """The owner: picks queued jobs and steps their state machines.

    Steps run synchronously inside ``run_job`` (callers block like MySQL DDL
    does) but every step is an independent schema-version bump + persisted
    job update, so a crash between steps resumes exactly where it left off —
    ``resume_pending`` re-enters half-done jobs after a restart.
    """

    def __init__(self, catalog):
        self.catalog = catalog
        self.store = catalog.store
        self._mu = threading.Lock()
        # one job runs at a time, like the reference's single owner job queue
        self._run_mu = threading.RLock()
        self._next_job_id = self._load_max_id() + 1

    # -- job persistence (ref: jobs in system tables). Each job lives under
    # its own key so per-batch checkpoint writes are O(1), not O(history). --
    @staticmethod
    def _job_key(job_id: int) -> bytes:
        return JOB_PREFIX + b"%012d" % job_id

    def _load_jobs(self) -> list[DDLJob]:
        kr = KeyRange(JOB_PREFIX, JOB_PREFIX + b"\xff")
        return [DDLJob.from_pb(json.loads(v.decode())) for _, v in self.store.raw_scan(kr)]

    def _load_max_id(self) -> int:
        return max((j.id for j in self._load_jobs()), default=0)

    def _update_job(self, job: DDLJob) -> None:
        with self._mu:
            self.store.raw_put(self._job_key(job.id), json.dumps(job.to_pb()).encode())

    def history(self) -> list[DDLJob]:
        """ADMIN SHOW DDL JOBS analog (ordered by job id)."""
        return self._load_jobs()

    # -- submission ----------------------------------------------------------
    def submit(self, tp: str, db: str, table_id: int, args: dict) -> DDLJob:
        with self._mu:
            job = DDLJob(self._next_job_id, tp, db, table_id, args)
            self._next_job_id += 1
            self.store.raw_put(self._job_key(job.id), json.dumps(job.to_pb()).encode())
        return job

    def run_job(self, job: DDLJob) -> None:
        """Step the job to completion (ref: runOneJobStep loop). Raises on
        failure after rolling the schema change back."""
        with self._run_mu:
            self._run_job_locked(job)

    def _run_job_locked(self, job: DDLJob) -> None:
        job.state = "running"
        self._update_job(job)
        try:
            while job.state == "running":
                self._one_step(job)
        except Exception as e:
            job.state = "failed"
            job.error = str(e)
            if job.tp == "add_index":
                self._rollback_add_index(job)
            self._update_job(job)
            raise

    def _rollback_add_index(self, job: DDLJob) -> None:
        """Un-publish and clear a half-built index (ref: onDropIndex reuse
        for cancelled ADD INDEX jobs)."""
        cat = self.catalog
        with cat._mu:
            try:
                t = self._table(job)
            except DDLError:
                return
            idx = self._find_index(t, job.args["name"])
            if idx is None or idx.state == "public":
                return
            t.indexes = [i for i in t.indexes if i.name != idx.name]
            self._clear_index_data(t, idx)
            cat._persist()

    def resume_pending(self) -> None:
        """Re-enter queued/running jobs after a restart (checkpoint/resume)."""
        for job in self._load_jobs():
            if job.state in ("queued", "running"):
                self.run_job(job)

    # -- the state machine ---------------------------------------------------
    def _one_step(self, job: DDLJob) -> None:
        if job.tp == "add_index":
            self._step_add_index(job)
        elif job.tp == "drop_index":
            self._step_drop_index(job)
        else:
            raise DDLError(f"unknown DDL job type {job.tp!r}")
        self._update_job(job)
        failpoint.inject("ddl/afterStateSwitch", job)

    def _table(self, job: DDLJob):
        for t in self.catalog.db(job.db).tables.values():
            if t.id == job.table_id:
                return t
        raise DDLError(f"table id {job.table_id} is gone")

    def _find_index(self, t, name: str):
        for idx in t.indexes:
            if idx.name == name:
                return idx
        return None

    def _step_add_index(self, job: DDLJob) -> None:
        cat = self.catalog
        with cat._mu:
            t = self._table(job)
            idx = self._find_index(t, job.args["name"])
            if job.schema_state == "none":
                if idx is not None:
                    raise DDLError(f"index {job.args['name']!r} already exists")
                from tidb_tpu_torch.catalog.schema import IndexInfo

                offs = [cat._col_offset(t, c) for c in job.args["columns"]]
                t.indexes.append(
                    IndexInfo(
                        t.next_index_id,
                        job.args["name"],
                        offs,
                        unique=job.args.get("unique", False),
                        state="delete_only",
                    )
                )
                t.next_index_id += 1
                job.schema_state = "delete_only"
            elif job.schema_state == "delete_only":
                idx.state = job.schema_state = "write_only"
            elif job.schema_state == "write_only":
                idx.state = job.schema_state = "write_reorg"
                job.reorg_handle = None
            elif job.schema_state == "write_reorg":
                done = self._backfill_batch(t, idx, job)
                if done:
                    idx.state = job.schema_state = "public"
                    job.state = "done"
                cat._persist()
                return
            cat._persist()

    def _step_drop_index(self, job: DDLJob) -> None:
        cat = self.catalog
        with cat._mu:
            t = self._table(job)
            idx = self._find_index(t, job.args["name"])
            if idx is None:
                raise DDLError(f"index {job.args['name']!r} doesn't exist")
            if idx.state == "public":
                idx.state = job.schema_state = "write_only"
            elif idx.state == "write_only":
                idx.state = job.schema_state = "delete_only"
            elif idx.state == "delete_only":
                # remove from schema, then clear entries (nobody reads or
                # writes them anymore)
                t.indexes = [i for i in t.indexes if i.name != idx.name]
                self._clear_index_data(t, idx)
                job.schema_state = "none"
                job.state = "done"
            cat._persist()

    # -- backfill (ref: ddl/backfilling.go txn-based path) --------------------
    def _backfill_batch(self, t, idx, job: DDLJob) -> bool:
        """One batch = one txn over REORG_BATCH rows from the checkpoint.
        Returns True when the table is exhausted. Each batch reads at its own
        fresh snapshot, so rows deleted since the last batch are skipped;
        rows written concurrently are maintained by DML itself (the index is
        in write_reorg state)."""
        from tidb_tpu_torch.executor.write import index_entry

        failpoint.inject("ddl/beforeBackfillBatch", job)
        schema = RowSchema(t.storage_schema)
        start = tablecodec.record_key(t.id, job.reorg_handle) if job.reorg_handle is not None else tablecodec.record_range(t.id).start
        kr = KeyRange(start, tablecodec.record_range(t.id).end)
        for attempt in range(8):
            txn = self.store.begin()
            try:
                rows = txn.scan(kr, limit=REORG_BATCH)
                if not rows:
                    txn.rollback()
                    return True
                for k, v in rows:
                    handle = tablecodec.decode_record_key(k)[1]
                    vals = decode_row(schema, v)
                    ik, iv = index_entry(t, idx, vals, handle)
                    if idx.unique and not any(vals[o] is None for o in idx.column_offsets):
                        hit = txn.get(ik)
                        if hit is not None and hit != iv:
                            raise DDLError(f"Duplicate entry for key {idx.name!r}")
                    txn.put(ik, iv)
                txn.commit()
                job.reorg_handle = tablecodec.decode_record_key(rows[-1][0])[1] + 1
                self._update_job(job)  # checkpoint survives a crash here
                return len(rows) < REORG_BATCH
            except WriteConflictError:
                txn.rollback()
                continue  # concurrent DML hit the same index key; retry batch
        raise DDLError("backfill kept conflicting with concurrent DML")

    def _clear_index_data(self, t, idx) -> None:
        kr = tablecodec.index_range(t.id, idx.id)
        txn = self.store.begin()
        for k, _ in txn.scan(kr):
            txn.delete(k)
        txn.commit()


def admin_check_index(store, t, idx) -> None:
    """ADMIN CHECK TABLE analog (ref: executor/admin.go): every row must have
    exactly its index entry and every index entry must point at a live row.
    Raises DDLError on any inconsistency."""
    from tidb_tpu_torch.executor.write import index_entry

    schema = RowSchema(t.storage_schema)
    txn = store.begin()
    expected = {}
    for k, v in txn.scan(tablecodec.record_range(t.id)):
        handle = tablecodec.decode_record_key(k)[1]
        ik, iv = index_entry(t, idx, decode_row(schema, v), handle)
        expected[ik] = iv
    actual = {k: v for k, v in txn.scan(tablecodec.index_range(t.id, idx.id))}
    txn.rollback()
    missing = set(expected) - set(actual)
    extra = set(actual) - set(expected)
    if missing or extra:
        raise DDLError(
            f"index {idx.name!r} inconsistent: {len(missing)} missing, {len(extra)} dangling entries"
        )
    for k in expected:
        if expected[k] != actual[k]:
            raise DDLError(f"index {idx.name!r} entry mismatch at {k!r}")
