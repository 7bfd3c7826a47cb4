"""Online DDL on the port (``catalog/ddl.py``, a copy), held against the
reference: the cases of ``tests/test_ddl.py`` run on ``tidb_tpu.open()``
and ``tidb_tpu_torch.open(device="cpu")`` and must observe the same F1
states, rows and job history. At every state switch of an ADD INDEX (the
``ddl/afterStateSwitch`` failpoint) the port's ``gpu`` session reads the
table, and the read equals the reference's ``tpu`` read at that state."""

import os
import sys
import types

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.catalog import ddl as ref_ddl  # noqa: E402
from tidb_tpu.kv import tablecodec as ref_tablecodec  # noqa: E402
from tidb_tpu.utils import failpoint as ref_failpoint  # noqa: E402
from tidb_tpu_torch.catalog import ddl as port_ddl  # noqa: E402
from tidb_tpu_torch.kv import tablecodec as port_tablecodec  # noqa: E402
from tidb_tpu_torch.utils import failpoint as port_failpoint  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(
        open=lambda: tidb_tpu.open(), ddl=ref_ddl, fp=ref_failpoint, tc=ref_tablecodec, eng="tpu"
    ),
    "port": types.SimpleNamespace(
        open=lambda: tidb_tpu_torch.open(device="cpu"), ddl=port_ddl, fp=port_failpoint, tc=port_tablecodec, eng="gpu"
    ),
}


def _index(db, tname, iname):
    t = db._ses().catalog.table("test", tname)
    return t, next((i for i in t.indexes if i.name == iname), None)


def _history(db):
    return [(j.tp, j.state, j.schema_state, j.error) for j in db._ses().catalog.ddl.history()]


def _device_reader(db, eng):
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines = '{eng}'")
    return s


def case_add_index_online_with_concurrent_dml(P):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, a BIGINT)")
    db.execute("INSERT INTO t VALUES " + ",".join(f"({i}, {i % 50})" for i in range(1, 401)))
    ses2 = db._ses()
    dev = _device_reader(db, P.eng)
    states, reads = [], []

    def on_switch(job):
        if states and states[-1] == job.schema_state:
            return
        states.append(job.schema_state)
        if job.schema_state == "delete_only":
            ses2.execute("DELETE FROM t WHERE id = 1")
        elif job.schema_state == "write_only":
            ses2.execute("INSERT INTO t VALUES (1001, 777)")
            ses2.execute("UPDATE t SET a = 99 WHERE id = 2")
        elif job.schema_state == "write_reorg":
            ses2.execute("INSERT INTO t VALUES (1002, 888)")
            ses2.execute("DELETE FROM t WHERE id = 3")
        # the device session's read at this state
        rows = dev.query("SELECT a, COUNT(*), SUM(id) FROM t GROUP BY a ORDER BY a")
        engines = {("dev" if e == P.eng else e): n for e, n in dev.exec_summary.engines.items()}
        reads.append((job.schema_state, rows, engines))

    with P.fp.enabled("ddl/afterStateSwitch", on_switch):
        db.execute("CREATE INDEX ia ON t (a)")
    t, idx = _index(db, "t", "ia")
    assert idx is not None and idx.state == "public"
    P.ddl.admin_check_index(db.store, t, idx)
    assert db.query("ADMIN CHECK INDEX t ia") == []
    q = [
        db.query("SELECT id FROM t WHERE a = 99 ORDER BY id"),
        db.query("SELECT COUNT(*) FROM t WHERE a = 777"),
        db.query("SELECT COUNT(*) FROM t WHERE a = 888"),
    ]
    return states, reads, q, _history(db)


def case_add_index_not_readable_before_public(P):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, a BIGINT)")
    db.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    plans = {}

    def on_switch(job):
        if job.schema_state in ("write_only", "public"):
            r = db.execute("EXPLAIN SELECT id FROM t WHERE a = 10")
            plans[job.schema_state] = "\n".join(row[0] for row in r.rows).replace(f"[{P.eng}]", "[dev]")

    with P.fp.enabled("ddl/afterStateSwitch", on_switch):
        db.execute("CREATE INDEX ia ON t (a)")
    assert "IndexReader" not in plans["write_only"]
    assert "IndexReader" in plans["public"] or "IndexScan" in plans["public"]
    return plans, db.query("SELECT id FROM t WHERE a = 10"), _history(db)


def case_unique_index_backfill_duplicate_rolls_back(P):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, a BIGINT)")
    db.execute("INSERT INTO t VALUES (1, 5), (2, 5)")
    with pytest.raises(Exception, match="[Dd]uplicate"):
        db.execute("CREATE UNIQUE INDEX ua ON t (a)")
    t, idx = _index(db, "t", "ua")
    assert idx is None
    txn = db.store.begin()
    leftovers = txn.scan(P.tc.index_range(t.id, t.next_index_id - 1))
    txn.rollback()
    assert leftovers == []
    jobs = db._ses().catalog.ddl.history()
    assert jobs[-1].state == "failed" and "uplicate" in jobs[-1].error
    return _history(db)


def case_backfill_checkpoint_resume_after_crash(P):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, a BIGINT)")
    db.execute("INSERT INTO t VALUES " + ",".join(f"({i}, {i})" for i in range(1, 601)))
    calls = []

    def crash_second_batch(job):
        calls.append(job.reorg_handle)
        if len(calls) == 2:
            raise KeyboardInterrupt

    with P.fp.enabled("ddl/beforeBackfillBatch", crash_second_batch):
        with pytest.raises(KeyboardInterrupt):
            db.execute("CREATE INDEX ia ON t (a)")
    cat = db._ses().catalog
    job = cat.ddl.history()[-1]
    assert job.state == "running" and job.schema_state == "write_reorg"
    checkpoint = job.reorg_handle
    assert checkpoint is not None and checkpoint > 0
    t, idx = _index(db, "t", "ia")
    assert idx is not None and idx.state == "write_reorg"
    cat._ddl = None
    cat.ddl.resume_pending()
    t, idx = _index(db, "t", "ia")
    assert idx.state == "public"
    P.ddl.admin_check_index(db.store, t, idx)
    dev = _device_reader(db, P.eng)
    return calls, checkpoint, dev.query("SELECT COUNT(*), SUM(a) FROM t WHERE a > 0"), _history(db)


def case_drop_index_clears_entries(P):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, a BIGINT)")
    db.execute("INSERT INTO t VALUES (1, 10), (2, 20)")
    db.execute("CREATE INDEX ia ON t (a)")
    t, idx = _index(db, "t", "ia")
    iid = idx.id
    db.execute("DROP INDEX ia ON t")
    t, idx = _index(db, "t", "ia")
    assert idx is None
    txn = db.store.begin()
    assert txn.scan(P.tc.index_range(t.id, iid)) == []
    txn.rollback()
    return db.query("SELECT id FROM t WHERE a = 10"), _history(db)


def case_ddl_job_history(P):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, a BIGINT)")
    db.execute("CREATE INDEX ia ON t (a)")
    db.execute("DROP INDEX ia ON t")
    jobs = db._ses().catalog.ddl.history()
    assert [j.tp for j in jobs] == ["add_index", "drop_index"]
    assert all(j.state == "done" for j in jobs)
    shown = [r[1:3] for r in db.query("ADMIN SHOW DDL JOBS")]
    return _history(db), shown


CASES = {name[5:]: fn for name, fn in sorted(globals().items()) if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_ddl_case_observes_the_references_states_and_rows(case):
    got = {pkg: CASES[case](P) for pkg, P in PKGS.items()}
    assert got["port"] == got["ref"]


def test_device_reads_at_every_f1_state():
    """The online ADD INDEX passes through delete-only, write-only,
    write-reorg (once per backfill batch) and public; at each the port's
    gpu session reads the concurrent writes as the reference's tpu one."""
    states, reads, _q, history = case_add_index_online_with_concurrent_dml(PKGS["port"])
    assert states[:3] == ["delete_only", "write_only", "write_reorg"] and states[-1] == "public"
    assert [r[0] for r in reads] == states
    assert all(engines == {"dev": 1} for _s, _rows, engines in reads)
    assert history == [("add_index", "done", "public", "")]
    by_state = {s: dict((a, (n, sid)) for a, n, sid in rows) for s, rows, _e in reads}
    assert by_state["write_only"][777] == (1, 1001) and by_state["public"][888] == (1, 1002)


def test_add_index_on_a_partitioned_table_answers_as_the_reference():
    """ADD INDEX on a partitioned table: the backfill scans the logical
    table id, which holds no rows (ROADMAP Queue C 12, a reference defect
    the copy keeps), so ADMIN CHECK INDEX reports the same missing entries
    in both packages, while the gpu read stays right."""
    got = {}
    for pkg, P in PKGS.items():
        db = P.open()
        db.execute(
            "CREATE TABLE t (a BIGINT, b BIGINT) PARTITION BY RANGE (a) "
            "(PARTITION p0 VALUES LESS THAN (3), PARTITION p1 VALUES LESS THAN MAXVALUE)"
        )
        db.execute("INSERT INTO t VALUES (1, 1), (2, 2), (3, 3), (4, 4)")
        db.execute("ALTER TABLE t ADD INDEX ib (b)")
        with pytest.raises(P.ddl.DDLError) as ei:
            db.query("ADMIN CHECK INDEX t ib")
        dev = _device_reader(db, P.eng)
        got[pkg] = str(ei.value), dev.query("SELECT a FROM t WHERE b = 3"), _history(db)
    assert got["port"] == got["ref"]
    assert got["port"][1] == [(3,)]
