"""LOAD DATA, IMPORT INTO and the distributed task framework on the port
(``tools/importer.py``, ``disttask/``: copies), held against the reference.

Each case runs the same statements on ``tidb_tpu.open()`` and
``tidb_tpu_torch.open(device="cpu")`` and must give the same outcome: the
cases of tests/test_load_data.py, tests/test_disttask.py and
tests/test_tools.py::test_import_into_csv, a dist-task import beside an MPP
gather in another session, appends into a table the device engine has
already read (a small one folded as the delta operand, with a string the
table never held; a big one that rebuilds the blocks), and the two
cross-process cases of tests/test_disttask_remote.py against a port store
process. The port's ``gpu`` engine runs every kernel's plain version here.
"""

import dataclasses
import os
import signal
import subprocess
import sys
import threading
import time
import types

import jax
import jax.experimental
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu import config as ref_config  # noqa: E402
from tidb_tpu import disttask as ref_disttask  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv import remote as ref_remote  # noqa: E402
from tidb_tpu.parallel import mesh as ref_mesh  # noqa: E402
from tidb_tpu.tools import importer as ref_importer  # noqa: E402
from tidb_tpu.utils import failpoint as ref_failpoint  # noqa: E402
from tidb_tpu.utils import lockcheck  # noqa: E402
from tidb_tpu_torch import config as port_config  # noqa: E402
from tidb_tpu_torch import disttask as port_disttask  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load as port_bulk_load  # noqa: E402
from tidb_tpu_torch.kv import remote as port_remote  # noqa: E402
from tidb_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from tidb_tpu_torch.tools import importer as port_importer  # noqa: E402
from tidb_tpu_torch.utils import failpoint as port_failpoint  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "ref": types.SimpleNamespace(
        open=lambda **kw: tidb_tpu.open(**kw), importer=ref_importer, disttask=ref_disttask,
        failpoint=ref_failpoint, bulk_load=ref_bulk_load, mesh=ref_mesh, config=ref_config, remote=ref_remote,
        eng="tpu",
    ),
    "port": types.SimpleNamespace(
        open=lambda **kw: tidb_tpu_torch.open(device="cpu", **kw), importer=port_importer,
        disttask=port_disttask, failpoint=port_failpoint, bulk_load=port_bulk_load, mesh=port_mesh,
        config=port_config, remote=port_remote, eng="gpu",
    ),
}


@pytest.fixture(autouse=True)
def _reference_pallas(monkeypatch):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _both(fn, tmp_path):
    out = {}
    for pkg, P in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = fn(P, d)
    assert out["port"] == out["ref"]
    return out["port"]


# -- the reference's cases, on both packages ----------------------------------


def _load_data_basic_and_column_list(P, d):
    s = P.open().session()
    s.execute("CREATE TABLE ld (id BIGINT PRIMARY KEY, name VARCHAR(16), v BIGINT)")
    p = d / "d.csv"
    p.write_text("id,name,v\n1,alpha,10\n2,beta,20\n3,\\N,30\n")
    r = s.execute(f"LOAD DATA INFILE '{p}' INTO TABLE ld FIELDS TERMINATED BY ',' IGNORE 1 LINES")
    rows = s.execute("SELECT * FROM ld ORDER BY id").rows
    assert (r.affected, rows) == (3, [(1, "alpha", 10), (2, "beta", 20), (3, None, 30)])
    p2 = d / "d.tsv"
    p2.write_text("40\t4\n50\t5\n")
    r2 = s.execute(f"LOAD DATA LOCAL INFILE '{p2}' INTO TABLE ld (v, id)")
    rows2 = s.execute("SELECT id, name, v FROM ld WHERE id >= 4 ORDER BY id").rows
    assert (r2.affected, rows2) == (2, [(4, None, 40), (5, None, 50)])
    return r.affected, rows, r2.affected, rows2


def _load_data_errors(P, d):
    s = P.open().session()
    s.execute("CREATE TABLE le (a BIGINT, b BIGINT)")
    p = d / "e.csv"
    p.write_text("1,2\n")
    out = []
    for sql in (f"LOAD DATA INFILE '{p}' INTO TABLE le FIELDS TERMINATED BY ',' (a, nope)",
                "LOAD DATA INFILE '/definitely/not/here.csv' INTO TABLE le"):
        with pytest.raises(Exception) as e:
            s.execute(sql)
        out.append((type(e.value).__name__, str(e.value)))
    assert "Unknown column" in out[0][1]
    return out


def _sum_task_type(P):
    """tests/test_disttask.py's two-step "sum" task over ``P``'s framework."""

    class SumExt(P.disttask.SchedulerExt):
        steps = [1, 2]

        def plan_subtasks(self, task, step, manager):
            if step == 1:
                return [{"lo": i * 10, "hi": (i + 1) * 10} for i in range(task.meta["n"])]
            return [{"merge": True}]

        def on_done(self, task, manager):
            pass

    class SumExec(P.disttask.StepExecutor):
        def run_subtask(self, task, subtask, manager):
            if subtask.meta.get("merge"):
                parts = [st.summary["part"] for st in manager.subtasks(task.id, 1)
                         if st.state == P.disttask.SubtaskState.SUCCEED]
                return {"total": sum(parts)}
            lo, hi = subtask.meta["lo"], subtask.meta["hi"]
            if task.meta.get("boom") and lo >= 20:
                raise RuntimeError("subtask exploded")
            return {"part": sum(range(lo, hi))}

    P.disttask.register_task_type("sum", SumExt(), SumExec())
    return SumExt


def _mgr(P):
    _sum_task_type(P)
    return P.disttask.DistTaskManager(P.open(), n_workers=3)


def _multi_step_task(P, d):
    mgr = _mgr(P)
    tid = mgr.submit_task("sum", {"n": 5}, concurrency=3)
    task = mgr.run_task(tid)
    merge = mgr.subtasks(tid, 2)[0]
    execs = {st.exec_id for st in mgr.subtasks(tid, 1)}
    assert all(e.startswith("exec-") for e in execs)
    rows = mgr.db.query(f"SELECT state FROM mysql.tidb_global_task WHERE id = {tid}")
    assert (task.state, merge.summary["total"], rows) == ("succeed", sum(range(50)), [("succeed",)])
    return task.state, merge.summary, rows


def _failure_fails_task_and_cancels_rest(P, d):
    mgr = _mgr(P)
    tid = mgr.submit_task("sum", {"n": 30, "boom": True}, concurrency=1)
    task = mgr.run_task(tid)
    states = {st.state for st in mgr.subtasks(tid, 1)}
    assert task.state == "failed" and "exploded" in task.error
    assert {"failed", "canceled"} <= states
    return task.state, task.error, sorted(states)


def _cancel_task(P, d):
    mgr = _mgr(P)

    class SlowExec(P.disttask.StepExecutor):
        def run_subtask(self, task, subtask, manager):
            for _ in range(100):
                if manager.is_cancelling(task.id):
                    raise RuntimeError("observed cancel")
                time.sleep(0.01)
            return {}

    P.disttask.register_task_type("slow", _sum_task_type(P)(), SlowExec())
    tid = mgr.submit_task("slow", {"n": 8}, concurrency=2)
    out = {}
    th = threading.Thread(target=lambda: out.update(task=mgr.run_task(tid)))
    th.start()
    time.sleep(0.15)
    mgr.cancel_task(tid)
    th.join(timeout=30)
    assert out["task"].state in ("cancelled", "failed")
    return "cancelled or failed"


def _resume_pending(P, d):
    mgr = _mgr(P)
    tid = mgr.submit_task("sum", {"n": 2})
    before = mgr.get_task(tid).state
    resumed = mgr.resume_pending()
    after = mgr.get_task(tid).state
    assert (before, tid in resumed, after) == ("pending", True, "succeed")
    return before, after


def _import_into_via_disttask(P, d):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    p = d / "x.csv"
    p.write_text("".join(f"{i},{i * 2}\n" for i in range(500)))
    n = P.importer.import_into_disttask(db, "test", "t", str(p))
    agg = db.query("SELECT COUNT(*), SUM(v) FROM t")
    trail = db.query("SELECT task_type, state FROM mysql.tidb_global_task")
    assert (n, agg) == (500, [(500, 2 * 499 * 500 // 2)]) and ("import_into", "succeed") in trail
    return n, agg, trail


def _import_into_sql_dist_task_var(P, d):
    db = P.open()
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    p = d / "y.csv"
    p.write_text("1,2\n3,4\n")
    s = db.session()
    s.execute("SET tidb_enable_dist_task = 1")
    n = s.execute(f"IMPORT INTO t FROM '{p}'").affected
    trail = db.query("SELECT task_type FROM mysql.tidb_global_task")
    assert (n, trail) == (2, [("import_into",)])
    return n, trail, s.query("SELECT * FROM t ORDER BY id")


def _import_subtask_rerun_is_idempotent(P, d):
    db = P.open()
    db.execute("CREATE TABLE noidx (a BIGINT, b VARCHAR(16))")
    p = d / "dup.csv"
    p.write_text("".join(f"{i},row{i}\n" for i in range(400)))
    importer, failpoint = P.importer, P.failpoint
    importer.register_import_task_type()
    mgr = P.disttask.DistTaskManager(db, n_workers=0)
    db._disttask_mgr = mgr
    importer._SUBTASK_ROWS, saved = 150, importer._SUBTASK_ROWS
    try:
        tid = mgr.submit_task(
            "import_into",
            {"db": "test", "table": "noidx", "path": str(p), "skip_header": False, "delimiter": ","},
        )
        done = {}
        th = threading.Thread(target=lambda: done.update(task=mgr.run_task(tid)))
        th.start()
        for _ in range(200):
            if mgr.get_task(tid).state == "running" and mgr.subtasks(tid):
                break
            time.sleep(0.05)
        task, st = mgr.claim_subtask("worker-A", lease_ms=60_000, task_id=tid)
        hold, entered = threading.Event(), threading.Event()

        def slow_first(sub):
            if sub.id == st.id and not entered.is_set():
                entered.set()
                hold.wait(30)

        failpoint.enable("import_subtask_before_ingest", slow_first)
        try:
            ta = threading.Thread(target=lambda: mgr.run_claimed(task, st))
            ta.start()
            assert entered.wait(10)
            mgr._x(
                "UPDATE mysql.tidb_background_subtask SET state = 'pending', "
                f"exec_id = '', lease = 0 WHERE id = {st.id}"
            )
            failpoint.disable("import_subtask_before_ingest")
            re_claimed = mgr.claim_subtask("worker-B", lease_ms=60_000, task_id=tid)
            assert re_claimed is not None and re_claimed[1].id == st.id
            mgr.run_claimed(*re_claimed)
            hold.set()
            ta.join(timeout=60)
            assert not ta.is_alive()
            while (nxt := mgr.claim_subtask("worker-B", lease_ms=60_000, task_id=tid)) is not None:
                mgr.run_claimed(*nxt)
        finally:
            failpoint.disable("import_subtask_before_ingest")
            hold.set()
        th.join(timeout=120)
        assert not th.is_alive(), "owner loop hung"
    finally:
        importer._SUBTASK_ROWS = saved
    out = (done["task"].state, db.query("SELECT COUNT(*) FROM noidx"), db.query("SELECT COUNT(DISTINCT a) FROM noidx"))
    assert out == ("succeed", [(400,)], [(400,)])
    return out


def _import_rerun_idempotent_pk_and_partitioned(P, d):
    db = P.open()
    slice_ = P.importer.import_rows_slice
    db.execute("CREATE TABLE pkh (id BIGINT PRIMARY KEY, v BIGINT)")
    rows = [[str(i), str(i * 2)] for i in range(100)]
    slice_(db, "test", "pkh", rows, on_existing="verify")
    slice_(db, "test", "pkh", rows, on_existing="verify")
    with pytest.raises(Exception, match="duplicate key"):
        slice_(db, "test", "pkh", [["5", "999"]], on_existing="verify")
    db.execute("CREATE TABLE ph (k BIGINT, v BIGINT) PARTITION BY HASH(k) PARTITIONS 3")
    prow = [[str(i % 7), str(i)] for i in range(90)]
    base = db.catalog.alloc_autoid(db.catalog.table("test", "ph").id, 90)
    slice_(db, "test", "ph", prow, handle_base=base, on_existing="skip")
    slice_(db, "test", "ph", prow, handle_base=base, on_existing="skip")
    out = [db.query(q) for q in ("SELECT COUNT(*) FROM pkh", "SELECT v FROM pkh WHERE id = 5",
                                 "SELECT COUNT(*) FROM ph", "SELECT SUM(v) FROM ph")]
    assert out == [[(100,)], [(10,)], [(90,)], [(sum(range(90)),)]]
    return out


def _import_verify_on_indexed_table_txn_path(P, d):
    db = P.open()
    slice_ = P.importer.import_rows_slice
    db.execute("CREATE TABLE ivt (id BIGINT PRIMARY KEY, v BIGINT, KEY kv (v))")
    rows = [[str(i), str(i * 3)] for i in range(50)]
    slice_(db, "test", "ivt", rows, on_existing="verify")
    slice_(db, "test", "ivt", rows, on_existing="verify")
    with pytest.raises(Exception, match="duplicate key"):
        slice_(db, "test", "ivt", [["7", "1234"]], on_existing="verify")
    out = [db.query("SELECT COUNT(*) FROM ivt"), db.query("SELECT v FROM ivt WHERE id = 7")]
    assert out == [[(50,)], [(21,)]]
    return out


def _import_into_csv(P, d):
    import decimal

    db = P.open()
    db.execute("CREATE TABLE emp (id BIGINT PRIMARY KEY, name VARCHAR(40), sal DECIMAL(10,2), hired DATE, dept BIGINT)")
    db.execute("CREATE INDEX idx_dept ON emp (dept)")
    db.execute("INSERT INTO emp VALUES (1, 'ann', 100.50, '2020-01-01', 10), "
               "(2, 'bob', 200.25, '2021-06-15', 20), (3, NULL, NULL, NULL, 10)")
    p = d / "in.csv"
    p.write_text("id,name,sal,hired,dept\n10,carl,5.25,2023-03-04,30\n11,\\N,\\N,\\N,30\n"
                 '12,"x,y",1.00,2023-01-01,40\n')
    n = db.execute(f"IMPORT INTO emp FROM '{p}'").affected
    s = db.session()
    q = d / "nohdr.csv"
    q.write_text("20;dora;9.99;2022-02-02;50\n")
    db.execute(f"IMPORT INTO emp FROM '{q}' WITH skip_header=0, delimiter=';'")
    out = [n, s.query("SELECT name, dept FROM emp WHERE id = 12"), s.query("SELECT sal FROM emp WHERE id = 10"),
           s.query("SELECT name FROM emp WHERE id = 20"), s.query("SELECT * FROM emp ORDER BY id"),
           s.query("SELECT id FROM emp WHERE dept = 30 ORDER BY id")]
    assert out[:4] == [3, [("x,y", 40)], [(decimal.Decimal("5.25"),)], [("dora",)]]
    return out


CASES = {
    "load_data_basic_and_column_list": _load_data_basic_and_column_list,
    "load_data_errors": _load_data_errors,
    "multi_step_task": _multi_step_task,
    "failure_fails_task_and_cancels_rest": _failure_fails_task_and_cancels_rest,
    "cancel_task": _cancel_task,
    "resume_pending": _resume_pending,
    "import_into_via_disttask": _import_into_via_disttask,
    "import_into_sql_dist_task_var": _import_into_sql_dist_task_var,
    "import_subtask_rerun_is_idempotent": _import_subtask_rerun_is_idempotent,
    "import_rerun_idempotent_pk_and_partitioned": _import_rerun_idempotent_pk_and_partitioned,
    "import_verify_on_indexed_table_txn_path": _import_verify_on_indexed_table_txn_path,
    "import_into_csv": _import_into_csv,
}


@pytest.mark.parametrize("case", list(CASES))
def test_import_case_answers_as_the_reference(case, tmp_path):
    _both(CASES[case], tmp_path)


# -- a lineitem CSV read on the device engine ----------------------------------

LI = "li"
SCHEMA = chip_smoke.SQL_SCHEMA.replace("lineitem", LI, 1)
QUERIES = chip_smoke.table_queries(LI)


def test_load_data_lineitem_on_the_device_engine(tmp_path):
    """A 3,000-row lineitem CSV through LOAD DATA and, under
    ``tidb_enable_dist_task``, IMPORT INTO (1,000-row subtasks): the seven
    statements on the port's gpu engine equal the reference's tpu and host
    engines and the oracle."""
    cols = chip_smoke.lineitem_sf1(seed=21, n=3000)
    path = tmp_path / "li.csv"
    path.write_text(chip_smoke.lineitem_csv(cols))
    want = {name: chip_smoke.sql_oracle(name, cols) for name in QUERIES}
    for pkg, P in PKGS.items():
        db = P.open()
        s = db.session()
        s.execute(SCHEMA)
        s.execute(SCHEMA.replace(f"TABLE {LI}", "TABLE li2", 1))
        assert s.execute(f"LOAD DATA INFILE '{path}' INTO TABLE {LI} FIELDS TERMINATED BY ','").affected == 3000
        s.execute("SET tidb_enable_dist_task = 1")
        P.importer._SUBTASK_ROWS, saved = 1000, P.importer._SUBTASK_ROWS
        try:
            assert s.execute(f"IMPORT INTO li2 FROM '{path}'").affected == 3000
        finally:
            P.importer._SUBTASK_ROWS = saved
        assert len(s.query("SELECT id FROM mysql.tidb_background_subtask")) == 3
        for engine in (P.eng, "host"):
            s.execute(f"SET tidb_isolation_read_engines='{engine}'")
            for table in (LI, "li2"):
                for name, sql in chip_smoke.table_queries(table).items():
                    rows = chip_smoke.sql_rows(name, s.query(sql))
                    assert set(s.exec_summary.engines) == {engine} and not s.exec_summary.degraded
                    assert rows == want[name], (pkg, engine, table, name)
        db.stop_background()


# -- a dist-task import beside an MPP gather ---------------------------------


def test_dist_import_beside_an_mpp_gather(tmp_path, monkeypatch):
    """One session runs a dist-task IMPORT INTO (six subtasks on the
    framework's worker threads) while another runs bench.py's Q3 as one
    MPP gather over other tables, over and over, under the lock-order
    checker tests/conftest.py installs: both finish, the gather's rows
    equal the oracle in every run, the import's table equals the
    reference's."""
    assert lockcheck.installed()
    n = 3000
    cols = chip_smoke.lineitem_sf1(seed=22, n=n)
    tables = chip_smoke.mpp_tables(cols, chip_smoke.lineitem_partkey(22, n), 22, n_part=2000, n_cust=1500)
    want_q3 = chip_smoke.mpp_oracle("q3", tables)
    path = tmp_path / "imp.csv"
    path.write_text("".join(f"{i},{i * 7 % 1000},w{i % 13}\n" for i in range(3000)))
    out = {}
    for pkg, P in PKGS.items():
        monkeypatch.setattr(P.mesh, "FORCE_NDEV", 2)
        monkeypatch.setattr(P.importer, "_SUBTASK_ROWS", 500)
        db = P.open(region_split_keys=1 << 62)
        chip_smoke.mpp_sql(db, P.bulk_load, tables)
        db.execute("CREATE TABLE imp (a BIGINT PRIMARY KEY, b BIGINT, c VARCHAR(8))")
        done, errors, gathers = threading.Event(), [], []

        def importer_thread():
            try:
                s = db.session()
                s.execute("SET tidb_enable_dist_task = 1")
                out[pkg, "affected"] = s.execute(f"IMPORT INTO imp FROM '{path}'").affected
            except Exception as e:  # surfaces below
                errors.append(e)
            finally:
                done.set()

        def gather_thread():
            try:
                s = db.session()
                while not done.is_set() or len(gathers) < 3:
                    rows = s.query(chip_smoke.MPP_QUERIES["q3"])
                    assert s.mpp_details and s.mpp_details[-1].n_fragments == 3
                    assert chip_smoke.mpp_rows_match("q3", rows, want_q3, 10)
                    gathers.append(rows)
            except Exception as e:  # surfaces below
                errors.append(e)

        threads = [threading.Thread(target=importer_thread), threading.Thread(target=gather_thread)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
        assert not any(th.is_alive() for th in threads), f"{pkg}: a thread hung"
        assert not errors, errors
        assert len(gathers) >= 3
        subtasks = db.query("SELECT COUNT(*) FROM mysql.tidb_background_subtask WHERE state = 'succeed'")
        out[pkg] = (out[pkg, "affected"], subtasks, db.query("SELECT COUNT(*), SUM(b) FROM imp"),
                    db.query("SELECT c, COUNT(*), SUM(a) FROM imp GROUP BY c ORDER BY c"), gathers[0])
        db.stop_background()
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (3000, [(6,)])


# -- appends into a table the device engine already holds --------------------

APPEND_QUERIES = dict(
    {name: QUERIES[name] for name in chip_smoke.APPEND_QUERIES},
    flagx=f"SELECT l_linestatus, COUNT(*), SUM(l_quantity) FROM {LI} WHERE l_returnflag = 'X' GROUP BY l_linestatus",
)


def _flagx(c):
    m = c[4] == len(chip_smoke.RETURNFLAGS)
    out = []
    for si, st in enumerate(chip_smoke.LINESTATUS):
        mm = m & (c[5] == si)
        if mm.any():
            out.append((st.decode(), int(mm.sum()), chip_smoke._dec(int(c[0][mm].sum()), 2)))
    return out


def _want(c):
    out = {name: chip_smoke.sql_oracle(name, c) for name in chip_smoke.APPEND_QUERIES}
    out["flagx"] = _flagx(c)
    return out


def _rows(name, rows):
    return sorted(rows, key=repr) if name == "flagx" else chip_smoke.sql_rows(name, rows)


def _shrink(monkeypatch, cap):
    """The delta capacity, and delta reads from one base row, equally in
    both packages (the default region size stays: the table splits as a
    user's would at its scale, region_split_keys = 1,000)."""
    for P in PKGS.values():
        monkeypatch.setattr(P.config, "_CURRENT", dataclasses.replace(
            P.config.current(), device_delta_cap=cap, device_delta_min_rows=1))


def _spy_tasks(monkeypatch):
    seen = []
    real = gpu_engine.execute_region

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        st = {} if stats is None else stats
        seen.append(st)
        return real(region, dag, ranges, warn, device, st)

    monkeypatch.setattr(gpu_engine, "execute_region", spy)
    return seen


def _append_drive(monkeypatch, tmp_path, n_more, new_flag_every):
    """LOAD DATA of 1,800 rows (two regions of 900 at region_split_keys =
    1,000), every statement read once on the device engine, then LOAD DATA
    of ``n_more`` rows into the tail region; → (rows per package and
    engine after the append, the port's gpu task stats, the columns)."""
    _shrink(monkeypatch, cap=64)
    seen = _spy_tasks(monkeypatch)
    cols = chip_smoke.lineitem_sf1(seed=23, n=1800)
    more = chip_smoke.append_rows(24, n_more, new_flag_every)
    (tmp_path / "a.csv").write_text(chip_smoke.lineitem_csv(cols))
    (tmp_path / "b.csv").write_text(chip_smoke.lineitem_csv(more))
    got, stats = {}, {}
    for pkg, P in PKGS.items():
        db = P.open(region_split_keys=1000)
        s = db.session()
        s.execute(SCHEMA)
        s.execute(f"LOAD DATA INFILE '{tmp_path / 'a.csv'}' INTO TABLE {LI} FIELDS TERMINATED BY ','")
        s.execute(f"SET tidb_isolation_read_engines='{P.eng}'")
        for sql in APPEND_QUERIES.values():
            s.query(sql)
        assert len(db.store.regions()) == 2
        s.execute(f"LOAD DATA INFILE '{tmp_path / 'b.csv'}' INTO TABLE {LI} FIELDS TERMINATED BY ','")
        assert len(db.store.regions()) == 2  # the append fits the tail region
        h = db.session()
        h.execute("SET tidb_isolation_read_engines='host'")
        for name, sql in APPEND_QUERIES.items():
            seen.clear()
            got[pkg, P.eng, name] = _rows(name, s.query(sql))
            assert set(s.exec_summary.engines) == {P.eng} and not s.exec_summary.degraded
            if pkg == "port":
                stats[name] = [(st["path"], st.get("delta_rows", 0)) for st in seen]
            got[pkg, "host", name] = _rows(name, h.query(sql))
        db.stop_background()
    return got, stats, chip_smoke.concat_rows(cols, more)


def _check_append(got, union):
    want = _want(union)
    for (pkg, engine, name), rows in got.items():
        assert rows == want[name], (pkg, engine, name)


def test_small_append_is_read_as_the_delta_operand(monkeypatch, tmp_path):
    """40 appended rows, every third with a return flag the table never
    held: the touched task folds them as its delta (40 rows), the other
    task reads its base alone, and Q1, band, Q6 and a filter on the new
    string equal the reference's tpu and host engines and the oracle over
    the union: the new group shows, no stale dictionary code is served."""
    got, stats, union = _append_drive(monkeypatch, tmp_path, 40, new_flag_every=3)
    _check_append(got, union)
    assert got["port", "gpu", "flagx"] and any(k[0] == "X" for k in got["port", "gpu", "q1"])
    for name, tasks in stats.items():
        assert sorted(d for _p, d in tasks) == [0, 40], (name, tasks)


def test_big_append_rebuilds_the_blocks(monkeypatch, tmp_path):
    """100 appended rows, past the delta capacity (64): the touched region's
    blocks are rebuilt (no task carries a delta) and the statements equal
    the reference's and the oracle."""
    got, stats, union = _append_drive(monkeypatch, tmp_path, 100, new_flag_every=7)
    _check_append(got, union)
    for name, tasks in stats.items():
        assert [d for _p, d in tasks] == [0, 0], (name, tasks)


# -- disttask across processes (tests/test_disttask_remote.py on the port) -----

_STORE_NODE = r"""
import sys, time
sys.path.insert(0, {repo!r})
import tidb_tpu_torch
from tidb_tpu_torch.kv.remote import StoreServer
from tidb_tpu_torch.disttask import DistTaskManager
from tidb_tpu_torch.tools.importer import register_import_task_type

db = tidb_tpu_torch.open(device="cpu")
db.execute("CREATE TABLE imp (a BIGINT, b VARCHAR(16))")
srv = StoreServer(db.store)
port = srv.start()
if {with_node!r} == "yes":
    register_import_task_type()
    mgr = DistTaskManager(db, node_prefix="store")
    mgr.start_executor_node("store-node")
print(f"PORT {{port}}", flush=True)
while True:
    time.sleep(1)
"""

_SLEEPY_WORKER = r"""
import sys, time
sys.path.insert(0, {repo!r})
import tidb_tpu_torch
from tidb_tpu_torch.disttask import DistTaskManager
from tidb_tpu_torch.tools.importer import register_import_task_type
from tidb_tpu_torch.utils import failpoint

db = tidb_tpu_torch.open(remote={addr!r}, device="cpu")
register_import_task_type()
failpoint.enable("import_subtask_before_ingest", lambda st: (print(f"CLAIMED {{st.id}}", flush=True), time.sleep(3600)))
mgr = DistTaskManager(db, node_prefix="sleepy")
mgr.start_executor_node("sleepy-node", poll_s=0.05)
print("WORKER READY", flush=True)
while True:
    time.sleep(1)
"""


def _spawn(script, **fmt):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return subprocess.Popen([sys.executable, "-c", script.format(repo=REPO, **fmt)], stdout=subprocess.PIPE,
                            stderr=subprocess.DEVNULL, text=True, env=env)


def _read_until(proc, prefix, timeout=120):
    got = []

    def reader():
        for line in proc.stdout:
            if line.startswith(prefix):
                got.append(line.strip())
                return

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    t.join(timeout)
    if not got:
        proc.kill()
        raise RuntimeError(f"subprocess never printed {prefix!r}")
    return got[0]


@pytest.fixture()
def csv_path(tmp_path):
    p = tmp_path / "imp.csv"
    p.write_text("".join(f"{i},row{i}\n" for i in range(1000)))
    return str(p)


def test_import_subtasks_run_in_the_port_store_process(csv_path, monkeypatch):
    """The SQL layer owns the task and runs no worker; the port's store
    process executes every subtask, and the rows read back on its gpu
    engine."""
    proc = _spawn(_STORE_NODE, with_node="yes")
    try:
        port = int(_read_until(proc, "PORT ").split()[1])
        db = tidb_tpu_torch.open(remote=f"127.0.0.1:{port}", device="cpu")
        monkeypatch.setattr(port_importer, "_SUBTASK_ROWS", 300)
        db._disttask_mgr = port_disttask.DistTaskManager(db, n_workers=0)
        assert port_importer.import_into_disttask(db, "test", "imp", csv_path) == 1000
        s = db.session()
        assert s.query("SELECT COUNT(*), SUM(a) FROM imp") == [(1000, sum(range(1000)))]
        assert set(s.exec_summary.engines) == {"gpu"} and not s.exec_summary.degraded
        execs = s.query("SELECT DISTINCT exec_id FROM mysql.tidb_background_subtask WHERE state = 'succeed'")
        assert execs == [("store-node",)], execs
        assert len(s.query("SELECT id FROM mysql.tidb_background_subtask")) == 4
        db.stop_background()
    finally:
        proc.kill()
        proc.wait()


def test_killed_worker_lease_requeues_on_the_port(csv_path, monkeypatch):
    """A port worker process SIGKILLed mid-subtask leaves an expired lease;
    the owner re-queues the claim and its local workers finish the
    import."""
    store = _spawn(_STORE_NODE, with_node="no")
    worker = None
    try:
        addr = f"127.0.0.1:{int(_read_until(store, 'PORT ').split()[1])}"
        db = tidb_tpu_torch.open(remote=addr, device="cpu")
        db.session().execute("CREATE TABLE imp2 (a BIGINT, b VARCHAR(16))")
        worker = _spawn(_SLEEPY_WORKER, addr=addr)
        _read_until(worker, "WORKER READY")
        monkeypatch.setattr(port_importer, "_SUBTASK_ROWS", 300)
        port_failpoint.enable("disttask_local_worker_start", lambda _eid: time.sleep(2.0))
        result: dict = {}

        def run_import():
            try:
                db._disttask_mgr = port_disttask.DistTaskManager(db, n_workers=2, lease_ms=3000)
                result["rows"] = port_importer.import_into_disttask(db, "test", "imp2", csv_path)
            except Exception as e:  # surfaces below
                result["error"] = e

        try:
            t = threading.Thread(target=run_import)
            t.start()
            _read_until(worker, "CLAIMED", timeout=60)
            worker.send_signal(signal.SIGKILL)
            worker.wait()
            t.join(timeout=120)
        finally:
            port_failpoint.disable("disttask_local_worker_start")
        assert not t.is_alive(), "import hung after worker death"
        assert "error" not in result, result.get("error")
        assert result["rows"] == 1000
        s = db.session()
        assert s.query("SELECT COUNT(*), SUM(a) FROM imp2") == [(1000, sum(range(1000)))]
        assert set(s.exec_summary.engines) == {"gpu"}
        execs = {e for (e,) in s.query("SELECT exec_id FROM mysql.tidb_background_subtask WHERE state = 'succeed'")}
        assert "sleepy-node" not in execs and execs
        db.stop_background()
    finally:
        if worker is not None and worker.poll() is None:
            worker.kill()
        store.kill()
        store.wait()


@pytest.mark.parametrize("statement", ["load_data", "import_into", "import_into_dist"])
def test_a_string_column_loaded_over_a_remote_store_pins_the_references_defect(tmp_path, statement):
    """ROADMAP Queue C 11, which both packages carry: ``bulk_load`` in a SQL
    layer over ``open(remote=...)`` ingests a string column without its
    dictionary, so LOAD DATA and IMPORT INTO there (the dist-task subtasks
    too, when the SQL layer's own workers run them) leave rows whose
    strings the device engine cannot read (IndexError), while the integer
    columns answer. Pinned as the reference's behaviour; subtasks run in
    the store process (above) do not hit it."""
    path = tmp_path / "s.csv"
    path.write_text("".join(f"{i},row{i % 7}\n" for i in range(300)))
    sql = {
        "load_data": f"LOAD DATA INFILE '{path}' INTO TABLE imp FIELDS TERMINATED BY ','",
        "import_into": f"IMPORT INTO imp FROM '{path}'",
        "import_into_dist": f"IMPORT INTO imp FROM '{path}'",
    }[statement]
    out = {}
    for pkg, P in PKGS.items():
        store = P.open()
        srv = P.remote.StoreServer(store.store)
        port = srv.start()
        try:
            db = P.open(remote=f"127.0.0.1:{port}")
            s = db.session()
            s.execute("CREATE TABLE imp (a BIGINT, b VARCHAR(16))")
            if statement == "import_into_dist":
                s.execute("SET tidb_enable_dist_task = 1")
            assert s.execute(sql).affected == 300
            ints = s.query("SELECT COUNT(*), SUM(a) FROM imp")
            assert set(s.exec_summary.engines) == {P.eng}
            with pytest.raises(IndexError):
                s.query("SELECT b, COUNT(*) FROM imp GROUP BY b")
            out[pkg] = ints
            db.stop_background()
        finally:
            srv.shutdown()
            store.stop_background()
    assert out["port"] == out["ref"] == [(300, sum(range(300)))]
