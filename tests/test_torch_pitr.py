"""Log backup and point-in-time restore on the port (``tools/pitr.py``: a
copy), held against the reference.

The six cases of tests/test_pitr.py and the ``memory://`` case of
tests/test_external_storage.py run the same DML script on
``tidb_tpu.open()`` and ``tidb_tpu_torch.open(device="cpu")``; each
outcome (rows, replay counts, the refusals) must be the reference's. Then
a lineitem restored at a target ts, its updates and deletes replayed
through transactions, is read first on the port's ``gpu`` engine (plain
kernels here) and equals the reference's tpu and host engines and the
oracle at that ts.
"""

import os
import sys
import types

import jax
import jax.experimental
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.executor import load as ref_load  # noqa: E402
from tidb_tpu.kv import gcworker as ref_gcworker  # noqa: E402
from tidb_tpu.kv import memstore as ref_memstore  # noqa: E402
from tidb_tpu.kv import tablecodec as ref_tablecodec  # noqa: E402
from tidb_tpu.tools import brie as ref_brie  # noqa: E402
from tidb_tpu.tools import pitr as ref_pitr  # noqa: E402
from tidb_tpu_torch.executor import load as port_load  # noqa: E402
from tidb_tpu_torch.kv import gcworker as port_gcworker  # noqa: E402
from tidb_tpu_torch.kv import memstore as port_memstore  # noqa: E402
from tidb_tpu_torch.kv import tablecodec as port_tablecodec  # noqa: E402
from tidb_tpu_torch.tools import brie as port_brie  # noqa: E402
from tidb_tpu_torch.tools import pitr as port_pitr  # noqa: E402

PKGS = {
    "ref": types.SimpleNamespace(
        open=lambda **kw: tidb_tpu.open(**kw), brie=ref_brie, pitr=ref_pitr, load=ref_load, gc=ref_gcworker,
        memstore=ref_memstore, tablecodec=ref_tablecodec, eng="tpu",
    ),
    "port": types.SimpleNamespace(
        open=lambda **kw: tidb_tpu_torch.open(device="cpu", **kw), brie=port_brie, pitr=port_pitr, load=port_load,
        gc=port_gcworker, memstore=port_memstore, tablecodec=port_tablecodec, eng="gpu",
    ),
}


@pytest.fixture(autouse=True)
def _reference_pallas(monkeypatch):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _replays_to_target_ts(P, d):
    src = P.open()
    src.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, s VARCHAR(8), KEY iv (v))")
    src.execute("INSERT INTO t VALUES (1, 10, 'a'), (2, 20, 'b'), (3, 30, 'c')")
    task = P.pitr.LogBackupTask(src, str(d / "log"))
    full = str(d / "full")
    P.brie.backup_database(src, "test", full)
    src.execute("UPDATE t SET v = 200 WHERE id = 2")
    src.execute("DELETE FROM t WHERE id = 1")
    src.execute("INSERT INTO t VALUES (4, 40, 'd')")
    task.flush()
    mid_ts = src.store.current_ts()
    src.execute("INSERT INTO t VALUES (5, 50, 'e')")
    src.execute("UPDATE t SET v = 999 WHERE id = 3")
    task.flush()
    dst = P.open()
    out = P.pitr.restore_point(dst, full, str(d / "log"), target_ts=mid_ts)
    s = dst.session()
    res = [out, s.query("SELECT id, v, s FROM t ORDER BY id"), s.query("SELECT id FROM t WHERE v = 200"),
           s.query("SELECT id FROM t WHERE v = 10")]
    s.execute("INSERT INTO t VALUES (9, 90, 'z')")
    res.append(s.query("SELECT COUNT(*) FROM t"))
    dst2 = P.open()
    P.pitr.restore_point(dst2, full, str(d / "log"))
    res.append(dst2.session().query("SELECT id, v FROM t ORDER BY id"))
    assert out["replayed"] >= 3
    assert res[1:] == [[(2, 200, "b"), (3, 30, "c"), (4, 40, "d")], [(2,)], [], [(4,)],
                       [(2, 200), (3, 999), (4, 40), (5, 50)]]
    return res


def _checkpoint_resumes(P, d):
    src = P.open()
    src.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    log = str(d / "log")
    task = P.pitr.LogBackupTask(src, log)
    full = str(d / "full")
    P.brie.backup_database(src, "test", full)
    src.execute("INSERT INTO t VALUES (1, 1)")
    n1 = task.flush()
    task2 = P.pitr.LogBackupTask(src, log)
    same = task2.checkpoint_ts == task.checkpoint_ts
    n2 = task2.flush()
    src.execute("INSERT INTO t VALUES (2, 2)")
    n3 = task2.flush()
    dst = P.open()
    P.pitr.restore_point(dst, full, log)
    res = [n1, same, n2, n3, dst.session().query("SELECT * FROM t ORDER BY id")]
    assert n1 >= 1 and same and n2 == 0 and n3 >= 1 and res[4] == [(1, 1), (2, 2)]
    return res


def _columnar_ingest_changes(P, d):
    src = P.open()
    src.execute("CREATE TABLE noidx (a BIGINT, b VARCHAR(8))")
    task = P.pitr.LogBackupTask(src, str(d / "log"))
    full = str(d / "full")
    P.brie.backup_database(src, "test", full)
    P.load.bulk_load(src, "noidx", [[1, 2, 3], [b"x", b"y", b"z"]])
    task.flush()
    dst = P.open()
    out = P.pitr.restore_point(dst, full, str(d / "log"))
    res = [out, dst.session().query("SELECT COUNT(*), SUM(a) FROM noidx"),
           dst.session().query("SELECT a, b FROM noidx ORDER BY a")]
    assert out["replayed"] == 3 and res[1] == [(3, 6)]
    return res


def _gc_respects_log_checkpoint(P, d):
    src = P.open()
    src.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    task = P.pitr.LogBackupTask(src, str(d / "log"))
    full = str(d / "full")
    P.brie.backup_database(src, "test", full)
    src.execute("INSERT INTO t VALUES (1, 1)")
    src.execute("DELETE FROM t WHERE id = 1")
    P.gc.GCWorker(src.store, life_ms=0).run_once()
    n = task.flush()
    dst = P.open()
    P.pitr.restore_point(dst, full, str(d / "log"))
    res = [n, dst.session().query("SELECT COUNT(*) FROM t")]
    task.stop()
    P.gc.GCWorker(src.store, life_ms=0).run_once()
    assert n >= 2 and res[1] == [(0,)]
    return res


def _rejects_uncovered_gap(P, d):
    src = P.open()
    src.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    full = str(d / "full")
    P.brie.backup_database(src, "test", full)
    src.execute("INSERT INTO t VALUES (1, 1)")
    task = P.pitr.LogBackupTask(src, str(d / "log"))
    task.flush()
    with pytest.raises(ValueError, match="gap") as e:
        P.pitr.restore_point(P.open(), full, str(d / "log"))
    return type(e.value).__name__, "AFTER the full backup" in str(e.value)


def _flush_blocked_by_inflight_prewrite(P, d):
    src = P.open()
    src.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT)")
    t = src.catalog.table("test", "t")
    task = P.pitr.LogBackupTask(src, str(d / "log"))
    key = P.tablecodec.record_key(t.id, 77)
    start_ts = src.store.tso.ts()
    src.store.prewrite([P.memstore.Mutation(P.memstore.OP_PUT, key, b"xx")], key, start_ts)
    n0 = task.flush()
    held = task.checkpoint_ts < start_ts
    commit_ts = src.store.tso.ts()
    src.store.commit([key], start_ts, commit_ts)
    n1 = task.flush()
    res = [n0, held, n1, task.checkpoint_ts >= commit_ts]
    assert held and n1 >= 1 and res[3]
    return res


def _restore_point_through_memory_url(P, d):
    db = P.open()
    s = db.session()
    s.execute("CREATE TABLE bs (id BIGINT PRIMARY KEY, name VARCHAR(8), v BIGINT, KEY kv (v))")
    s.execute("INSERT INTO bs VALUES " + ", ".join(f"({i}, 'n{i % 5}', {i * 3})" for i in range(200)))
    log_dir = str(d / "logs")
    task = P.pitr.LogBackupTask(db, log_dir)
    url = "memory://pitrtest/" + d.name
    P.brie.backup_database(db, "test", url)
    db.execute("INSERT INTO bs VALUES (500, 'late', 1500)")
    task.flush()
    db2 = P.open()
    out = P.pitr.restore_point(db2, url, log_dir)
    res = [out, db2.query("SELECT COUNT(*) FROM bs"), db2.query("SELECT id FROM bs WHERE v = 1500")]
    assert out["tables"] == {"bs": 200} and res[1] == [(201,)]
    return res


CASES = {
    "restore_point_replays_to_target_ts": _replays_to_target_ts,
    "log_backup_checkpoint_resumes": _checkpoint_resumes,
    "restore_point_columnar_ingest_changes": _columnar_ingest_changes,
    "gc_respects_log_checkpoint": _gc_respects_log_checkpoint,
    "restore_point_rejects_uncovered_gap": _rejects_uncovered_gap,
    "flush_blocked_by_inflight_prewrite": _flush_blocked_by_inflight_prewrite,
    "restore_point_through_memory_url": _restore_point_through_memory_url,
}


@pytest.mark.parametrize("case", list(CASES))
def test_pitr_case_answers_as_the_reference(case, tmp_path):
    out = {}
    for pkg, P in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        out[pkg] = CASES[case](P, d)
    assert out["port"] == out["ref"]


def test_point_restore_read_on_the_device_engine(tmp_path):
    """lineitem (3,000 rows by LOAD DATA), a log task, a full backup, then
    an UPDATE of the first orders' lines, a DELETE of a run of orders and an
    INSERT of 30 lines; the target ts; then a DELETE past it. restore_point
    at the target into database p: the seven statements' first reads on
    the port's gpu engine equal the reference's tpu and host engines and
    the oracle at the target ts (the write past it absent)."""
    n = 3000
    cols = chip_smoke.lineitem_sf1(seed=41, n=n)
    okey = cols[9]
    k_upd, (k_lo, k_hi), k_late = okey[99], (okey[2000], okey[2100]), okey[10]
    *_, insert, _after, _d1, _d2 = chip_smoke.htap_writes(cols, 41, n_update=100, n_delete=50, n_insert=30, table="li")
    new = chip_smoke.lineitem_sf1(42, 30)
    new[9] = new[9] + (int(okey.max()) // 32 + 1) * 32
    c = {k: v.copy() for k, v in cols.items()}
    upd = okey <= k_upd
    c[0][upd] += 100
    c[1][upd] += 10_000
    keep = ~((okey >= k_lo) & (okey <= k_hi))
    want_cols = {k: np.concatenate([v[keep], new[k].astype(v.dtype)]) for k, v in c.items()}
    want = {name: chip_smoke.sql_oracle(name, want_cols) for name in chip_smoke.SQL_QUERIES}
    p = tmp_path / "li.csv"
    p.write_text(chip_smoke.lineitem_csv(cols))
    got = {}
    for pkg, P in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        src = P.open(region_split_keys=1000)
        s = src.session()
        s.execute(chip_smoke.SQL_SCHEMA.replace("lineitem", "li", 1))
        s.execute(f"LOAD DATA INFILE '{p}' INTO TABLE li FIELDS TERMINATED BY ','")
        task = P.pitr.LogBackupTask(src, str(d / "log"))
        P.brie.backup_database(src, "test", f"file://{d}/full")
        s.execute(f"UPDATE li SET l_quantity = l_quantity + 1.00, l_extendedprice = l_extendedprice + 100.00 "
                  f"WHERE l_orderkey <= {k_upd}")
        s.execute(f"DELETE FROM li WHERE l_orderkey BETWEEN {k_lo} AND {k_hi}")
        s.execute(insert)
        task.flush()
        target = src.store.current_ts()
        s.execute(f"DELETE FROM li WHERE l_orderkey <= {k_late}")
        task.flush()
        dst = P.open(region_split_keys=1000)
        out = P.pitr.restore_point(dst, f"file://{d}/full", str(d / "log"), target_ts=target, db_name="p")
        assert out["tables"] == {"li": n}
        s2 = dst.session()
        for engine in (P.eng, "host"):
            s2.execute(f"SET tidb_isolation_read_engines='{engine}'")
            for name, sql in chip_smoke.table_queries("p.li").items():
                rows = chip_smoke.sql_rows(name, s2.query(sql))
                assert set(s2.exec_summary.engines) == {engine} and not s2.exec_summary.degraded
                assert rows == want[name], (pkg, engine, name)
                got[pkg, engine, name] = rows
        got[pkg] = out["replayed"]
        src.stop_background()
        dst.stop_background()
    assert got["port"] == got["ref"]
