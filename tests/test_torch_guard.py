"""The PyTorch port stands alone: importing it loads neither jax nor any
tidb_tpu module, and its entry points never drop to the CPU unasked.

The import checks run in a subprocess because this test process has
already imported jax (conftest.py)."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import tidb_tpu_torch
import tidb_tpu_torch.copr.gpu_engine
import tidb_tpu_torch.copr.carry
import tidb_tpu_torch.ops.grouped_sums
import tidb_tpu_torch.ops.mxu_groupby
import tidb_tpu_torch.ops.dag_kernel
import tidb_tpu_torch.ops.window_core
import tidb_tpu_torch.parallel
import tidb_tpu_torch.parallel.gather
import tidb_tpu_torch.parallel.mesh
import tidb_tpu_torch.parallel.mpp
import tidb_tpu_torch.parallel.mpptask
import tidb_tpu_torch.parallel.probe
import tidb_tpu_torch.native
import tidb_tpu_torch.__main__
import tidb_tpu_torch.server
import tidb_tpu_torch.server.client
import tidb_tpu_torch.server.protocol
import tidb_tpu_torch.server.status
import tidb_tpu_torch.kv.remote
import tidb_tpu_torch.kv.sharded
import tidb_tpu_torch.kv.fault_injection
import tidb_tpu_torch.privilege
import tidb_tpu_torch.catalog.infoschema
import tidb_tpu_torch.planner.prepcache
import tidb_tpu_torch.utils.metricshist
import tidb_tpu_torch.utils.topsql
import tidb_tpu_torch.planner.partition
import tidb_tpu_torch.statistics.globalstats
import tidb_tpu_torch.tools
import tidb_tpu_torch.tools.dumpling
import tidb_tpu_torch.catalog.ddl
import tidb_tpu_torch.utils.timer
import tidb_tpu_torch.ttl
import tidb_tpu_torch.ttl.worker
import tidb_tpu_torch.tools.fuzz
import tidb_tpu_torch.tools.fuzz.gen
import tidb_tpu_torch.tools.fuzz.oracles
import tidb_tpu_torch.tools.fuzz.shrink
import tidb_tpu_torch.tools.fuzz.harness
import tidb_tpu_torch.tools.fuzz.runner
import tidb_tpu_torch.tools.fuzz.__main__
import tidb_tpu_torch.tools.storage
import tidb_tpu_torch.disttask
import tidb_tpu_torch.disttask.framework
import tidb_tpu_torch.tools.importer
import tidb_tpu_torch.tools.brie
import tidb_tpu_torch.tools.pitr
import tidb_tpu_torch.tools.replayer
import tidb_tpu_torch.utils.inspection
import tidb_tpu_torch.tools.diag
import tidb_tpu_torch.utils.lockcheck
import tidb_tpu_torch.tools.check
import tidb_tpu_torch.tools.check.__main__
import tidb_tpu_torch.tools.check.rules_compile
import tidb_tpu_torch.tools.check.rules_dead
import tidb_tpu_torch.tools.check.rules_hygiene
import tidb_tpu_torch.tools.check.rules_locks
import tidb_tpu_torch.tools.check.rules_pyopt
import tidb_tpu_torch.tools.check.rules_robust
import tidb_tpu_torch.tools.check.rules_wire
import tidb_tpu_torch.bench
import tidb_tpu_torch.bench.benchdb
import tidb_tpu_torch.bench.benchdaily
import tidb_tpu_torch.bench.qps
import chip_smoke
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "tidb_tpu" or m.startswith("tidb_tpu."))
print(json.dumps(bad))
"""


# the SQL front end to end: open, load, run Q1 on the port's gpu engine and
# bench.py's Q3 as one MPP gather
_SQL_PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
import tidb_tpu_torch
from tidb_tpu_torch.executor.load import bulk_load
from tidb_tpu_torch.kv.tablecodec import record_key
import chip_smoke
db = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
cols = chip_smoke.lineitem_sf1(1, n=3000)
chip_smoke.lineitem_sql(db, bulk_load, record_key, cols, parts=2)
s = db.session()
rows = s.query(chip_smoke.SQL_QUERIES["q1"])
assert chip_smoke.sql_rows("q1", rows) == chip_smoke.sql_oracle("q1", cols)
assert s.exec_summary.engines == {{"gpu": 2}}, s.exec_summary.engines
n = 3000
tables = chip_smoke.mpp_tables(cols, chip_smoke.lineitem_partkey(1, n), 1, n_part=2000, n_cust=1500)
mdb = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
chip_smoke.mpp_sql(mdb, bulk_load, tables)
ms = mdb.session()
rows = ms.query(chip_smoke.MPP_QUERIES["q3"])
assert ms.mpp_details and ms.mpp_details[-1].n_fragments == 3
assert chip_smoke.mpp_rows_match("q3", rows, chip_smoke.mpp_oracle("q3", tables), 10)
mdb.stop_background()
db.stop_background()
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "tidb_tpu" or m.startswith("tidb_tpu."))
print(json.dumps(bad))
"""


def _clean_env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=_clean_env(),
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sql_front_imports_no_jax_and_no_reference():
    out = subprocess.run(
        [sys.executable, "-c", _SQL_PROBE.format(repo=REPO)],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=_clean_env(),
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_default_open_raises_on_its_first_query_without_a_card(monkeypatch):
    """``tidb_tpu_torch.open()`` asks for the card; with none its first
    device task raises, and no task runs on the host engine instead."""
    import torch

    import tidb_tpu_torch
    from tidb_tpu_torch.copr import host_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host_calls = []
    real = host_engine.execute_dag
    monkeypatch.setattr(host_engine, "execute_dag", lambda *a, **k: host_calls.append(a) or real(*a, **k))
    db = tidb_tpu_torch.open()
    db.execute("CREATE TABLE t (a BIGINT, b DECIMAL(10,2))")
    db.execute("INSERT INTO t VALUES (1, 2.50), (2, 3.50)")
    for sql in ("SELECT a, SUM(b) FROM t GROUP BY a", "SELECT COUNT(*) FROM t WHERE b < 3"):
        with pytest.raises(RuntimeError, match="cuda"):
            db.query(sql)
    assert host_calls == []
    db.execute("SET tidb_isolation_read_engines='host'")
    assert db.query("SELECT COUNT(*) FROM t WHERE b < 3") == [(1,)]
    db.stop_background()


def test_default_open_loads_and_restores_then_raises_on_its_first_read_without_a_card(monkeypatch, tmp_path):
    """LOAD DATA, IMPORT INTO, BACKUP and RESTORE on a default ``open()``
    touch no device; the first read of the loaded or the restored table
    raises at its first device task, and none runs on the host engine."""
    import torch

    import tidb_tpu_torch
    from tidb_tpu_torch.copr import host_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    host_calls = []
    real = host_engine.execute_dag
    monkeypatch.setattr(host_engine, "execute_dag", lambda *a, **k: host_calls.append(a) or real(*a, **k))
    path = tmp_path / "t.csv"
    path.write_text("".join(f"{i},{i}.50\n" for i in range(100)))
    db = tidb_tpu_torch.open()
    db.execute("CREATE TABLE t (a BIGINT, b DECIMAL(10,2))")
    assert db.execute(f"LOAD DATA INFILE '{path}' INTO TABLE t FIELDS TERMINATED BY ','").affected == 100
    assert db.execute(f"IMPORT INTO t FROM '{path}'").affected == 100
    db.execute(f"BACKUP DATABASE test TO 'file://{tmp_path}/bk'")
    assert db.execute(f"RESTORE DATABASE r FROM 'file://{tmp_path}/bk'").rows == [("t", 200)]
    for sql in ("SELECT COUNT(*), SUM(b) FROM t", "SELECT COUNT(*), SUM(b) FROM r.t"):
        with pytest.raises(RuntimeError, match="cuda"):
            db.query(sql)
    assert host_calls == []
    db.stop_background()


def test_default_open_raises_on_its_first_mpp_fragment_without_a_card(monkeypatch):
    """A join that plans one MPP gather on ``tidb_tpu_torch.open()``: with
    no card the gather's first fragment raises; the statement is not
    re-planned onto the host join."""
    import torch

    import tidb_tpu_torch
    from tidb_tpu_torch.parallel import gather

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    attempts = []
    real = gather.MPPGatherExec._execute_attempt
    monkeypatch.setattr(gather.MPPGatherExec, "_execute_attempt", lambda self, mesh: attempts.append(mesh) or real(self, mesh))
    db = tidb_tpu_torch.open()
    db.execute("CREATE TABLE f (k BIGINT, v BIGINT)")
    db.execute("CREATE TABLE d (k BIGINT PRIMARY KEY, g BIGINT)")
    db.execute("INSERT INTO f VALUES (1, 2), (2, 3)")
    db.execute("INSERT INTO d VALUES (1, 7), (2, 8)")
    sql = "SELECT g, SUM(v) FROM f JOIN d ON f.k = d.k GROUP BY g"
    assert "PhysMPPGather" in "\n".join(r[0] for r in db.query("EXPLAIN " + sql))
    with pytest.raises(RuntimeError, match="cuda"):
        db.query(sql)
    assert attempts == []
    db.stop_background()


def test_benchdaily_raises_at_the_device_without_a_card(monkeypatch, tmp_path):
    """``benchdaily`` with no ``--device`` asks for the card: with none, a
    lane raises at its first device task (``device.resolve``), and no cop
    task runs on the host engine instead."""
    import torch

    from tidb_tpu_torch.bench import benchdaily
    from tidb_tpu_torch.copr import client, host_engine
    from tidb_tpu_torch.kv.kv import StoreType
    from tidb_tpu_torch.tools.fuzz import runner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    # main() sets both from --device: restored after the test
    monkeypatch.setattr(benchdaily, "DEVICE", benchdaily.DEVICE)
    monkeypatch.setattr(runner, "DEVICE", runner.DEVICE)
    host_calls = []
    real = host_engine.execute_dag
    monkeypatch.setitem(client._engines(), StoreType.HOST, lambda *a, **k: host_calls.append(a) or real(*a, **k))
    out = tmp_path / "daily.json"
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        benchdaily.main(["--only", "fixed_overhead_ms", "--out", str(out)])
    assert benchdaily.DEVICE == "cuda" and runner.DEVICE == "cuda"
    assert host_calls == [] and not out.exists()


def test_open_remote_raises_until_the_remote_store_is_copied():
    """``kv/remote.py`` is copied: ``open(remote=...)`` dials the store and,
    with nothing listening there, raises the store's connection error (no
    longer ``ModuleNotFoundError``)."""
    import tidb_tpu_torch

    with pytest.raises(ConnectionError, match="127.0.0.1:1 unreachable"):
        tidb_tpu_torch.open(remote="127.0.0.1:1")


def test_grouped_sums_default_device_raises_without_a_card(monkeypatch):
    import torch

    from tidb_tpu_torch.ops import grouped_sums as gs

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seg = torch.zeros(1024, dtype=torch.int32)
    pair = [(torch.zeros(1024, dtype=torch.int64), torch.ones(1024, dtype=torch.bool))]
    with pytest.raises(RuntimeError, match="cuda"):
        gs.grouped_sums(seg, pair, 65, 1024)


def _run_smoke(cwd):
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], capture_output=True, text=True, timeout=120, cwd=cwd, env=_clean_env()
    )


def test_chip_smoke_fails_without_a_card_or_without_the_port(tmp_path):
    import torch

    if not torch.cuda.is_available():
        out = _run_smoke(REPO)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
    # alone in a directory, without the package beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
