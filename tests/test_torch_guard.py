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


def test_open_remote_raises_until_the_remote_store_is_copied():
    import tidb_tpu_torch

    with pytest.raises(ModuleNotFoundError, match="tidb_tpu_torch.kv.remote"):
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
