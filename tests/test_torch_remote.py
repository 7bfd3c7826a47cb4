"""The port's process boundary held against the reference's: a SQL layer
over a storage server (``kv/remote.py``: ``StoreServer``, ``RemoteStore``,
``_RemoteCopClient``; ``tests/test_remote_store.py``'s cases).

Each package's store is a ``StoreServer`` on a thread of this process
holding the same data: the reference test's 600,000-row ``li`` and its
small ``kvt``/``kd``/``d`` tables, ``chip_smoke``'s lineitem (two regions)
and, in database ``mpp``, ``chip_smoke``'s MPP tables (ANALYZEd in the
store). ``tidb_tpu.open(remote=...)`` and ``tidb_tpu_torch.open(remote=...,
device="cpu")`` plan the statements and ship cop DAGs, KV verbs and MPP
gathers over TCP; the port's store runs every kernel's plain version on
the CPU. Rows must be equal between the packages (decimals exact) and to
``chip_smoke``'s numpy oracles. The case that kills the store runs it as
``python -m tidb_tpu_torch --store-server --device cpu``.

The reference ``tpu`` engine reaches its Pallas kernel on the band query,
which needs ``jax.experimental.enable_x64`` (gone from this jax): the
comparisons patch it in from ``jax.enable_x64``.
"""

import os
import signal
import subprocess
import sys
import threading
import time

import jax
import jax.experimental
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv.remote import StoreServer as RefStoreServer  # noqa: E402
from tidb_tpu.kv.tablecodec import record_key as ref_record_key  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine, host_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.kv import tablecodec  # noqa: E402
from tidb_tpu_torch.kv.remote import StoreServer  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key  # noqa: E402

SQL = chip_smoke.SQL_QUERIES
N_LINEITEM = 60_000
N_MPP, N_PART, N_CUST = 20_000, 2_000, 1_500
MPPQ = (
    "SELECT d.grp, COUNT(*), SUM(li.price) FROM li JOIN d ON li.qty = d.id"
    " GROUP BY d.grp ORDER BY d.grp"
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def x64_shim(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _load_store(db, bulk, rkey, data):
    """The reference test's server data, chip_smoke's lineitem (two
    regions) and, in database ``mpp``, its MPP tables ANALYZEd."""
    db.execute("CREATE TABLE li (flag VARCHAR(1), qty DECIMAL(10,2), price DECIMAL(12,2), sd DATE)")
    rng = np.random.default_rng(4)
    n = 600_000
    bulk(db, "li", [
        np.array([b"A", b"N", b"R"], dtype="S1")[rng.integers(0, 3, n)],
        rng.integers(100, 5100, n),
        rng.integers(1000, 900000, n),
        8036 + rng.integers(0, 2525, n),
    ])
    db.execute("CREATE TABLE kvt (id BIGINT PRIMARY KEY, v BIGINT)")
    db.execute("INSERT INTO kvt VALUES (1, 10), (2, 20)")
    db.execute("CREATE TABLE kd (id BIGINT PRIMARY KEY, grp BIGINT)")
    db.execute("INSERT INTO kd VALUES " + ", ".join("(%d, %d)" % (i, i % 5) for i in range(100, 400)))
    db.execute("CREATE TABLE d (id BIGINT PRIMARY KEY, grp BIGINT)")
    db.execute("INSERT INTO d VALUES " + ", ".join("(%d, %d)" % (i, i % 7) for i in range(100, 700)))
    chip_smoke.lineitem_sql(db, bulk, rkey, data["cols"], parts=2)
    chip_smoke.mpp_sql(db, bulk, data["mpp"], db_name="mpp")


def _sql_layer(db):
    """Load the persisted statistics of every table, so the first plan of
    a statement reads real statistics (a SQL layer loads them lazily)."""
    for dbname in ("mpp", "test"):
        for name in db.catalog.tables(dbname):
            db.stats.load_sync(db.catalog.table(dbname, name).id)
    return db


@pytest.fixture(scope="module")
def topo():
    """{"ref", "port": (SQL layer, store DB, server)} plus the data."""
    cols = chip_smoke.lineitem_sf1(seed=7, n=N_LINEITEM)
    mcols = chip_smoke.lineitem_sf1(seed=3, n=N_MPP)
    partkey = np.random.default_rng(9).integers(1, N_PART + 1, N_MPP)
    data = {
        "cols": cols,
        "mpp": chip_smoke.mpp_tables(mcols, partkey, 3, n_part=N_PART, n_cust=N_CUST),
    }
    rstore = tidb_tpu.open(region_split_keys=200_000)
    _load_store(rstore, ref_bulk_load, ref_record_key, data)
    rsrv = RefStoreServer(rstore.store)
    rport = rsrv.start()
    pstore = tidb_tpu_torch.open(region_split_keys=200_000, device="cpu")
    _load_store(pstore, bulk_load, record_key, data)
    psrv = StoreServer(pstore.store)
    pport = psrv.start()
    ref = _sql_layer(tidb_tpu.open(remote=f"127.0.0.1:{rport}"))
    port = _sql_layer(tidb_tpu_torch.open(remote=f"127.0.0.1:{pport}", device="cpu"))
    yield {"ref": (ref, rstore, rsrv), "port": (port, pstore, psrv), "data": data}
    rsrv.shutdown()
    psrv.shutdown()
    for db in (ref, port, rstore, pstore):
        db.stop_background()


def _both(topo, fn):
    """``fn(session)`` on a fresh session of each SQL layer → (ref, port)."""
    return fn(topo["ref"][0].session()), fn(topo["port"][0].session())


@pytest.mark.parametrize("name", list(SQL))
def test_sql_statements_over_remote_regions(x64_shim, topo, name):
    """chip_smoke's seven statements over the wire: the port's rows equal
    the reference's over its wire and the oracle; both of the port's cop
    tasks ran on the store's gpu engine, none degraded."""
    port = topo["port"][0]
    s = port.session()
    got = chip_smoke.sql_rows(name, s.query(SQL[name]))
    assert s.exec_summary.engines == {"gpu": 2} and s.exec_summary.degraded == {}
    assert len(s.exec_summary.procs) == 2 and min(s.exec_summary.procs) > 0
    assert got == chip_smoke.sql_rows(name, topo["ref"][0].query(SQL[name]))
    assert got == chip_smoke.sql_oracle(name, topo["data"]["cols"])
    plan = "\n".join(r[0] for r in port.query("EXPLAIN " + SQL[name]))
    assert "[gpu]" in plan and "[host]" not in plan


def test_q1_against_remote_regions(x64_shim, topo):
    q = (
        "SELECT flag, SUM(qty), AVG(price), COUNT(*) FROM li"
        " WHERE sd <= DATE '1998-09-02' GROUP BY flag ORDER BY flag"
    )
    ref_rows, rows = _both(topo, lambda s: s.query(q))
    assert rows == ref_rows
    assert [r[0] for r in rows] == ["A", "N", "R"]
    port = topo["port"][0]
    assert sum(r[3] for r in rows) == port.query("SELECT COUNT(*) FROM li WHERE sd <= DATE '1998-09-02'")[0][0] > 0
    t = port.catalog.table("test", "li")
    assert len(port.store.pd.regions_in_ranges([tablecodec.record_range(t.id)])) > 1


def test_band_takes_the_k1_route_in_the_store(monkeypatch, topo):
    """The band statement's two cop tasks take the K1 route in the store's
    engine (this process holds the store: the spy sees its kernels)."""
    routes = []
    real = gpu_engine.get_kernel

    def spy(*a, **k):
        kernel = real(*a, **k)
        routes.append(kernel.routes)
        return kernel

    monkeypatch.setattr(gpu_engine, "get_kernel", spy)
    s = topo["port"][0].session()
    rows = s.query(SQL["band"])
    assert routes == [("k1",)] * 2
    assert chip_smoke.sql_rows("band", rows) == chip_smoke.sql_oracle("band", topo["data"]["cols"])


def test_point_get_and_dml_through_the_wire(topo):
    def run(s):
        out = [s.query("SELECT v FROM kvt WHERE id = 1")]
        s.execute("INSERT INTO kvt VALUES (3, 30)")
        s.execute("UPDATE kvt SET v = 21 WHERE id = 2")
        out.append(s.query("SELECT id, v FROM kvt ORDER BY id"))
        s.execute("BEGIN")
        s.execute("INSERT INTO kvt VALUES (4, 40)")
        out.append(s.query("SELECT COUNT(*) FROM kvt"))
        s.execute("ROLLBACK")
        out.append(s.query("SELECT COUNT(*) FROM kvt"))
        s.execute("DELETE FROM kvt WHERE id = 3")
        s.execute("UPDATE kvt SET v = 20 WHERE id = 2")
        return out

    ref_out, out = _both(topo, run)
    assert out == ref_out == [[(10,)], [(1, 10), (2, 21), (3, 30)], [(4,)], [(3,)]]


@pytest.mark.parametrize("name", ["mppq", "q3", "q17"])
def test_mpp_dispatched_to_store_server(x64_shim, topo, name):
    """A remote SQL layer plans MPP and the store executes it: one
    ``PhysMPPGather`` with the reference's fragments and stages, whose
    details come home in the store's exec pb; rows equal the reference's
    over its wire, the ``tidb_allow_mpp = 0`` answer and the oracle."""
    sql = MPPQ if name == "mppq" else chip_smoke.MPP_QUERIES[name]

    def run(s):
        if name != "mppq":
            s.execute("USE mpp")
        plan = "\n".join(r[0] for r in s.query("EXPLAIN " + sql))
        assert plan.count("PhysMPPGather") == 1, plan
        rows = s.query(sql)
        det = s.mpp_details[-1]
        s.execute("SET tidb_allow_mpp = 0")
        host = s.query(sql)
        return rows, host, (det.n_fragments, det.stages)

    (ref_rows, ref_host, ref_shape), (rows, host, shape) = _both(topo, run)
    assert rows == ref_rows == host == ref_host
    assert shape == ref_shape
    if name == "mppq":
        assert len(rows) == 7 and sum(r[1] for r in rows) > 0
    else:
        assert shape == chip_smoke.MPP_PLANS[name]
        want = chip_smoke.mpp_oracle(name, topo["data"]["mpp"])
        assert chip_smoke.mpp_rows_match(name, rows, want, chip_smoke.MPP_LIMITS[name])


def test_remote_mpp_carries_warnings(topo):
    def run(s):
        s.execute("CREATE TABLE IF NOT EXISTS wmp (id BIGINT PRIMARY KEY, g BIGINT, z BIGINT)")
        s.execute("DELETE FROM wmp")
        s.execute("INSERT INTO wmp VALUES " + ", ".join(f"({i}, {i % 3}, {i % 2})" for i in range(60)))
        s.execute("ANALYZE TABLE wmp")
        s.execute("SET tidb_enforce_mpp = 1")
        q = "SELECT g, SUM(id / z) FROM wmp GROUP BY g ORDER BY g"
        assert "PhysMPPGather" in "\n".join(r[0] for r in s.query("EXPLAIN " + q))
        rows = s.execute(q).rows
        warns = s.execute("SHOW WARNINGS").rows
        return rows, sorted({w[1] for w in warns})

    ref_out, out = _both(topo, run)
    assert out == ref_out
    assert len(out[0]) == 3 and 1365 in out[1]


def test_mpp_remote_txn_dirty_falls_back(topo):
    def run(s):
        s.execute("BEGIN")
        s.execute("INSERT INTO d VALUES (100000, 6)")
        with_dirty = s.query(MPPQ)
        s.execute("ROLLBACK")
        return with_dirty, s.query(MPPQ)

    ref_out, out = _both(topo, run)
    assert out == ref_out and out[0] == out[1]


def test_mpp_remote_ddl_resync(topo):
    def run(s):
        s.execute("CREATE TABLE d2 (id BIGINT PRIMARY KEY, grp BIGINT)")
        s.execute("INSERT INTO d2 VALUES (100, 1), (101, 2)")
        q = "SELECT d2.grp, COUNT(*) FROM li JOIN d2 ON li.qty = d2.id GROUP BY d2.grp ORDER BY d2.grp"
        assert "PhysMPPGather" in "\n".join(r[0] for r in s.query("EXPLAIN " + q))
        return s.query(q)

    ref_rows, rows = _both(topo, run)
    assert rows == ref_rows and len(rows) == 2 and all(r[1] > 0 for r in rows)


def test_store_device_failure_fails_the_statement(monkeypatch, topo):
    """A failure on the store's card (here: the device path raising as a
    CUDA error would) reaches the SQL layer as the store's error and fails
    the statement; no remote cop task is answered by the host engine."""
    host_calls = []
    real_host = host_engine.execute_dag

    def boom(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(gpu_engine, "_execute_dag_device", boom)
    monkeypatch.setattr(host_engine, "execute_dag", lambda *a, **k: host_calls.append(a) or real_host(*a, **k))
    s = topo["port"][0].session()
    with pytest.raises(RuntimeError, match="illegal memory access"):
        s.query(SQL["q6"])
    assert host_calls == []
    monkeypatch.undo()
    assert chip_smoke.sql_rows("q6", s.query(SQL["q6"])) == chip_smoke.sql_oracle("q6", topo["data"]["cols"])


def test_remote_store_carries_the_callers_device(topo):
    """``open(remote=..., device=...)``: the SQL layer's own device work
    (the root window, a fleet's hybrid gather) runs where the caller said."""
    port = topo["port"][0]
    assert port.store.device == "cpu"
    assert gpu_engine.store_device(port.store) == torch.device("cpu")


def test_planning_over_a_remote_store_touches_no_card(monkeypatch, topo):
    """Planning an MPP statement and running cop statements over a remote
    store never asks CUDA for a device or its memory in the SQL layer (the
    card belongs to the store process), even where a card is present."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for fn in ("current_device", "mem_get_info", "init", "set_device", "synchronize"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, _fn=fn, **k: calls.append(_fn), raising=False)
    port = tidb_tpu_torch.open(remote=f"127.0.0.1:{topo['port'][2].port}")  # device="cuda"
    s = port.session()
    assert port.health is not None
    plan = "\n".join(r[0] for r in s.query("EXPLAIN " + MPPQ))
    assert "PhysMPPGather" in plan
    s.query(SQL["count"])
    port.stop_background()
    assert calls == []
    assert not torch.cuda.is_initialized()


def test_killing_the_remote_mid_query_surfaces(tmp_path):
    """``python -m tidb_tpu_torch --store-server --device cpu`` loaded over
    the wire (``bulk_load`` → ``ingest_columnar``), SIGKILLed while a
    thread alternates a cop statement and an MPP dispatch: the statement
    in flight fails with a connection error, nothing hangs."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", "--store-server", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO, env=env,
    )
    try:
        line = proc.stdout.readline()
        assert line.startswith("ready port="), line
        db = tidb_tpu_torch.open(remote=f"127.0.0.1:{int(line.split('=')[1])}", device="cpu")
        # integer columns: a string column loaded through ingest_columnar
        # comes back with an empty dictionary in both packages (a reference
        # defect)
        db.execute("CREATE TABLE li (flag BIGINT, qty DECIMAL(10,2))")
        rng = np.random.default_rng(4)
        bulk_load(db, "li", [rng.integers(0, 3, 50_000), rng.integers(100, 5100, 50_000)])
        db.execute("CREATE TABLE kd (id BIGINT PRIMARY KEY, grp BIGINT)")
        db.execute("INSERT INTO kd VALUES " + ", ".join("(%d, %d)" % (i, i % 5) for i in range(100, 400)))
        s = db.session()
        assert len(s.query("SELECT flag, COUNT(*) FROM li GROUP BY flag")) == 3
        errs: list = []
        started = threading.Event()

        def hammer():
            try:
                started.set()
                for i in range(400):
                    if i % 2:
                        s.query("SELECT kd.grp, COUNT(*) FROM li JOIN kd ON li.qty = kd.id GROUP BY kd.grp")
                    else:
                        s.query("SELECT flag, COUNT(*) FROM li GROUP BY flag")
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        t = threading.Thread(target=hammer)
        t.start()
        started.wait()
        time.sleep(0.5)
        proc.send_signal(signal.SIGKILL)
        proc.wait()
        t.join(timeout=60)
        assert not t.is_alive(), "query thread hung after server death"
        assert errs, "killing the store mid-query must surface an error"
        assert isinstance(errs[0], (ConnectionError, RuntimeError, OSError)), errs[0]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
