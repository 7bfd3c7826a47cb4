"""A SQL layer over a fleet of two raw stores (``kv/sharded.py``), held
against the reference's fleet (``tests/test_sharded_store.py``'s cases).

The port's stores are ``python -m tidb_tpu_torch --store-server --raw-store
--device cpu`` processes; the reference's are ``StoreServer(MemStore())``
threads of this process. Each SQL layer (``open(remote="h1:p1,h2:p2")``)
places consecutive table ids on alternating stores, so a two-table join
crosses the process split: its gather runs on the coordinator's own device
(the port's: the CPU it was opened with), per-owner reads crossing the
wire. The same statements must give the same rows on both fleets.
"""

import collections
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

import tidb_tpu
import tidb_tpu_torch
from tidb_tpu.kv.memstore import MemStore as RefMemStore
from tidb_tpu.kv.remote import StoreServer as RefStoreServer
from tidb_tpu.kv.sharded import ShardedStore as RefShardedStore
from tidb_tpu.utils import metrics as ref_metrics
from tidb_tpu_torch.kv.sharded import ShardedStore
from tidb_tpu_torch.utils import metrics as port_metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q3 = (
    "SELECT o_odate, SUM(l_price) AS rev FROM lineitem2, orders "
    "WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY rev DESC, o_odate"
)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _raw_store_process():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "tidb_tpu_torch", "--store-server", "--raw-store", "--device", "cpu", "--port", "0"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True, cwd=REPO, env=env,
    )
    line = proc.stdout.readline()
    if not line.startswith("ready port="):
        proc.kill()
        raise RuntimeError(f"store server did not report ready: {line!r}")
    return proc, int(line.split("=")[1])


def _populate(db):
    s = db.session()
    s.execute("CREATE TABLE orders (o_orderkey BIGINT PRIMARY KEY, o_odate BIGINT)")
    s.execute("CREATE TABLE lineitem2 (l_orderkey BIGINT, l_price BIGINT)")
    s.execute("INSERT INTO orders VALUES " + ", ".join(f"({i}, {8000 + i % 5})" for i in range(40)))
    s.execute("INSERT INTO lineitem2 VALUES " + ", ".join(f"({i % 40}, {100 + i})" for i in range(400)))
    return db


@pytest.fixture(scope="module")
def fleets():
    """{"ref": (db, servers), "port": (db, processes)}."""
    ref_srvs = [RefStoreServer(RefMemStore(region_split_keys=100_000)) for _ in range(2)]
    ref_ports = [srv.start() for srv in ref_srvs]
    procs = [_raw_store_process() for _ in range(2)]
    ref = _populate(tidb_tpu.open(remote=",".join(f"127.0.0.1:{p}" for p in ref_ports)))
    port = _populate(tidb_tpu_torch.open(remote=",".join(f"127.0.0.1:{p}" for _proc, p in procs), device="cpu"))
    yield {"ref": (ref, ref_srvs), "port": (port, [proc for proc, _p in procs])}
    for srv in ref_srvs:
        srv.shutdown()
    for proc, _p in procs:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)


def _shards(db):
    cat = db.catalog
    return db.store.shard_of_table(cat.table("test", "orders").id), db.store.shard_of_table(cat.table("test", "lineitem2").id)


def test_tables_split_across_stores(fleets):
    port = fleets["port"][0]
    assert isinstance(port.store, ShardedStore)
    assert _shards(port) == _shards(fleets["ref"][0])
    assert set(_shards(port)) == {0, 1}, "consecutive table ids must land on both stores"


def test_cross_store_join_q3_parity(fleets):
    """Q3-shaped join of tables on different store processes: the port's
    rows equal the reference's and the expected revenue per date."""
    got = fleets["port"][0].session().execute(Q3).rows
    assert got == fleets["ref"][0].session().execute(Q3).rows
    rev = collections.defaultdict(int)
    for i in range(400):
        rev[8000 + (i % 40) % 5] += 100 + i
    assert got == sorted(rev.items(), key=lambda kv: (-kv[1], kv[0]))


@pytest.mark.parametrize("pkg", ["ref", "port"])
def test_single_owner_mpp_agg(monkeypatch, fleets, pkg):
    """A single-table gather has one owner and ships as one remote MPP task;
    a cross-owner join is not dispatched and rides the hybrid path (the
    coordinator's device, per-owner reads over the wire)."""
    db = fleets[pkg][0]
    cls, metrics = (RefShardedStore, ref_metrics) if pkg == "ref" else (ShardedStore, port_metrics)
    s = db.session()
    s.execute("ANALYZE TABLE orders")
    s.execute("ANALYZE TABLE lineitem2")
    s.execute("SET tidb_enforce_mpp = 1")
    dispatched: list = []
    orig = cls.mpp_dispatch

    def spy(self, spec, read_ts):
        tid = orig(self, spec, read_ts)
        dispatched.append(tid)
        return tid

    monkeypatch.setattr(cls, "mpp_dispatch", spy)
    got = s.execute("SELECT o_odate, COUNT(*) FROM orders GROUP BY o_odate ORDER BY o_odate").rows
    assert got == sorted(collections.Counter(8000 + i % 5 for i in range(40)).items())
    assert len(dispatched) == 1, "single-owner agg must ship as ONE remote MPP task"
    dispatched.clear()
    h0 = metrics.MPP_HYBRID.get()
    join = s.execute(
        "SELECT o_odate, SUM(l_price) FROM lineitem2, orders WHERE l_orderkey = o_orderkey GROUP BY o_odate ORDER BY o_odate"
    ).rows
    assert len(join) == 5 and not dispatched, "cross-owner gather must not dispatch"
    assert metrics.MPP_HYBRID.get() > h0, "cross-owner gather must ride the hybrid path"
    s.execute("SET tidb_enforce_mpp = 0")


def test_cross_store_txn_atomic(fleets):
    def run(db):
        s = db.session()
        s.execute("BEGIN")
        s.execute("INSERT INTO orders VALUES (1000, 9999)")
        s.execute("INSERT INTO lineitem2 VALUES (1000, 777)")
        s.execute("COMMIT")
        out = [s.execute("SELECT o_odate, l_price FROM orders, lineitem2 WHERE o_orderkey = 1000 AND l_orderkey = 1000").rows]
        s.execute("BEGIN")
        s.execute("INSERT INTO orders VALUES (1001, 1)")
        s.execute("INSERT INTO lineitem2 VALUES (1001, 2)")
        s.execute("ROLLBACK")
        out.append(s.execute("SELECT COUNT(*) FROM orders WHERE o_orderkey = 1001").rows)
        out.append(s.execute("SELECT COUNT(*) FROM lineitem2 WHERE l_orderkey = 1001").rows)
        return out

    assert run(fleets["port"][0]) == run(fleets["ref"][0]) == [[(9999, 777)], [(0,)], [(0,)]]


def test_kill_one_store_surfaces_cleanly(fleets):
    """SIGKILL the port's store owning lineitem2: a query touching it fails
    with the store's connection error; the surviving store keeps serving
    its table when it is also the meta authority (shard 0)."""
    db, procs = fleets["port"]
    so, sl = _shards(db)
    s = db.session()
    n_orders = s.execute("SELECT COUNT(*) FROM orders").rows
    victim = procs[sl]
    victim.send_signal(signal.SIGKILL)
    victim.wait(timeout=10)
    time.sleep(0.2)
    with pytest.raises(Exception) as ei:
        s.execute("SELECT COUNT(*) FROM lineitem2")
    assert "unreachable" in str(ei.value) or "Connection" in type(ei.value).__name__
    if so == 0:
        assert s.execute("SELECT COUNT(*) FROM orders").rows == n_orders
