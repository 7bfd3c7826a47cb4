"""The port's MPP gather over a mesh of several workers, held against the
reference, on the CPU through logical devices.

The statements are ``chip_smoke.MPP_QUERIES`` (bench.py's Q3, TPC-H Q3 in
its JOIN form, Q17, a TopN over a join) over a few thousand generated
rows, and ``tests/test_mpp_failure.py``'s ``MPPQ`` over its data. Each
runs on the reference at ``FORCE_NDEV`` 1 and 4 (the conftest's 8-device
CPU mesh) and on its host engine, which must agree, and on the port at
four layouts (``LAYOUTS``): one shard, four virtual shards on one device,
four logical devices (four workers) and two workers of two shards. The
port's rows must equal the reference's (integers and decimals exactly,
doubles within a relative 1e-12), its gather the reference's fragments at
the layout's width, with no retry.

Then the counterparts of ``tests/test_mpp_failure.py`` over four logical
devices: a lost device is blacklisted and the rerun on the three survivors
answers the same rows (from the failpoint, and from a worker that raises
inside the program); a worker that hangs fails its attempt after the
rendezvous timeout, is blamed by probing and the retry answers;
unattributed failures exhaust and the session re-plans without MPP, as it
does with every device blacklisted; a KILL is not retried; a reduced mesh
answers correctly. Last, ``mpp_ndev`` over a store server and an embedded
fleet reports the mesh's width, and a SQL layer over the store server runs
its gather on the store's four workers.
"""

import math
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.parallel import mesh as ref_mesh  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.kv.memstore import MemStore  # noqa: E402
from tidb_tpu_torch.kv.remote import RemoteStore, StoreServer  # noqa: E402
from tidb_tpu_torch.kv.sharded import ShardedStore  # noqa: E402
from tidb_tpu_torch.parallel import mesh  # noqa: E402
from tidb_tpu_torch.parallel.probe import GLOBAL_PROBER, DeviceProber  # noqa: E402
from tidb_tpu_torch.utils import failpoint  # noqa: E402
from tidb_tpu_torch.utils.memory import QueryKilledError  # noqa: E402

REL = 1e-12  # doubles, relative
CPU = torch.device("cpu")
L = mesh.logical_devices(CPU, 4)
# name → (FORCE_DEVICES, FORCE_NDEV, width)
LAYOUTS = {
    "1shard": (None, 1, 1),
    "4virtual": (None, 4, 4),
    "4logical": (L, None, 4),
    "2x2": ([L[0], L[0], L[1], L[1]], None, 4),
}
N_LINE, N_PART, N_CUST = 6_000, 800, 600
# tests/test_mpp_failure.py's statement over its data
MPPQ = "SELECT cat, COUNT(*), SUM(qty) FROM fact JOIN dim ON fact.cid = dim.id GROUP BY cat ORDER BY cat"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def clean_state():
    yield
    mesh.FORCE_DEVICES = mesh.FORCE_NDEV = ref_mesh.FORCE_NDEV = None
    GLOBAL_PROBER._failed.clear()


def _fact_dim(db, _bulk):
    db.execute("CREATE TABLE fact (cid BIGINT, qty BIGINT)")
    db.execute("CREATE TABLE dim (id BIGINT PRIMARY KEY, cat BIGINT)")
    db.execute("INSERT INTO dim VALUES " + ",".join(f"({i},{i % 4})" for i in range(30)))
    db.execute("INSERT INTO fact VALUES " + ",".join(f"({i % 30},{i % 7})" for i in range(600)))


@pytest.fixture(scope="module")
def dbs():
    """(reference, port) handles over the MPP tables and fact/dim, and the
    generated tables."""
    cols = chip_smoke.lineitem_sf1(5, n=N_LINE)
    partkey = np.random.default_rng(9).integers(1, N_PART + 1, N_LINE)
    tables = chip_smoke.mpp_tables(cols, partkey, 5, n_part=N_PART, n_cust=N_CUST)

    def setup(db, bl):
        chip_smoke.mpp_sql(db, bl, tables)
        _fact_dim(db, bl)

    ref = tidb_tpu.open(region_split_keys=1 << 62)
    setup(ref, ref_bulk_load)
    port = tidb_tpu_torch.open(device="cpu", region_split_keys=1 << 62)
    setup(port, bulk_load)
    yield ref, port, tables
    for db in (ref, port):
        db.stop_background()


STATEMENTS = {**chip_smoke.MPP_QUERIES, "mppq": MPPQ}
_REF: dict = {}


def _same(got, want) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) or isinstance(b, float):
                if not math.isclose(float(a), float(b), rel_tol=REL, abs_tol=0.0):
                    return False
            elif a != b:
                return False
    return True


def _reference(ref, name):
    """The reference's rows at FORCE_NDEV 1 and 4 and on its host engine
    (which must agree) and its fragment count."""
    if name not in _REF:
        sql = STATEMENTS[name]
        rows, frags = [], set()
        for nd in (1, 4):
            ref_mesh.FORCE_NDEV = nd
            s = ref.session()
            rows.append(s.query(sql))
            frags.add(s.mpp_details[-1].n_fragments)
        ref_mesh.FORCE_NDEV = None
        h = ref.session()
        h.execute("SET tidb_allow_mpp = 0")
        rows.append(h.query(sql))
        assert _same(rows[0], rows[1]) and _same(rows[0], rows[2]), name
        assert len(frags) == 1
        _REF[name] = (rows[0], frags.pop())
    return _REF[name]


def _set(layout):
    mesh.FORCE_DEVICES, mesh.FORCE_NDEV, width = LAYOUTS[layout]
    return width


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(STATEMENTS))
def test_statement_equals_the_reference_at_every_layout(dbs, name, layout):
    ref, port, tables = dbs
    want, frags = _reference(ref, name)
    width = _set(layout)
    s = port.session()
    plan = "\n".join(r[0] for r in s.query("EXPLAIN " + STATEMENTS[name]))
    assert "PhysMPPGather" in plan
    got = s.query(STATEMENTS[name])
    assert _same(got, want), (got[:3], want[:3])
    if name in chip_smoke.MPP_QUERIES:
        assert chip_smoke.mpp_rows_match(name, got, chip_smoke.mpp_oracle(name, tables), chip_smoke.MPP_LIMITS[name])
    d = s.mpp_details[-1]
    assert (d.n_fragments, d.ndev, d.retries) == (frags, width, 0)
    # one probe row per shard, each with its worker's wall
    assert sorted(sh[0] for sh in d.shards) == list(range(width))


# -- tests/test_mpp_failure.py over four logical devices ----------------------------


def _host_rows(port):
    s = port.session()
    s.execute("SET tidb_allow_mpp = 0")
    return s.query(MPPQ)


def _logical():
    mesh.FORCE_DEVICES = L


def test_device_failure_blacklists_and_retries(dbs):
    _ref, port, _t = dbs
    _logical()
    calls = []

    def boom(m):
        calls.append(m.devices.size)
        if len(calls) == 1:
            err = RuntimeError("device lost: injected")
            err.mpp_device = m.devices.flat[0]
            raise err

    failpoint.enable("mpp_run_fragment", boom)
    try:
        s = port.session()
        rows = s.query(MPPQ)
    finally:
        failpoint.disable("mpp_run_fragment")
    assert calls == [4, 3]  # failed once, succeeded on the three survivors
    assert GLOBAL_PROBER.failed_count() == 1 and GLOBAL_PROBER.alive(L) == L[1:]
    assert rows == _host_rows(port)
    assert (s.mpp_details[-1].ndev, s.mpp_details[-1].retries) == (3, 1)


def test_a_worker_lost_inside_the_program_is_blamed_and_the_survivors_answer(dbs, monkeypatch):
    _ref, port, _t = dbs
    _logical()
    real = mesh._Rendezvous.exchange
    lost = []

    def exchange(self, w, sends):
        h = self.mesh.workers[w][0]
        if h is L[2] and not lost:
            lost.append(h)
            raise RuntimeError("CUDA error: an illegal memory access was encountered (injected)")
        return real(self, w, sends)

    monkeypatch.setattr(mesh._Rendezvous, "exchange", exchange)
    before = threading.active_count()
    t0 = time.monotonic()
    s = port.session()
    rows = s.query(MPPQ)
    assert time.monotonic() - t0 < 30
    assert lost == [L[2]] and GLOBAL_PROBER.alive(L) == [L[0], L[1], L[3]]
    assert rows == _host_rows(port)
    d = s.mpp_details[-1]
    assert (d.ndev, d.retries) == (3, 1)
    assert threading.active_count() == before


def test_a_hung_worker_times_out_and_is_blamed_by_probing(dbs, monkeypatch):
    _ref, port, _t = dbs
    _logical()
    monkeypatch.setattr(mesh, "RENDEZVOUS_TIMEOUT_S", 0.3)
    real = mesh._Rendezvous.exchange
    hung = []

    def exchange(self, w, sends):
        if self.mesh.workers[w][0] is L[1] and not hung:
            hung.append(w)
            time.sleep(1.0)  # past the timeout: the others give up
        return real(self, w, sends)

    monkeypatch.setattr(mesh._Rendezvous, "exchange", exchange)
    s = port.session()
    rows = s.query(MPPQ)
    assert hung and rows == _host_rows(port)
    # every logical CPU device answers its probe: nothing is blacklisted and
    # the same mesh answers the retry
    d = s.mpp_details[-1]
    assert GLOBAL_PROBER.failed_count() == 0 and (d.ndev, d.retries) == (4, 1)


def test_unattributed_failures_exhaust_then_fall_back(dbs):
    _ref, port, _t = dbs
    _logical()
    calls = []

    def always_boom(m):
        calls.append(m.devices.size)
        raise RuntimeError("shard OOM: injected")

    failpoint.enable("mpp_run_fragment", always_boom)
    try:
        rows = port.session().query(MPPQ)
    finally:
        failpoint.disable("mpp_run_fragment")
    assert calls == [4, 4]  # no progress twice → the session re-plans
    assert rows == _host_rows(port)


def test_all_devices_blacklisted_falls_back(dbs):
    _ref, port, _t = dbs
    _logical()
    for d in mesh.available_devices("cpu"):
        GLOBAL_PROBER.report_failure(d)
    s = port.session()
    rows = s.query(MPPQ)  # MPPRetryExhausted → the host join
    assert rows == _host_rows(port)
    assert not s.mpp_details


def test_prober_recovery_window():
    p = DeviceProber(recovery_s=0.05)
    p.report_failure(L[0])
    assert p.alive(L[:2]) == [L[1]]
    time.sleep(0.06)
    assert p.alive(L[:2]) == L[:2]  # past the window the device rejoins
    p.report_failure(L[0])
    p.report_ok(L[0])
    assert p.alive(L[:2]) == L[:2]


def test_reduced_mesh_correctness(dbs):
    _ref, port, _t = dbs
    _logical()
    GLOBAL_PROBER.report_failure(L[0])
    s = port.session()
    rows = s.query(MPPQ)
    assert rows == _host_rows(port)
    assert (s.mpp_details[-1].ndev, s.mpp_details[-1].retries) == (3, 0)


def test_kill_is_not_retried(dbs):
    _ref, port, _t = dbs
    _logical()
    calls = []

    def kill(m):
        calls.append(1)
        raise QueryKilledError("killed: injected")

    failpoint.enable("mpp_run_fragment", kill)
    try:
        with pytest.raises(QueryKilledError):
            port.session().query(MPPQ)
    finally:
        failpoint.disable("mpp_run_fragment")
    assert calls == [1]  # no retry, no host fallback


# -- the store side -------------------------------------------------------------------


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_mpp_ndev_reports_the_mesh_width(layout):
    width = _set(layout)
    srv = StoreServer(MemStore())
    try:
        assert RemoteStore("127.0.0.1", srv.start()).mpp_ndev() == width
    finally:
        srv.shutdown()
    assert ShardedStore([MemStore()]).mpp_ndev() == width  # an embedded fleet


def test_a_sql_layer_runs_its_gather_on_the_store_servers_workers():
    store = tidb_tpu_torch.open(device="cpu")
    _fact_dim(store, bulk_load)
    srv = StoreServer(store.store)
    sql = None
    try:
        sql = tidb_tpu_torch.open(remote=f"127.0.0.1:{srv.start()}", device="cpu")
        _logical()
        s = sql.session()
        rows = s.query(MPPQ)
        d = s.mpp_details[-1]
        assert (d.ndev, d.retries) == (4, 0) and sorted(sh[0] for sh in d.shards) == [0, 1, 2, 3]
        assert rows == _host_rows(store)
    finally:
        srv.shutdown()
        for db in (sql, store):
            if db is not None:
                db.stop_background()
