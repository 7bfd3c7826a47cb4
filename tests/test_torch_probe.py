"""The engine's chip probe, the first-call build probe and the scaling
widths of the PyTorch port, held against the reference.

- ``gpu_engine.device_probe_fn`` against ``tpu_engine.device_probe_fn``: a
  6,000-row lineitem from ``chip_smoke.lineitem_sf1`` in one region of
  each package; COUNT(*), Q6, Q1, Q10 and the band query captured as the
  SQL layer sends them, probed at each route (one program, one program per
  block, one program over every block; ``_BLOCK`` and ``_FUSE_MAX_NB``
  shrink equally in both engines). The decoded outputs of one ``run_once``
  equal the reference probe's and the task's own chunk, and both packages
  refuse the same five shapes.
- ``dag_kernel._arm_compile_probe``: a cold program charges the cop task's
  ``compile_ms`` and ``COP_COMPILE_SECONDS`` once under a ``jit-compile``
  span, in the port as in the reference; a warm one charges nothing; eight
  threads making the first call at once charge it once, in both packages.
- ``benchdaily._scaling_curve`` and graftfuzz's ``_forced_ndev`` over four
  logical CPU devices standing in for cards, and over one.
"""

import copy
import os
import sys
import threading
import time
from types import SimpleNamespace

import jax
import jax.experimental
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.copr import colcache as ref_colcache  # noqa: E402
from tidb_tpu.copr import tpu_engine  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv.tablecodec import record_key as ref_record_key  # noqa: E402
from tidb_tpu.ops import dag_kernel as ref_dag_kernel  # noqa: E402
from tidb_tpu.utils import execdetails as ref_ed  # noqa: E402
from tidb_tpu.utils import metrics as ref_metrics  # noqa: E402
from tidb_tpu.utils import tracing as ref_tracing  # noqa: E402
from tidb_tpu_torch.bench import benchdaily  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key  # noqa: E402
from tidb_tpu_torch.ops import dag_kernel  # noqa: E402
from tidb_tpu_torch.ops import grouped_sums as gs  # noqa: E402
from tidb_tpu_torch.parallel import mesh  # noqa: E402
from tidb_tpu_torch.tools.fuzz import runner  # noqa: E402
from tidb_tpu_torch.utils import execdetails as ed  # noqa: E402
from tidb_tpu_torch.utils import metrics  # noqa: E402
from tidb_tpu_torch.utils import tracing  # noqa: E402

N_ROWS = 6000
NAMES = ("count", "q6", "q1", "q10", "band")
LIMIT_SQL = "SELECT l_extendedprice, l_shipmode FROM lineitem WHERE l_discount >= 0.01 LIMIT 5"
MANY_GROUPS_SQL = "SELECT l_suppkey, SUM(l_quantity) FROM lineitem GROUP BY l_suppkey"

# (rows per block, most blocks fused, {statement: the production path})
LAYOUTS = {
    "single": (None, None, {n: "single" for n in NAMES}),
    "per_block": (1024, 4, {n: "per-block stacked" for n in NAMES}),
    "fused": (2048, 8, {**{n: "fused" for n in NAMES}, "q10": "per-block stacked"}),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reference_pallas(monkeypatch):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


@pytest.fixture(scope="module")
def dbs():
    cols = chip_smoke.lineitem_sf1(seed=14, n=N_ROWS)
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    chip_smoke.lineitem_sql(ref, ref_bulk_load, ref_record_key, cols, parts=1)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(port, bulk_load, record_key, cols, parts=1)
    yield ref, port
    port.stop_background()


def _capture(db, engine_mod, engine: str, sql: str):
    """(dag, region, ranges, read_ts) of the statement's one cop task, as
    bench.py's ``chip_time`` captures it (the task itself runs)."""
    got = {}
    real = engine_mod._execute_dag_device

    def cap(store, dag, region, ranges, read_ts, warn=None):
        got["args"] = (dag, region, ranges, read_ts)
        return real(store, dag, region, ranges, read_ts, warn)

    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines = '{engine}'")
    engine_mod._execute_dag_device = cap
    try:
        s.query(sql)
    finally:
        engine_mod._execute_dag_device = real
    return got["args"]


def _blocks(monkeypatch, block, fuse_max):
    if block is None:
        return
    for mod in (tpu_engine, gpu_engine):
        monkeypatch.setattr(mod, "_BLOCK", block)
        monkeypatch.setattr(mod, "_FUSE_MAX_NB", fuse_max)


def _ref_probe_rows(monkeypatch, db, dag, region, ranges, ts):
    """The reference probe's outputs of one run, decoded as its engine
    decodes a task's buffers."""
    kernels = []
    real = tpu_engine.get_kernel

    def spy(*a, **k):
        kernels.append(real(*a, **k))
        return kernels[-1]

    monkeypatch.setattr(tpu_engine, "get_kernel", spy)
    run_once, sync = tpu_engine.device_probe_fn(db.store, dag, region, ranges, ts)
    outs = run_once()
    sync(outs)
    (kernel,) = kernels
    cache = ref_colcache.cache_for(db.store)
    rows = []
    for p in outs:
        buf = np.asarray(p[0] if isinstance(p, tuple) else p)
        fbuf = np.asarray(p[1]) if isinstance(p, tuple) else None
        rows += tpu_engine._chunk_from_bufs(
            buf, fbuf, int(buf[0, 0]), kernel, dag, cache, dag.executors[0]
        ).rows()
    return rows


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_probe_matches_reference_and_task(dbs, monkeypatch, layout, name):
    ref, port = dbs
    block, fuse_max, paths = LAYOUTS[layout]
    _blocks(monkeypatch, block, fuse_max)
    sql = chip_smoke.SQL_QUERIES[name]
    want = _ref_probe_rows(monkeypatch, ref, *_capture(ref, tpu_engine, "tpu", sql))
    dag, region, ranges, ts = _capture(port, gpu_engine, "gpu", sql)
    stats = {}
    real_region = gpu_engine.execute_region
    monkeypatch.setattr(
        gpu_engine, "execute_region", lambda *a, **k: real_region(*a, **{**k, "stats": stats})
    )
    task = gpu_engine._execute_dag_device(port.store, dag, region, ranges, ts)
    assert stats["path"] == paths[name]
    k1 = gs.LAUNCHES
    calls = []
    monkeypatch.setattr(dag_kernel, "grouped_sums", lambda *a, **k: calls.append(1) or gs.grouped_sums(*a, **k))
    run_once, sync = gpu_engine.device_probe_fn(port.store, dag, region, ranges, ts)
    calls.clear()
    outs = run_once()
    sync(outs)
    got = run_once.chunk(outs).rows()
    assert chip_smoke.rows_match(got, want, 1e-12)
    assert got == task.rows()
    assert len(outs) == (len(gpu_engine._block_bounds(N_ROWS)) if paths[name] == "per-block stacked" else 1)
    # K1's route on band only: once per program run (the plain version on
    # the CPU counts no launch)
    assert len(calls) == (len(outs) if name == "band" else 0)
    assert gs.LAUNCHES == k1


def _window_dag(dag):
    pb = copy.deepcopy(dag.to_pb())
    pb["executors"] = pb["executors"][:1] + [{
        "tp": "window", "partition_by": [], "order_by": [],
        "win_funcs": [{"name": "row_number", "args": [], "ft": [8, 20, 0, 1, "binary", 0]}],
    }]
    pb["output_offsets"] = []
    return type(dag).from_pb(pb)


def _desc_dag(dag):
    pb = copy.deepcopy(dag.to_pb())
    pb["executors"][0]["desc"] = True
    return type(dag).from_pb(pb)


REJECTED = ("descending", "many_ranges", "window", "limit_blocked", "agg_cap_overflow")


@pytest.mark.parametrize("shape", REJECTED)
def test_both_probes_refuse_the_same_shapes(dbs, monkeypatch, shape):
    ref, port = dbs
    sql = chip_smoke.SQL_QUERIES["q10"]
    if shape == "limit_blocked":
        sql = LIMIT_SQL
        _blocks(monkeypatch, 1024, 8)
    elif shape == "agg_cap_overflow":
        sql = MANY_GROUPS_SQL
        for mod in (tpu_engine, gpu_engine):
            monkeypatch.setattr(mod, "_DEFAULT_AGG_CAP", 64)
    for db, mod, engine in ((ref, tpu_engine, "tpu"), (port, gpu_engine, "gpu")):
        dag, region, ranges, ts = _capture(db, mod, engine, sql)
        if shape == "descending":
            dag = _desc_dag(dag)
        elif shape == "many_ranges":
            ranges = list(ranges) * (dag_kernel.MAX_RANGES + 1)
        elif shape == "window":
            dag = _window_dag(dag)
        with pytest.raises(ValueError, match="probe unsupported"):
            mod.device_probe_fn(db.store, dag, region, ranges, ts)


def test_probe_does_not_recharge_a_program_production_ran(dbs):
    _ref, port = dbs
    dag, region, ranges, ts = _capture(port, gpu_engine, "gpu", chip_smoke.SQL_QUERIES["q6"])
    n0 = metrics.COP_COMPILE_SECONDS.count
    det = ed.CopExecDetails()
    with ed.collecting(det):
        run_once, sync = gpu_engine.device_probe_fn(port.store, dag, region, ranges, ts)
        sync(run_once())
    assert det.compile_ms == 0.0 and metrics.COP_COMPILE_SECONDS.count == n0


# -- the first-call build probe


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_cold_program_charges_compile_once_and_warm_nothing(dbs, monkeypatch, pkg):
    ref, port = dbs
    db, mod, kmod, engine, ed_mod, m, tr_mod = (
        (port, gpu_engine, dag_kernel, "gpu", ed, metrics, tracing)
        if pkg == "port"
        else (ref, tpu_engine, ref_dag_kernel, "tpu", ref_ed, ref_metrics, ref_tracing)
    )
    dag, region, ranges, ts = _capture(db, mod, engine, chip_smoke.SQL_QUERIES["band"])
    monkeypatch.setattr(kmod, "_COMPILE_CACHE", {})  # every program is new
    n0 = m.COP_COMPILE_SECONDS.count
    det, tracer = ed_mod.CopExecDetails(), tr_mod.Tracer()
    with ed_mod.collecting(det, tracer):
        cold = mod.execute_dag(db.store, dag, region, ranges, ts)
    assert det.compile_ms > 0.0
    assert m.COP_COMPILE_SECONDS.count == n0 + len(kmod._COMPILE_CACHE) == n0 + 1
    assert [s.name for s in tracer.spans].count("jit-compile") == 1
    det, tracer = ed_mod.CopExecDetails(), tr_mod.Tracer()
    with ed_mod.collecting(det, tracer):
        warm = mod.execute_dag(db.store, dag, region, ranges, ts)
    assert det.compile_ms == 0.0 and m.COP_COMPILE_SECONDS.count == n0 + 1
    assert "jit-compile" not in [s.name for s in tracer.spans]
    assert warm.rows() == cold.rows()


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_explain_analyze_shows_the_cold_compile(dbs, monkeypatch, pkg):
    ref, port = dbs
    db, kmod, engine = (port, dag_kernel, "gpu") if pkg == "port" else (ref, ref_dag_kernel, "tpu")
    monkeypatch.setattr(kmod, "_COMPILE_CACHE", {})
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines = '{engine}'")
    text = "\n".join(" ".join(str(v) for v in r) for r in s.query("EXPLAIN ANALYZE " + chip_smoke.SQL_QUERIES["q6"]))
    assert "compile:" in text
    text = "\n".join(" ".join(str(v) for v in r) for r in s.query("EXPLAIN ANALYZE " + chip_smoke.SQL_QUERIES["q6"]))
    assert "compile:" not in text


@pytest.mark.parametrize("pkg", ["port", "reference"])
def test_concurrent_first_callers_charge_once(pkg):
    """Eight threads make a new program's first call at once: one claims
    the build probe and charges its task, the others run the program bare;
    the probe then unhooks itself."""
    kmod, ed_mod, m = (dag_kernel, ed, metrics) if pkg == "port" else (ref_dag_kernel, ref_ed, ref_metrics)
    inner_calls = []

    def program(x):
        inner_calls.append(1)
        time.sleep(0.05)  # the claimant is still inside when the others enter
        return torch.zeros((2, 2), dtype=torch.int64) + x

    k = SimpleNamespace(fn=program)
    kmod._arm_compile_probe(k)
    assert k.fn is not program
    n0 = m.COP_COMPILE_SECONDS.count
    barrier = threading.Barrier(8)
    dets = [ed_mod.CopExecDetails() for _ in range(8)]
    outs = [None] * 8

    def worker(i):
        barrier.wait()
        with ed_mod.collecting(dets[i]):
            outs[i] = k.fn(i)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sum(d.compile_ms > 0.0 for d in dets) == 1
    assert m.COP_COMPILE_SECONDS.count == n0 + 1
    assert len(inner_calls) == 8 and all(int(o[0, 0]) == i for i, o in enumerate(outs))
    assert k.fn is program  # warm calls run the bare program


# -- mesh widths on several cards


class _StubSession:
    """A session whose statement takes ``cost(width)`` seconds and records
    the mesh pins it ran under."""

    mpp_details: list = []

    def __init__(self, log, cost):
        self.log, self.cost = log, cost

    def query(self, sql):
        self.log.append((mesh.FORCE_NDEV, mesh.FORCE_DEVICES))
        time.sleep(self.cost(mesh.FORCE_NDEV))
        return []


def _stub_build(log, cost):
    class _DB:
        def session(self):
            return _StubSession(log, cost)

    return lambda: (_DB(), lambda s: None)


@pytest.fixture
def clean_mesh(monkeypatch):
    monkeypatch.setattr(benchdaily, "DEVICE", "cpu")
    yield
    mesh.FORCE_DEVICES = mesh.FORCE_NDEV = None


def test_scaling_curve_on_four_cards_runs_the_widths_that_fit_under_the_per_chip_gate(clean_mesh):
    cards = mesh.logical_devices("cpu", 4)
    mesh.FORCE_DEVICES = cards
    log = []
    per_chip = benchdaily._scaling_curve("lane", _stub_build(log, lambda d: 0.04 / d), "q", 1000)
    assert sorted({nd for nd, _ in log}) == [1, 2, 4]
    assert all(devs == cards for _, devs in log)
    curve = benchdaily.SCALING_CURVES["lane"]
    assert (curve["cards"], curve["gate"], sorted(curve["rows_per_s"])) == (4, "per-chip", [1, 2, 4])
    assert per_chip == curve["rows_per_s"][4] / 4
    assert mesh.FORCE_DEVICES == cards and mesh.FORCE_NDEV is None
    # a flat curve on four cards: rows/s/chip at width 4 is a quarter of one card's
    with pytest.raises(RuntimeError, match="rows/s/chip degraded at ndev=4"):
        benchdaily._scaling_curve("flat", _stub_build([], lambda d: 0.02), "q", 1000)


def test_scaling_curve_on_one_card_pins_it_and_keeps_the_virtual_widths(clean_mesh):
    log = []
    benchdaily._scaling_curve("one", _stub_build(log, lambda d: 0.01), "q", 1000)
    assert [nd for nd, _ in log[::4]] == [1, 2, 4, 8]
    assert all(devs == [mesh.handle("cpu")] for _, devs in log)
    assert benchdaily.SCALING_CURVES["one"]["gate"] == "total"
    assert mesh.FORCE_DEVICES is None
    # the total gate: a collapse past a tenth of the 1-shard throughput
    with pytest.raises(RuntimeError, match="total throughput collapsed"):
        benchdaily._scaling_curve("collapse", _stub_build([], lambda d: 0.004 * d * d), "q", 1000)


def test_forced_width_is_one_virtual_mesh_on_any_card_count(clean_mesh):
    db = tidb_tpu_torch.open(device="cpu", region_split_keys=1 << 62)
    db.execute("CREATE TABLE fact (cid BIGINT, qty BIGINT)")
    db.execute("CREATE TABLE dim (id BIGINT PRIMARY KEY, cat BIGINT)")
    db.execute("INSERT INTO dim VALUES " + ",".join(f"({i},{i % 4})" for i in range(30)))
    db.execute("INSERT INTO fact VALUES " + ",".join(f"({i % 30},{i % 7})" for i in range(600)))
    sql = "SELECT cat, COUNT(*), SUM(qty) FROM fact JOIN dim ON fact.cid = dim.id GROUP BY cat ORDER BY cat"
    cards = mesh.logical_devices("cpu", 4)
    rows = {}
    try:
        with runner.on_device("cpu"):
            for width in (1, 8):
                mesh.FORCE_DEVICES = cards  # the machine's four cards
                with runner._forced_ndev(True, width):
                    s = db.session()
                    s.execute("SET tidb_enforce_mpp = 1")
                    rows[width] = s.query(sql)
                    d = s.mpp_details[-1]
                    assert (d.ndev, d.retries) == (width, 0)
                    assert mesh.make_mesh().workers == [(mesh.handle("cpu"), 0, width)]
                assert mesh.FORCE_DEVICES == cards and mesh.FORCE_NDEV is None
    finally:
        db.stop_background()
    assert rows[8] == rows[1] and len(rows[1]) == 4
