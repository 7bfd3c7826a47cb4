"""The PyTorch port's coprocessor engine (tidb_tpu_torch.copr.gpu_engine)
held against the reference's device and host engines on one region.

A tidb_tpu DB holds a 6,000-row lineitem with the twelve columns the eight
fixture DAGs read, in one region (n_pad = 8192). The DAGs the reference
planner sends to ``tpu_engine._execute_dag_device`` are captured (as
bench.py's ``chip_time`` captures them), the region's decoded arrays are
carried across with ``carry.region_from_arrays``, and each DAG runs through
the port on the CPU. Rows must be equal, decimals exact.

Run ``python tests/test_torch_engine.py`` to rewrite the checked-in DAG
fixtures under tidb_tpu_torch/bench/dags/ from the reference planner.
"""

import json
import os
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke
import tidb_tpu
from tidb_tpu.copr import dagpb as ref_dagpb
from tidb_tpu.copr import host_engine, tpu_engine
from tidb_tpu.copr.colcache import cache_for
from tidb_tpu.executor.load import bulk_load
from tidb_tpu.kv.rowcodec import RowSchema
from tidb_tpu_torch.copr import carry, gpu_engine
from tidb_tpu_torch.copr.binder import Binder, UnsupportedForDevice
from tidb_tpu_torch.kv import tablecodec as ttc
from tidb_tpu_torch.ops import dag_kernel

FIXTURES = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tidb_tpu_torch", "bench", "dags")

SCHEMA = """CREATE TABLE lineitem (
    l_quantity DECIMAL(12,2), l_extendedprice DECIMAL(12,2),
    l_discount DECIMAL(12,2), l_tax DECIMAL(12,2),
    l_returnflag VARCHAR(1), l_linestatus VARCHAR(1), l_shipdate DATE,
    l_shipmode VARCHAR(10), l_shipinstruct VARCHAR(25),
    l_orderkey INT, l_suppkey INT, l_linenumber INT)"""

QUERIES = {
    "count": "SELECT COUNT(*) FROM lineitem",
    "q6": """SELECT SUM(l_extendedprice * l_discount) FROM lineitem
  WHERE l_shipdate >= DATE '1994-01-01' AND l_shipdate < DATE '1995-01-01'
    AND l_discount BETWEEN 0.05 AND 0.07 AND l_quantity < 24""",
    "q1": """SELECT l_returnflag, l_linestatus,
    SUM(l_quantity), SUM(l_extendedprice),
    SUM(l_extendedprice * (1 - l_discount)),
    SUM(l_extendedprice * (1 - l_discount) * (1 + l_tax)),
    AVG(l_quantity), AVG(l_extendedprice), AVG(l_discount), COUNT(*)
  FROM lineitem WHERE l_shipdate <= DATE '1998-09-02'
  GROUP BY l_returnflag, l_linestatus ORDER BY l_returnflag, l_linestatus""",
    "q10": """SELECT l_returnflag, l_extendedprice FROM lineitem
  WHERE l_shipdate >= DATE '1994-01-01'
  ORDER BY l_extendedprice DESC LIMIT 20""",
    # (7+1)(4+1)(3+1) = 160 buckets: the 64 < B <= 512 band of K1
    "band": """SELECT l_shipmode, l_shipinstruct, l_returnflag, COUNT(*),
    SUM(l_quantity), SUM(l_extendedprice)
  FROM lineitem GROUP BY l_shipmode, l_shipinstruct, l_returnflag""",
    # TPC-H Q18's inner aggregation (its HAVING runs at the root)
    "q18sub": "SELECT l_orderkey, SUM(l_quantity) FROM lineitem GROUP BY l_orderkey",
    # TPC-H Q15's revenue view
    "q15rev": """SELECT l_suppkey, SUM(l_extendedprice * (1 - l_discount)) FROM lineitem
  WHERE l_shipdate >= DATE '1996-01-01' AND l_shipdate < DATE '1996-04-01'
  GROUP BY l_suppkey""",
    # grouped order statistics and bit aggregates: the lex-sort path only
    "extremes": """SELECT l_suppkey, COUNT(*), MIN(l_extendedprice), MAX(l_shipdate),
    BIT_OR(l_linenumber), BIT_XOR(l_orderkey) FROM lineitem GROUP BY l_suppkey""",
}
# a scan → selection DAG: rows-kind output, compacted in handle order
ROWS_QUERY = "SELECT l_extendedprice, l_shipmode, l_shipdate FROM lineitem WHERE l_discount < 0.02"

SHIPMODES = [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB"]
SHIPINSTRUCTS = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE", b"TAKE BACK RETURN"]


def _lineitem_db(n=6000, seed=0):
    db = tidb_tpu.open(region_split_keys=1 << 62)  # one region
    db.execute(SCHEMA)
    rng = np.random.default_rng(seed)
    flags = np.array([b"A", b"N", b"R"], dtype="S1")[rng.integers(0, 3, n)]
    flags = [None if rng.random() < 0.02 else f for f in flags]  # a NULL key bucket
    qty = [None if rng.random() < 0.02 else int(q) for q in rng.integers(100, 5100, n)]
    cols = [
        qty,
        rng.integers(90_100, 10_494_950, n),
        rng.integers(0, 11, n),
        rng.integers(0, 9, n),
        flags,
        np.array([b"F", b"O"], dtype="S1")[rng.integers(0, 2, n)],
        8036 + rng.integers(0, 2525, n),
        np.array(SHIPMODES, dtype="S10")[rng.integers(0, 7, n)],
        np.array(SHIPINSTRUCTS, dtype="S25")[rng.integers(0, 4, n)],
    ]
    # drawn after the nine columns above, which keep their values; 100
    # suppliers (TPC-H's S at scale factor 0.01) so each has many lines
    cols += chip_smoke.lineitem_keys(rng, rng.integers(1, 2001, n), 100)
    bulk_load(db, "lineitem", cols)
    return db


def _capture(db, queries=None):
    """{name: (dag, region, ranges, read_ts)} as the SQL layer sends them,
    for ``queries`` ({name: sql}; the fixture queries and the rows query
    when None)."""
    s = db.session()
    s.execute("SET tidb_isolation_read_engines = 'tpu'")
    out = {}
    items = list(QUERIES.items()) + [("rows", ROWS_QUERY)] if queries is None else list(queries.items())
    for name, sql in items:
        got = {}

        def cap(store, dag, region, ranges, read_ts, warn=None):
            got["args"] = (dag, region, ranges, read_ts)
            raise UnsupportedCapture()

        real = tpu_engine._execute_dag_device
        tpu_engine._execute_dag_device = cap
        try:
            s.query(sql)
        except UnsupportedCapture:
            pass
        finally:
            tpu_engine._execute_dag_device = real
        out[name] = got["args"]
    return out


class UnsupportedCapture(tpu_engine.UnsupportedForDevice):
    """Raised by the capture hook: the engine then answers on the host."""


def _carry_region(db, dag, region, read_ts):
    scan = dag.executors[0]
    cache = cache_for(db.store)
    slots = list(range(len(scan.storage_schema)))
    entry, delta = cache.get_split(region, scan.table_id, RowSchema(scan.storage_schema), slots, read_ts)
    assert delta is None
    dicts = {
        s: cache.dictionary(scan.table_id, s).values_array()
        for s in slots
        if scan.storage_schema[s].kind == tidb_tpu.types.TypeKind.STRING
    }
    return carry.region_from_arrays(
        entry.handles, {s: entry.cols[s] for s in slots}, dicts, scan.table_id, (region.start, region.end)
    )


@pytest.fixture(scope="module")
def setup():
    db = _lineitem_db()
    caps = _capture(db)
    dag0, region, _, read_ts = caps["count"]
    return db, caps, _carry_region(db, dag0, region, read_ts)


def _port_dag(dag):
    return carry.dag_from_pb(json.loads(json.dumps(dag.to_pb())))


def _port_ranges(ranges):
    return [ttc.KeyRange(r.start, r.end) for r in ranges]


def _spy(monkeypatch):
    calls = {"k1": 0, "dot": 0}
    real_k1, real_dot = dag_kernel.grouped_sums, dag_kernel.grouped_sums_dot

    def k1(*a, **kw):
        calls["k1"] += 1
        return real_k1(*a, **kw)

    def dot(*a, **kw):
        calls["dot"] += 1
        return real_dot(*a, **kw)

    monkeypatch.setattr(dag_kernel, "grouped_sums", k1)
    monkeypatch.setattr(dag_kernel, "grouped_sums_dot", dot)
    return calls


@pytest.mark.parametrize("name", list(QUERIES) + ["rows"])
def test_port_matches_reference_engines(setup, monkeypatch, name):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    db, caps, reg = setup
    dag, region, ranges, read_ts = caps[name]
    ref = tpu_engine.execute_dag(db.store, dag, region, ranges, read_ts).rows()
    host = host_engine.execute_dag(db.store, dag, region, ranges, read_ts).rows()
    calls = _spy(monkeypatch)
    got = gpu_engine.execute_region(reg, _port_dag(dag), _port_ranges(ranges), device="cpu").rows()
    # the host engine emits groups in its own order; the port returns the
    # JAX engine's chunk row for row
    assert sorted(ref, key=repr) == sorted(host, key=repr)
    assert got == ref
    assert len(got) == {"count": 1, "q6": 1, "q10": 20}.get(name, len(got)) > 0
    if name == "rows":
        assert len(got) == int((reg.entry.cols[2][0] < 2).sum())
    # the band DAG reaches grouped_sums (K1) and nothing else does at this size
    assert calls["k1"] == (1 if name == "band" else 0)
    assert calls["dot"] == 0


def test_routes_at_sf1_region_scale(setup):
    """At one SF1 region's padded size (4,194,304 rows) the reference rule
    sends Q1 (B = 12) to the int8 dot and the band query (B = 160) to K1."""
    db, caps, reg = setup
    want = {"q1": "dot", "band": "k1", "count": "eqmask", "q6": "eqmask"}
    for name, route in want.items():
        dag = _port_dag(caps[name][0])
        scan = dag.executors[0]
        bound = Binder(reg.cache, scan.table_id, scan.columns, reg.entry).bind_dag(dag)
        ex = bound.executors[-1]
        from tidb_tpu_torch.expression.expr import AggDesc, expr_from_pb

        got, _doms = dag_kernel.agg_route(
            ex, [expr_from_pb(g) for g in ex.group_by], [AggDesc.from_pb(a) for a in ex.aggs],
            bound.executors[0], 1 << 22, 4096,
        )
        assert got == route, name


def test_dot_route_in_engine_matches_host(setup, monkeypatch):
    """Q1 through the int8 dot inside the engine: lower the reference's
    size gate (2^21 rows) for this region so the small region takes it."""
    db, caps, reg = setup
    dag, region, ranges, read_ts = caps["q1"]
    host = host_engine.execute_dag(db.store, dag, region, ranges, read_ts).rows()
    real_route = dag_kernel.agg_route
    monkeypatch.setattr(dag_kernel, "agg_route", lambda ex, g, a, scan, n, cap: real_route(ex, g, a, scan, 1 << 21, cap))
    monkeypatch.setattr(dag_kernel, "_COMPILE_CACHE", {})
    calls = _spy(monkeypatch)
    got = gpu_engine.execute_region(reg, _port_dag(dag), _port_ranges(ranges), device="cpu").rows()
    assert calls["dot"] == 1 and calls["k1"] == 0
    assert sorted(got, key=repr) == sorted(host, key=repr)


@pytest.mark.parametrize("name", ["q6", "q10", "band"])
def test_partial_ranges_mask_rows(setup, name):
    """Two sub-ranges of the region's handles: the 8-range handle mask."""
    db, caps, reg = setup
    dag, region, _ranges, read_ts = caps[name]
    tid = dag.executors[0].table_id
    from tidb_tpu.kv import tablecodec

    h = reg.entry.handles
    spans = [(int(h[100]), int(h[2000])), (int(h[3000]), int(h[5500]))]
    ref_ranges = [tablecodec.handle_range(tid, lo, hi) for lo, hi in spans]
    host = host_engine.execute_dag(db.store, dag, region, ref_ranges, read_ts).rows()
    port_ranges = [ttc.handle_range(tid, lo, hi) for lo, hi in spans]
    assert port_ranges == _port_ranges(ref_ranges)
    got = gpu_engine.execute_region(reg, _port_dag(dag), port_ranges, device="cpu").rows()
    assert sorted(got, key=repr) == sorted(host, key=repr)


def test_large_rows_buffer_moves_only_live_rows():
    """A selection over a region padded past 65,536 rows: the engine reads
    the meta row first and copies only the live slice to the host."""
    cols = chip_smoke.lineitem_sf1(seed=7, n=70_000)
    (reg, ranges), _ = chip_smoke.make_regions(cols, 100)
    pb = json.load(open(os.path.join(FIXTURES, "q6.json")))
    pb["executors"] = pb["executors"][:2]  # scan → selection only
    dag = carry.dag_from_pb(pb)
    k = dag_kernel.get_kernel(dag, 65536, 4096)
    assert k.kind == "rows" and k.out_n == 65536
    got = gpu_engine.execute_region(reg, dag, ranges, device="cpu")
    qty, price, disc, ship = (cols[i][:35_000] for i in (0, 1, 2, 6))
    m = (ship >= 8766) & (ship < 9131) & (disc >= 5) & (disc <= 7) & (qty < 2400)
    assert [c.data.tolist() for c in got.columns] == [qty[m].tolist(), price[m].tolist(), disc[m].tolist(), ship[m].tolist()]


def test_unported_shapes_raise(setup):
    """Complete mode, once unported, now finalizes on the device: the
    COUNT(*) DAG in complete mode equals the reference engine's."""
    db, caps, reg = setup
    dag, region, ranges, read_ts = caps["count"]
    pb = json.loads(json.dumps(dag.to_pb()))
    pb["executors"][1]["agg_mode"] = "complete"
    want = tpu_engine.execute_dag(db.store, ref_dagpb.DAGRequest.from_pb(pb), region, ranges, read_ts).rows()
    got = gpu_engine.execute_region(reg, carry.dag_from_pb(pb), _port_ranges(ranges), device="cpu").rows()
    assert got == want == [(6000,)]


def test_default_device_raises_without_a_card(setup, monkeypatch):
    db, caps, reg = setup
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dag, _region, ranges, _ts = caps["count"]
    with pytest.raises(RuntimeError, match="cuda"):
        gpu_engine.execute_region(reg, _port_dag(dag), _port_ranges(ranges))


def _port_table(n=200):
    """A port handle (device="cpu") with one table keyed by its handle."""
    import tidb_tpu_torch

    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    db.execute("CREATE TABLE t (id BIGINT PRIMARY KEY, v BIGINT, p DECIMAL(10,2))")
    db.execute("INSERT INTO t VALUES " + ", ".join(f"({i}, {i * 3 % 17}, {i}.25)" for i in range(1, n + 1)))
    return db


def test_gpu_task_counts_the_bytes_it_copies_off_the_card():
    """A ``gpu`` cop task reports the bytes of the program buffers it
    copies to the host (ExecDetails ``d2h_bytes``, the transfer metric,
    EXPLAIN ANALYZE's ``d2h:``), as the reference's device engine does."""
    from tidb_tpu_torch.utils import metrics

    db = _port_table()
    s = db.session()
    before = metrics.DEVICE_TRANSFER.get(dir="d2h")
    for sql in ("SELECT id, v FROM t ORDER BY id DESC LIMIT 3", "SELECT SUM(v), COUNT(*) FROM t WHERE v = 3"):
        s.query(sql)
        assert s.exec_summary.engines == {"gpu": 1}
        assert s.exec_summary.d2h_bytes > 0
    assert metrics.DEVICE_TRANSFER.get(dir="d2h") > before
    lines = [r[0] for r in db.query("EXPLAIN ANALYZE SELECT SUM(v), COUNT(*) FROM t WHERE v = 3")]
    (reader,) = [line for line in lines if "PhysTableReader" in line]
    d2h = reader.split("d2h: ")[1].split("B")[0]
    assert "[gpu]" in reader and int(d2h) > 0
    db.stop_background()


@pytest.mark.parametrize("shape", ["nine_ranges", "descending"])
def test_execute_dag_hands_point_lookups_and_descending_scans_to_host(monkeypatch, shape):
    """A task of more than ``MAX_RANGES`` ranges, or a descending scan,
    runs on the host engine with nothing marked degraded (the reference's
    split, tpu_engine._execute_dag_device); ``execute_region`` still raises
    for a direct caller."""
    from tidb_tpu_torch.copr import host_engine as port_host
    from tidb_tpu_torch.utils import execdetails as ed

    db = _port_table()
    seen = []
    real = gpu_engine._execute_dag_device

    def spy(store, dag, region, ranges, read_ts, warn=None):
        seen.append((store, dag, region, ranges, read_ts))
        return real(store, dag, region, ranges, read_ts, warn)

    monkeypatch.setattr(gpu_engine, "_execute_dag_device", spy)
    db.session().query("SELECT id, v, p FROM t WHERE v >= 3")
    store, dag, region, ranges, read_ts = seen[0]
    tid = dag.executors[0].table_id
    if shape == "nine_ranges":
        ranges = [ttc.handle_range(tid, h, h + 1) for h in (2, 5, 9, 30, 31, 77, 150, 151, 199)]
        assert len(ranges) > dag_kernel.MAX_RANGES
    else:
        pb = dag.to_pb()
        pb["executors"][0]["desc"] = True
        dag = carry.dag_from_pb(pb)
        assert dag.executors[0].desc
    det = ed.CopExecDetails()
    with ed.collecting(det):
        got = gpu_engine.execute_dag(store, dag, region, ranges, read_ts)
    assert not det.degraded
    want = port_host.execute_dag(store, dag, region, ranges, read_ts)
    assert got.rows() == want.rows() and len(got) > 0
    with pytest.raises(UnsupportedForDevice):
        reg = gpu_engine.RegionView(region.region_id, tid, *_entry_of(store, dag, region, read_ts))
        gpu_engine.execute_region(reg, dag, ranges, device="cpu")
    db.stop_background()


def _entry_of(store, dag, region, read_ts):
    from tidb_tpu_torch.copr.colcache import cache_for as port_cache_for
    from tidb_tpu_torch.kv.rowcodec import RowSchema as PortRowSchema

    scan = dag.executors[0]
    cache = port_cache_for(store)
    slots = [c.column_id for c in scan.columns if not c.is_handle]
    entry, _delta = cache.get_split(region, scan.table_id, PortRowSchema(scan.storage_schema), slots, read_ts)
    return entry, cache


def _fixture_pbs():
    db = _lineitem_db(n=600)
    return {name: args[0].to_pb() for name, args in _capture(db).items() if name in QUERIES}


def test_dag_fixtures_match_reference_planner():
    """chip_smoke.py runs the checked-in DAGs; they must be exactly what the
    reference SQL layer sends."""
    for name, pb in _fixture_pbs().items():
        with open(os.path.join(FIXTURES, f"{name}.json")) as f:
            assert json.load(f) == json.loads(json.dumps(pb)), name


if __name__ == "__main__":
    os.makedirs(FIXTURES, exist_ok=True)
    for name, pb in _fixture_pbs().items():
        with open(os.path.join(FIXTURES, f"{name}.json"), "w") as f:
            json.dump(pb, f, indent=1, sort_keys=True)
            f.write("\n")
        print("wrote", name)
