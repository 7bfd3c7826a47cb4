"""The port's SQL front (``tidb_tpu_torch.open``) held against the reference.

A 20,000-row lineitem from ``chip_smoke.lineitem_sf1`` is bulk-loaded into
``tidb_tpu.open()`` and ``tidb_tpu_torch.open(device="cpu")`` with the same
region split (one region, and three at equal handle counts). The seven
statements of ``chip_smoke.SQL_QUERIES`` run on the port's ``gpu`` engine
(every kernel's plain version on the CPU) and must equal the reference's
``host`` and ``tpu`` engines row for row, decimals exact, with every cop
task on ``gpu`` and none degraded. Further cases: the band query's route,
an INSERT read back and an older snapshot that keeps its result, the
planner's legality gate, a window on the root.

The reference ``tpu`` engine reaches its Pallas kernel on the band query,
which needs ``jax.experimental.enable_x64`` (gone from this jax); the
comparisons patch it in from ``jax.enable_x64`` for the test's duration.
"""

import os
import sys

import jax
import jax.experimental
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402
import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv.tablecodec import record_key as ref_record_key  # noqa: E402
from tidb_tpu_torch import config as port_config  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.copr.colcache import cache_for  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.expression import eval as port_eval  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key  # noqa: E402

import test_torch_engine as te  # noqa: E402

N_ROWS = 20_000
SQL = chip_smoke.SQL_QUERIES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The statements are small; one intra-op thread keeps this module from
    loading every core of the machine the other test workers share."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def x64_shim(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


@pytest.fixture(scope="module")
def cols():
    return chip_smoke.lineitem_sf1(seed=5, n=N_ROWS)


def _open_pair(cols, parts):
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    chip_smoke.lineitem_sql(ref, ref_bulk_load, ref_record_key, cols, parts)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(port, bulk_load, record_key, cols, parts)
    assert len(port.store.regions()) == len(ref.store.regions()) == parts
    return ref, port


@pytest.fixture(scope="module", params=[1, 3], ids=["one_region", "three_regions"])
def dbs(request, cols):
    ref, port = _open_pair(cols, request.param)
    yield ref, port, request.param
    ref.stop_background()
    port.stop_background()


def _ref_rows(ref, sql, engine):
    s = ref.session()
    s.execute(f"SET tidb_isolation_read_engines='{engine}'")
    return s.query(sql)


def _port_run(port, sql):
    """(rows, the statement's cop-task summary)."""
    s = port.session()
    rows = s.query(sql)
    return rows, s.exec_summary


def test_statements_are_the_reference_benchs():
    """COUNT(*), Q6, Q1 and Q10 are bench.py's texts; band and q15rev are
    the SQL of the DAG fixtures the engine tests capture."""
    assert [SQL[k] for k in ("count", "q6", "q1", "q10")] == [bench.COUNT_STAR, bench.Q6, bench.Q1, bench.Q10]
    assert SQL["band"] == te.QUERIES["band"] and SQL["q15rev"] == te.QUERIES["q15rev"]


@pytest.mark.parametrize("name", list(SQL))
def test_sql_matches_reference_engines(x64_shim, dbs, cols, name):
    ref, port, parts = dbs
    got, summ = _port_run(port, SQL[name])
    assert summ.engines == {"gpu": parts}
    assert summ.degraded == {}
    got = chip_smoke.sql_rows(name, got)
    assert got == chip_smoke.sql_rows(name, _ref_rows(ref, SQL[name], "host"))
    assert got == chip_smoke.sql_rows(name, _ref_rows(ref, SQL[name], "tpu"))
    assert got == chip_smoke.sql_oracle(name, cols)
    plan = "\n".join(r[0] for r in port.query("EXPLAIN " + SQL[name]))
    assert "[gpu]" in plan and "[host]" not in plan


def test_band_query_takes_the_k1_route(monkeypatch, dbs):
    """The binder's dictionaries, built from the loaded data, hold the 7
    ship modes, 4 instructions and 3 return flags: B = 8 * 5 * 4 = 160
    buckets (a NULL slot per key), inside K1's 64 < B <= 512, so every
    region's task takes the K1 route."""
    _ref, port, parts = dbs
    routes = []
    real = gpu_engine.get_kernel

    def spy(*a, **k):
        kernel = real(*a, **k)
        routes.append(kernel.routes)
        return kernel

    monkeypatch.setattr(gpu_engine, "get_kernel", spy)
    _port_run(port, SQL["band"])
    assert routes == [("k1",)] * parts
    tid = port.catalog.table("test", "lineitem").id
    cache = cache_for(port.store)
    sizes = [len(cache.dictionary(tid, slot)) for slot in (7, 8, 4)]
    assert sizes == [len(chip_smoke.SHIPMODES), len(chip_smoke.SHIPINSTRUCTS), len(chip_smoke.RETURNFLAGS)]
    assert 64 < np.prod([s + 1 for s in sizes]) <= 512


# two new rows (the next handles: the last region) and new quantities for
# the first orders' lines (the first region's leading rows, changed in place)
_WRITES = (
    "INSERT INTO lineitem VALUES (17.00, 25500.00, 0.04, 0.02, 'R', 'F', DATE '1994-03-05', "
    "'AIR', 'NONE', 7, 3, 1, DATE '1994-02-10', DATE '1994-03-20'), (3.00, 4500.00, 0.06, 0.00, 'N', 'O', "
    "DATE '1997-01-09', 'MAIL', 'COLLECT COD', 8, 4, 2, DATE '1996-12-20', DATE '1997-01-30')",
    "UPDATE lineitem SET l_quantity = l_quantity + 1 WHERE l_orderkey <= 40",
)


@pytest.mark.parametrize("delta_min_rows", [1000, None], ids=["delta", "rebuild"])
def test_insert_read_back_and_older_snapshot(monkeypatch, cols, delta_min_rows):
    """After a first read, an INSERT (and an UPDATE) is read back by the
    next query on gpu, with no task degraded: where the cache carries the
    changes as a delta on the pinned entry (a table past
    ``device_delta_min_rows``) the program folds the delta operand in, and
    a smaller table rebuilds its entry. A transaction whose snapshot came
    before the writes keeps its result: its entry, built at the older
    snapshot, never shares the device copies of the rebuilt head."""
    if delta_min_rows is not None:
        monkeypatch.setattr(port_config, "_CURRENT", port_config.Config(device_delta_min_rows=delta_min_rows))
    ref, port = _open_pair(cols, 2)
    reader = port.session()
    reader.execute("BEGIN")
    before = reader.query(SQL["q1"])
    first, summ = _port_run(port, SQL["q1"])
    assert first == before and summ.engines == {"gpu": 2}
    for sql in _WRITES:
        port.execute(sql)
        ref.execute(sql)
    after, summ = _port_run(port, SQL["q1"])
    assert after == _ref_rows(ref, SQL["q1"], "host") != before
    assert summ.engines == {"gpu": 2} and summ.degraded == {}
    # the INSERT lands in the last region, the UPDATE in the first
    assert (summ.delta_rows > 0) == (delta_min_rows is not None)
    assert reader.query(SQL["q1"]) == before
    assert reader.exec_summary.engines == {"gpu": 2}
    reader.execute("COMMIT")
    for s in (ref, port):
        s.stop_background()


def test_analyze_then_explain_analyze(x64_shim, cols):
    """ANALYZE TABLE builds the port's statistics; EXPLAIN ANALYZE runs the
    band query and reports its cop tasks on the gpu engine; the statements
    still equal the reference after ANALYZE on both sides."""
    ref, port = _open_pair(cols, 2)
    for db in (ref, port):
        db.execute("ANALYZE TABLE lineitem")
    lines = [r[0] for r in port.query("EXPLAIN ANALYZE " + SQL["band"])]
    (reader,) = [line for line in lines if "PhysTableReader" in line]
    assert "[gpu]" in reader and "engine: gpu×2" in reader
    for name in ("q1", "q10"):
        got, summ = _port_run(port, SQL[name])
        assert summ.engines == {"gpu": 2}
        assert got == _ref_rows(ref, SQL[name], "host") == chip_smoke.sql_oracle(name, cols)
    for db in (ref, port):
        db.stop_background()


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT COUNT(*), SUM(l_quantity) FROM lineitem WHERE bit_count(l_orderkey) > 9 AND LENGTH(l_shipmode) > 2",
        "SELECT l_returnflag, COUNT(*) FROM lineitem WHERE l_suppkey % 7 = 3 AND UPPER(l_shipinstruct) <> 'X' "
        "GROUP BY l_returnflag",
    ],
    ids=["bit_count", "mod_eq"],
)
def test_device_illegal_builtin_is_planned_to_host(x64_shim, dbs, sql):
    """BIT_COUNT and % are device-legal; the string builtin beside each
    (LENGTH, UPPER: host-only, as in the reference) holds the whole
    fragment on the host engine, with nothing marked degraded."""
    ref, port, parts = dbs
    plan = "\n".join(r[0] for r in port.query("EXPLAIN " + sql))
    assert "[host]" in plan and "[gpu]" not in plan
    got, summ = _port_run(port, sql)
    assert summ.engines == {"host": parts} and summ.degraded == {}
    got = sorted(got, key=repr)
    assert got == sorted(_ref_rows(ref, sql, "host"), key=repr)
    assert got == sorted(_ref_rows(ref, sql, "tpu"), key=repr)


_WINDOW = """SELECT l_returnflag, MAX(rn), MAX(cum) FROM (
    SELECT l_returnflag,
           ROW_NUMBER() OVER (PARTITION BY l_returnflag ORDER BY l_extendedprice, l_orderkey, l_linenumber) AS rn,
           SUM(l_quantity) OVER (PARTITION BY l_returnflag ORDER BY l_extendedprice, l_orderkey, l_linenumber) AS cum
    FROM lineitem WHERE l_shipdate < DATE '1994-01-01') t
    GROUP BY l_returnflag ORDER BY l_returnflag"""


def test_window_runs_on_the_root(x64_shim, dbs, monkeypatch):
    """The window pushes into the [gpu] reader as the reference's into
    [tpu]; over several regions its tasks carry no window and it runs on
    the root (the cop client's host tail), at one region inside the task."""
    ref, port, parts = dbs
    plan = "\n".join(str(r[0]) for r in port.query("EXPLAIN " + _WINDOW))
    assert plan == "\n".join(str(r[0]) for r in ref.query("EXPLAIN " + _WINDOW)).replace("[tpu]", "[gpu]")
    assert "[gpu]" in plan and "Window(" in plan
    windowed = []
    real = gpu_engine.execute_region

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        windowed.append(gpu_engine._has_window(dag))
        return real(region, dag, ranges, warn, device, stats)

    monkeypatch.setattr(gpu_engine, "execute_region", spy)
    got, summ = _port_run(port, _WINDOW)
    assert summ.engines == {"gpu": parts} and not summ.degraded
    assert windowed == [parts == 1] * parts
    assert got == _ref_rows(ref, _WINDOW, "host") == _ref_rows(ref, _WINDOW, "tpu")


def test_bit_count_torch_matches_numpy():
    """The port's two popcounts (numpy for the host, SWAR for torch) over
    two's-complement int64, MySQL's BIT_COUNT(-1) = 64 included."""
    rng = np.random.default_rng(3)
    vals = np.concatenate(
        [np.array([0, 1, -1, 2**63 - 1, -(2**63), 255, -256], dtype=np.int64), rng.integers(-(2**63), 2**63 - 1, 500)]
    )
    want = np.array([bin(int(v) & (2**64 - 1)).count("1") for v in vals])
    got_np, _ = port_eval._bit_count(np, [(vals, None)], None)
    got_t, _ = port_eval._bit_count(torch, [(torch.from_numpy(vals), None)], None)
    assert np.array_equal(got_np, want)
    assert np.array_equal(got_t.numpy(), want)
