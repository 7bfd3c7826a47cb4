"""Window functions through SQL in the PyTorch port against the reference.

The statements of tests/test_window_device.py and
tests/test_window_pushdown.py run on ``tidb_tpu_torch.open(device="cpu")``
with the ``gpu`` engine and on ``tidb_tpu.open()`` with the ``tpu`` engine,
over the same tables, and on the port's host engine (the WindowExec sweep):
the rows must be equal (integers, decimals and strings exactly, doubles to
a relative 1e-12, since a prefix sum may associate differently). EXPLAIN
shows the window inside the ``[gpu]`` reader wherever the reference shows it
inside ``[tpu]``; the window tasks run on ``gpu`` with none degraded, over
one block, over several blocks as one fused program (``_BLOCK`` shrunk in
both packages), and with the host tail of a table of several regions. The
root ``WindowExec._try_device`` runs with the cost constants zeroed, as the
reference's fixture zeroes them; an unpackable sort past the pack guard
degrades to the host engine; a window read after writes merges the delta
first. Last, the device warnings: ``SHOW WARNINGS`` after a division by
zero on ``gpu`` lists what the reference's ``tpu`` task lists.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import tidb_tpu
import tidb_tpu_torch
from tidb_tpu import config as ref_config
from tidb_tpu.copr import colcache as ref_colcache
from tidb_tpu.copr import tpu_engine
from tidb_tpu.executor.load import bulk_load as ref_bulk_load
from tidb_tpu.ops import window_kernel as ref_wk
from tidb_tpu_torch import config as port_config
from tidb_tpu_torch.copr import colcache as port_colcache
from tidb_tpu_torch.copr import gpu_engine
from tidb_tpu_torch.copr.binder import UnsupportedForDevice
from tidb_tpu_torch.executor.load import bulk_load as port_bulk_load
from tidb_tpu_torch.ops import window_core as wc
from tidb_tpu_torch.ops import window_kernel as wk

FLOAT_REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _device_fill(db, load):
    # tests/test_window_device.py's table: NULL partition keys with non-NULL
    # values and NULL values inside live partitions
    db.execute("CREATE TABLE w (g VARCHAR(4), v BIGINT, x DOUBLE, dv DECIMAL(8,2))")
    rng = np.random.default_rng(13)
    n = 900
    load(db, "w", [
        np.array([b"a", b"b", b"c"], dtype="S1")[rng.integers(0, 3, n)],
        rng.integers(0, 25, n),
        rng.random(n) * 10,
        rng.integers(0, 10000, n),
    ])
    db.execute(
        "INSERT INTO w VALUES (NULL, NULL, NULL, NULL), ('a', NULL, NULL, NULL),"
        " (NULL, 5, 5.0, 5.00), (NULL, 9, 9.0, 9.00)"
    )


def _pushdown_fill(db, load, n=5000, seed=7):
    # tests/test_window_pushdown.py's table
    db.execute("CREATE TABLE w (g VARCHAR(4), v BIGINT, x DOUBLE, d2 DECIMAL(8,2))")
    rng = np.random.default_rng(seed)
    load(db, "w", [
        np.array([b"aa", b"bb", b"cc", b"dd"], dtype="S2")[rng.integers(0, 4, n)],
        rng.integers(-50, 50, n),
        rng.random(n) * 10,
        rng.integers(0, 10000, n),
    ])
    db.execute("INSERT INTO w VALUES (NULL, NULL, NULL, NULL), ('aa', NULL, NULL, NULL)")


def _zero_costs(monkeypatch):
    # the measured cost model always picks the device on tiny data
    for mod in (ref_wk, wk):
        for name in ("DEV_FIXED_S", "H2D_NS_PER_BYTE", "D2H_NS_PER_BYTE", "DEV_ROW_NS_PER_FUNC"):
            monkeypatch.setattr(mod, name, 0.0)
    monkeypatch.setattr(ref_wk, "COMPILE_GATE_ROWS", 0)


@pytest.fixture()
def dev_dbs(monkeypatch):
    _zero_costs(monkeypatch)
    ref, port = tidb_tpu.open(), tidb_tpu_torch.open(device="cpu")
    _device_fill(ref, ref_bulk_load)
    _device_fill(port, port_bulk_load)
    yield ref, port
    ref.stop_background()
    port.stop_background()


def _push_dbs(split=1 << 62, n=5000):
    ref = tidb_tpu.open(region_split_keys=split)
    port = tidb_tpu_torch.open(region_split_keys=split, device="cpu")
    _pushdown_fill(ref, ref_bulk_load, n)
    _pushdown_fill(port, port_bulk_load, n)
    return ref, port


@pytest.fixture()
def push_dbs():
    ref, port = _push_dbs()
    yield ref, port
    ref.stop_background()
    port.stop_background()


def _run(db, sql, engines):
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines = '{engines}'")
    return s.query(sql), s.exec_summary


def _same(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return a == b or math.isclose(a, b, rel_tol=FLOAT_REL, abs_tol=FLOAT_REL)
    return a == b


def _rows_equal(got, want, ordered=True):
    if not ordered:
        got, want = sorted(got, key=repr), sorted(want, key=repr)
    return len(got) == len(want) and all(
        len(r) == len(w) and all(_same(x, y) for x, y in zip(r, w)) for r, w in zip(got, want)
    )


def both(dbs, sql, ordered=True, degraded=False):
    """Port gpu == reference tpu == port host; → the port's gpu summary."""
    ref, port = dbs
    got, summ = _run(port, sql, "gpu,host")
    want, _ = _run(ref, sql, "tpu,host")
    host, _ = _run(port, sql, "host")
    assert _rows_equal(got, want, ordered), (sql, got[:6], want[:6])
    assert _rows_equal(got, host, ordered), (sql, got[:6], host[:6])
    if summ is not None:
        assert set(summ.engines) <= {"gpu", "host"}
        assert bool(summ.degraded) == degraded, summ.degraded
    return summ


def _explain(db, sql, engines):
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines = '{engines}'")
    return "\n".join(str(r[0]) for r in s.query("EXPLAIN " + sql))


def _spy_tasks(monkeypatch):
    """The engine ``stats`` of every port task that carries a window."""
    seen = []
    real = gpu_engine.execute_region

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        st = {} if stats is None else stats
        if gpu_engine._has_window(dag):
            seen.append(st)
        return real(region, dag, ranges, warn, device, st)

    monkeypatch.setattr(gpu_engine, "execute_region", spy)
    return seen


# -- tests/test_window_device.py ----------------------------------------------

DEVICE_QUERIES = {
    "ranking": "SELECT g, v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v),"
    " RANK() OVER (PARTITION BY g ORDER BY v),"
    " DENSE_RANK() OVER (PARTITION BY g ORDER BY v),"
    " PERCENT_RANK() OVER (PARTITION BY g ORDER BY v),"
    " CUME_DIST() OVER (PARTITION BY g ORDER BY v)"
    " FROM w ORDER BY g, v, x",
    "framed_agg": "SELECT g, v, SUM(v) OVER (PARTITION BY g ORDER BY v),"
    " COUNT(v) OVER (PARTITION BY g ORDER BY v),"
    " AVG(x) OVER (PARTITION BY g ORDER BY v)"
    " FROM w ORDER BY g, v, x",
    "whole_partition": "SELECT g, SUM(v) OVER (PARTITION BY g), MIN(v) OVER (PARTITION BY g),"
    " MAX(dv) OVER (PARTITION BY g), COUNT(*) OVER (PARTITION BY g)"
    " FROM w ORDER BY g, v, x",
    "bounded_rows": "SELECT v, SUM(v) OVER (PARTITION BY g ORDER BY v, x"
    " ROWS BETWEEN 2 PRECEDING AND 1 FOLLOWING)"
    " FROM w ORDER BY g, v, x",
    "rows_unbounded_current": "SELECT v, SUM(v) OVER (PARTITION BY g ORDER BY v, x"
    " ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW)"
    " FROM w ORDER BY g, v, x",
    "lead_lag_ntile_first_last": "SELECT v, LEAD(v, 2) OVER (PARTITION BY g ORDER BY v, x),"
    " LAG(v, 1, -7) OVER (PARTITION BY g ORDER BY v, x),"
    " NTILE(4) OVER (PARTITION BY g ORDER BY v, x),"
    " FIRST_VALUE(v) OVER (PARTITION BY g ORDER BY v, x),"
    " LAST_VALUE(v) OVER (PARTITION BY g ORDER BY v, x)"
    " FROM w ORDER BY g, v, x",
    "cumulative_min_max": "SELECT v, MIN(v) OVER (PARTITION BY g ORDER BY v, x"
    " ROWS BETWEEN UNBOUNDED PRECEDING AND CURRENT ROW),"
    " MAX(x) OVER (PARTITION BY g ORDER BY v, x)"
    " FROM w ORDER BY g, v, x",
    "no_partition": "SELECT v, RANK() OVER (ORDER BY v), SUM(v) OVER (ORDER BY v) FROM w ORDER BY v, x",
    "desc_order": "SELECT g, v, RANK() OVER (PARTITION BY g ORDER BY v DESC),"
    " SUM(v) OVER (PARTITION BY g ORDER BY v DESC),"
    " CUME_DIST() OVER (PARTITION BY g ORDER BY x DESC)"
    " FROM w ORDER BY g, v, x",
    "null_partition_extent": "SELECT v, LAST_VALUE(v) OVER (PARTITION BY g ORDER BY v"
    " ROWS BETWEEN UNBOUNDED PRECEDING AND UNBOUNDED FOLLOWING),"
    " CUME_DIST() OVER (ORDER BY v) FROM w ORDER BY g, v, x",
}


@pytest.mark.parametrize("name", list(DEVICE_QUERIES))
def test_device_window_parity(dev_dbs, monkeypatch, name):
    tasks = _spy_tasks(monkeypatch)
    summ = both(dev_dbs, DEVICE_QUERIES[name])
    assert tasks and all(t["path"] == "single" for t in tasks), tasks
    assert summ.engines == {"gpu": len(tasks)}


def test_window_pushes_into_reader(dev_dbs):
    ref, port = dev_dbs
    sql = "SELECT SUM(v) OVER (PARTITION BY g ORDER BY v) FROM w"
    want = _explain(ref, sql, "tpu,host")
    got = _explain(port, sql, "gpu,host")
    assert "Window(" in want and "[tpu]" in want, want
    assert got == want.replace("[tpu]", "[gpu]"), (got, want)
    plan = _explain(port, sql, "host")
    assert "Window(" not in plan.split("\n")[-1], plan  # host: the window stays at the root


def test_root_device_path_engages(dev_dbs, monkeypatch):
    """Two OVER specs: the second window's child is the already-windowed
    reader, so it stays at the root, where WindowExec._try_device serves
    it (once in each package)."""
    calls = {"ref": 0, "port": 0}
    for key, mod in (("ref", ref_wk), ("port", wk)):
        real = mod.get_window_fn

        def spy(spec, n_pad, bounds=None, _real=real, _key=key):
            calls[_key] += 1
            return _real(spec, n_pad, bounds)

        monkeypatch.setattr(mod, "get_window_fn", spy)
    sql = "SELECT SUM(v) OVER (PARTITION BY g ORDER BY v), RANK() OVER (PARTITION BY g ORDER BY x) FROM w"
    both(dev_dbs, sql, ordered=False)
    assert calls == {"ref": 1, "port": 1}


# (statement, its OVER specs: one root window each)
ROOT_QUERIES = {
    # a window over an aggregate (the smoke's rootwin shape)
    "over_agg": ("SELECT k, s, RANK() OVER (ORDER BY s DESC) FROM"
                 " (SELECT v AS k, SUM(dv) AS s FROM w GROUP BY v) t ORDER BY k", 1),
    "over_agg_partitioned": ("SELECT k, c, ROW_NUMBER() OVER (PARTITION BY c ORDER BY k DESC),"
                             " SUM(k) OVER (PARTITION BY c ORDER BY k), AVG(m) OVER (PARTITION BY c)"
                             " FROM (SELECT v AS k, COUNT(*) AS c, MAX(x) AS m FROM w GROUP BY v) t ORDER BY k", 3),
}


@pytest.mark.parametrize("name", list(ROOT_QUERIES))
def test_root_window_over_an_aggregate(dev_dbs, monkeypatch, name):
    sql, n_windows = ROOT_QUERIES[name]
    calls = []
    real = wk.get_window_fn
    monkeypatch.setattr(wk, "get_window_fn", lambda *a: calls.append(a) or real(*a))
    both(dev_dbs, sql)
    assert len(calls) == n_windows
    # with the measured costs a few dozen rows stay on the host sweep
    monkeypatch.undo()
    del calls[:]
    monkeypatch.setattr(wk, "get_window_fn", lambda *a: calls.append(a) or real(*a))
    both(dev_dbs, sql)
    assert calls == []


def test_root_window_stays_on_host_without_the_gpu_engine(dev_dbs, monkeypatch):
    _ref, port = dev_dbs
    monkeypatch.setattr(wk, "get_window_fn", lambda *a: pytest.fail("device window under 'host'"))
    _run(port, ROOT_QUERIES["over_agg"][0], "host")


# -- tests/test_window_pushdown.py --------------------------------------------

WIN_AGG = (
    "SELECT g, MAX(rn), MAX(cum) FROM ("
    " SELECT g, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn,"
    " SUM(v) OVER (PARTITION BY g ORDER BY v) AS cum"
    " FROM w WHERE v > -20) t GROUP BY g ORDER BY g"
)
WIN_ROWS = (
    "SELECT g, v, RANK() OVER (PARTITION BY g ORDER BY v DESC),"
    " AVG(d2) OVER (PARTITION BY g) FROM w WHERE v < 30 ORDER BY g, v, x"
)


def test_pushdown_parity_single_block(push_dbs, monkeypatch):
    tasks = _spy_tasks(monkeypatch)
    both(push_dbs, WIN_AGG)
    both(push_dbs, WIN_ROWS, ordered=False)
    assert [t["path"] for t in tasks] == ["single", "single"], tasks


def test_agg_fuses_into_reader(push_dbs):
    ref, port = push_dbs
    want = _explain(ref, WIN_AGG, "tpu,host")
    got = _explain(port, WIN_AGG, "gpu,host")
    assert "Window(" in got and "PartialAgg(" in got and "WindowExec" not in got, got
    assert got == want.replace("[tpu]", "[gpu]"), (got, want)


def test_multiblock_fused_program(push_dbs, monkeypatch):
    # 5,002 rows in blocks of 1,024: one program over every block
    monkeypatch.setattr(tpu_engine, "_BLOCK", 1 << 10)
    monkeypatch.setattr(gpu_engine, "_BLOCK", 1 << 10)
    tasks = _spy_tasks(monkeypatch)
    both(push_dbs, WIN_AGG)
    both(push_dbs, WIN_ROWS, ordered=False)
    assert [t["path"] for t in tasks] == ["fused", "fused"], tasks


def test_multi_region_falls_back_to_host_tail(monkeypatch):
    ref, port = _push_dbs(split=512, n=3000)
    tasks = _spy_tasks(monkeypatch)
    both((ref, port), WIN_AGG, ordered=False)
    assert tasks == []  # the reader's tasks carry no window: the root runs it
    ref.stop_background()
    port.stop_background()


def test_string_order_key_pushes_with_sorted_dict(push_dbs, monkeypatch):
    tasks = _spy_tasks(monkeypatch)
    both(
        push_dbs,
        "SELECT v, RANK() OVER (ORDER BY g), DENSE_RANK() OVER (PARTITION BY g ORDER BY g)"
        " FROM w ORDER BY g, v, x",
    )
    assert tasks


def test_window_then_topn_pushdown(push_dbs, monkeypatch):
    tasks = _spy_tasks(monkeypatch)
    both(
        push_dbs,
        "SELECT * FROM (SELECT v, ROW_NUMBER() OVER (PARTITION BY g ORDER BY v) AS rn"
        " FROM w) t ORDER BY rn, v LIMIT 7",
    )
    assert tasks


def _strict_guard(bound, n):
    """The pack guard with no small-n exemption: any unpackable window sort
    raises, forcing the host engine even on tiny test tables."""
    from tidb_tpu_torch.copr import dagpb

    for ex in bound.executors[1:]:
        if ex.tp == dagpb.WINDOW:
            sb = [tuple(b) if b is not None else None for b in ex.sort_bounds] or None
            if wc.packed_bits(sb, max(n, 1)) is None:
                raise UnsupportedForDevice("unpackable (strict test guard)")


def test_unpackable_sort_falls_back(push_dbs, monkeypatch):
    # float order keys carry no integer bounds; past the pack guard the task
    # is the host engine's, recorded as degraded
    import test_window_pushdown as ref_tests

    monkeypatch.setattr(tpu_engine, "_window_pack_guard", ref_tests._strict_guard)
    monkeypatch.setattr(gpu_engine, "_window_pack_guard", _strict_guard)
    summ = both(push_dbs, "SELECT v, RANK() OVER (PARTITION BY g ORDER BY x) FROM w ORDER BY g, v, x",
                degraded=True)
    assert "unpackable (strict test guard)" in str(summ.degraded)


def test_pack_guard_matches_reference_at_scale():
    """The real guard: exempt up to 2^20 rows, then a sort must pack."""
    from tidb_tpu.copr import dagpb as ref_dagpb
    from tidb_tpu_torch.copr import dagpb

    for n, bounds in ((1 << 20, [None]), ((1 << 20) + 1, [None]), (6_001_215, [(0, 3), (0, 1 << 24)]),
                      (6_001_215, [(0, 1 << 30), (0, 1 << 30)])):
        outcome = []
        for mod, guard in ((ref_dagpb, tpu_engine._window_pack_guard), (dagpb, gpu_engine._window_pack_guard)):
            ex = mod.ExecutorPB(tp=mod.WINDOW)
            ex.sort_bounds = bounds
            dag = mod.DAGRequest(executors=[mod.ExecutorPB(tp=mod.TABLE_SCAN), ex])
            try:
                guard(dag, n)
                outcome.append("device")
            except Exception as e:  # each package's own UnsupportedForDevice
                assert type(e).__name__ == "UnsupportedForDevice"
                outcome.append("host")
        assert outcome[0] == outcome[1], (n, bounds, outcome)


# -- a window read after writes -----------------------------------------------


def test_window_after_writes_merges_the_delta_first(monkeypatch):
    knobs = {"device_delta_cap": 64, "device_delta_merge_rows": 8, "device_delta_min_rows": 1}
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "_CURRENT", dataclasses.replace(cfg.current(), **knobs))
    for mod in (ref_colcache, port_colcache):
        monkeypatch.setattr(mod, "DEVICE_BLOCK_ROWS", 1 << 10)
    for mod in (tpu_engine, gpu_engine):
        monkeypatch.setattr(mod, "_BLOCK", 1 << 10)
    ref, port = _push_dbs()
    plain = "SELECT COUNT(*), SUM(v) FROM w"
    for db in (ref, port):
        db.query(WIN_AGG)
        db.execute("UPDATE w SET v = v + 7 WHERE v = 1 AND x < 2")
        db.execute("DELETE FROM w WHERE v = -3 AND x < 3")
        db.execute("INSERT INTO w VALUES ('aa', 41, 1.5, 2.25), ('ee', -19, NULL, 3.00)")
        db.query(plain)  # a plain read builds the delta and leaves it pending
    assert port_colcache.cache_for(port.store).delta_rows_pending() > 0
    tasks = _spy_tasks(monkeypatch)
    summ = both((ref, port), WIN_AGG)
    (st,) = tasks
    assert st["path"] == "fused" and st["delta_rows"] == 0 and summ.delta_rows == 0
    assert port_colcache.cache_for(port.store).delta_rows_pending() == 0  # merged first
    both((ref, port), WIN_ROWS, ordered=False)
    ref.stop_background()
    port.stop_background()


def test_execute_region_refuses_a_window_with_a_delta(push_dbs):
    _ref, port = push_dbs
    from tidb_tpu_torch.copr import dagpb
    from tidb_tpu_torch.copr.colcache import DeltaOverlay

    dag = dagpb.DAGRequest(executors=[dagpb.ExecutorPB(tp=dagpb.TABLE_SCAN), dagpb.ExecutorPB(tp=dagpb.WINDOW)])
    dag.executors[0].table_id = 7
    region = gpu_engine.RegionView(1, 7, entry=None, cache=None,
                                   delta=DeltaOverlay(np.array([1]), np.array([False]), 1, 1))
    with pytest.raises(ValueError, match="no delta operand"):
        gpu_engine.execute_region(region, dag, [], device="cpu")


# -- device warnings (division by zero) ---------------------------------------

WARN_QUERIES = [
    "SELECT COUNT(*) FROM w WHERE v / (v - v) > 1",
    "SELECT g, SUM(v DIV (v - v)), COUNT(*) FROM w GROUP BY g ORDER BY g",
    "SELECT COUNT(*) FROM w WHERE v % 0 IS NULL",
    "SELECT v, x / (v - v) FROM w WHERE v < -45 ORDER BY v, x LIMIT 5",
    "SELECT COUNT(*) FROM w WHERE v / 2 > 10",  # no warning
]


@pytest.mark.parametrize("sql", WARN_QUERIES)
def test_division_by_zero_warnings_match_the_reference(push_dbs, sql):
    ref, port = push_dbs
    shown = {}
    for key, db, engines in (("ref", ref, "tpu"), ("port", port, "gpu"), ("host", port, "host")):
        s = db.session()
        s.execute(f"SET tidb_isolation_read_engines = '{engines}'")
        rows = s.query(sql)
        summ = s.exec_summary
        shown[key] = (rows, s.query("SHOW WARNINGS"), summ)
    assert _rows_equal(shown["port"][0], shown["ref"][0])
    assert shown["port"][1] == shown["ref"][1], (shown["port"][1][:3], shown["ref"][1][:3])
    assert shown["port"][2].engines == {"gpu": 1} and not shown["port"][2].degraded
    assert {w[1] for w in shown["port"][1]} == {w[1] for w in shown["host"][1]}


def test_smoke_window_statements_plan_as_the_reference():
    """chip_smoke's WINDOW_QUERIES: ``win`` is bench.py's WINDOWED verbatim,
    and at one region every statement but ``rootwin`` plans its window
    inside the [gpu] reader exactly where the reference plans it inside
    [tpu]; ``rootwin``'s stays on the root in both."""
    import bench
    import chip_smoke
    from tidb_tpu.kv.tablecodec import record_key as ref_record_key
    from tidb_tpu_torch.kv.tablecodec import record_key as port_record_key

    assert chip_smoke.WINDOW_QUERIES["win"] == bench.WINDOWED
    cols = chip_smoke.lineitem_sf1(seed=2, n=3000)
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(ref, ref_bulk_load, ref_record_key, cols, parts=1)
    chip_smoke.lineitem_sql(port, port_bulk_load, port_record_key, cols, parts=1)
    for name, sql in chip_smoke.WINDOW_QUERIES.items():
        want = _explain(ref, sql, "tpu,host")
        got = _explain(port, sql, "gpu,host")
        assert got == want.replace("[tpu]", "[gpu]"), (name, got, want)
        reader = [ln for ln in got.split("\n") if "PhysTableReader" in ln]
        assert reader and all("[gpu]" in ln for ln in reader), (name, got)
        assert ("Window(" in got) == (name != chip_smoke.WINDOW_ROOT), (name, got)
        assert _rows_equal(_run(port, sql, "gpu,host")[0], _run(ref, sql, "tpu,host")[0]), name
    ref.stop_background()
    port.stop_background()
