"""Each metric reader's arithmetic on synthetic records, and the trace's
reduction of device intervals."""

import numpy as np
import pytest

from cudabench import records, trace
from cudabench.records import Run, Stmt, Trace


def _run(trace_=None):
    s = [
        Stmt(0, 0, "q1", 10.0, 10.1, cop_tasks=3, max_proc_ms=60.0),
        Stmt(1, 1, "q6", 10.0, 10.02, cop_tasks=3, max_proc_ms=10.0),
        Stmt(0, 2, "q3", 10.1, 10.14, gathers=1, gather_ms=30.0, exchange_bytes=2_000_000),
        Stmt(1, 1, "q6", 10.02, 10.05, error="boom"),  # failed: not done
        Stmt(1, 0, "q1", 10.05, 12.5, cop_tasks=3, max_proc_ms=1.0),  # ends after the window
    ]
    return Run(setup_s=42.0, t_start=10.0, t_end=12.0, stmts=s, builds={"cop": 1, "mpp": 2},
               stmt_bytes={0: 3.35e9, 1: 0.0, 2: 3.35e9}, hbm_bytes_per_s=3.35e12, trace=trace_)


def test_end_to_end_readers():
    run = _run()
    assert records.reader("stmt_per_s")(run) == pytest.approx(3 / 2.0)
    assert records.reader("setup_s")(run) == 42.0


def test_layer_readers():
    run = _run()
    assert records.reader("session.tax_ms.agg")(run) == pytest.approx(((100 - 60) + (20 - 10)) / 2)
    assert records.reader("copr.task_ms")(run) == pytest.approx(35.0)
    assert records.reader("session.tax_ms.joins")(run) == pytest.approx(10.0)
    assert records.reader("mpp.gather_ms")(run) == pytest.approx(30.0)
    assert records.reader("mpp.exchange_mb")(run) == pytest.approx(2.0)
    for tail in ("sql.lat_p95_ms.agg", "sql.lat_p95_ms.joins"):
        assert records.reader(tail)(run) == pytest.approx(np.percentile([100.0, 20.0, 40.0], 95))
    assert records.reader("ops.builds_in_window")(run) == 3.0
    assert records.reader("kernels.hbm_roofline")(run) is None  # untraced: nothing to read
    assert records.reader("device.idle_share")(run) is None


def test_trace_readers():
    run = _run(Trace(busy_s=0.5, window_s=2.0))
    # two statements' 3.35 GB each at 3.35 TB/s is 2 ms against 0.5 s busy
    assert records.reader("kernels.hbm_roofline")(run) == pytest.approx(0.4)
    assert records.reader("device.idle_share")(run) == pytest.approx(0.75)


def test_percentile_is_numpys_linear():
    v = list(np.random.default_rng(3).random(101))
    assert records.percentile(v, 95) == pytest.approx(np.percentile(v, 95))
    assert records.percentile([], 95) is None


def test_busy_union_merges_and_clips():
    s = np.array([0, 5, 6, 20, 40])
    e = np.array([10, 8, 12, 25, 50])
    bs, be = trace.busy_union(s, e, 2, 45)
    assert bs.tolist() == [2, 20, 40] and be.tolist() == [12, 25, 45]


def test_summarize_names_the_gaps_by_host_activity():
    class Spans:
        gather = [(1.0, 1.5)]
        cop = [(2.0, 2.5)]

    ns = 10**9
    stmts = [Stmt(0, 0, "q3", 0.9, 1.8), Stmt(0, 1, "q1", 1.9, 2.9)]
    events = (np.array([int(1.6 * ns), int(2.6 * ns)]), np.array([int(1.7 * ns), int(2.7 * ns)]), ["k1", "k2"])
    t = trace.summarize(events, 1 * ns, 3 * ns, stmts, Spans, 0)
    assert t.busy_s == pytest.approx(0.2) and t.window_s == pytest.approx(2.0)
    assert dict(t.device_ops) == pytest.approx({"k1": 0.1, "k2": 0.1})
    gaps = dict(t.idle_gaps)
    # [1.0, 1.6) mid 1.3: q3 in a gather; [1.7, 2.6) mid 2.15: q1 in a cop task; [2.7, 3.0) mid 2.85: q1 on the host
    assert gaps == pytest.approx({"q3:gather": 0.6, "q1:cop": 0.9, "q1:host": 0.3})
