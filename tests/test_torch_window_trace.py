"""The port's window recorder (``utils/tracing.start_window`` /
``stop_window``) and the phase spans inside its two device paths, on a
``device="cpu"`` store: a TPC-H Q1 over three regions (the cop fan-out and
the gpu engine's ``cop.*`` phases) and the MPP q3 (the gather's ``mpp.*``
phases), with the recorder off, on, and under ``TRACE``.
"""

import os
import sys
import time
import types

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key  # noqa: E402
from tidb_tpu_torch.utils import execdetails, tracing  # noqa: E402

COP_PHASES = ("cop.snapshot", "cop.bind", "cop.inputs", "cop.program", "cop.issue", "cop.sync", "cop.decode")
MPP_PHASES = ("mpp.prepare", "mpp-inputs", "mpp.program", "mpp.issue", "mpp.drain", "mpp.merge")
N_LINE, N_PART, N_CUST = 20_000, 2_000, 1_500
Q1 = chip_smoke.SQL_QUERIES["q1"]
Q3 = chip_smoke.MPP_QUERIES["q3"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def no_window_left():
    yield
    if tracing.window() is not None:
        tracing.stop_window()


@pytest.fixture(scope="module")
def cols():
    return chip_smoke.lineitem_sf1(5, n=N_LINE)


@pytest.fixture(scope="module")
def lineitem(cols):
    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(db, bulk_load, record_key, cols, parts=3)
    s = db.session()
    s.query(Q1)  # builds the programs
    yield db
    db.stop_background()


@pytest.fixture(scope="module")
def star(cols):
    partkey = np.random.default_rng(9).integers(1, N_PART + 1, N_LINE)
    tables = chip_smoke.mpp_tables(cols, partkey, 5, n_part=N_PART, n_cust=N_CUST)
    db = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.mpp_sql(db, bulk_load, tables)
    db.session().query(Q3)
    yield db
    db.stop_background()


def windowed(session, sql):
    tracing.start_window()
    try:
        rows = session.query(sql)
    finally:
        win = tracing.stop_window()
    return rows, win


def ancestors(span, by_id):
    out = []
    while span.parent_id:
        span = by_id[span.parent_id]
        out.append(span)
    return out


def test_off_records_nothing_and_hands_back_the_shared_null_span(lineitem, monkeypatch):
    made = []

    class Counting(tracing.Span):
        def __init__(self, *a, **k):
            made.append(a)
            super().__init__(*a, **k)

    def no_clock(*_a):
        raise AssertionError("a seam read a clock with nothing recording")

    clock = types.SimpleNamespace(**{k: getattr(time, k) for k in dir(time) if not k.startswith("__")})
    clock.perf_counter_ns = clock.thread_time_ns = no_clock
    monkeypatch.setattr(tracing, "Span", Counting)
    monkeypatch.setattr(tracing, "time", clock)
    assert tracing.window() is None
    assert execdetails.trace_span("cop.bind") is tracing.NULL_SPAN
    assert lineitem.session().span("plan") is tracing.NULL_SPAN
    rows = lineitem.session().query(Q1)
    assert rows and made == []
    # and a window started after the statement holds none of its spans
    monkeypatch.undo()
    tracing.start_window()
    assert tracing.stop_window().spans == []


def test_each_cop_task_has_its_seven_phases_in_order(lineitem):
    s = lineitem.session()
    rows, win = windowed(s, Q1)
    assert rows == s.query(Q1)
    by_id = {sp.span_id: sp for sp in win.spans}
    (root,) = [sp for sp in win.spans if sp.name == "statement"]
    assert root.parent_id == 0 and root.root_id == root.span_id
    tasks = [sp for sp in win.spans if sp.name.startswith("cop.r")]
    assert len(tasks) == 3 == s.exec_summary.num
    for task in tasks:
        assert ancestors(task, by_id)[-1] is root and task.root_id == root.span_id
        leaves = sorted(
            (sp for sp in win.spans if sp.name in COP_PHASES and task in ancestors(sp, by_id)),
            key=lambda sp: sp.start_ns,
        )
        first = list(dict.fromkeys(sp.name for sp in leaves))
        assert first == list(COP_PHASES)
        for a, b in zip(leaves, leaves[1:]):
            if a.thread == b.thread:
                assert a.end_ns <= b.start_ns  # leaves never overlap on their thread
        for sp in leaves:
            assert task.start_ns <= sp.start_ns <= sp.end_ns <= task.end_ns
            assert 0 <= sp.cpu_ns <= sp.end_ns - sp.start_ns
            assert sp.root_id == root.span_id
    # the device-exec spans stay between each task and its leaves
    assert {by_id[sp.parent_id].name for sp in win.spans if sp.name in COP_PHASES} == {"device-exec"}


def test_an_mpp_gather_has_its_six_phases_inside_it(star):
    s = star.session()
    rows, win = windowed(s, Q3)
    (detail,) = s.mpp_details
    assert rows == s.query(Q3)
    by_id = {sp.span_id: sp for sp in win.spans}
    (gather,) = [sp for sp in win.spans if sp.name == "mpp.gather"]
    assert ancestors(gather, by_id)[-1].name == "statement"
    leaves = sorted((sp for sp in win.spans if sp.name in MPP_PHASES), key=lambda sp: sp.start_ns)
    assert list(dict.fromkeys(sp.name for sp in leaves)) == list(MPP_PHASES)
    for sp in leaves:
        assert gather in ancestors(sp, by_id)
        assert gather.start_ns <= sp.start_ns <= sp.end_ns <= gather.end_ns
        assert 0 <= sp.cpu_ns <= sp.end_ns - sp.start_ns
    for a, b in zip(leaves, leaves[1:]):
        assert a.end_ns <= b.start_ns
    # one program run: one mpp.issue under the gather
    assert [sp.name for sp in leaves].count("mpp.issue") == 1
    issue_drain_ms = sum(sp.end_ns - sp.start_ns for sp in leaves if sp.name in ("mpp.issue", "mpp.drain")) / 1e6
    assert 0 < issue_drain_ms <= detail.wall_ms


def _trace(session, sql):
    """TRACE rows → [(depth, name)]."""
    out = []
    for label, _start, _dur in session.query("TRACE " + sql):
        body = label.lstrip(" ")
        depth = (len(label) - len(body)) // 2
        out.append((depth, body.removeprefix("└─")))
    return out


def _parents(rows):
    """Each TRACE row's parent name (rows in start order, so a child's
    parent is the nearest earlier row one level up)."""
    out = []
    for i, (depth, name) in enumerate(rows):
        parent = next((n for d, n in reversed(rows[:i]) if d == depth - 1), None)
        out.append((name, parent))
    return out


@pytest.mark.parametrize("window", [False, True], ids=["window_off", "window_on"])
def test_trace_keeps_its_spans_with_the_phases_as_children(lineitem, star, window):
    if window:
        tracing.start_window()
    cop = _parents(_trace(lineitem.session(), Q1))
    mpp = _parents(_trace(star.session(), Q3))
    win = tracing.stop_window() if window else None
    names = [n for n, _p in cop]
    assert names[:3] == ["select", "plan", "execute"]
    assert sum(n.startswith("cop.r") for n in names) == 3 and names.count("device-exec") == 3
    assert {p for n, p in cop if n in COP_PHASES} == {"device-exec"}
    assert {n for n, _p in cop if n in COP_PHASES} == set(COP_PHASES)
    assert ("mpp-pipeline[1dev]", "mpp.gather") in mpp and ("mpp.gather", "execute") in mpp
    assert {p for n, p in mpp if n in ("mpp.issue", "mpp.drain")} == {"mpp-pipeline[1dev]"}
    assert {p for n, p in mpp if n in ("mpp.prepare", "mpp-inputs", "mpp.program", "mpp.merge")} == {"mpp.gather"}
    if win is not None:
        # the window keeps the traced statements' spans too, the cop tasks
        # under their requester across the pool's threads
        by_id = {sp.span_id: sp for sp in win.spans}
        roots = [sp for sp in win.spans if sp.name == "statement"]
        assert len(roots) == 2
        for sp in win.spans:
            if sp.name.startswith("cop.r") or sp.name in COP_PHASES + MPP_PHASES:
                assert ancestors(sp, by_id)[-1] in roots


def test_window_start_stop_and_the_clock_anchors():
    with pytest.raises(RuntimeError):
        tracing.stop_window()
    rec = tracing.start_window()
    with pytest.raises(RuntimeError):
        tracing.start_window()
    with rec.span("a") as a:
        with rec.span("b") as b:
            pass
    with rec.span("open at the stop"):
        win = tracing.stop_window()
    # spans in open order; one still open at the stop is left out
    assert tracing.window() is None and win.spans == [a, b]
    assert (b.parent_id, b.root_id, a.parent_id, a.root_id) == (a.span_id, a.span_id, 0, a.span_id)
    (p0, w0), (p1, w1) = win.anchors
    assert p0 < b.start_ns <= b.end_ns < p1 and w0 <= w1
    # the wall mapping is linear between the anchors: drift is corrected
    drifted = tracing.Window([], ((1_000, 5_000_000), (2_001_000, 5_000_000 + 2_002_000)))
    assert drifted.wall_ns(1_000) == 5_000_000
    assert drifted.wall_ns(2_001_000) == 7_002_000
    assert drifted.wall_ns(1_001_000) == 6_001_000


def test_spans_cross_threads_under_an_explicit_parent():
    import threading

    rec = tracing.start_window()
    with rec.span("statement") as root:
        parent = rec.current()
        seen = {}

        def worker():
            with rec.span("task", parent) as t:
                with execdetails.trace_span("leaf") as leaf:
                    pass
            seen.update(task=t, leaf=leaf)

        th = threading.Thread(target=worker)
        th.start()
        th.join()
    tracing.stop_window()
    assert parent is root
    assert seen["task"].parent_id == root.span_id and seen["task"].thread != root.thread
    assert seen["leaf"].parent_id == seen["task"].span_id and seen["leaf"].root_id == root.span_id


def test_phases_are_consecutive_and_close_on_the_way_out():
    rec = tracing.start_window()
    ph = tracing.Phases(rec.span)
    ph.to("one")
    ph.to("two")
    ph.close()
    ph.close()  # closing twice is a no-op
    with pytest.raises(ValueError):
        try:
            ph.to("three")
            raise ValueError
        finally:
            ph.close()
    win = tracing.stop_window()
    one, two, three = sorted(win.spans, key=lambda sp: sp.start_ns)
    assert [sp.name for sp in (one, two, three)] == ["one", "two", "three"]
    assert one.end_ns <= two.start_ns and two.end_ns <= three.start_ns
    assert {sp.parent_id for sp in win.spans} == {0}


def test_threads_recording_at_once_lose_no_span():
    """More recording threads than cores, switching often: every span is
    kept once, with an id of its own, under its own thread's parent."""
    import threading

    n_threads, per = 4 * (os.cpu_count() or 1) + 3, 200
    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        tracing.start_window()

        def worker():
            for _ in range(per):
                with execdetails.trace_span("outer"):
                    with execdetails.trace_span("inner"):
                        pass

        threads = [threading.Thread(target=worker) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        win = tracing.stop_window()
    finally:
        sys.setswitchinterval(before)
    assert len(win.spans) == 2 * n_threads * per
    assert len({sp.span_id for sp in win.spans}) == len(win.spans)
    by_id = {sp.span_id: sp for sp in win.spans}
    for sp in win.spans:
        if sp.name == "inner":
            parent = by_id[sp.parent_id]
            assert parent.name == "outer" and parent.thread == sp.thread and sp.root_id == parent.span_id
