"""The port's runtime lock-order detector (``tidb_tpu_torch.utils.lockcheck``)
against the reference's (``tidb_tpu.utils.lockcheck``): the eleven scenarios
of ``tests/test_lockcheck.py``, each run on both modules in this process with
the same outcome (the same error, the module's own ``LockOrderError``, the
same cycle length), and the two detectors side by side under the conftest's
install of the reference's."""

import _thread
import contextlib
import gc
import os
import queue
import sys
import threading
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidb_tpu.utils import lockcheck as ref_lc  # noqa: E402
from tidb_tpu_torch.utils import lockcheck as port_lc  # noqa: E402

MODULES = {"reference": ref_lc, "port": port_lc}


@contextlib.contextmanager
def _active(lc):
    """``lc``'s factories installed for one scenario, its graph reset; the
    reference's install (the conftest's, or a forced one) stands under the
    port's and is left as found."""
    ref_was = ref_lc.installed()
    ref_lc.install(force=True)
    if lc is port_lc:
        port_lc.install(force=True)
    lc.reset()
    try:
        yield lc
    finally:
        lc.reset()
        if lc is port_lc:
            port_lc.uninstall()
        if not ref_was:
            ref_lc.uninstall()


def _raises(lc, fn):
    """(the module's own LockOrderError raised?, the cycle's length) for one
    call of ``fn``; (False, 0) when it raises nothing."""
    try:
        fn()
    except (ref_lc.LockOrderError, port_lc.LockOrderError) as e:
        return type(e) is lc.LockOrderError, len(e.cycle)
    return False, 0


def two_lock_inversion(lc):
    a, b = threading.Lock(), threading.Lock()
    with a:
        with b:
            pass

    def reversed_order():
        with b:
            with a:
                pass

    raised = _raises(lc, reversed_order)
    # the failed acquire must not leave the inner lock held
    free = a.acquire(blocking=False)
    if free:
        a.release()
    return raised, free


def inversion_across_threads(lc):
    a, b = threading.Lock(), threading.Lock()
    errs: list = []

    def t1():
        with a:
            time.sleep(0.01)
            with b:
                pass

    def t2():
        time.sleep(0.05)  # strictly after t1 released everything
        try:
            with b:
                with a:
                    pass
        except lc.LockOrderError as e:
            errs.append(len(e.cycle))

    th1 = threading.Thread(target=t1, name="lc-t1")
    th2 = threading.Thread(target=t2, name="lc-t2")
    th1.start(), th2.start()
    th1.join(5), th2.join(5)
    return errs


def three_lock_cycle(lc):
    a, b, c = threading.Lock(), threading.Lock(), threading.Lock()
    with a:
        with b:
            pass
    with b:
        with c:
            pass

    def close():
        with c:
            with a:
                pass

    return _raises(lc, close)


def consistent_order(lc):
    a, b = threading.Lock(), threading.Lock()

    def run():
        for _ in range(3):
            with a:
                with b:
                    pass
        with b:
            pass
        with a:
            pass

    return _raises(lc, run)


def rlock_reentry(lc):
    r = threading.RLock()

    def run():
        with r:
            with r:
                with r:
                    pass

    raised = _raises(lc, run)
    free = r.acquire(blocking=False)
    if free:
        r.release()
    return raised, free


def condition_event_queue(lc):
    cond = threading.Condition()
    hits = []

    def waiter():
        with cond:
            cond.wait(2.0)
            hits.append(1)

    t = threading.Thread(target=waiter, name="lc-cond")
    t.start()
    time.sleep(0.05)
    with cond:
        cond.notify_all()
    t.join(5)
    ev = threading.Event()
    ev.set()
    q = queue.Queue()
    q.put("x")
    return hits, t.is_alive(), ev.wait(0.1), q.get(timeout=1)


def condition_on_reentrant_rlock(lc):
    r = threading.RLock()
    cond = threading.Condition(r)
    x = threading.Lock()
    with r:
        with r:
            with cond:
                cond.wait(0.05)  # times out: a full release and restore
        # depth 1 again: the nested acquire records the r -> x edge
        with x:
            pass
    return (id(r), id(x)) in lc._edges


def nonblocking_and_timeout(lc):
    a = threading.Lock()
    first = a.acquire(blocking=False)
    second = a.acquire(blocking=False)  # a failed try-acquire is not held
    a.release()
    timed = a.acquire(True, 0.1)
    a.release()
    return first, second, timed


def id_reuse(lc):
    def run():
        for i in range(50):
            a, b = threading.Lock(), threading.Lock()
            if i % 2:
                with a:
                    with b:
                        pass
            else:
                with b:
                    with a:
                        pass
            del a, b
            gc.collect()

    return _raises(lc, run)


def reset_clears_history(lc):
    a, b = threading.Lock(), threading.Lock()
    with a:
        with b:
            pass
    lc.reset()

    def reversed_order():
        with b:
            with a:
                pass

    return _raises(lc, reversed_order)


# scenario → (function, the outcome both detectors give; a cycle's length
# counts the closed path's sites and the held lock's again)
SCENARIOS = {
    "two_lock_inversion": (two_lock_inversion, ((True, 3), True)),
    "inversion_across_threads": (inversion_across_threads, [3]),
    "three_lock_cycle": (three_lock_cycle, (True, 4)),
    "consistent_order": (consistent_order, (False, 0)),
    "rlock_reentry": (rlock_reentry, ((False, 0), True)),
    "condition_event_queue": (condition_event_queue, ([1], False, True, "x")),
    "condition_on_reentrant_rlock": (condition_on_reentrant_rlock, True),
    "nonblocking_and_timeout": (nonblocking_and_timeout, (True, False, True)),
    "id_reuse": (id_reuse, (False, 0)),
    "reset_clears_history": (reset_clears_history, (False, 0)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_answers_as_the_reference(name):
    fn, want = SCENARIOS[name]
    got = {}
    for label, lc in MODULES.items():
        with _active(lc):
            got[label] = fn(lc)
    assert got["port"] == got["reference"] == want


def test_env_knob_gates_install_as_the_reference(monkeypatch):
    monkeypatch.setenv(port_lc.ENV_KNOB, "0")
    assert port_lc.ENV_KNOB == ref_lc.ENV_KNOB
    outcomes = {}
    for label, lc in MODULES.items():
        was = lc.installed()
        if was:
            lc.uninstall()
        try:
            outcomes[label] = (lc.install(), lc.installed(), lc.install(force=True), lc.installed())
            lc.uninstall()
            outcomes[label] += (lc.installed(),)
        finally:
            if was:
                lc.install(force=True)
    assert outcomes["port"] == outcomes["reference"] == (False, False, True, True, False)


# -- the two detectors side by side ---------------------------------------------


@contextlib.contextmanager
def _under_reference_install():
    """The reference's detector installed, as the conftest leaves it (forced
    when the run opted out), and restored as found."""
    was = ref_lc.installed()
    ref_lc.install(force=True)
    try:
        yield
    finally:
        if not was:
            ref_lc.uninstall()


def test_port_install_wraps_raw_thread_locks():
    raw_lock, raw_rlock = type(_thread.allocate_lock()), type(_thread.RLock())
    with _under_reference_install():
        assert threading.Lock is ref_lc.Lock
        port_lc.install(force=True)
        try:
            a, r = threading.Lock(), threading.RLock()
            cond = threading.Condition()
        finally:
            port_lc.uninstall()
        for lk, raw in ((a, raw_lock), (r, raw_rlock), (cond._lock, raw_rlock)):
            assert type(lk) is port_lc._CheckedLock
            assert not isinstance(lk._inner, ref_lc._CheckedLock)
            assert type(lk._inner) is raw
        # the detector's own mutex is raw too
        assert type(port_lc._graph_mu) is raw_lock


def test_an_inversion_raises_once_and_it_is_the_ports():
    with _under_reference_install():
        port_lc.install(force=True)
        port_lc.reset()
        try:
            a, b = threading.Lock(), threading.Lock()
            with a:
                with b:
                    pass
            with pytest.raises(port_lc.LockOrderError) as ei:
                with b:
                    with a:
                        pass
        finally:
            port_lc.reset()
            port_lc.uninstall()
        assert not isinstance(ei.value, ref_lc.LockOrderError)
        assert len(ei.value.cycle) == 3  # the path b -> a, then the held a
        # the reference's graph never saw these locks: nothing of theirs is
        # a reference checked lock, so no second detector records the edge
        assert id(a._inner) not in ref_lc._sites and id(b._inner) not in ref_lc._sites
        assert (id(a), id(b)) not in ref_lc._edges
        assert a.acquire(blocking=False)
        a.release()


def test_port_uninstall_leaves_the_reference_install_standing():
    with _under_reference_install():
        before = (threading.Lock, threading.RLock)
        assert port_lc.install(force=True) is True
        assert threading.Lock is port_lc.Lock and threading.RLock is port_lc.RLock
        port_lc.uninstall()
        assert not port_lc.installed()
        assert (threading.Lock, threading.RLock) == before
        assert threading.Lock is ref_lc.Lock
        assert ref_lc.installed()
        # a lock made now is the reference's checked lock again
        assert type(threading.Lock()) is ref_lc._CheckedLock
