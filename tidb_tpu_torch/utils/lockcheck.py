"""Runtime lock-order cycle detection: the would-deadlock detector.

Deadlocks are the worst CI failure mode this repo has paid for: the PR 1
``_MESH_EXEC_LOCK`` hang (two concurrent shard_map programs starving the
XLA CPU client's collective rendezvous) walled the whole tier-1 suite at
test_disttask for ~700 seconds with zero diagnostics, and only reproduced
on 2-core hosts. A lock-ORDER inversion has the same shape — it needs the
unlucky interleaving to actually deadlock, so tests pass for months until
one CI host loses the race and hangs forever.

This module makes the inversion itself the error, deterministically: an
opt-in instrumented wrapper around ``threading.Lock``/``RLock`` records the
per-thread set of held locks and the global acquisition-order graph (edge
A→B = "B was acquired while A was held", per lock INSTANCE so two
instances of one class never alias). The moment an acquisition would close
a cycle — even single-threaded, even if the other order ran minutes
earlier — the acquire raises :class:`LockOrderError` naming both creation
sites and the path, instead of some future run hanging.

Opt-in: ``TIDB_TPU_LOCKCHECK=1`` + :func:`install` (``chip_smoke.py
--lockcheck-child`` does both before it imports any other module of this
package, so the SQL path on the card runs order-checked). ``install()``
patches the ``threading.Lock``/``RLock`` factories, so only locks created
AFTER it are instrumented — stdlib locks bound at interpreter start stay
plain. A checked lock wraps a raw ``_thread`` lock, never whatever
``threading.Lock`` was at import: when another detector (the JAX
package's, which the shared test suite's conftest installs) already
patched the factories, this one's locks are checked once, in this graph
only. :func:`uninstall` restores the factories that :func:`install`
replaced, so such an earlier install stays standing. The overhead budget is enforced,
not hoped for: the ``graftcheck_runtime_overhead_ms`` benchdaily lane
fails if the instrumented warm-query path costs more than 5% over plain
(ref: TiKV's deadlock detector and abseil's ABSL_ANNOTATE deadlock check,
both of which run in test builds by default).

The static half of this check lives in ``tidb_tpu_torch.tools.check`` (rule
GC-LOCK-ORDER builds the same graph from the AST); this runtime half
catches what static resolution can't see — locks reached through dynamic
dispatch, callbacks, and cross-process server threads.
"""

from __future__ import annotations

import _thread
import os
import sys
import threading
import weakref

__all__ = [
    "LockOrderError",
    "Lock",
    "RLock",
    "install",
    "uninstall",
    "installed",
    "enabled",
    "reset",
]

ENV_KNOB = "TIDB_TPU_LOCKCHECK"


class LockOrderError(RuntimeError):
    """An acquisition closed a lock-order cycle: with the right thread
    interleaving this program CAN deadlock. ``cycle`` carries the creation
    sites along the closed path, first element = the lock being acquired."""

    def __init__(self, msg: str, cycle: list):
        super().__init__(msg)
        self.cycle = cycle


# the detector's own structures and every checked lock's inner lock are raw
# _thread locks — never whatever threading.Lock is at import, which may be
# another detector's checked factory: the detector must never instrument
# itself, and a lock it wraps is checked once
_ORIG_LOCK = _thread.allocate_lock
_ORIG_RLOCK = _thread.RLock

_graph_mu = _ORIG_LOCK()
# lock id → set of lock ids acquired while it was held (the order graph)
_succ: dict[int, set] = {}
# (outer id, inner id) → True for edges already recorded (lock-free fast path)
_edges: dict = {}
# lock id → creation site ("file:line") for error messages
_sites: dict[int, str] = {}
_tls = threading.local()


def _held() -> list:
    h = getattr(_tls, "held", None)
    if h is None:
        h = _tls.held = []
    return h


def _site(depth: int) -> str:
    try:
        f = sys._getframe(depth)
        return f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno}"
    except Exception:
        return "?"


# dead-lock ids queued by GC finalizers. The finalizer must NOT take
# _graph_mu: finalizers run at arbitrary allocation points — including
# inside _path's list building while THIS thread already holds the mutex —
# and a plain lock self-deadlocks (first suite run hung exactly there).
# list.append is GIL-atomic, so the queue needs no lock; the next locked
# operation drains it.
_dead: list = []


def _forget(lid: int) -> None:
    """GC hook (weakref.finalize on every wrapper): queue the dead lock's
    id so a recycled id() can never alias it into someone else's edge."""
    _dead.append(lid)  # GIL-atomic, lock-free by design  # graftcheck: off=shared-mutation


def _purge_locked(lid: int) -> None:
    """Remove one node and its edges. Caller holds _graph_mu (the lock is
    taken one frame up, so the suppressions below document what the static
    rule cannot see)."""
    _succ.pop(lid, None)  # graftcheck: off=shared-mutation (under _graph_mu)
    _sites.pop(lid, None)  # graftcheck: off=shared-mutation (under _graph_mu)
    for s in _succ.values():
        s.discard(lid)
    for k in [k for k in _edges if lid in k]:
        _edges.pop(k, None)  # graftcheck: off=shared-mutation (under _graph_mu)


def _drain_dead_locked() -> None:
    """Drop queued dead nodes from the graph. Caller holds _graph_mu."""
    while _dead:
        _purge_locked(_dead.pop())  # graftcheck: off=shared-mutation (under caller's _graph_mu)


def _path(frm: int, to: int) -> "list | None":
    """DFS over _succ: ids along a path frm→…→to, or None. Caller holds
    _graph_mu."""
    stack = [(frm, [frm])]
    seen = {frm}
    while stack:
        node, path = stack.pop()
        if node == to:
            return path
        for nxt in _succ.get(node, ()):
            if nxt not in seen:
                seen.add(nxt)
                stack.append((nxt, path + [nxt]))
    return None


def _note_acquire(lk: "_CheckedLock") -> None:
    held = _held()
    me = id(lk)
    for h in held:
        if h is lk:  # RLock re-entry: no new ordering information
            held.append(lk)
            return
    for h in held:
        a = id(h)
        if a == me or (a, me) in _edges:
            continue
        with _graph_mu:
            _drain_dead_locked()
            # adding a→me closes a cycle iff me already reaches a
            cyc = _path(me, a)
            if cyc is not None:
                sites = [_sites.get(i, "?") for i in cyc]
                raise LockOrderError(
                    "lock-order cycle: acquiring lock created at "
                    f"{_sites.get(me, '?')} while holding lock created at "
                    f"{_sites.get(a, '?')}, but the reverse order "
                    f"{' -> '.join(sites)} was already observed — with the "
                    "right thread interleaving this deadlocks",
                    cycle=sites + [_sites.get(a, "?")],
                )
            _succ.setdefault(a, set()).add(me)
            _edges[(a, me)] = True
    held.append(lk)


def _note_release(lk: "_CheckedLock", all_levels: bool = False) -> int:
    """Remove lk from the held list (innermost entry, or every recursion
    level). Returns how many entries were removed — Condition.wait's
    release/restore cycle must re-append exactly that many."""
    held = getattr(_tls, "held", None)
    if not held:
        return 0
    removed = 0
    for i in range(len(held) - 1, -1, -1):
        if held[i] is lk:
            del held[i]
            removed += 1
            if not all_levels:
                break
    return removed


class _CheckedLock:
    """Wraps one lock (plain or reentrant). Implements enough of the
    internal Condition protocol (_is_owned/_release_save/_acquire_restore)
    that ``threading.Condition``/``Event``/``Queue`` built on a checked lock
    keep exact stdlib semantics."""

    def __init__(self, inner, site: str):
        self._inner = inner
        self._site = site
        me = id(self)
        with _graph_mu:
            # id() reuse: if this object recycled a dead wrapper's address,
            # that wrapper's stale edges must die NOW — a leftover A→B edge
            # attributed to our fresh id manufactures false cycles (first
            # seen as a phantom DDLWorker _mu/_run_mu inversion when a new
            # worker's locks landed on its predecessor's freed slots). The
            # finalizer ran at free time, so a recycled id is necessarily
            # still in _sites (not yet drained) or queued in _dead — an O(1)
            # membership guard keeps the O(graph) purge off the common
            # fresh-id construction path.
            if me in _sites or me in _dead:
                _purge_locked(me)
                try:
                    _dead.remove(me)  # graftcheck: off=shared-mutation (under _graph_mu)
                except ValueError:
                    pass
            _sites[me] = site
        weakref.finalize(self, _forget, me)

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._inner.acquire(blocking, timeout)
        if got:
            try:
                _note_acquire(self)
            except LockOrderError:
                self._inner.release()  # fail the acquire, don't leak the hold
                raise
        return got

    def release(self) -> None:
        self._inner.release()
        _note_release(self)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._inner.locked()

    # -- Condition wait() protocol ------------------------------------------
    def _is_owned(self) -> bool:
        io = getattr(self._inner, "_is_owned", None)
        if io is not None:
            return io()
        # plain lock: the stdlib probe — if we can grab it, we didn't own it
        if self._inner.acquire(False):
            self._inner.release()
            return False
        return True

    def _release_save(self):
        # Condition.wait fully releases a re-entrantly held RLock; carry the
        # recursion depth in our saved state so restore re-appends exactly
        # that many held entries — re-appending one would leave the thread
        # holding the lock with an EMPTY held record, silently blinding the
        # detector to every ordering edge through this lock afterwards
        n = _note_release(self, all_levels=True)
        rs = getattr(self._inner, "_release_save", None)
        inner_state = rs() if rs is not None else self._inner.release()
        return (inner_state, max(n, 1))

    def _acquire_restore(self, state) -> None:
        inner_state, n = state
        ar = getattr(self._inner, "_acquire_restore", None)
        if ar is not None:
            ar(inner_state)
        else:
            self._inner.acquire()
        for _ in range(n):
            _note_acquire(self)

    def __getattr__(self, name: str):
        # stdlib internals poke lock-protocol attrs we don't wrap
        # (_at_fork_reinit, _recursion_count, ...) — delegate verbatim
        return getattr(self._inner, name)

    def __repr__(self) -> str:
        return f"<lockcheck {self._inner!r} @ {self._site}>"


def Lock() -> _CheckedLock:
    """Instrumented ``threading.Lock`` (what the patched factory returns)."""
    return _CheckedLock(_ORIG_LOCK(), _site(2))


def RLock() -> _CheckedLock:
    return _CheckedLock(_ORIG_RLOCK(), _site(2))


def enabled() -> bool:
    return os.environ.get(ENV_KNOB, "") == "1"


_installed = False
# the (Lock, RLock) factories install() replaced, restored by uninstall()
_REPLACED: tuple = ()


def installed() -> bool:
    return _installed


def install(force: bool = False) -> bool:
    """Patch the ``threading.Lock``/``RLock`` factories so every lock
    created from here on is order-checked. No-op unless ``force`` or the
    ``TIDB_TPU_LOCKCHECK=1`` env knob is set. Returns whether installed.
    ``threading.Condition()`` (and Event/Queue on top of it) picks the
    checked factory up automatically at construction time."""
    global _installed, _REPLACED
    if _installed:
        return True
    if not (force or enabled()):
        return False
    _REPLACED = (threading.Lock, threading.RLock)
    threading.Lock = Lock  # type: ignore[assignment]
    threading.RLock = RLock  # type: ignore[assignment]
    _installed = True
    return True


def uninstall() -> None:
    """Restore the factories :func:`install` replaced (an earlier install
    of another detector stays standing)."""
    global _installed, _REPLACED
    if not _installed:
        return
    threading.Lock, threading.RLock = _REPLACED  # type: ignore[assignment]
    _REPLACED = ()
    _installed = False


def reset() -> None:
    """Drop every recorded edge (tests: isolate one scenario's graph from
    the suite-wide history; existing locks stay instrumented)."""
    with _graph_mu:
        _drain_dead_locked()
        _succ.clear()
        _edges.clear()
