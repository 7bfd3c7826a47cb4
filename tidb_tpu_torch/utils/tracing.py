"""Tracing (ref: pkg/util/tracing dual spans + the TRACE statement,
executor/trace.go): a per-statement span collector; instrumentation sites
open spans through Session.span() which no-ops when tracing is off.

Distributed half (ref: Dapper-style trace-context propagation): the trace id
travels inside cop/MPP RPC headers (:class:`TraceContext`), the remote
``StoreServer`` records spans into its own :class:`Tracer` under that
context, and the finished spans ship home in the response where the caller
grafts them into the statement trace with :meth:`Tracer.merge_remote` — so
TRACE shows the full cross-process tree, each remote span tagged with the
store that recorded it.

Thread-safety: shared-cop-pool workers open spans on ONE statement tracer
concurrently. Depth/nesting state is per-thread (a span stack in a
``threading.local``); the span list itself appends under a lock with a
monotonically increasing sequence number, and :meth:`rows` orders by
``(start, seq)`` — a deterministic rule independent of interleaving.
Cross-thread nesting (a worker's task span under the requester's
``execute`` span) is explicit via ``span(name, parent=...)``.

Always-on sampled tracing (ref: Dapper §4 — probabilistic sampling makes a
continuous latency breakdown affordable at serving rates): a per-statement
coin in ``Session.execute`` creates a ``Tracer`` for a small fraction of
statements; its ``sampled`` flag rides the :class:`TraceContext` through
every cop/MPP RPC so remote stores record spans ONLY for sampled
statements. Finished sampled traces land in the :class:`TraceReservoir` —
a bounded ring of recent traces plus a *tail-keep* section that pins any
trace whose statement crossed the slow-log threshold, so the interesting
outliers survive ring rotation (the slow log cross-links them by trace id).
Unsampled statements never construct a tracer: the ``Request.tracer is
None`` zero-cost rule is untouched.

The window (port): ``TRACE`` and sampling each keep one statement's tree; a
profiler run or a benchmark window needs every statement's spans over a
stretch of time, on a clock the device trace can be placed against.
``start_window()`` makes a process-wide :class:`Tracer`, the window, that
the span seams (``Session.span``, ``execdetails.trace_span``, the cop
client's task spans) record into whenever no statement tracer is in effect;
a statement tracer's spans go to the window too, under the window's open
span of their thread (``Session.execute`` opens each statement's root span,
``statement``, there). ``stop_window()`` stops it and returns
:class:`Window`: the finished spans and two ``(perf_counter_ns, time_ns)``
anchors read at start and at stop, which ``Window.wall_ns`` uses to put a
span time on ``time_ns``, the clock ``torch.profiler`` stamps device events
on, linear between them so the drift between the clocks is corrected. Off is
the default: a seam then reads one module global and hands back the shared
``NULL_SPAN``, with no clock read and no allocation. Spans stay in memory
until ``stop_window()``.

Each :class:`Span` carries, besides its ``TRACE`` fields: ``span_id``,
``parent_id`` (0 for a root) and ``root_id`` (its statement's root), unique
across the process so a window holds spans of several tracers; ``thread``,
the recording thread's ident; ``start_ns``/``end_ns`` on
``time.perf_counter_ns``; ``cpu_ns``, the thread's CPU time over the span
(``time.thread_time_ns``, read inside the wall readings). Where the thread
clock ticks (gVisor's does every 10 ms) a short span can read a tick more
CPU than wall: only sums over many spans hold there.
"""

from __future__ import annotations

import itertools
import threading
import time
import uuid
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field


@dataclass
class Span:
    name: str
    start_s: float  # relative to trace start
    duration_s: float
    depth: int
    seq: int = 0
    # "" = recorded in this process; else the remote store that recorded it
    node: str = ""
    # process-wide ids (0 on a span merged from a remote store) and the
    # recording thread; perf_counter_ns at open and close, and the thread's
    # CPU ns over the span
    span_id: int = 0
    parent_id: int = 0
    root_id: int = 0
    thread: int = 0
    start_ns: int = 0
    end_ns: int = 0
    cpu_ns: int = 0


@dataclass(frozen=True)
class TraceContext:
    """The wire form of an active trace: what a cop/MPP RPC carries outward
    so the remote side can record spans under the same trace."""

    trace_id: str
    sampled: bool = True

    def to_pb(self) -> dict:
        return {"tid": self.trace_id, "sampled": int(self.sampled)}

    @staticmethod
    def from_pb(pb) -> "TraceContext | None":
        if not pb:
            return None
        return TraceContext(str(pb.get("tid", "")), bool(pb.get("sampled", 1)))


class Tracer:
    def __init__(self, trace_id: "str | None" = None, sampled: bool = True):
        self._t0 = time.perf_counter()
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        # rides the wire context: remote sides record spans only when set
        self.sampled = sampled
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._seq = 0
        self.spans: list[Span] = []

    # -- span recording -----------------------------------------------------
    def _stack(self) -> list:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def current(self) -> "Span | None":
        """The innermost open span of THIS thread (cross-thread parents are
        captured here and passed to workers via ``span(parent=...)``)."""
        st = self._stack()
        return st[-1] if st else None

    @contextmanager
    def span(self, name: str, parent: "Span | None" = None):
        st = self._stack()
        if parent is None and st:
            parent = st[-1]
        depth = parent.depth + 1 if parent is not None else 0
        win = _WINDOW
        if win is self:
            win = None
        # a statement tracer's top span hangs under the window's open span
        # of this thread (the statement's root), so the window holds one tree
        up = parent if parent is not None or win is None else win.current()
        sid = next(_SPAN_IDS)
        start = time.perf_counter_ns()
        cpu0 = time.thread_time_ns()
        sp = Span(
            name, start / 1e9 - self._t0, 0.0, depth,
            span_id=sid,
            parent_id=up.span_id if up is not None else 0,
            root_id=up.root_id if up is not None else sid,
            thread=threading.get_ident(),
            start_ns=start,
        )
        with self._mu:
            sp.seq = self._seq
            self._seq += 1
            self.spans.append(sp)
        st.append(sp)
        try:
            yield sp
        finally:
            cpu1 = time.thread_time_ns()
            end = time.perf_counter_ns()
            st.pop()
            sp.duration_s = (end - start) / 1e9
            sp.cpu_ns = cpu1 - cpu0
            sp.end_ns = end  # last: a span with end_ns set is finished
            if win is not None:
                with win._mu:
                    win.spans.append(sp)

    # -- wire ----------------------------------------------------------------
    def context(self) -> TraceContext:
        return TraceContext(self.trace_id, self.sampled)

    def to_pb(self) -> list[list]:
        """Finished spans in wire form: [name, start_s, duration_s, depth],
        ordered by the same deterministic (start, seq) rule as rows()."""
        with self._mu:
            spans = sorted(self.spans, key=lambda s: (s.start_s, s.seq))
        return [[s.name, round(s.start_s, 6), round(s.duration_s, 6), s.depth] for s in spans]

    def merge_remote(self, pb_spans, base_s: float, node: str, depth: int = 0) -> None:
        """Graft spans recorded by a remote process into this trace: remote
        starts are relative to the REMOTE trace start (its RPC handling), so
        they rebase onto ``base_s`` — the local time the RPC span opened —
        and indent ``depth`` levels under it. Clock skew never enters: only
        the remote's own relative timings travel."""
        if not pb_spans:
            return
        with self._mu:
            for name, start_s, dur_s, sd in pb_spans:
                sp = Span(
                    str(name), base_s + float(start_s), float(dur_s), depth + int(sd), node=node
                )
                sp.seq = self._seq
                self._seq += 1
                self.spans.append(sp)

    def dump(self) -> list[list]:
        """Structured spans for the trace reservoir / JSON surfaces:
        [name, start_ms, duration_ms, depth, node], (start, seq)-ordered."""
        with self._mu:
            spans = sorted(self.spans, key=lambda s: (s.start_s, s.seq))
        return [
            [s.name, round(s.start_s * 1e3, 3), round(s.duration_s * 1e3, 3), s.depth, s.node]
            for s in spans
        ]

    # -- rendering -----------------------------------------------------------
    def rows(self) -> list[tuple]:
        with self._mu:
            spans = sorted(self.spans, key=lambda s: (s.start_s, s.seq))
        out = []
        for s in spans:
            label = ("  " * s.depth) + ("└─" if s.depth else "") + s.name
            if s.node:
                label += f" @{s.node}"
            out.append((label, f"{s.start_s * 1e3:.3f}ms", f"{s.duration_s * 1e3:.3f}ms"))
        return out


def effective(tracer) -> "Tracer | None":
    """The tracer a recording seam should actually use: None when tracing is
    off OR the context is explicitly unsampled (``TraceContext.sampled=0``).
    The single home of the zero-cost gating rule — every span-recording seam
    (cop clients, MPP dispatch) routes through this, so an unsampled tracer
    behaves byte-identically to no tracer at all."""
    if tracer is None or not getattr(tracer, "sampled", True):
        return None
    return tracer


def clamp_rate(rate: float, qps: float, clamp_qps: float) -> float:
    """Adaptive sampling clamp (Dapper's follow-up idiom: sample generously
    when idle, shed tracing under pressure): above ``clamp_qps`` the
    effective rate scales down proportionally, so the expected number of
    sampled statements per second stays ~``rate * clamp_qps`` no matter how
    hard the instance is driven — and recovers to the configured rate the
    moment load falls back under the threshold. ``clamp_qps <= 0`` disables
    the clamp. The single home of the rule: the session's sampling coin and
    any future remote-side clamp must both route here."""
    if clamp_qps <= 0 or qps <= clamp_qps:
        return rate
    return rate * (clamp_qps / qps)


# -- trace reservoir ---------------------------------------------------------


@dataclass
class TraceEntry:
    """One finished sampled statement in the reservoir."""

    trace_id: str
    time: float  # unix seconds the statement finished
    sql: str
    digest: str
    duration_s: float
    slow: bool  # crossed the slow-log threshold → tail-keep pinned
    spans: list = field(default_factory=list)  # Tracer.dump() rows


class TraceReservoir:
    """Bounded store of recent sampled traces (ref: Dapper's sampled-trace
    collection; GWP's always-on-with-a-budget discipline). Two sections:

    - a ring of the N most recent sampled traces (FIFO eviction);
    - *tail-keep*: traces of statements over the slow-log threshold are
      additionally pinned in their own (smaller) ring, so a latency outlier
      survives long after ordinary ring rotation would have dropped it —
      regardless of how many fast sampled statements follow.

    No background threads: deposits happen on the statement's own thread,
    reads under one lock. Surfaced via ``GET /traces`` and
    ``information_schema.trace_reservoir``; the slow log cross-links entries
    by ``trace_id``."""

    def __init__(self, capacity: int = 64, slow_capacity: int = 32):
        self._mu = threading.Lock()
        self._ring: deque = deque(maxlen=max(int(capacity), 1))
        self._slow: "OrderedDict[str, TraceEntry]" = OrderedDict()
        self.slow_capacity = max(int(slow_capacity), 1)

    def add(self, entry: TraceEntry) -> None:
        with self._mu:
            self._ring.append(entry)
            if entry.slow:
                self._slow[entry.trace_id] = entry
                while len(self._slow) > self.slow_capacity:
                    self._slow.popitem(last=False)

    def get(self, trace_id: str) -> "TraceEntry | None":
        with self._mu:
            hit = self._slow.get(trace_id)
            if hit is not None:
                return hit
            for e in self._ring:
                if e.trace_id == trace_id:
                    return e
        return None

    def traces(self) -> list[TraceEntry]:
        """Every retained trace, oldest first: tail-keep entries that have
        already rotated out of the ring, then the ring itself."""
        with self._mu:
            ring_ids = {e.trace_id for e in self._ring}
            pinned = [e for tid, e in self._slow.items() if tid not in ring_ids]
            return sorted(pinned + list(self._ring), key=lambda e: e.time)

    def __len__(self) -> int:
        with self._mu:
            ring_ids = {e.trace_id for e in self._ring}
            return len(self._ring) + sum(1 for t in self._slow if t not in ring_ids)

    def clear(self) -> None:
        with self._mu:
            self._ring.clear()
            self._slow.clear()


# -- the window ----------------------------------------------------------------

# what a span seam hands back while nothing records
NULL_SPAN = nullcontext()

# span ids, unique across every tracer of the process (next() holds the GIL)
_SPAN_IDS = itertools.count(1)

_WINDOW: "Tracer | None" = None
_WINDOW_MU = threading.Lock()
_WINDOW_ANCHOR = (0, 0)


def _clock_anchor() -> tuple[int, int]:
    """(perf_counter_ns, time_ns) read together: the wall reading sits
    between two perf readings and takes their midpoint."""
    p0 = time.perf_counter_ns()
    w = time.time_ns()
    p1 = time.perf_counter_ns()
    return ((p0 + p1) // 2, w)


@dataclass
class Window:
    """What ``stop_window()`` hands back: the finished spans and the two
    clock anchors, ``(perf_counter_ns, time_ns)`` at start and at stop."""

    spans: list
    anchors: tuple

    def wall_ns(self, perf_ns: int) -> int:
        """A ``perf_counter_ns`` reading on the wall clock (``time_ns``, the
        clock ``torch.profiler`` stamps events on), linear between the two
        anchors, so the drift between the clocks over the window is
        corrected."""
        (p0, w0), (p1, w1) = self.anchors
        rate = (w1 - w0) / (p1 - p0) if p1 > p0 else 1.0
        return w0 + round((perf_ns - p0) * rate)


def start_window() -> Tracer:
    """Start recording every span of the process → the window's tracer;
    RuntimeError if a window is already recording."""
    global _WINDOW, _WINDOW_ANCHOR
    with _WINDOW_MU:
        if _WINDOW is not None:
            raise RuntimeError("a window is already recording")
        _WINDOW_ANCHOR = _clock_anchor()
        _WINDOW = Tracer()
        return _WINDOW


def stop_window() -> Window:
    """Stop recording → the spans finished inside the window and its clock
    anchors. A span still open when the window stops is left out."""
    global _WINDOW
    with _WINDOW_MU:
        win, _WINDOW = _WINDOW, None
        if win is None:
            raise RuntimeError("no window is recording")
        end = _clock_anchor()
        with win._mu:
            spans = [sp for sp in win.spans if sp.end_ns]
        return Window(spans, (_WINDOW_ANCHOR, end))


def window() -> "Tracer | None":
    """The recording window's tracer, or None while none records."""
    return _WINDOW


class Phases:
    """Consecutive spans of one thread for code whose phases do not sit in
    one block each: ``to(name)`` ends the open phase and opens ``name``
    through ``open_span`` (a span seam, such as ``Session.span``);
    ``close()`` ends the open phase. Phases never overlap."""

    __slots__ = ("_open", "_cm")

    def __init__(self, open_span):
        self._open = open_span
        self._cm = None

    def to(self, name: str) -> None:
        self.close()
        cm = self._open(name)
        cm.__enter__()
        self._cm = cm

    def close(self) -> None:
        cm, self._cm = self._cm, None
        if cm is not None:
            cm.__exit__(None, None, None)
