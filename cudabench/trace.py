"""The traced run: ``torch.profiler`` over the window (device activity
only), and spans the harness records around the calls into the program's
layers, so that the device's idle gaps can be named by what the host was
doing: ``<statements in flight>:<phase>``, the phase ``gather`` inside an
MPP gather, ``cop`` while a cop task runs, else ``host``.

Times: the profiler stamps events on the wall clock in nanoseconds; the
spans are taken on ``time.perf_counter`` and moved onto the wall clock by
one offset read when tracing starts.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import numpy as np

from cudabench.records import Trace

TOP = 10


class Spans:
    """Host spans around the program's gather and cop-task entries,
    installed for the traced run only and removed after it."""

    def __init__(self):
        self.gather: list = []  # (t0, t1) perf_counter seconds
        self.cop: list = []
        self._undo: list = []
        self._mu = threading.Lock()

    def _wrap(self, owner, attr, into, key=None):
        orig = owner[key] if key is not None else getattr(owner, attr)
        mu = self._mu

        def spanned(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                with mu:
                    into.append((t0, t1))

        if key is not None:
            owner[key] = spanned
            self._undo.append(lambda: owner.__setitem__(key, orig))
        else:
            setattr(owner, attr, spanned)
            self._undo.append(lambda: setattr(owner, attr, orig))

    def install(self) -> None:
        from tidb_tpu_torch.copr import client
        from tidb_tpu_torch.kv.kv import StoreType
        from tidb_tpu_torch.parallel.gather import MPPGatherExec

        self._wrap(MPPGatherExec, "execute", self.gather)
        self._wrap(client._engines(), None, self.cop, key=StoreType.GPU)

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()


class Profiler:
    """The device's operations over the window. On ``cpu`` (the CPU
    tests' rehearsal only) the host's operators stand in for them."""

    def __init__(self, device: str = "cuda"):
        import torch
        from torch.profiler import ProfilerActivity, profile

        on_card = device != "cpu"
        self._prof = profile(activities=[ProfilerActivity.CUDA if on_card else ProfilerActivity.CPU])
        self._kind = torch.autograd.DeviceType.CUDA if on_card else torch.autograd.DeviceType.CPU
        self.offset_ns = 0

    def start(self) -> None:
        self._prof.start()
        self.offset_ns = time.time_ns() - int(time.perf_counter() * 1e9)

    def stop(self) -> None:
        self._prof.stop()

    def device_events(self):
        """(start_ns, end_ns, name) arrays of every device operation."""
        starts, ends, names = [], [], []
        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == self._kind:
                s = e.start_ns()
                starts.append(s)
                ends.append(s + e.duration_ns())
                names.append(e.name())
        return np.array(starts, np.int64), np.array(ends, np.int64), names


def busy_union(starts: np.ndarray, ends: np.ndarray, w0: int, w1: int):
    """Merged busy intervals of the device ops, clipped to [w0, w1]."""
    s, e = np.clip(starts, w0, w1), np.clip(ends, w0, w1)
    keep = e > s
    s, e = s[keep], e[keep]
    if not len(s):
        return s, e
    order = np.argsort(s, kind="stable")
    s, e = s[order], np.maximum.accumulate(e[order])
    new = np.r_[True, s[1:] > e[:-1]]
    first = np.flatnonzero(new)
    last = np.r_[first[1:] - 1, len(s) - 1]
    return s[first], e[last]


def _covering(t: np.ndarray, spans: list) -> np.ndarray:
    """Whether each time in ``t`` lies inside one of ``spans``
    (non-overlapping after merging)."""
    if not spans:
        return np.zeros(len(t), bool)
    a = np.array(sorted(spans))
    s, e = busy_union(a[:, 0], a[:, 1], a[:, 0].min(), a[:, 1].max())
    i = np.searchsorted(s, t, side="right") - 1
    return (i >= 0) & (e[np.maximum(i, 0)] > t)


def summarize(events, w0: int, w1: int, stmts: list, spans: Spans, offset_ns: int) -> Trace:
    """Busy seconds, window seconds, the top device ops by time and the
    longest idle gaps by host activity, over the window [w0, w1] (ns)."""
    starts, ends, names = events
    bs, be = busy_union(starts, ends, w0, w1)
    busy_s = float((be - bs).sum()) / 1e9
    by_name: dict = defaultdict(int)
    inside = (ends > w0) & (starts < w1)
    for i in np.flatnonzero(inside):
        by_name[names[i]] += int(min(ends[i], w1) - max(starts[i], w0))
    device_ops = [[n, v / 1e9] for n, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]]

    gs = np.r_[w0, be]
    ge = np.r_[bs, w1]
    keep = ge > gs
    gs, ge = gs[keep], ge[keep]
    mid = (gs + ge) // 2
    ns = lambda spans_s: [(int(a * 1e9) + offset_ns, int(b * 1e9) + offset_ns) for a, b in spans_s]  # noqa: E731
    phase = np.where(_covering(mid, ns(spans.gather)), 2, np.where(_covering(mid, ns(spans.cop)), 1, 0))
    templates = sorted({s.template for s in stmts})
    clients = sorted({s.client for s in stmts})
    codes = np.zeros((len(clients), len(mid)), np.int64)  # template index + 1 in flight, per client
    for k, client in enumerate(clients):
        mine = sorted((s for s in stmts if s.client == client), key=lambda s: s.t0)
        t0 = np.array([int(s.t0 * 1e9) + offset_ns for s in mine], np.int64)
        t1 = np.array([int(s.t1 * 1e9) + offset_ns for s in mine], np.int64)
        tpl = np.array([templates.index(s.template) + 1 for s in mine], np.int64)
        i = np.searchsorted(t0, mid, side="right") - 1
        on = (i >= 0) & (t1[np.maximum(i, 0)] > mid)
        codes[k] = np.where(on, tpl[np.maximum(i, 0)], 0)
    codes.sort(axis=0)
    key = np.zeros(len(mid), np.int64)
    for row in codes:
        key = key * (len(templates) + 1) + row
    key = key * 3 + phase
    gaps: dict = {}
    uniq, inv = np.unique(key, return_inverse=True)
    for u, total in zip(uniq, np.bincount(inv, weights=(ge - gs).astype(np.float64))):
        ph, rest, parts = int(u % 3), int(u // 3), []
        for _ in clients:
            rest, c = divmod(rest, len(templates) + 1)
            if c:
                parts.append(templates[c - 1])
        label = f"{'_'.join(sorted(parts))}:{('host', 'cop', 'gather')[ph]}" if parts else "between_statements"
        gaps[label] = gaps.get(label, 0) + int(total)
    idle_gaps = [[n, v / 1e9] for n, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]]
    return Trace(busy_s=busy_s, window_s=(w1 - w0) / 1e9, device_ops=device_ops, idle_gaps=idle_gaps)
