"""Top-SQL + continuous CPU profiling (ref: util/topsql — per-SQL-digest CPU
attribution reported to the dashboard; util/cpuprofile — the shared
continuous profile window).

tpu-native redesign: the reference samples Go pprof labels; here a sampler
thread walks ``sys._current_frames()`` on an interval and attributes each
sample to whatever SQL digest the sampled thread REGISTERED at statement
start (``attach``/``detach``).  Two aggregations come out of one sampler:

- per-digest CPU samples over a ring of 1-second windows (Top-SQL);
- collapsed-stack counts over the same ring (continuous profiling; the
  /status/profile endpoint renders them flamegraph-style: "a;b;c count").
"""

from __future__ import annotations

import sys
import threading
import time
from collections import defaultdict


class TopSQLCollector:
    """One process-wide sampler (started lazily, stopped at close)."""

    def __init__(self, interval_s: float = 0.02, window_s: int = 1, keep_windows: int = 120):
        self.interval_s = interval_s
        self.window_s = window_s
        self.keep = keep_windows
        self._mu = threading.Lock()
        # thread ident → stack of (sql_digest, plan_digest, sample_sql,
        # trace_id): nested internal statements (privilege checks,
        # infoschema helpers) push/pop; samples attribute to the TOP entry
        self._attached: dict[int, list[tuple[str, str, str, str]]] = {}
        # ring: window start ts → digest → samples
        self._windows: dict[int, dict[str, int]] = {}
        self._samples_of: dict[str, str] = {}  # digest → sample sql text
        self._plan_of: dict[str, str] = {}  # digest → plan digest
        # digest → the last trace-sampled statement's reservoir trace id:
        # the Top-SQL ↔ trace-reservoir pivot (GET /traces?id=...)
        self._trace_of: dict[str, str] = {}
        # digest → cumulative metered request units (workload attribution:
        # hot-by-CPU vs hot-by-RU can rank differently — scan-heavy
        # statements burn RUs in the store, not in this process's frames)
        self._ru_of: dict[str, float] = defaultdict(float)
        # collapsed python stacks: "mod.fn;mod.fn;..." → samples
        self._stacks: dict[int, dict[str, int]] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.enabled = True

    # -- statement attribution (called by the session) ----------------------
    def attach(self, sql_digest: str, plan_digest: str, sample_sql: str, trace_id: str = "") -> None:
        self._ensure_running()
        tid = threading.get_ident()
        with self._mu:
            self._attached.setdefault(tid, []).append(
                (sql_digest, plan_digest, sample_sql[:256], trace_id)
            )

    def note_ru(self, sql_digest: str, ru: float) -> None:
        """Accumulate a finished statement's metered RUs on its digest."""
        with self._mu:
            self._ru_of[sql_digest] += ru

    def detach(self) -> None:
        tid = threading.get_ident()
        with self._mu:
            stack = self._attached.get(tid)
            if stack:
                stack.pop()
            if not stack:
                self._attached.pop(tid, None)

    # -- sampler ------------------------------------------------------------
    def _ensure_running(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._run, daemon=True, name="topsql-sampler")
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            if not self.enabled:
                continue
            with self._mu:
                attached = dict(self._attached)
            if not attached:
                continue  # idle: no stop-the-world frame walks
            now_w = int(time.time()) // self.window_s * self.window_s
            # collect OUTSIDE the lock and drop frame references promptly —
            # held frames pin their locals (sockets, buffers) alive
            hits: list[tuple[str, str, str, str, str]] = []
            frames = sys._current_frames()
            try:
                for tid, stack_entries in attached.items():
                    if not stack_entries:
                        continue
                    dg, pdg, sample, trace_id = stack_entries[-1]
                    f = frames.get(tid)
                    if f is None:
                        continue
                    parts = []
                    g = f
                    depth = 0
                    while g is not None and depth < 48:
                        co = g.f_code
                        parts.append(f"{co.co_filename.rsplit('/', 1)[-1]}:{co.co_name}")
                        g = g.f_back
                        depth += 1
                    del g, f
                    hits.append((dg, pdg, sample, trace_id, ";".join(reversed(parts))))
            finally:
                del frames
            with self._mu:
                win = self._windows.setdefault(now_w, defaultdict(int))
                swin = self._stacks.setdefault(now_w, defaultdict(int))
                for dg, pdg, sample, trace_id, stack in hits:
                    win[dg] += 1
                    self._samples_of[dg] = sample
                    self._plan_of[dg] = pdg
                    if trace_id:  # keep the last SAMPLED statement's pivot
                        self._trace_of[dg] = trace_id
                    swin[stack] += 1
                # expire old windows — and prune digest metadata no retained
                # window references, or a long-lived server accumulates one
                # sample/plan entry per distinct SQL digest forever
                if len(self._windows) > self.keep:
                    for k in sorted(self._windows)[: len(self._windows) - self.keep]:
                        self._windows.pop(k, None)
                        self._stacks.pop(k, None)
                    live = {dg for counts in self._windows.values() for dg in counts}
                    for dg in list(self._samples_of):
                        if dg not in live:
                            self._samples_of.pop(dg, None)
                            self._plan_of.pop(dg, None)
                            self._trace_of.pop(dg, None)
                            self._ru_of.pop(dg, None)

    # -- reports ------------------------------------------------------------
    def top_sql(self, last_s: int = 60, limit: int = 30) -> list[tuple]:
        """[(digest, plan_digest, sample_sql, cpu_seconds, samples,
        trace_id, ru)] over the trailing ``last_s`` seconds, hottest first.
        ``trace_id`` cross-links to the trace reservoir when a sampled
        statement contributed samples; ``ru`` is the digest's cumulative
        metered request units (lifetime — RUs land once per statement, not
        per sample, so they don't window)."""
        cutoff = int(time.time()) - last_s
        agg: dict[str, int] = defaultdict(int)
        with self._mu:
            for w, counts in self._windows.items():
                if w >= cutoff:
                    for dg, n in counts.items():
                        agg[dg] += n
            rows = [
                (
                    dg,
                    self._plan_of.get(dg, ""),
                    self._samples_of.get(dg, ""),
                    round(n * self.interval_s, 4),
                    n,
                    self._trace_of.get(dg, ""),
                    round(self._ru_of.get(dg, 0.0), 3),
                )
                for dg, n in agg.items()
            ]
        rows.sort(key=lambda r: -r[4])
        return rows[:limit]

    def profile(self, last_s: int = 60, limit: int = 100) -> list[tuple[str, int]]:
        """Collapsed-stack lines over the trailing window (flamegraph
        input format: 'frame;frame;frame count')."""
        cutoff = int(time.time()) - last_s
        agg: dict[str, int] = defaultdict(int)
        with self._mu:
            for w, stacks in self._stacks.items():
                if w >= cutoff:
                    for s, n in stacks.items():
                        agg[s] += n
        rows = sorted(agg.items(), key=lambda kv: -kv[1])
        return rows[:limit]


_GLOBAL: TopSQLCollector | None = None
_GLOBAL_MU = threading.Lock()


def collector() -> TopSQLCollector:
    global _GLOBAL
    with _GLOBAL_MU:
        if _GLOBAL is None:
            _GLOBAL = TopSQLCollector()
        return _GLOBAL
