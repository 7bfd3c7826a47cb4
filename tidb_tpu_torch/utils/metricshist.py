"""In-process metrics history: a bounded ring time-series recorder.

Reference parity: the ``metrics_schema`` time-series views TiDB fronts a
Prometheus with — except here there is no external scraper: one daemon
thread samples ``utils/metrics.REGISTRY`` every
``[observability] metrics-history-interval-s`` seconds into per-series
rings bounded by ``metrics-history-retention`` (Monarch's in-process
collection idiom). "What did ``qps`` / ``mpp_shard_seconds`` look like
five minutes ago" becomes one query against
``information_schema.metrics_history`` (or ``GET /metrics/history``), and
the fleet-wide variant rides the ``sys_snapshot`` introspection verb
(``information_schema.cluster_metrics_history``).

Footprint discipline: counters/gauges record one point per label set per
tick (plus a ``__total__`` roll-up per metric — the rate/QPS read);
histograms record ``<name>_sum`` and ``<name>_count``. Series count is
capped; each ring holds ``retention/interval`` points of two floats. The
recorder is refcounted — the server boot paths and ``DB.start_background``
start it, and the thread (named ``metrics-history``, covered by the test
suite's thread-hygiene guard) dies when the last holder stops it.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

from tidb_tpu_torch.utils import metrics as _metrics

# process birth (the uptime anchor for sys_snapshot reports)
PROC_START = time.time()

# the label-string key of the per-metric roll-up series (sum over every
# label combination — what rate()/QPS reads want)
TOTAL = "__total__"


class MetricsHistory:
    """Bounded per-series rings of (unix_ts, value) samples."""

    def __init__(
        self,
        interval_s: float = 5.0,
        retention_s: float = 600.0,
        registry=None,
        max_series: int = 512,
    ):
        self.interval_s = float(interval_s)
        self.retention_s = float(retention_s)
        self._registry = registry if registry is not None else _metrics.REGISTRY
        self._mu = threading.Lock()
        self._series: dict[tuple[str, str], deque] = {}
        self._max_series = max(int(max_series), 8)
        self.dropped_series = 0
        self._refs = 0
        self._stop: Optional[threading.Event] = None
        self._thread: Optional[threading.Thread] = None

    # -- sampling ------------------------------------------------------------
    def _maxlen(self) -> int:
        iv = max(self.interval_s, 0.05)
        return max(int(self.retention_s / iv) + 1, 2)

    def sample_now(self, now: Optional[float] = None) -> None:
        """One synchronous sample of the whole registry (the recorder thread
        calls this per tick; tests call it directly for determinism)."""
        snap = self._registry.snapshot()
        t = time.time() if now is None else float(now)
        with self._mu:
            for name, m in snap.items():
                if m["kind"] == "histogram":
                    self._append((name + "_sum", ""), t, float(m["sum"]))
                    self._append((name + "_count", ""), t, float(m["count"]))
                    continue
                lnames = m["labels"]
                total = 0.0
                for key, v in m["values"]:
                    total += v
                    lbl = ",".join(f"{k}={val}" for k, val in zip(lnames, key))
                    self._append((name, lbl), t, float(v))
                if lnames:
                    # roll-up series: the one a rate/QPS read wants
                    self._append((name, TOTAL), t, float(total))
            _metrics.METRICS_HISTORY_POINTS.set(
                sum(len(d) for d in self._series.values())
            )

    def _append(self, key: tuple[str, str], t: float, v: float) -> None:
        ml = self._maxlen()
        d = self._series.get(key)
        if d is None:
            if len(self._series) >= self._max_series:
                self.dropped_series += 1
                return
            d = self._series[key] = deque(maxlen=ml)
        elif d.maxlen != ml:
            # interval/retention changed on a live recorder (benchdaily's
            # hostile-tick lane does this): re-bound the ring, or a series
            # born under a fast tick keeps a huge maxlen forever
            d = self._series[key] = deque(d, maxlen=ml)
        d.append((t, v))

    # -- reads ---------------------------------------------------------------
    def series(self, name: Optional[str] = None, since: Optional[float] = None):
        """→ [(name, labels, unix_ts, value)] sorted by (name, labels, ts)."""
        with self._mu:
            out = []
            for (n, lbl), d in sorted(self._series.items()):
                if name is not None and n != name:
                    continue
                for t, v in d:
                    if since is not None and t < since:
                        continue
                    out.append((n, lbl, t, v))
            return out

    def rate(self, name: str, labels: str = TOTAL, window_s: float = 60.0) -> float:
        """Recent per-second rate of a CUMULATIVE series (counter roll-up or
        a histogram's ``_count``): delta over the newest sample reaching back
        ``window_s`` (or the oldest retained). 0.0 when under two samples."""
        with self._mu:
            d = self._series.get((name, labels))
            if d is None and labels == TOTAL:
                # unlabeled counters record under "" (no roll-up needed)
                d = self._series.get((name, ""))
            if d is None or len(d) < 2:
                return 0.0
            t1, v1 = d[-1]
            t0, v0 = d[0]
            for t, v in reversed(d):
                if t1 - t >= window_s:
                    t0, v0 = t, v
                    break
            if t1 <= t0:
                return 0.0
            return max(v1 - v0, 0.0) / (t1 - t0)

    def points(self) -> int:
        with self._mu:
            return sum(len(d) for d in self._series.values())

    def clear(self) -> None:
        with self._mu:
            self._series.clear()

    # -- lifecycle (refcounted: server boot + DB.start_background share one
    # process recorder; the thread dies with the LAST stop()) ---------------
    @property
    def running(self) -> bool:
        t = self._thread
        return t is not None and t.is_alive()

    def start(self) -> None:
        with self._mu:
            self._refs += 1
            if self.running or self.interval_s <= 0:
                return
            self._stop = threading.Event()
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="metrics-history"
            )
            self._thread.start()

    def _loop(self) -> None:
        stop = self._stop
        self.sample_now()  # short-lived processes still get one point
        while not stop.wait(max(self.interval_s, 0.05)):
            self.sample_now()

    def stop(self) -> None:
        with self._mu:
            self._refs = max(self._refs - 1, 0)
            if self._refs > 0 or self._thread is None:
                return
            stop, thread = self._stop, self._thread
            self._stop = self._thread = None
        if stop is not None:
            stop.set()
        if thread is not None:
            thread.join(timeout=5)


# -- process-global recorder --------------------------------------------------
_REC: Optional[MetricsHistory] = None
_REC_MU = threading.Lock()


def recorder() -> MetricsHistory:
    """The process recorder, built from ``[observability]`` config on first
    use. One per process: every starter (StoreServer, DB.start_background,
    the bootable server) shares it refcounted."""
    global _REC
    with _REC_MU:
        if _REC is None:
            from tidb_tpu_torch import config as _config

            cfg = _config.current()
            _REC = MetricsHistory(
                interval_s=cfg.metrics_history_interval_s,
                retention_s=cfg.metrics_history_retention_s,
            )
        return _REC
