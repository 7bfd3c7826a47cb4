"""What a run records, and the per-metric readers that reduce it.

A metric of ``BENCHMARK.json`` is read by ``metrics/<name>.py``: a module
with ``read(run) -> float | None`` over the ``Run`` below. A reader that
finds nothing to read returns None and the harness leaves the metric out
of the result line. Adding a metric is adding its file and its entry.
"""

from __future__ import annotations

import importlib.util
import math
from dataclasses import dataclass, field
from pathlib import Path

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclass
class Stmt:
    """One statement a client sent: host-clock times (``time.perf_counter``
    seconds), the rows ``Session.query`` returned, and what the session
    recorded of it (``exec_summary`` and ``mpp_details``)."""

    client: int
    index: int  # position in the traffic file's statement list
    template: str
    t0: float
    t1: float
    rows: list | None = None
    error: str = ""
    cop_tasks: int = 0
    max_proc_ms: float = 0.0  # the longest cop task's proc_ms
    gathers: int = 0
    gather_ms: float = 0.0  # summed wall_ms of the statement's MPP gathers
    exchange_bytes: int = 0  # shards' exchanged bytes + stage_bytes

    @property
    def wall_ms(self) -> float:
        return (self.t1 - self.t0) * 1e3


@dataclass
class Trace:
    """The profiler's reading of the window: device busy seconds (the
    union of device-op intervals), the traced window's length, and the
    breakdown lists."""

    busy_s: float
    window_s: float
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


@dataclass
class Run:
    setup_s: float
    t_start: float  # the window, on the statements' clock
    t_end: float
    stmts: list  # every Stmt sent in the window, finished or not by its close
    builds: dict  # counter growth inside the window: {"cop": n, "mpp": n}
    stmt_bytes: dict  # statement index -> bytes its template must read
    hbm_bytes_per_s: float
    trace: Trace | None = None

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_start

    def done(self) -> list:
        """Statements that completed inside the window, without error."""
        return [s for s in self.stmts if s.t1 <= self.t_end and not s.error]


def percentile(values: list, q: float) -> float | None:
    """The ``q``-th percentile, linear between closest ranks (numpy's
    default method)."""
    if not values:
        return None
    v = sorted(values)
    pos = (len(v) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def mean(values: list) -> float | None:
    return sum(values) / len(values) if values else None


def reader(name: str):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = METRICS_DIR / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no reader for metric {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location("cudabench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def available() -> list:
    """The metric names that have a reader."""
    return sorted(p.name[: -len(".py")] for p in METRICS_DIR.glob("*.py") if not p.name.startswith("_"))
