"""Generic timer framework (ref: pkg/timer — the runtime TTL and other
background jobs schedule on): named timers with intervals, driven either by
a daemon thread (production) or explicit tick() (tests)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Optional


@dataclass
class Timer:
    name: str
    interval_s: float
    fn: Callable[[], object]
    last_run: float = 0.0
    runs: int = 0
    last_error: Optional[str] = None


class TimerRuntime:
    def __init__(self):
        self._mu = threading.Lock()
        self._timers: dict[str, Timer] = {}
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    def register(self, name: str, interval_s: float, fn: Callable[[], object]) -> None:
        with self._mu:
            self._timers[name] = Timer(name, interval_s, fn)

    def unregister(self, name: str) -> None:
        with self._mu:
            self._timers.pop(name, None)

    def timers(self) -> list[Timer]:
        with self._mu:
            return list(self._timers.values())

    def tick(self, now: Optional[float] = None, force: bool = False) -> list[str]:
        """Run every timer whose interval elapsed; returns the names run."""
        now = time.monotonic() if now is None else now
        ran = []
        for t in self.timers():
            if force or now - t.last_run >= t.interval_s:
                t.last_run = now
                t.runs += 1
                try:
                    t.fn()
                    t.last_error = None
                except Exception as e:  # background jobs never kill the loop
                    t.last_error = str(e)
                ran.append(t.name)
        return ran

    def start(self, resolution_s: float = 0.5) -> None:
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.wait(resolution_s):
                self.tick()

        self._thread = threading.Thread(target=loop, daemon=True, name="timer-runtime")
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
            self._thread = None
