"""Typed retry/backoff layer — the Backoffer every distributed seam shares.

Reference parity: tikv/client-go ``internal/retry/backoff.go`` — one
``Backoffer`` per request carries a TOTAL sleep budget; each retriable
condition backs off under a typed config (``BoTiKVRPC``, ``BoRegionMiss``,
``BoTxnLock``, ...) with exponential growth and equal jitter; exhausting the
budget surfaces the LAST error, not a generic timeout. Surfaced in
``pkg/store/copr/coprocessor.go`` (region-error re-splitting) and
``pkg/store/copr/mpp_probe.go`` (store liveness).

Every retry loop in :mod:`tidb_tpu.kv.remote`, :mod:`tidb_tpu.kv.sharded`,
:mod:`tidb_tpu.copr.client`, and :mod:`tidb_tpu.parallel.gather` runs under
a Backoffer from this module — there is deliberately no second retry
mechanism. Tests drive determinism two ways: a seeded RNG makes the jitter
sequence reproducible, and the ``sleep`` hook lets a test capture sleeps
instead of paying them.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional

from tidb_tpu_torch.utils import eventlog as _ev


class BackoffConfig:
    """One retriable condition: exponential growth from ``base_ms`` capped at
    ``cap_ms`` (ref: backoff.go NewConfig — name, base, cap, jitter kind)."""

    __slots__ = ("name", "base_ms", "cap_ms", "jitter")

    def __init__(self, name: str, base_ms: float, cap_ms: float, jitter: str = "equal"):
        if jitter not in ("equal", "full", "none"):
            raise ValueError(f"unknown jitter mode {jitter!r}")
        self.name = name
        self.base_ms = base_ms
        self.cap_ms = cap_ms
        self.jitter = jitter

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"BackoffConfig({self.name}, base={self.base_ms}ms, cap={self.cap_ms}ms)"


# the typed conditions (ref: backoff.go BoTiKVRPC / BoRegionMiss / BoTiKVServerBusy /
# BoTxnLock / BoMaxTsNotSynced). Bases are small: the stores are local
# processes, so the first retry should land within a scheduler quantum.
boRPC = BackoffConfig("rpc", base_ms=10, cap_ms=400)  # wire hiccup / reconnect
boRegionMiss = BackoffConfig("regionMiss", base_ms=2, cap_ms=200)  # stale routing
boStoreDown = BackoffConfig("storeDown", base_ms=50, cap_ms=1000)  # owner loss
boTxnLock = BackoffConfig("txnLock", base_ms=1, cap_ms=100)  # foreign lock alive
boMPP = BackoffConfig("mpp", base_ms=1, cap_ms=50)  # mesh re-plan is local


RETRIABLE = "retriable"
FATAL = "fatal"
AMBIGUOUS = "ambiguous"


def classify(err: BaseException) -> str:
    """Error taxonomy (see RESILIENCE.md):

    - ``retriable`` — transient distributed failure: dropped frames, resets,
      timeouts, stale region routing. Safe to retry under a Backoffer.
    - ``ambiguous`` — the request MAY have executed (commit sent, reply
      lost). Never blind-retried; surfaces as UndeterminedError.
    - ``fatal`` — statement/data verdicts (conflicts, aborts, kills, OOM)
      and programming errors. Retrying would change semantics or never help.
    """
    from tidb_tpu_torch.kv.kv import KVError, RegionError, UndeterminedError

    if isinstance(err, UndeterminedError):
        return AMBIGUOUS
    if isinstance(err, RegionError):
        return RETRIABLE
    if isinstance(err, KVError):
        return FATAL  # conflicts/locks/aborts have their own resolution paths
    try:
        from tidb_tpu_torch.utils.memory import QueryKilledError, QueryOOMError

        if isinstance(err, (QueryKilledError, QueryOOMError)):
            return FATAL
    except ImportError:  # pragma: no cover
        pass
    if isinstance(err, (ConnectionError, TimeoutError, OSError)):
        return RETRIABLE
    if getattr(err, "retriable", False):
        return RETRIABLE
    return FATAL


class BackoffExhausted(Exception):
    """The Backoffer's total budget ran out. Carries the last underlying
    error so callers can surface the CAUSE, not the mechanism (ref:
    backoff.go returning the longest-sleeping config's error)."""

    def __init__(self, config: BackoffConfig, attempts: int, slept_ms: float, last: Optional[BaseException]):
        self.config = config
        self.attempts = attempts
        self.slept_ms = slept_ms
        self.last = last
        super().__init__(
            f"backoff budget exhausted after {attempts} attempts / {slept_ms:.0f}ms slept"
            + (f"; last error: {last}" if last is not None else "")
        )


class Backoffer:
    """Per-request retry budget (ref: backoff.go Backoffer).

    One instance travels with one logical request (a cop fan-out, a 2PC
    round, an MPP gather); every transient failure along the way calls
    :meth:`backoff` with its typed config. Sleeps grow exponentially per
    config, total sleep is capped by ``budget_ms``, and the jitter stream is
    deterministic under a fixed ``seed`` — chaos tests schedule exact fault
    sequences and still assert exact retry behavior.

    Thread-safe: cop worker pools share one Backoffer per request.
    """

    def __init__(
        self,
        budget_ms: float = 5000,
        seed: Optional[int] = None,
        sleep: Callable[[float], None] = time.sleep,
    ):
        self.budget_ms = budget_ms
        # RNG construction is LAZY: one Backoffer travels with every cop
        # request, and seeding a Mersenne state per request was measurable
        # on the warm query path — a request that never backs off never pays
        # it. Determinism is unchanged: Random(seed) built at first backoff
        # replays the same jitter stream as one built here.
        self._seed = seed
        self._rng: Optional[random.Random] = None
        self._sleep = sleep
        self._mu = threading.Lock()
        self._attempts: dict[str, int] = {}
        self._slept_ms = 0.0
        self._errors: list[BaseException] = []

    # -- introspection ------------------------------------------------------
    def attempts(self, config: Optional[BackoffConfig] = None) -> int:
        with self._mu:
            if config is None:
                return sum(self._attempts.values())
            return self._attempts.get(config.name, 0)

    @property
    def slept_ms(self) -> float:
        with self._mu:
            return self._slept_ms

    def remaining_ms(self) -> float:
        with self._mu:
            return max(0.0, self.budget_ms - self._slept_ms)

    def errors(self) -> list[BaseException]:
        with self._mu:
            return list(self._errors)

    # -- the verb -----------------------------------------------------------
    def backoff(self, config: BackoffConfig, err: Optional[BaseException] = None) -> float:
        """Sleep once under ``config`` and record the attempt; returns the
        slept milliseconds. Raises :class:`BackoffExhausted` when the sleep
        would cross the budget, and re-raises ``err`` immediately when it
        classifies as fatal/ambiguous (belt-and-braces: a caller should not
        have asked to retry it)."""
        if err is not None and classify(err) != RETRIABLE:
            raise err
        with self._mu:
            if err is not None and len(self._errors) < 16:
                self._errors.append(err)
            if self._rng is None:
                self._rng = random.Random(self._seed)
            n = self._attempts.get(config.name, 0)
            raw = min(config.cap_ms, config.base_ms * (2 ** n))
            if config.jitter == "equal":
                sleep_ms = raw / 2 + self._rng.random() * raw / 2
            elif config.jitter == "full":
                sleep_ms = self._rng.random() * raw
            else:
                sleep_ms = raw
            if self._slept_ms + sleep_ms > self.budget_ms:
                exhausted = BackoffExhausted(
                    config, sum(self._attempts.values()), self._slept_ms, err
                )
                lg = _ev.on(_ev.ERROR)
                if lg is not None:
                    lg.emit(
                        _ev.ERROR,
                        "backoff",
                        "exhausted",
                        config=config.name,
                        attempts=exhausted.attempts,
                        slept_ms=round(exhausted.slept_ms, 2),
                        last=str(err) if err is not None else None,
                    )
                raise exhausted
            self._attempts[config.name] = n + 1
            self._slept_ms += sleep_ms
        from tidb_tpu_torch.utils import metrics as _metrics

        # regionMiss sleeps are the re-route signal (stale placement → refresh
        # → retry) and log at info; everything else is debug-only churn
        lvl = _ev.INFO if config.name == "regionMiss" else _ev.DEBUG
        lg = _ev.on(lvl)
        if lg is not None:
            lg.emit(
                lvl,
                "backoff",
                "region_miss" if config.name == "regionMiss" else "sleep",
                config=config.name,
                attempt=n + 1,
                sleep_ms=round(sleep_ms, 2),
            )
        _metrics.BACKOFF_TOTAL.inc(config=config.name)
        self._sleep(sleep_ms / 1000.0)
        return sleep_ms
