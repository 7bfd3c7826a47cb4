"""Fault injection: the store wrapper and the deterministic chaos toolkit.

Reference parity: ``pkg/kv/fault_injection.go`` (InjectedStore /
InjectedTransaction — configurable errors on get/scan/commit/prewrite
without failpoint rewrites) plus the failpoint *scheduling* idioms the
reference's 238 failpoint call sites rely on (``N*return(x)`` one-shot
counts, ``x%return`` probabilities — pingcap/failpoint term grammar).

Two layers live here:

1. :class:`InjectedStore` + :class:`InjectionConfig` — wrap a kv.Storage so
   tests force typed errors on get/scan/prewrite/commit, permanently or for
   exactly ``n_times`` calls (one-shot semantics).
2. Chaos actions for :mod:`tidb_tpu.utils.failpoint` points — :class:`NShot`,
   :class:`Probabilistic` (seeded RNG → reproducible schedules), and
   :class:`Script` (exact per-call fault sequences). Combined with the wire
   failpoints in ``kv/remote.py`` (``remote_send`` / ``remote_recv``) they
   reach down to the frame level: drops, delays, and connection resets
   against real multi-process topologies.
"""

from __future__ import annotations

import random
import threading
import time
from typing import Callable, Optional, Sequence

# -- failpoint registry ------------------------------------------------------
#
# The authoritative set of failpoint names the package defines (every
# ``failpoint.inject("<name>", ...)`` call site). Failpoints are armed by
# bare string name, so a typo'd name in a chaos test silently never fires
# and the test passes vacuously; graftcheck's ``failpoint-registry`` rule
# cross-checks every reference in package code AND tests/ against this set,
# and flags stale entries whose inject site was removed. Adding a new
# inject site means adding its name here in the same change.

FAILPOINTS = frozenset(
    {
        "colcache_merge",  # copr/colcache.py: mid-merge crash atomicity
        "cop_task_engine",  # copr/client.py: per-task engine fault/degrade
        "ddl/afterStateSwitch",  # catalog/ddl.py: crash between DDL states
        "ddl/beforeBackfillBatch",  # catalog/ddl.py: crash mid-backfill
        "disttask_local_worker_start",  # disttask/framework.py: slow worker
        "import_subtask_before_ingest",  # tools/importer.py: subtask restart
        "mpp_run_fragment",  # parallel/gather.py: fragment dispatch fault
        "mpp_shard_slow",  # parallel/gather.py: per-shard straggler delay
        "placement_cutover",  # kv/placement.py: hold the migration fence
        "placement_migrate_batch",  # kv/placement.py: slow copy batches
        "remote_send",  # kv/remote.py: wire frame drop/delay on send
        "remote_recv",  # kv/remote.py: wire frame drop/delay on receive
        "table_reader_begin",  # executor/executors.py: park a reader mid-stmt
    }
)


class InjectionConfig:
    """Configurable error hooks. Each hook is ``(exception, remaining)``:
    ``remaining is None`` fires forever (the original permanent semantics);
    an integer fires for exactly that many calls, then disarms itself."""

    _HOOKS = ("get", "scan", "commit", "prewrite")

    def __init__(self):
        self._mu = threading.Lock()
        self._errs: dict[str, tuple[Exception, Optional[int]]] = {}

    def _set(self, name: str, err: Optional[Exception], n_times: Optional[int]) -> None:
        if name not in self._HOOKS:
            raise KeyError(f"unknown injection hook {name!r}")
        with self._mu:
            if err is None:
                self._errs.pop(name, None)
            else:
                self._errs[name] = (err, n_times)

    def _take(self, name: str) -> Optional[Exception]:
        """The armed error for ``name`` (decrementing one-shot counts)."""
        with self._mu:
            ent = self._errs.get(name)
            if ent is None:
                return None
            err, n = ent
            if n is not None:
                if n <= 1:
                    del self._errs[name]
                else:
                    self._errs[name] = (err, n - 1)
            return err

    def set_get_error(self, err: Optional[Exception], n_times: Optional[int] = None) -> None:
        self._set("get", err, n_times)

    def set_scan_error(self, err: Optional[Exception], n_times: Optional[int] = None) -> None:
        self._set("scan", err, n_times)

    def set_commit_error(self, err: Optional[Exception], n_times: Optional[int] = None) -> None:
        self._set("commit", err, n_times)

    def set_prewrite_error(self, err: Optional[Exception], n_times: Optional[int] = None) -> None:
        self._set("prewrite", err, n_times)


class InjectedSnapshot:
    def __init__(self, snap, cfg: InjectionConfig):
        self._snap = snap
        self._cfg = cfg

    def get(self, key):
        err = self._cfg._take("get")
        if err is not None:
            raise err
        return self._snap.get(key)

    def scan(self, *args, **kwargs):
        err = self._cfg._take("scan")
        if err is not None:
            raise err
        return self._snap.scan(*args, **kwargs)

    def __getattr__(self, name):
        return getattr(self._snap, name)


class InjectedTxn:
    def __init__(self, txn, cfg: InjectionConfig):
        self._txn = txn
        self._cfg = cfg

    def get(self, key):
        err = self._cfg._take("get")
        if err is not None:
            raise err
        return self._txn.get(key)

    def scan(self, *args, **kwargs):
        err = self._cfg._take("scan")
        if err is not None:
            raise err
        return self._txn.scan(*args, **kwargs)

    def commit(self):
        err = self._cfg._take("commit")
        if err is not None:
            raise err
        return self._txn.commit()

    def __getattr__(self, name):
        return getattr(self._txn, name)


class InjectedStore:
    """kv.Storage wrapper; pass the real store everywhere else."""

    def __init__(self, store, cfg: Optional[InjectionConfig] = None):
        self._store = store
        self.cfg = cfg or InjectionConfig()

    def get_snapshot(self, ts):
        return InjectedSnapshot(self._store.get_snapshot(ts), self.cfg)

    def begin(self):
        return InjectedTxn(self._store.begin(), self.cfg)

    def prewrite(self, mutations, primary, start_ts):
        err = self.cfg._take("prewrite")
        if err is not None:
            raise err
        return self._store.prewrite(mutations, primary, start_ts)

    def __getattr__(self, name):
        return getattr(self._store, name)


# -- chaos actions for failpoints ------------------------------------------
#
# These are *callables* for failpoint.enable(name, action): the point fires
# them with its site args. Raising simulates the fault; returning None lets
# the call proceed. All counters are thread-safe, and every random choice
# comes from a SEEDED rng (see the Probabilistic caveat on concurrency —
# exact schedules belong to Script/NShot).


class NShot:
    """Fire ``action`` for the first ``n_times`` *matching* calls, then pass
    (ref: failpoint ``N*return`` terms). ``match(*args)`` filters by site
    args — e.g. only ``cmd == "cop"`` frames of the wire point."""

    def __init__(self, action: Callable, n_times: int = 1, match: Optional[Callable] = None):
        self._action = action
        self._match = match
        self._mu = threading.Lock()
        self.remaining = n_times
        self.fired = 0
        self.calls = 0

    def __call__(self, *args):
        with self._mu:
            self.calls += 1
            if self._match is not None and not self._match(*args):
                return None
            if self.remaining <= 0:
                return None
            self.remaining -= 1
            self.fired += 1
        return self._action(*args)


class Probabilistic:
    """Fire ``action`` with probability ``p`` per matching call, from a
    SEEDED rng (ref: failpoint ``x%return`` terms). The DRAW sequence is
    reproducible; which call consumes which draw is not when the point is
    hit concurrently (the cop fan-out's worker pool races for the rng), so
    the same seed can fault different (task, verb) pairs run-to-run. Use
    :class:`Script`/:class:`NShot` with a ``match`` filter when a test must
    schedule exact faults; use this for soak-style randomized pressure."""

    def __init__(self, action: Callable, p: float, seed: int, match: Optional[Callable] = None):
        self._action = action
        self._p = p
        self._match = match
        self._mu = threading.Lock()
        self._rng = random.Random(seed)
        self.fired = 0

    def __call__(self, *args):
        if self._match is not None and not self._match(*args):
            return None
        with self._mu:
            fire = self._rng.random() < self._p
            if fire:
                self.fired += 1
        return self._action(*args) if fire else None


class Script:
    """Exact per-call fault sequence: step k of ``steps`` decides call k.
    A step is None (pass), an Exception instance (raised), a float (sleep
    seconds — injected latency), or a callable (run with the site args).
    Past the end of the script every call passes."""

    def __init__(self, steps: Sequence, match: Optional[Callable] = None):
        self._steps = list(steps)
        self._match = match
        self._mu = threading.Lock()
        self._idx = 0

    def __call__(self, *args):
        if self._match is not None and not self._match(*args):
            return None
        with self._mu:
            if self._idx >= len(self._steps):
                return None
            step = self._steps[self._idx]
            self._idx += 1
        if step is None:
            return None
        if isinstance(step, BaseException):
            raise step
        if isinstance(step, (int, float)):
            time.sleep(step)
            return None
        return step(*args)


def reset_wire(*_args):
    """Chaos action: sever the connection (frame drop / peer reset). The
    retry layer sees exactly what a killed store produces."""
    raise ConnectionResetError("chaos: injected connection reset")


def delay(seconds: float) -> Callable:
    """Chaos action factory: inject ``seconds`` of wire latency."""

    def _sleep(*_args):
        time.sleep(seconds)

    return _sleep
