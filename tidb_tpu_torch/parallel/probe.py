"""MPP device failure detection & recovery.

Reference parity: the TiFlash liveness prober (pkg/store/copr/mpp_probe.go:62
MPPFailedStoreProber — detect loop :190, recovery :235) and the MPP retry
wrapper (pkg/executor/internal/mpp/executor_with_retry.go:40). A mesh has its
own failure modes — device loss, per-shard OOM, a hung ICI collective — so
the gather executor reports failures here, plans its next attempt on the
surviving devices, and blacklisted devices are re-probed (time-based) so a
recovered chip rejoins the mesh.
"""

from __future__ import annotations

import threading
import time


class DeviceProber:
    """Blacklist with timed recovery. Keys are stable device identifiers
    (``id(device)`` of jax Device objects — the process-lifetime identity the
    mesh cache also uses)."""

    def __init__(self, recovery_s: float = 60.0):
        self.recovery_s = recovery_s
        self._mu = threading.Lock()
        self._failed: dict[int, float] = {}  # dev key → fail time

    def report_failure(self, dev) -> None:
        with self._mu:
            self._failed[id(dev)] = time.monotonic()

    def report_ok(self, dev) -> None:
        with self._mu:
            self._failed.pop(id(dev), None)

    def alive(self, devices: list) -> list:
        """Filter out blacklisted devices; entries past the recovery window
        are dropped (the next attempt re-probes them — ref mpp_probe
        MaxObsoletTime recovery)."""
        now = time.monotonic()
        with self._mu:
            for k in [k for k, t in self._failed.items() if now - t > self.recovery_s]:
                del self._failed[k]
            return [d for d in devices if id(d) not in self._failed]

    def failed_count(self) -> int:
        with self._mu:
            return len(self._failed)


GLOBAL_PROBER = DeviceProber()

# total backoff sleep one MPP gather may spend across ALL its retry attempts
# (device re-plans + unattributed same-mesh retries share this one budget —
# ref: executor_with_retry.go bounding the whole retry loop, not per-attempt)
MPP_RETRY_BUDGET_MS = 2000.0


def gather_backoffer(seed=None):
    """The per-gather Backoffer every MPP retry runs under (see
    utils/backoff.py). One instance per gather execution: attempts against a
    shrinking mesh and unattributed retries draw from the same budget."""
    from tidb_tpu_torch.utils.backoff import Backoffer

    return Backoffer(budget_ms=MPP_RETRY_BUDGET_MS, seed=seed)


def probe_and_blacklist(devices, prober: DeviceProber = GLOBAL_PROBER) -> int:
    """Liveness-probe each device with a tiny round-trip computation (the
    MPPAlive probe analog, mpp_probe.go detect loop) and blacklist the ones
    that fail. Returns how many new failures were recorded — the production
    attribution path when an XLA error doesn't name its device."""
    import torch

    n = 0
    for d in devices:
        try:
            (torch.zeros(8, dtype=torch.int32, device=d) + 1).cpu()
            if d.type == "cuda":
                torch.cuda.synchronize(d)
            prober.report_ok(d)
        except Exception:
            prober.report_failure(d)
            n += 1
    return n


class MPPRetryExhausted(Exception):
    """All MPP attempts failed — the session re-plans without MPP (ref:
    executor_with_retry giving up → error surfaced / fallback)."""


class MPPStraddleError(MPPRetryExhausted):
    """A gather's readers live on MULTIPLE store shards, so single-owner
    dispatch cannot place it. Subclasses MPPRetryExhausted (any handler that
    re-plans without MPP still works), but the gather executor catches it
    FIRST and runs the hybrid shards × devices path: reader materialization
    crosses the wire per owner (today's cop/columnar route), the staged
    fragment program runs on the coordinator's own mesh."""


class MPPTaskLostError(Exception):
    """The storage server no longer knows a dispatched task (it restarted
    between dispatch and conn, or the task was reclaimed). Retriable at the
    GATHER level by a fresh dispatch — the client-go mpp_probe lost-task
    recovery idiom: re-dispatch to a surviving owner instead of failing the
    whole gather."""
