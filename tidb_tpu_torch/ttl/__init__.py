"""TTL row expiry (ref: pkg/ttl — ttlworker/job_manager.go:98 scanning
expired rows via SQL jobs on the timer framework)."""

from tidb_tpu_torch.ttl.worker import run_ttl_once

__all__ = ["run_ttl_once"]
