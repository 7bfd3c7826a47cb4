"""Executor layer.

Reference parity: pkg/executor — the Volcano engine (exec.Executor
Open/Next/Close, builder.go dispatch). Round-1 shape: operators materialize
chunks (streaming iteration is a later round; the coprocessor layer below
already streams per-region). Read path in executors.py, DML in write.py.
"""

from tidb_tpu_torch.executor.executors import build_executor, ExecError

__all__ = ["build_executor", "ExecError"]
