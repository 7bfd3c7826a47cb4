"""Distributed task framework (ref: pkg/disttask/framework — scheduler.go:61
dispatching subtasks, taskexecutor/interface.go:70 running them, proto/task.go
state machine, framework/storage system-table persistence)."""

from tidb_tpu_torch.disttask.framework import (
    DistTaskManager,
    StepExecutor,
    SchedulerExt,
    TaskState,
    SubtaskState,
    register_task_type,
)

__all__ = [
    "DistTaskManager",
    "StepExecutor",
    "SchedulerExt",
    "TaskState",
    "SubtaskState",
    "register_task_type",
]
