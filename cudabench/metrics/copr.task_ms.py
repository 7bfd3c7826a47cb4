"""The cop fan-out and gpu engine: mean over the window's statements of
the longest cop task's proc_ms (the task that sets the statement's wait)."""

from cudabench.records import mean


def read(run):
    return mean([s.max_proc_ms for s in run.done() if s.cop_tasks])
