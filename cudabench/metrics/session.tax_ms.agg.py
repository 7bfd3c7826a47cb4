"""The SQL front's share of a cop statement: mean over the window's
statements of the statement wall less its longest cop task's proc_ms."""

from cudabench.records import mean


def read(run):
    return mean([s.wall_ms - s.max_proc_ms for s in run.done() if s.cop_tasks])
