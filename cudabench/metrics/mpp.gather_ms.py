"""Mean MPP gather wall per statement (``Session.mpp_details`` wall_ms)."""

from cudabench.records import mean


def read(run):
    return mean([s.gather_ms for s in run.done() if s.gathers])
