"""The SQL front's share of an MPP statement: mean over the window's
statements of the statement wall less its gathers' walls (mpp_details)."""

from cudabench.records import mean


def read(run):
    return mean([s.wall_ms - s.gather_ms for s in run.done() if s.gathers])
