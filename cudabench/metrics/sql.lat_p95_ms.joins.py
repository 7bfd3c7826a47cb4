"""The join stream's tail, as a layer's reading: 95th percentile of the
statement walls completed inside the window (host clock)."""

from cudabench.records import percentile


def read(run):
    return percentile([s.wall_ms for s in run.done()], 95)
