"""The aggregation stream's tail, as a layer's reading: 95th percentile
over every statement completed inside the window, from its
``Session.query`` call to its rows in hand (host clock)."""

from cudabench.records import percentile


def read(run):
    return percentile([s.wall_ms for s in run.done()], 95)
