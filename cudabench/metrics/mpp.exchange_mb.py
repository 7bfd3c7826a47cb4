"""MB a statement's gathers exchange: the shards' exchanged bytes plus
the stage bytes, as the session's resource accounting sums them."""

from cudabench.records import mean


def read(run):
    return mean([s.exchange_bytes / 1e6 for s in run.done() if s.gathers])
