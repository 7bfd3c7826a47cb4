"""The kernels' share of the HBM roofline: the bytes the window's
statements must read (each referenced column once a statement, at its
narrowest whole-byte width, with a validity bit a row where nullable)
over the card's peak bandwidth, divided by the profiled device busy time."""


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    need = sum(run.stmt_bytes[s.index] for s in run.done())
    return 100.0 * need / run.hbm_bytes_per_s / run.trace.busy_s
