"""Process start to the window's start: generation, load, region split,
ANALYZE, plan checks and warm-up (the reference's work comes after)."""


def read(run):
    return run.setup_s
