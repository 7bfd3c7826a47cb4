"""Programs built inside the window: growth of the cop programs' build
count (``COP_COMPILE_SECONDS``) and of the MPP program cache's misses.
Set-up builds every statement of the list, so this reads 0."""


def read(run):
    return float(run.builds["cop"] + run.builds["mpp"])
