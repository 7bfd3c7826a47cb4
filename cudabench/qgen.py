"""TPC-H qgen's substitution parameters (TPC-H v3 §2.4), drawn once.

The traffic files hold their statement lists with the parameters written
out; this module is how those lists were drawn, from the ``param_seed``
each file states, and the CPU tests draw them again to hold the files to
it. ``python -m cudabench.qgen <workload file>`` prints the list a file's
``draw`` section gives.
"""

from __future__ import annotations

import datetime as dt
import json
import sys

import numpy as np

from cudabench.data import CONTAINER_KINDS, CONTAINER_SIZES


def _q1(rng) -> dict:
    """Q1: DELTA uniform in [60, 120] days before 1998-12-01."""
    delta = int(rng.integers(60, 121))
    return {"delta": delta, "date": str(dt.date(1998, 12, 1) - dt.timedelta(days=delta))}


def _q6(rng) -> dict:
    """Q6: DATE the first of January of a year in [1993, 1997], DISCOUNT in
    [0.02, 0.09], QUANTITY in [24, 25]."""
    year = int(rng.integers(1993, 1998))
    disc = int(rng.integers(2, 10))
    return {
        "date": f"{year}-01-01",
        "date_end": f"{year + 1}-01-01",
        "discount": f"0.{disc:02d}",
        "disc_lo": f"0.{disc - 1:02d}",
        "disc_hi": f"0.{disc + 1:02d}",
        "quantity": int(rng.integers(24, 26)),
    }


def _q17(rng) -> dict:
    """Q17: BRAND 'Brand#MN' with M, N in [1, 5]; CONTAINER one of the 40
    (a size syllable and a kind syllable)."""
    m, n = (int(v) for v in rng.integers(1, 6, 2))
    size = CONTAINER_SIZES[int(rng.integers(0, len(CONTAINER_SIZES)))]
    kind = CONTAINER_KINDS[int(rng.integers(0, len(CONTAINER_KINDS)))]
    return {"brand": f"Brand#{m}{n}", "container": f"{size} {kind}"}


DRAWS = {"q1": _q1, "q6": _q6, "q17": _q17}


def draw(spec: dict) -> list[dict]:
    """The statement list a workload file's ``draw`` section describes:
    ``sets`` parameter sets per drawn template, from ``param_seed``, one
    generator per template; the list repeats ``pattern`` (template names)
    ``sets`` times, the i-th repetition taking each drawn template's i-th
    set. Templates without a draw take no parameters."""
    sets = spec["sets"]
    drawn = {}
    for i, name in enumerate(sorted(set(spec["pattern"]) & set(DRAWS))):
        rng = np.random.default_rng([spec["param_seed"], i])
        drawn[name] = [DRAWS[name](rng) for _ in range(sets)]
    return [
        {"template": name, "params": drawn[name][i] if name in drawn else {}}
        for i in range(sets)
        for name in spec["pattern"]
    ]


if __name__ == "__main__":
    with open(sys.argv[1]) as f:
        print(json.dumps(draw(json.load(f)["draw"]), indent=1))
