"""The control for ``correct``: the reference put in the program's place,
computed in the next lower precision than the configuration states.

The configurations state exact DECIMAL arithmetic (scaled 64-bit
integers). The control does the same arithmetic in float64; where no
statement of a cell has a sum that float64 cannot hold exactly (the join
stream's sums stay under 2**53), float64 would change no answer and the
control steps down once more, to float32. Each cell's traffic file names
its control's precision (``"control"``). A run compares the number of
distinct statements whose answer differs from the exact reference
against the limit ``LIMIT``; the control has to exceed it.

    python3 -m cudabench.control --workload <cell> --seeds 1,2,3

prints, per seed, the number the control reads (and the exact
reference's own, which is 0), at the configuration's size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

from cudabench import data, harness

LIMIT = 0


def wrong_statements(traffic: dict, tables: dict, numeric: str) -> int:
    """Distinct statements of the list whose ``numeric`` answer differs
    from the exact reference's (LIMIT rows, as a statement returns them)."""
    import importlib

    stmts = harness.statements(traffic)
    answers, seen = {}, set()
    for i, st in enumerate(traffic["statements"]):
        if stmts[i][1] in seen:
            continue
        seen.add(stmts[i][1])
        ref = importlib.import_module(f"cudabench.reference.{st['template']}")
        rows = ref.rows(tables, st["params"], numeric)
        answers[i] = [rows if ref.LIMIT is None else rows[: ref.LIMIT]]
    ok = harness.compare(traffic, tables, stmts, answers)
    return sum(1 for v in ok.values() if not v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--numeric", help="another precision to read (default: the cell's control)")
    args = ap.parse_args(argv)
    bench = harness.load_json(Path.cwd() / "BENCHMARK.json")
    _cell, config, traffic, _e, _p = harness.cell_spec(bench, args.workload)
    numeric = args.numeric or traffic["control"]
    for seed in args.seeds.split(","):
        t = time.perf_counter()
        tables = data.generate(config, int(seed) % 2**64)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": numeric,
                          "control_wrong": wrong_statements(traffic, tables, numeric),
                          "exact_wrong": wrong_statements(traffic, tables, "exact"), "limit": LIMIT,
                          "seconds": round(time.perf_counter() - t, 3)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
