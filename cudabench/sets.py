"""Run one cell several times, one process a run, and summarize.

    python3 -m cudabench.sets --workload <cell> --seeds 11,12,13 --seconds 51 [--trace 0] [--out <file>.jsonl]

Each run is ``python3 -m cudabench`` with its seed, one after another
(one process on the card at a time). Every result line, with the tail of
the run's standard error, goes to ``--out``; the summary gives per metric
the median and the spread (first to third quartile as a share of the
median, Python's ``statistics.quantiles(values, n=4)``), over all runs and
with the run farthest from the median left out.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time


def spread(values: list) -> float | None:
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def trimmed_spread(values: list) -> float | None:
    """The spread without the run farthest from the median."""
    if len(values) < 3:
        return spread(values)
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return spread([v for i, v in enumerate(values) if i != far])


def summary(results: list) -> dict:
    out = {}
    names = sorted({k for r in results for k in r.get("metrics", {})})
    for n in names:
        vals = [r["metrics"][n]["value"] for r in results if n in r.get("metrics", {})]
        out[n] = {"median": statistics.median(vals), "spread": spread(vals), "trimmed": trimmed_spread(vals),
                  "values": vals}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", required=True)
    ap.add_argument("--trace", default="0")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    results = []
    for seed in args.seeds.split(","):
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "cudabench", "--workload", args.workload, "--seed", seed,
             "--seconds", args.seconds, "--trace", args.trace],
            capture_output=True, text=True,
        )
        wall = time.perf_counter() - t0
        lines = proc.stdout.strip().splitlines()
        try:
            res = json.loads(lines[-1]) if proc.returncode == 0 and lines else {}
        except json.JSONDecodeError:
            res = {}
        info = [ln for ln in lines[:-1] if ln.startswith("cudabench:")]
        rec = {"workload": args.workload, "seed": seed, "rc": proc.returncode, "wall_s": wall, "result": res,
               "info": info, "stderr_tail": proc.stderr[-3000:]}
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        m = {k: round(v["value"], 4) for k, v in res.get("metrics", {}).items()}
        print(f"seed {seed} rc {proc.returncode} wall {wall:.1f} s correct {res.get('correct')} "
              f"attempted {res.get('attempted')} {m}", flush=True)
        for ln in info:
            print("   ", ln[:600], flush=True)
        if proc.returncode != 0 or not res:
            print(proc.stderr[-2500:], flush=True)
        if res:
            results.append(res)
    print(json.dumps({"workload": args.workload, "runs": len(results), "summary": summary(results)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
