"""CLI for graftfuzz: ``python -m tidb_tpu_torch.tools.fuzz``.

Exit codes: 0 = campaign clean, 1 = divergences found, 2 = usage error.
The findings JSON (stdout, and ``<out>/findings.json`` with ``--out``) is
byte-identical for identical ``--seed``/``--cases`` — timing goes to stderr,
with one ``graftfuzz: device {...}`` JSON line: the device sessions' cop
tasks by engine, degraded tasks, MPP cases and gathers, and K1 launches.
``--device`` names where every DB is opened (the card unless ``cpu``).
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tidb_tpu_torch.tools.fuzz",
        description="graftfuzz: differential + metamorphic query fuzzing of the device engine",
    )
    ap.add_argument("--seed", type=int, default=42, help="campaign seed (default 42)")
    ap.add_argument("--cases", type=int, default=300, help="number of cases (default 300)")
    ap.add_argument(
        "--minutes", type=float, default=None,
        help="run for N minutes of wall clock instead of --cases (nightly lane)",
    )
    ap.add_argument("--out", default=None, help="directory for repro files + findings.json")
    ap.add_argument("--queries-per-case", type=int, default=2)
    ap.add_argument(
        "--query-pool", type=int, default=12,
        help="per-profile query-pool size (smaller = faster via kernel-cache reuse, "
        "larger = more shape diversity; the tier-1 smoke lane uses 6)",
    )
    ap.add_argument("--no-shrink", action="store_true", help="report unshrunk divergences")
    ap.add_argument("--quiet", action="store_true", help="suppress progress lines")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda", help="where the DBs run (default cuda)")
    args = ap.parse_args(argv)
    if args.cases < 1 and args.minutes is None:
        print("--cases must be >= 1", file=sys.stderr)
        return 2

    from tidb_tpu_torch.ops import grouped_sums
    from tidb_tpu_torch.tools.fuzz import runner
    from tidb_tpu_torch.tools.fuzz.harness import run_campaign

    progress = None if args.quiet else (lambda msg: print(f"graftfuzz: {msg}", file=sys.stderr))
    runner.reset_tally()
    k1_before = grouped_sums.LAUNCHES
    with runner.on_device(args.device):
        res = run_campaign(
            seed=args.seed,
            cases=args.cases,
            out_dir=args.out,
            n_queries=args.queries_per_case,
            pool_size=args.query_pool,
            do_shrink=not args.no_shrink,
            minutes=args.minutes,
            progress=progress,
        )
    sys.stdout.write(res.findings_json())
    dev = dict(runner.TALLY, k1_launches=grouped_sums.LAUNCHES - k1_before, elapsed_s=res.elapsed_s)
    print(f"graftfuzz: device {json.dumps(dev, sort_keys=True)}", file=sys.stderr)
    print(
        f"graftfuzz: {res.checked} cases, {len(res.findings)} finding(s), "
        f"{res.errors} harness error(s), {res.checked / max(res.elapsed_s, 1e-9):.1f} cases/s",
        file=sys.stderr,
    )
    # harness errors are NOT clean: a campaign that failed to run its cases
    # must never report green (only the oracles' verdicts count as coverage)
    return 1 if (res.findings or res.errors) else 0


if __name__ == "__main__":
    sys.exit(main())
