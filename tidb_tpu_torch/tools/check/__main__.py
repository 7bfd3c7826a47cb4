"""CLI for graftcheck: ``python -m tidb_tpu_torch.tools.check``.

Exit codes: 0 = clean (baselined legacy findings allowed), 1 = new
findings, 2 = usage error. The committed baseline lives at the repo root
as ``graftcheck_baseline_torch.json`` (the JAX package's checker keeps
its own, ``graftcheck_baseline.json``); keep it near-empty — the point of the
checker is that review-hardening classes fail CI, not that they accrete.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import textwrap

from tidb_tpu_torch.tools.check.core import (
    build_tree,
    load_baseline,
    load_rules,
    repo_root,
    scan,
    write_baseline,
)

BASELINE_NAME = "graftcheck_baseline_torch.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m tidb_tpu_torch.tools.check",
        description="graftcheck: repo-native invariant checker (see STATIC_ANALYSIS.md)",
    )
    ap.add_argument("--root", default=None, help="repo root (default: auto-detected)")
    ap.add_argument(
        "--baseline",
        default=None,
        help=f"baseline JSON (default: <root>/{BASELINE_NAME} if present)",
    )
    ap.add_argument("--explain", metavar="RULE", help="print one rule's catalog entry")
    ap.add_argument("--json", dest="json_out", help="write the full report as JSON")
    ap.add_argument(
        "--rules", default=None, help="comma-separated rule ids (default: all)"
    )
    ap.add_argument(
        "--update-baseline",
        action="store_true",
        help="rewrite the baseline to grandfather every current finding",
    )
    args = ap.parse_args(argv)

    rules = load_rules()
    if args.explain:
        r = rules.get(args.explain)
        if r is None:
            print(
                f"unknown rule {args.explain!r}; known: {', '.join(sorted(rules))}",
                file=sys.stderr,
            )
            return 2
        print(f"{r.id} — {r.title}\n")
        print(textwrap.fill(" ".join(r.explain.split()), width=78))
        return 0

    root = args.root or repo_root()
    tree = build_tree(root)
    baseline = None
    bpath = args.baseline or os.path.join(root, BASELINE_NAME)
    if os.path.isfile(bpath):
        baseline = load_baseline(bpath)
    ids = [r.strip() for r in args.rules.split(",")] if args.rules else None
    if args.update_baseline and ids:
        # a partial scan must never rewrite the whole baseline: every rule
        # NOT scanned would lose its grandfathered entries and the next
        # full run would hard-fail on them as "new"
        print("--update-baseline requires a full scan (drop --rules)", file=sys.stderr)
        return 2
    report = scan(tree, rules=ids, baseline=None if args.update_baseline else baseline)

    if args.update_baseline:
        write_baseline(bpath, tree, report)
        print(f"baseline rewritten: {len(report.findings)} finding(s) -> {bpath}")
        return 0

    if args.json_out:
        with open(args.json_out, "w", encoding="utf-8") as f:
            json.dump(report.to_pb(tree), f, indent=1)

    for f in report.findings:
        print(f.render())
    n_base = len(report.baselined)
    if report.findings:
        print(
            f"\ngraftcheck: {len(report.findings)} new finding(s) "
            f"({n_base} baselined, {report.suppressed} suppressed) — "
            "run with --explain RULE for the why and the fix"
        )
        return 1
    print(
        f"graftcheck: clean ({n_base} baselined, {report.suppressed} suppressed, "
        f"{len(tree.files)} files)"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
