"""graftcheck — the repo-native invariant checker.

    python -m tidb_tpu_torch.tools.check                     # scan, enforce baseline
    python -m tidb_tpu_torch.tools.check --explain RULE      # rule catalog entry
    python -m tidb_tpu_torch.tools.check --json report.json  # machine-readable report
    python -m tidb_tpu_torch.tools.check --update-baseline   # re-grandfather findings

See STATIC_ANALYSIS.md for the rule catalog and the historical incident
behind each rule; tests/test_torch_static_checks.py runs the full scan of
this package as a tier-1 test, so a new violation fails CI like any other
regression.
"""

from tidb_tpu_torch.tools.check.core import (
    Finding,
    Report,
    Rule,
    RULES,
    Tree,
    build_tree,
    load_baseline,
    load_rules,
    repo_root,
    scan,
    write_baseline,
)

__all__ = [
    "Finding",
    "Report",
    "Rule",
    "RULES",
    "Tree",
    "build_tree",
    "load_baseline",
    "load_rules",
    "repo_root",
    "scan",
    "write_baseline",
]
