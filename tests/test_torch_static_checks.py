"""The port's graftcheck as a tier-1 gate: the full scan of
``tidb_tpu_torch/`` is clean against its own committed, empty baseline
(``graftcheck_baseline_torch.json``) within the reference's 30 s budget, and
every rule the reference's checker has is there, documented with a fix."""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidb_tpu.tools import check as ref_check  # noqa: E402
from tidb_tpu_torch.tools.check import build_tree, load_baseline, load_rules, scan  # noqa: E402
from tidb_tpu_torch.tools.check.__main__ import BASELINE_NAME  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASELINE = os.path.join(ROOT, "graftcheck_baseline_torch.json")


def test_full_scan_of_the_port_is_clean_with_an_empty_baseline_within_budget():
    t0 = time.perf_counter()
    tree = build_tree(ROOT)
    report = scan(tree, baseline=load_baseline(BASELINE))
    elapsed = time.perf_counter() - t0
    msgs = "\n".join(f.render() for f in report.findings)
    assert not report.findings, f"graftcheck found violations in the port:\n{msgs}"
    assert report.baselined == []
    assert elapsed < 30.0, f"graftcheck scan took {elapsed:.1f}s (budget 30s)"
    # the port's tree, and only it, is linted; the smoke is corpus
    assert tree.files and all(p.startswith("tidb_tpu_torch/") for p in tree.files)
    assert "tidb_tpu_torch/utils/lockcheck.py" in tree.files and "tidb_tpu_torch/bench/benchdaily.py" in tree.files
    assert "chip_smoke.py" in tree.corpus


def test_every_reference_rule_is_there_and_documents_itself():
    rules = load_rules()
    assert set(rules) == set(ref_check.load_rules())
    assert len(rules) == 13
    for r in rules.values():
        assert len(r.explain) > 100, f"rule {r.id} lacks a real explanation"
        assert "Fix:" in r.explain, f"rule {r.id} explanation lacks a fix recipe"


def test_the_ports_baseline_is_its_own_committed_and_empty():
    assert BASELINE_NAME == "graftcheck_baseline_torch.json"
    assert os.path.isfile(BASELINE)
    with open(BASELINE) as f:
        data = json.load(f)
    assert data == {"findings": []}


def test_the_lock_rule_sees_the_detectors_raw_lock():
    """The port's lockcheck binds raw ``_thread`` locks; the static lock
    rule still sees its mutex as a lock constructor."""
    from tidb_tpu_torch.tools.check.rules_locks import _ModuleInfo

    tree = build_tree(ROOT)
    info = _ModuleInfo(tree.files["tidb_tpu_torch/utils/lockcheck.py"])
    assert "_graph_mu" in info.module_locks
