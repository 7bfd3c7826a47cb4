"""graftfuzz campaign driver: generate → check → shrink → emit.

A campaign is ``(seed, n_cases)`` and nothing else: the findings JSON it
produces is byte-identical across runs (no clocks, no paths derived from
temp state, stable key order), which is what lets CI diff two runs and what
makes a finding's ``seed``/``case`` pair a complete bug report. Wall-clock
throughput is printed to stderr/stdout only — never serialized into the
findings document.
"""

from __future__ import annotations

import json
import os
import pprint
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from tidb_tpu_torch.tools.fuzz.gen import CaseSpec, gen_case
from tidb_tpu_torch.tools.fuzz.oracles import Divergence
from tidb_tpu_torch.tools.fuzz.runner import DBPool, check_case, run_repro, spec_to_repro
from tidb_tpu_torch.tools.fuzz.shrink import shrink

_REPRO_TEMPLATE = '''"""graftfuzz shrunk repro (auto-generated — do not hand-edit the SPEC).

campaign seed={seed} case={case} oracle={oracle} phase={phase}
divergence: {detail}

Replayed by tests/test_fuzz_corpus.py when committed under tests/fuzz_corpus/;
runnable standalone: ``pytest {name}.py`` or ``python {name}.py``.
"""

from tidb_tpu_torch.tools.fuzz.runner import run_repro

SPEC = {spec}


def test_repro():
    run_repro(SPEC)


if __name__ == "__main__":
    test_repro()
    print("no divergence — the bug this repro pinned is fixed")
'''


@dataclass
class CampaignResult:
    seed: int
    cases: int
    findings: list = field(default_factory=list)  # finding dicts
    checked: int = 0
    errors: int = 0  # cases the harness itself failed to run (generator bugs)
    elapsed_s: float = 0.0

    def findings_json(self) -> str:
        doc = {
            "campaign": {"seed": self.seed, "cases": self.cases, "findings": len(self.findings), "harness_errors": self.errors},
            "findings": self.findings,
        }
        return json.dumps(doc, indent=1, sort_keys=True) + "\n"


def _spec_size(spec: CaseSpec) -> dict:
    return {
        "tables": len(spec.tables),
        "columns": sum(len(t.columns) for t in spec.tables),
        "rows": sum(len(r) for r in spec.rows.values()),
    }


def _finding(spec: CaseSpec, div: Divergence, repro_name: str, verified: bool) -> dict:
    f = {
        "seed": spec.seed,
        "case": spec.index,
        "oracle": div.oracle,
        "phase": div.phase,
        "query": div.query,
        "detail": div.detail,
        "shrunk": _spec_size(spec),
        "repro": repro_name,
        "repro_verified": verified,
    }
    if div.engine:
        f["engine"] = div.engine
    return f


def _emit_repro(spec: CaseSpec, div: Divergence, out_dir: Optional[str]) -> tuple:
    """Write the repro file (when out_dir given); returns (name, verified)."""
    rep = spec_to_repro(spec, div)
    name = f"repro_s{spec.seed}_c{spec.index}"
    try:
        run_repro(rep)
        verified = False  # shrunk spec no longer diverges standalone
    except AssertionError:
        verified = True
    except Exception:
        # the replay-from-empty-store itself broke (pool-state-dependent
        # scenario, rejected setup, ...): an unverifiable repro must not
        # abort the campaign and lose every earlier finding
        verified = False
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        body = _REPRO_TEMPLATE.format(
            seed=spec.seed,
            case=spec.index,
            oracle=div.oracle,
            phase=div.phase,
            detail=div.detail.replace("\\", "\\\\")[:400],
            name=name,
            spec=pprint.pformat(rep, indent=1, width=96, sort_dicts=True),
        )
        with open(os.path.join(out_dir, name + ".py"), "w", encoding="utf-8") as fh:
            fh.write(body)
    return name + ".py", verified


def run_campaign(
    seed: int,
    cases: int = 300,
    out_dir: Optional[str] = None,
    n_queries: int = 2,
    pool_size: int = 12,
    do_shrink: bool = True,
    minutes: Optional[float] = None,
    progress: Optional[Callable[[str], None]] = None,
) -> CampaignResult:
    """Run ``cases`` scenarios (or keep drawing fresh case indexes until
    ``minutes`` of wall clock, for the nightly long-campaign lane)."""
    res = CampaignResult(seed=seed, cases=cases)
    pool = DBPool()
    t0 = time.monotonic()
    deadline = t0 + minutes * 60.0 if minutes else None
    i = 0
    while True:
        if deadline is not None:
            if time.monotonic() >= deadline:
                break
        elif i >= cases:
            break
        spec = gen_case(seed, i, n_queries=n_queries, pool_size=pool_size)
        try:
            div = check_case(spec, pool=pool)
        except Exception as e:
            # the harness (not an engine) died on this case: a generator bug.
            # Count it loudly — a campaign full of harness errors is not
            # "clean" — but keep fuzzing the remaining cases.
            res.errors += 1
            if progress:
                progress(f"case {i}: harness error {type(e).__name__}: {e}")
            div = None
        res.checked += 1
        if div is not None:
            if do_shrink:
                spec, div = shrink(spec, div)
            repro_name, verified = _emit_repro(spec, div, out_dir)
            res.findings.append(_finding(spec, div, repro_name, verified))
            if progress:
                progress(f"case {i}: DIVERGENCE [{div.oracle}/{div.phase}] -> {repro_name}")
        if progress and i and i % 50 == 0:
            dt = time.monotonic() - t0
            progress(f"{i} cases, {len(res.findings)} finding(s), {res.checked / dt:.1f} cases/s")
        i += 1
    if deadline is not None:
        res.cases = res.checked
    res.elapsed_s = time.monotonic() - t0
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "findings.json"), "w", encoding="utf-8") as fh:
            fh.write(res.findings_json())
    return res
