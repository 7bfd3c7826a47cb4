"""graftfuzz — differential + metamorphic query fuzzing of the device engine.

    python -m tidb_tpu.tools.fuzz --seed 42 --cases 300          # smoke campaign
    python -m tidb_tpu.tools.fuzz --seed 42 --cases 300 --out d  # + repro files
    python -m tidb_tpu.tools.fuzz --seed 42 --minutes 30         # nightly lane

The harness generates random schemas/data/queries aimed at the device shape
library, interleaves committed DML so the delta+merge path is fuzzed, and
checks three oracles per case — differential (tpu vs host), metamorphic TLP
(which cross-checks the host engine itself), and freshness (pre- and
post-merge re-runs). Divergences are delta-debugged down to standalone
pytest repro files. Fully deterministic from ``--seed``: two runs produce
byte-identical findings JSON. See STATIC_ANALYSIS.md § graftfuzz for the
oracle table, seed policy, and corpus/triage rules.
"""

from tidb_tpu_torch.tools.fuzz.gen import CaseSpec, Query, gen_case, make_profile
from tidb_tpu_torch.tools.fuzz.harness import CampaignResult, run_campaign
from tidb_tpu_torch.tools.fuzz.oracles import Divergence, canon_rows, canon_scalar
from tidb_tpu_torch.tools.fuzz.runner import check_case, run_repro
from tidb_tpu_torch.tools.fuzz.shrink import shrink

__all__ = [
    "CampaignResult",
    "CaseSpec",
    "Divergence",
    "Query",
    "canon_rows",
    "canon_scalar",
    "check_case",
    "gen_case",
    "make_profile",
    "run_campaign",
    "run_repro",
    "shrink",
]
