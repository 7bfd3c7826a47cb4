"""Nothing cudabench runs loads JAX or the JAX package: a fresh process
imports cudabench, rehearses each cell's statements on the CPU and lists
the top-level names of its modules, compared whole (the port's own name
begins with the JAX package's)."""

import json
import subprocess
import sys

import rehearsal

CHILD = """
import json, sys
sys.path[:0] = [{root!r}, {here!r}]
import cudabench, rehearsal
from cudabench import harness
for cell in ("lineitem.agg", "star.joins"):
    assert rehearsal.run(cell, seconds=0.5)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_and_no_jax_package_loaded():
    here = str(rehearsal.Path(__file__).resolve().parent)
    proc = subprocess.run([sys.executable, "-c", CHILD.format(root=str(rehearsal.ROOT), here=here)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "tidb_tpu_torch" in names and "cudabench" in names
    assert not names & {"jax", "jaxlib", "flax", "tidb_tpu"}
    from cudabench import harness

    assert set(harness.FORBIDDEN) == {"jax", "jaxlib", "flax", "tidb_tpu"}
