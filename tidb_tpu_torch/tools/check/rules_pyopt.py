"""GC rule: ``python -O`` safety (``opt-assert``).

The twice-regressed bug class: ``assert`` statements vanish under
``python -O``/``PYTHONOPTIMIZE``, so an assert whose failure is
load-bearing (a protocol check, a refusal, an input validation) silently
becomes a no-op in optimized deployments. PR 2 caught benchdaily's grant
check living inside an assert; PR 3 caught bench workers asserting instead
of raising — each found by hand in review. Outside ``tests/`` an assert may
only narrow types; everything else must raise a typed error.
"""

from __future__ import annotations

import ast

from tidb_tpu_torch.tools.check.core import Finding, Tree, rule

RULE = "opt-assert"


def _is_narrowing(test: ast.expr) -> bool:
    """The allowlist: `assert x is not None` / `assert isinstance(x, T)` —
    pure type-narrowing for readers and checkers, whose failure would
    surface immediately as an AttributeError/TypeError anyway."""
    if (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.ops[0], ast.IsNot)
        and isinstance(test.comparators[0], ast.Constant)
        and test.comparators[0].value is None
    ):
        return True
    if (
        isinstance(test, ast.Call)
        and isinstance(test.func, ast.Name)
        and test.func.id == "isinstance"
    ):
        return True
    return False


@rule(
    RULE,
    "no load-bearing assert outside tests (stripped under python -O)",
    """
`assert` compiles to nothing under python -O / PYTHONOPTIMIZE=1, so any
assert whose failure matters at runtime — wire-protocol checks, refusals,
input validation, state guards — silently stops checking in optimized
deployments and the bug it guarded against proceeds as corruption.
Incident: this class regressed twice in review (PR 2's benchdaily grant
check, PR 3's bench worker guards), and the sweep that shipped with this
rule converted ~18 more (chunk codec magic, txn double-finish, MySQL
protocol greetings). Allowed: `assert x is not None` and
`assert isinstance(x, T)` — pure type narrowing whose failure would raise
on the next line anyway. Fix: `raise ValueError/RuntimeError/TypeError`
with the same message; tests/ are exempt (pytest runs them unoptimized).
""",
)
def check(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Assert) and not _is_narrowing(node.test):
                out.append(
                    Finding(
                        RULE,
                        sf.path,
                        node.lineno,
                        "load-bearing assert is stripped under python -O — "
                        "raise a typed error instead",
                        symbol=ast.unparse(node.test)[:60],
                    )
                )
    return out
