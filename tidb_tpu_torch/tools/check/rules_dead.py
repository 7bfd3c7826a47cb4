"""GC rule: high-confidence dead code (``dead-code``).

The incident: PR 1 shipped ``Backoffer.fork`` — a speculative API nothing
called — and carried it (plus its broken semantics and its unit test)
until review deleted it. Dead helpers are not free: they get "fixed"
during refactors, reviewed on every pass, and their tests wall CI time.

Vulture-style, tuned for near-zero false positives: a function or method
defined in the package whose name appears NOWHERE else in the repo — not
in the package, not in tests/, not in the entry points — is dead. Dynamic
dispatch is respected by counting raw identifier occurrences (attribute
calls, getattr strings, decorator registries all count as uses), and
decorated defs are skipped entirely (registration is a use we can't see).
"""

from __future__ import annotations

import ast
import re

from tidb_tpu_torch.tools.check.core import Finding, Tree, rule

RULE = "dead-code"

_SKIP_PREFIXES = ("test_", "visit_", "bench_")


def _candidates(sf):
    """(name, line, qual) for defs eligible for liveness counting."""
    tree = sf.tree
    exported = set()
    for node in tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "__all__":
                    if isinstance(node.value, (ast.List, ast.Tuple)):
                        for e in node.value.elts:
                            if isinstance(e, ast.Constant):
                                exported.add(e.value)
    out = []

    def walk(node, cls):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                n = child.name
                if (
                    not child.decorator_list
                    and not (n.startswith("__") and n.endswith("__"))
                    and not n.startswith(_SKIP_PREFIXES)
                    and n not in exported
                    and n != "main"
                ):
                    out.append((n, child.lineno, f"{cls}.{n}" if cls else n))
                # nested defs are closures — their liveness is their parent's
            else:
                walk(child, cls)

    walk(tree, None)
    return out


@rule(
    RULE,
    "functions/methods referenced nowhere in the repo",
    """
A def (function or method) whose name occurs exactly once in the entire
repo — its own definition, with tests/ and the entry points counted as
users — is dead at high confidence. Incident: PR 1's Backoffer.fork
shipped unused with broken semantics and a test that existed only to
exercise the dead API; review deleted all three. The count is textual
(word-boundary identifier match over every source), so attribute dispatch,
getattr strings, and decorator registries all register as uses — and any
def carrying a decorator is skipped outright. Fix: delete the def (and its
now-orphaned imports); if it is a deliberately public hook nobody calls
yet, export it in __all__ or reference it from a test that pins its
contract.
""",
)
def check(tree: Tree) -> list:
    # one tokenization pass over every source beats per-name regex scans by
    # ~100x: identifier occurrences are exactly the \w+ tokens
    counts: dict[str, int] = {}
    for tok in re.findall(r"\w+", tree.all_text()):
        counts[tok] = counts.get(tok, 0) + 1
    out = []
    for sf in tree.targets():
        for name, line, qual in _candidates(sf):
            # one occurrence = the def itself (defs of the same name in
            # several files each add one, keeping shadowed names alive)
            if counts.get(name, 0) <= 1:
                out.append(
                    Finding(
                        RULE,
                        sf.path,
                        line,
                        f"{qual!r} is referenced nowhere in the repo (including "
                        "tests) — delete it or pin its contract with a test",
                        symbol=qual,
                    )
                )
    return out
