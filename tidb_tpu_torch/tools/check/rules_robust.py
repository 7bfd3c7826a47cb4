"""Robustness rules: ``failpoint-registry`` (a chaos test must reference a
failpoint that actually exists) and ``except-swallow`` (no silent broad
exception swallowing in package code).

Failpoints: every ``failpoint.inject("name", ...)`` site defines a point;
tests arm them by NAME with ``enable``/``enabled``. The names are plain
strings with no definition to import, so a typo'd name in a chaos test
never fires — the fault is never injected and the test passes vacuously,
certifying resilience that was never exercised. ``kv/fault_injection.py``
now carries the authoritative ``FAILPOINTS`` registry; this rule
cross-checks it three ways (reference → registry, inject site → registry,
registry → some inject site).

Swallowing: ``except Exception: pass`` (and bare ``except:``) hides typed-
error regressions — a path that used to degrade gracefully starts throwing
something new and nobody ever sees it. Real cleanup/advisory paths carry a
``# graftcheck: off=except-swallow`` suppression WITH the reason the
swallow is sound; everything else must narrow the exception type or make
the failure observable.
"""

from __future__ import annotations

import ast
import re

from tidb_tpu_torch.tools.check.core import Finding, Tree, call_name, module_aliases, rule

FP_RULE = "failpoint-registry"
SWALLOW_RULE = "except-swallow"

_FP_METHODS = {"inject", "enable", "enabled", "disable"}
_FP_REGISTRY_PATH = "kv/fault_injection.py"
# corpus (tests / entry points) are raw text, not lint targets: match the
# conventional receiver spellings (failpoint module import or the _fp alias).
# DOTALL + whole-file matching so a black-wrapped call with the name on the
# NEXT line is still validated (a missed reference is a vacuous chaos test)
_FP_TEXT_RE = re.compile(
    r"\b(?:[\w.]*failpoint|_fp|fp)\s*\.\s*(?:inject|enable|enabled|disable)\s*\(\s*(['\"])([^'\"]+)\1",
    re.DOTALL,
)


def _registry(tree: Tree):
    """(names, name→lineno) from FAILPOINTS in kv/fault_injection.py, or
    (None, {}) when the tree ships no registry at all."""
    sf = tree.get(_FP_REGISTRY_PATH)
    if sf is None:
        return None, {}
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "FAILPOINTS" for t in node.targets
        ):
            names, lines = set(), {}
            for c in ast.walk(node.value):
                if isinstance(c, ast.Constant) and isinstance(c.value, str):
                    names.add(c.value)
                    lines.setdefault(c.value, c.lineno)
            return names, lines
    return None, {}


def _is_failpoint_call(node: ast.Call, aliases: dict) -> bool:
    name = call_name(node.func)
    if not name or name.rsplit(".", 1)[-1] not in _FP_METHODS:
        return False
    if "failpoint" in name:
        return True
    root = name.split(".", 1)[0]
    return "failpoint" in aliases.get(root, "")


@rule(
    FP_RULE,
    "failpoint names must exist in kv/fault_injection.py's FAILPOINTS registry",
    """
Failpoints are armed by bare string name (utils/failpoint.enable), so a
typo'd name in a chaos test silently never fires: the fault is never
injected, the recovery path is never exercised, and the test passes
vacuously — the worst kind of green. Incident class: the chaos suite is
the repo's resilience proof (SIGKILL-mid-2PC, mid-migration, mid-DDL all
hang off failpoints); one renamed inject site would have quietly voided
every test that armed the old name. Every name referenced by
failpoint.inject/enable/enabled/disable — in package code AND in tests/ —
must appear in kv/fault_injection.py's FAILPOINTS frozenset, and every
registry entry must still have an inject site (a stale entry means the
point was removed while tests may still arm it). Fix: add the new point's
name to FAILPOINTS when introducing the inject site; when renaming or
removing a point, sweep tests/ for the old name in the same change.
""",
)
def check_failpoints(tree: Tree) -> list:
    registry, reg_lines = _registry(tree)
    out: list[Finding] = []
    inject_sites: set = set()
    refs: list = []  # (path, lineno, name)
    for sf in tree.targets():
        aliases = module_aliases(sf.tree)
        for node in ast.walk(sf.tree):
            if not (isinstance(node, ast.Call) and _is_failpoint_call(node, aliases)):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
                continue
            name = node.args[0].value
            if call_name(node.func).rsplit(".", 1)[-1] == "inject":
                inject_sites.add(name)
            refs.append((sf.path, node.lineno, name))
    for path, text in tree.corpus.items():
        for m in _FP_TEXT_RE.finditer(text):
            lineno = text.count("\n", 0, m.start()) + 1
            refs.append((path, lineno, m.group(2)))
    if registry is None:
        if not refs:
            return []  # tree ships no registry and uses no failpoints
        registry = set()
    for path, lineno, name in refs:
        if name not in registry:
            out.append(
                Finding(
                    FP_RULE,
                    path,
                    lineno,
                    f"failpoint {name!r} is not in kv/fault_injection.py FAILPOINTS — "
                    "a typo'd name never fires and the chaos test passes vacuously",
                    symbol=name,
                )
            )
    for name in sorted(registry - inject_sites):
        # the loop only runs when the registry file parsed, so the path is real
        out.append(
            Finding(
                FP_RULE,
                tree.get(_FP_REGISTRY_PATH).path,
                reg_lines.get(name, 1),
                f"registry entry {name!r} has no failpoint.inject site left — "
                "remove it (tests arming it would pass vacuously)",
                symbol=name,
            )
        )
    return out


_BROAD = {"Exception", "BaseException"}


def _is_broad(h: ast.ExceptHandler) -> bool:
    if h.type is None:
        return True  # bare except
    names = []
    if isinstance(h.type, ast.Tuple):
        names = [call_name(e) for e in h.type.elts]
    else:
        names = [call_name(h.type)]
    return any(n in _BROAD for n in names)


def _body_swallows(h: ast.ExceptHandler) -> bool:
    """Only pass/continue/break/docstring statements: nothing handled,
    nothing recorded (a break-only body silently KILLS its loop forever —
    strictly worse than continue). A body that re-raises, returns a value,
    logs to a metric, or assigns state is treated as handling."""
    for s in h.body:
        if isinstance(s, (ast.Pass, ast.Continue, ast.Break)):
            continue
        if isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant):
            continue
        return False
    return True


@rule(
    SWALLOW_RULE,
    "no silent `except Exception: pass` / bare `except:` in package code",
    """
A broad except whose body is only pass/continue swallows EVERY failure on
that path forever: when a dependency starts raising something new (the
typed-error classes this repo leans on — RegionError re-routes,
UndeterminedError, LockOrderError), the regression is invisible — the
caller sees success and the bug surfaces as wrong results or a hang
somewhere else. Incident class: silently-swallowed store errors have
hidden typed-error regressions behind 'advisory' sweeps before (the
balancer's load probes, background keepalives), and a bare ``except:``
additionally eats KeyboardInterrupt/SystemExit. Tests are exempt (not
lint targets). Fix: narrow to the exception types the path genuinely
expects (ValueError for a parse, OSError for a close, InvalidStateError
for a racing future); make the failure observable (a metrics counter or
last-error field) when the loop must survive; or — for a genuine
best-effort cleanup/advisory path — keep the swallow with an inline
``# graftcheck: off=except-swallow`` naming WHY it is sound.
""",
)
def check_swallow(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            bare = node.type is None
            if bare or (_is_broad(node) and _body_swallows(node)):
                what = "bare except:" if bare else "except Exception with a pass-only body"
                out.append(
                    Finding(
                        SWALLOW_RULE,
                        sf.path,
                        node.lineno,
                        f"{what} silently swallows typed errors — narrow the type, "
                        "record the failure, or suppress with the reason it is sound",
                        symbol="except",
                    )
                )
    return out
