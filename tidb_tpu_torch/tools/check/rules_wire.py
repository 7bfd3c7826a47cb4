"""GC rule: wire-verb replay registry (``replay-registry``).

The incident: PR 1 shipped transparent reconnect-and-replay in
``RemoteStore._call`` with replayability as a DEFAULT — every verb replayed
unless listed in a deny-set. Review then caught that ``mpp_dispatch`` mints
a fresh task id per call, so replaying a lost reply double-executes the
whole gather; it had silently inherited replay-on-reconnect. Every verb
added since (election, placement, migration) repeated the same manual
review question. This rule makes the classification mandatory and the
cross-check mechanical: a verb that exists in the dispatcher or any client
header but in neither ``REPLAYABLE`` nor ``NON_REPLAYABLE`` is an error,
and the replay gate itself must be fail-closed (``cmd in REPLAYABLE``) so
an undeclared verb can never default to replay.
"""

from __future__ import annotations

import ast

from tidb_tpu_torch.tools.check.core import Finding, Tree, rule

RULE = "replay-registry"
SECTIONS_RULE = "sys-sections"

_DECLS = ("REPLAYABLE", "NON_REPLAYABLE")


def _literal_set(node: ast.expr):
    """frozenset({...}) / {...} / frozenset((...)) of string constants."""
    inner = node
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id in (
        "frozenset",
        "set",
    ):
        if not node.args:
            return set()
        inner = node.args[0]
    if isinstance(inner, (ast.Set, ast.Tuple, ast.List)):
        vals = set()
        for e in inner.elts:
            if not (isinstance(e, ast.Constant) and isinstance(e.value, str)):
                return None
            vals.add(e.value)
        return vals
    return None


def _collect(sf):
    tree = sf.tree
    decls: dict[str, tuple[set, int]] = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id in _DECLS:
                vals = _literal_set(node.value)
                if vals is not None:
                    decls[t.id] = (vals, node.lineno)
    server: dict[str, int] = {}
    client: dict[str, int] = {}
    dispatch = None
    call_fn = None
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            if node.name == "_dispatch":
                dispatch = node
            elif node.name == "_call":
                call_fn = node
    if dispatch is not None:
        for node in ast.walk(dispatch):
            if isinstance(node, ast.Compare) and len(node.ops) == 1:
                if (
                    isinstance(node.ops[0], ast.Eq)
                    and isinstance(node.left, ast.Name)
                    and node.left.id == "cmd"
                    and len(node.comparators) == 1
                    and isinstance(node.comparators[0], ast.Constant)
                    and isinstance(node.comparators[0].value, str)
                ):
                    server.setdefault(node.comparators[0].value, node.lineno)
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if (
                    isinstance(k, ast.Constant)
                    and k.value == "cmd"
                    and isinstance(v, ast.Constant)
                    and isinstance(v.value, str)
                ):
                    client.setdefault(v.value, k.lineno)
    return decls, server, client, call_fn


@rule(
    RULE,
    "every wire verb must be explicitly declared replayable or not",
    """
Every verb the StoreServer dispatches (and every {"cmd": ...} header a
client sends) must appear in exactly one of kv/remote.py's module-level
REPLAYABLE / NON_REPLAYABLE frozensets, and RemoteStore._call's transparent
reconnect-replay gate must read `replayable = cmd in REPLAYABLE` — replay
as an earned property, never a default. Incident: PR 1's `mpp_dispatch`
inherited replay-by-default and would have double-executed a gather on any
lost reply; PR 11's placement/migration verbs each re-paid the same manual
review. A replayed non-idempotent verb double-applies writes; an
accidentally NON-replayable read verb costs availability for nothing.
Fix: add the verb to the correct set (see the rationale comment above the
declarations); if genuinely ambiguous, it belongs in NON_REPLAYABLE with a
typed client-side story like commit's UndeterminedError.
""",
)
def check(tree: Tree) -> list:
    sf = tree.get("kv/remote.py")
    if sf is None:
        return []
    decls, server, client, call_fn = _collect(sf)
    out: list[Finding] = []
    if not all(d in decls for d in _DECLS):
        missing = [d for d in _DECLS if d not in decls]
        out.append(
            Finding(
                RULE,
                sf.path,
                1,
                f"kv/remote.py must declare module-level {' and '.join(missing)} "
                "frozenset(s) of wire verbs (literal string sets)",
                symbol="declarations",
            )
        )
        return out
    rep, rep_ln = decls["REPLAYABLE"]
    non, non_ln = decls["NON_REPLAYABLE"]
    declared = rep | non
    for verb in sorted(rep & non):
        out.append(
            Finding(
                RULE,
                sf.path,
                rep_ln,
                f"verb {verb!r} declared BOTH replayable and non-replayable",
                symbol=verb,
            )
        )
    for verb, ln in sorted(server.items()):
        if verb not in declared:
            out.append(
                Finding(
                    RULE,
                    sf.path,
                    ln,
                    f"server dispatches verb {verb!r} with no replay classification "
                    "— add it to REPLAYABLE or NON_REPLAYABLE",
                    symbol=verb,
                )
            )
    for verb, ln in sorted(client.items()):
        if verb not in declared and verb not in server:
            out.append(
                Finding(
                    RULE,
                    sf.path,
                    ln,
                    f"client sends verb {verb!r} with no replay classification "
                    "— add it to REPLAYABLE or NON_REPLAYABLE",
                    symbol=verb,
                )
            )
    for verb in sorted(declared - set(server) - set(client)):
        out.append(
            Finding(
                RULE,
                sf.path,
                rep_ln if verb in rep else non_ln,
                f"declared verb {verb!r} is neither dispatched by the server nor "
                "sent by any client — stale declaration",
                symbol=verb,
            )
        )
    # the gate itself: fail-closed membership in REPLAYABLE
    gate_ok = False
    gate_ln = 1
    if call_fn is not None:
        gate_ln = call_fn.lineno
        for node in ast.walk(call_fn):
            if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "replayable" for t in node.targets
            ):
                v = node.value
                if (
                    isinstance(v, ast.Compare)
                    and len(v.ops) == 1
                    and isinstance(v.ops[0], ast.In)
                    and isinstance(v.left, ast.Name)
                    and v.left.id == "cmd"
                    and isinstance(v.comparators[0], ast.Name)
                    and v.comparators[0].id == "REPLAYABLE"
                ):
                    gate_ok = True
                gate_ln = node.lineno
    if not gate_ok:
        out.append(
            Finding(
                RULE,
                sf.path,
                gate_ln,
                "RemoteStore._call's replay gate must be fail-closed: "
                "`replayable = cmd in REPLAYABLE` (a not-in-NON_REPLAYABLE test "
                "silently replays every undeclared verb)",
                symbol="gate",
            )
        )
    return out


@rule(
    SECTIONS_RULE,
    "every sys_report section a _want() gate selects must be declared",
    """
kv/remote.py must declare a module-level SYS_SECTIONS frozenset naming
every report section the request side may select, and every literal
`_want("...")` gate inside sys_report must name a declared section (and
every declared section must have a gate — a stale declaration misleads the
next section author). PR 9 established the sections= discipline: heavy
report parts (statements rings, slow logs, traffic heatmaps) ship ONLY
when a sweep asks for them, so a load probe with sections=() stays cheap.
A _want literal missing from the declaration is exactly how a new heavy
section silently escapes that contract — consumers can't discover it, the
/cluster slim filter doesn't know to strip it, and nobody reviewed its
wire weight. Fix: add the section name to SYS_SECTIONS next to the gate.
""",
)
def check_sections(tree: Tree) -> list:
    sf = tree.get("kv/remote.py")
    if sf is None:
        return []
    out: list[Finding] = []
    declared = None
    decl_ln = 1
    for node in sf.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "SYS_SECTIONS":
                declared = _literal_set(node.value)
                decl_ln = node.lineno
    if declared is None:
        out.append(
            Finding(
                SECTIONS_RULE,
                sf.path,
                1,
                "kv/remote.py must declare a module-level SYS_SECTIONS "
                "frozenset of literal sys_report section names",
                symbol="declarations",
            )
        )
        return out
    report_fn = None
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.FunctionDef) and node.name == "sys_report":
            report_fn = node
            break
    gated: dict[str, int] = {}
    if report_fn is not None:
        for node in ast.walk(report_fn):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Name)
                and node.func.id == "_want"
                and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
            ):
                gated.setdefault(node.args[0].value, node.lineno)
    for name, ln in sorted(gated.items()):
        if name not in declared:
            out.append(
                Finding(
                    SECTIONS_RULE,
                    sf.path,
                    ln,
                    f"sys_report gates section {name!r} with _want() but "
                    "SYS_SECTIONS does not declare it — the section escapes "
                    "the sections= selection contract",
                    symbol=name,
                )
            )
    for name in sorted(declared - set(gated)):
        out.append(
            Finding(
                SECTIONS_RULE,
                sf.path,
                decl_ln,
                f"SYS_SECTIONS declares {name!r} but no _want({name!r}) gate "
                "exists in sys_report — stale declaration",
                symbol=name,
            )
        )
    return out
