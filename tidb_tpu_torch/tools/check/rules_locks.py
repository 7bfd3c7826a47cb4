"""GC rules: static lock discipline.

``lock-order``: builds the static lock-acquisition graph — nodes are lock
ATTRIBUTES (``module::Class._mu``) and module-level locks
(``module::_LOCK``), edges mean "inner acquired while outer held", found
from ``with`` nesting inside one function and from calls made under a held
lock into functions that themselves acquire (resolved conservatively:
same-class methods, same-module functions, imported-module functions, and
attribute names unique across the repo). A cycle in this graph is a
potential deadlock that needs only the right thread interleaving — the
failure mode that walled tier-1 at PR 1's ``_MESH_EXEC_LOCK`` with zero
diagnostics. The runtime half (utils/lockcheck.py) catches instance-level
orders the AST can't see; this half catches orders no test exercises.

``shared-mutation``: flags mutation of module-level collections outside
any ``with`` block in modules that use threading. The incident: PR 5 found
``Session.record_cop_detail`` racing a check-then-create on a shared dict
— partition fan-out workers dropped whole sidecar sets; PR 7 re-found the
same shape in the change-log prune. Module-level caches are the most
thread-shared state there is; a bare ``X[k] = v`` next to a lock that
everyone else takes is exactly how those started.
"""

from __future__ import annotations

import ast

from tidb_tpu_torch.tools.check.core import Finding, Tree, call_name, module_aliases, rule

ORDER_RULE = "lock-order"
MUT_RULE = "shared-mutation"

_LOCK_CTORS = {"Lock", "RLock", "Condition"}

# attribute-call names too generic to resolve to a unique repo method
_COMMON_METHODS = {
    "get", "put", "set", "pop", "add", "append", "update", "items", "keys",
    "values", "acquire", "release", "join", "start", "close", "read", "write",
    "send", "recv", "run", "stop", "wait", "notify", "clear", "copy", "next",
    "execute", "query", "begin", "commit", "rollback", "render", "snapshot",
}

_MUTATORS = {
    "append", "add", "insert", "extend", "update", "pop", "popitem", "clear",
    "remove", "discard", "setdefault",
}


def _is_lock_ctor(node: ast.expr) -> bool:
    if not isinstance(node, ast.Call):
        return False
    name = call_name(node.func)
    leaf = name.rsplit(".", 1)[-1]
    if leaf in _LOCK_CTORS and ("threading" in name or name == leaf):
        return True
    # factory aliases (lockcheck's _ORIG_LOCK, bound pre-instrumentation)
    return not node.args and leaf.upper().endswith(("_LOCK", "_RLOCK"))


class _ModuleInfo:
    def __init__(self, sf):
        self.sf = sf
        self.path = sf.path
        # lock nodes declared here: name → node id
        self.module_locks: dict[str, str] = {}
        self.class_locks: dict[str, dict[str, str]] = {}  # class → attr → node id
        self.functions: dict[str, ast.FunctionDef] = {}  # qualified "Class.meth" / "fn"
        self.collections: dict[str, int] = {}  # module-level collection name → line
        self.aliases = module_aliases(sf.tree)
        self.uses_threading = "threading" in sf.source
        self._collect()

    def _nid(self, cls, attr) -> str:
        mod = self.path[:-3].replace("/", ".")
        return f"{mod}::{cls}.{attr}" if cls else f"{mod}::{attr}"

    def _collect(self):
        tree = self.sf.tree
        for node in tree.body:
            t = v = None
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                t, v = node.targets[0], node.value
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                t, v = node.target, node.value
            if isinstance(t, ast.Name):
                if _is_lock_ctor(v):
                    self.module_locks[t.id] = self._nid(None, t.id)
                elif self._is_collection(v):
                    self.collections[t.id] = node.lineno

        def walk(node, cls, fnchain):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    walk(child, child.name, fnchain)
                elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    qual = f"{cls}.{child.name}" if cls else child.name
                    # outermost defs only: nested closures are reached
                    # through their parent's body walk
                    if not fnchain:
                        self.functions.setdefault(qual, child)
                    for sub in ast.walk(child):
                        if isinstance(sub, ast.Assign) and _is_lock_ctor(sub.value):
                            for t in sub.targets:
                                if (
                                    isinstance(t, ast.Attribute)
                                    and isinstance(t.value, ast.Name)
                                    and t.value.id == "self"
                                    and cls
                                ):
                                    self.class_locks.setdefault(cls, {})[t.attr] = (
                                        self._nid(cls, t.attr)
                                    )
                    walk(child, cls, fnchain + [child.name])
                else:
                    walk(child, cls, fnchain)

        walk(tree, None, [])

    @staticmethod
    def _is_collection(v: ast.expr) -> bool:
        if isinstance(v, (ast.Dict, ast.List, ast.Set, ast.DictComp, ast.ListComp)):
            return True
        if isinstance(v, ast.Call):
            leaf = call_name(v.func).rsplit(".", 1)[-1]
            return leaf in {"dict", "list", "set", "OrderedDict", "defaultdict", "deque"}
        return False


class _Analyzer:
    def __init__(self, tree: Tree):
        self.mods = {sf.path: _ModuleInfo(sf) for sf in tree.targets()}
        # attr name → node ids across all classes (for unique-attr resolution)
        self.attr_locks: dict[str, list[str]] = {}
        # method name → qualified functions across repo (unique resolution)
        self.methods: dict[str, list[tuple[_ModuleInfo, str]]] = {}
        for mi in self.mods.values():
            for cls, attrs in mi.class_locks.items():
                for attr, nid in attrs.items():
                    self.attr_locks.setdefault(attr, []).append(nid)
            for qual in mi.functions:
                leaf = qual.rsplit(".", 1)[-1]
                self.methods.setdefault(leaf, []).append((mi, qual))
        self.edges: dict[tuple[str, str], tuple[str, int, str]] = {}
        # fn key → set of lock node ids it may acquire (fixpoint)
        self.acquires: dict[tuple[str, str], set] = {}
        self.calls: dict[tuple[str, str], set] = {}
        self.direct: dict[tuple[str, str], set] = {}
        # deferred (held locks, caller key, callee key, path, line)
        self.deferred: list = []

    # -- resolution ---------------------------------------------------------
    def _resolve_lock(self, mi: _ModuleInfo, cls, expr: ast.expr):
        if isinstance(expr, ast.Name):
            return mi.module_locks.get(expr.id)
        if isinstance(expr, ast.Attribute):
            base = expr.value
            if isinstance(base, ast.Name):
                if base.id == "self" and cls:
                    nid = mi.class_locks.get(cls, {}).get(expr.attr)
                    if nid:
                        return nid
                # imported module's module-level lock
                target = mi.aliases.get(base.id)
                if target:
                    for omi in self.mods.values():
                        omod = omi.path[:-3].replace("/", ".")
                        if omod == target or omod.endswith("." + target):
                            nid = omi.module_locks.get(expr.attr)
                            if nid:
                                return nid
            # unique lock attribute anywhere in the repo
            cands = self.attr_locks.get(expr.attr, [])
            if len(cands) == 1:
                return cands[0]
        return None

    def _resolve_call(self, mi: _ModuleInfo, cls, call: ast.Call):
        func = call.func
        if isinstance(func, ast.Name):
            if func.id in mi.functions:
                return (mi.path, func.id)
            target = mi.aliases.get(func.id)
            if target and "." in target:
                tmod, leaf = target.rsplit(".", 1)
                for omi in self.mods.values():
                    omod = omi.path[:-3].replace("/", ".")
                    if (omod == tmod or omod.endswith("." + tmod)) and leaf in omi.functions:
                        return (omi.path, leaf)
            return None
        if isinstance(func, ast.Attribute):
            base = func.value
            if isinstance(base, ast.Name) and base.id == "self" and cls:
                qual = f"{cls}.{func.attr}"
                if qual in mi.functions:
                    return (mi.path, qual)
                return None
            if isinstance(base, ast.Name):
                target = mi.aliases.get(base.id)
                if target:
                    for omi in self.mods.values():
                        omod = omi.path[:-3].replace("/", ".")
                        if omod == target or omod.endswith("." + target):
                            if func.attr in omi.functions:
                                return (omi.path, func.attr)
            # unique non-generic method name across the repo
            if func.attr not in _COMMON_METHODS:
                cands = self.methods.get(func.attr, [])
                if len(cands) == 1:
                    omi, qual = cands[0]
                    return (omi.path, qual)
        return None

    # -- per-function walk ---------------------------------------------------
    def analyze_function(self, mi: _ModuleInfo, qual: str, fn: ast.FunctionDef):
        key = (mi.path, qual)
        cls = qual.rsplit(".", 1)[0] if "." in qual else None
        direct: set = set()
        calls: set = set()
        muts: list = []

        def visit(node, held: tuple):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = list(held)
                for item in node.items:
                    nid = self._resolve_lock(mi, cls, item.context_expr)
                    if nid is not None:
                        for outer in inner:
                            if outer != nid:
                                self.edges.setdefault(
                                    (outer, nid), (mi.path, node.lineno, qual)
                                )
                        inner.append(nid)
                        direct.add(nid)
                    else:
                        visit(item.context_expr, held)
                for stmt in node.body:
                    visit(stmt, tuple(inner))
                return
            if isinstance(node, ast.Call):
                callee = self._resolve_call(mi, cls, node)
                if callee is not None:
                    calls.add(callee)
                    if held:
                        self.deferred.append(
                            (tuple(held), callee, mi.path, node.lineno, qual)
                        )
            if not held and isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete, ast.Expr)):
                m = self._mutation(mi, node)
                if m is not None:
                    muts.append(m)
            # nested defs run later (closures/threads): their bodies are
            # analyzed as NOT under the current held stack, but the locks
            # they acquire still count toward this function's acquire set
            fresh = isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            for child in ast.iter_child_nodes(node):
                visit(child, () if fresh else tuple(held))

        for stmt in fn.body:
            visit(stmt, ())
        self.direct[key] = direct
        self.calls[key] = calls
        return muts

    def _mutation(self, mi: _ModuleInfo, stmt):
        """(name, line, how) if stmt mutates a module-level collection."""
        if not mi.uses_threading:
            return None
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in mi.collections
                ):
                    return (t.value.id, stmt.lineno, "subscript store")
        elif isinstance(stmt, ast.AugAssign):
            t = stmt.target
            if (
                isinstance(t, ast.Subscript)
                and isinstance(t.value, ast.Name)
                and t.value.id in mi.collections
            ):
                return (t.value.id, stmt.lineno, "subscript store")
        elif isinstance(stmt, ast.Delete):
            for t in stmt.targets:
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.value, ast.Name)
                    and t.value.id in mi.collections
                ):
                    return (t.value.id, stmt.lineno, "del")
        elif isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
            f = stmt.value.func
            if (
                isinstance(f, ast.Attribute)
                and f.attr in _MUTATORS
                and isinstance(f.value, ast.Name)
                and f.value.id in mi.collections
            ):
                return (f.value.id, stmt.lineno, f".{f.attr}()")
        return None

    # -- fixpoint + cycles ---------------------------------------------------
    def close(self):
        acq = {k: set(v) for k, v in self.direct.items()}
        changed = True
        while changed:
            changed = False
            for key, callees in self.calls.items():
                cur = acq.setdefault(key, set())
                before = len(cur)
                for c in callees:
                    cur |= acq.get(c, set())
                if len(cur) != before:
                    changed = True
        self.acquires = acq
        for held, callee, path, line, qual in self.deferred:
            for nid in acq.get(callee, ()):
                for outer in held:
                    if outer != nid:
                        self.edges.setdefault((outer, nid), (path, line, qual))

    def cycles(self):
        """Distinct simple cycles in the edge graph, as sorted node tuples
        (one finding per cycle, anchored on one edge's provenance)."""
        succ: dict[str, set] = {}
        for a, b in self.edges:
            succ.setdefault(a, set()).add(b)
        seen_cycles = {}
        for start in sorted(succ):
            stack = [(start, [start])]
            visited = set()
            while stack:
                node, path = stack.pop()
                for nxt in sorted(succ.get(node, ())):
                    if nxt == start and len(path) > 1:
                        key = frozenset(path)
                        if key not in seen_cycles:
                            seen_cycles[key] = list(path)
                    elif nxt not in path and (nxt, len(path)) not in visited and len(path) < 6:
                        visited.add((nxt, len(path)))
                        stack.append((nxt, path + [nxt]))
        return list(seen_cycles.values())


def _analyze(tree: Tree):
    # both lock rules share one pass: the cross-module fixpoint is the
    # checker's most expensive analysis, so memoize it per Tree instance
    cached = getattr(tree, "_lock_analysis", None)
    if cached is not None:
        return cached
    an = _Analyzer(tree)
    mutations = []
    for mi in an.mods.values():
        for qual, fn in mi.functions.items():
            for name, line, how in an.analyze_function(mi, qual, fn):
                mutations.append((mi, name, line, how))
    an.close()
    tree._lock_analysis = (an, mutations)
    return tree._lock_analysis


@rule(
    ORDER_RULE,
    "no cycles in the static lock-acquisition graph",
    """
Nodes are lock attributes (Class._mu) and module-level locks; an edge A→B
means code acquires B while holding A (with-statement nesting, or a call
made under A into code that acquires B — resolved across modules). A cycle
means two threads taking the locks from opposite ends can deadlock, and
the failure needs only scheduling luck: PR 1's _MESH_EXEC_LOCK hang walled
the entire tier-1 suite with zero diagnostics and reproduced only on
2-core hosts. Fix: impose a single acquisition order (document it at the
lock definitions), narrow one critical section so the nested acquire moves
outside, or hand work off lock-free (snapshot under the lock, act after
release). The runtime detector (utils/lockcheck.py, TIDB_TPU_LOCKCHECK=1)
proves the orders tests exercise; this rule covers the orders they don't.
""",
)
def check_order(tree: Tree) -> list:
    an, _ = _analyze(tree)
    out = []
    for cyc in an.cycles():
        nodes = sorted(cyc)
        # anchor on the first edge of the cycle we recorded
        anchor = None
        for i in range(len(cyc)):
            e = an.edges.get((cyc[i], cyc[(i + 1) % len(cyc)]))
            if e is not None:
                anchor = e
                break
        path, line, qual = anchor if anchor else (nodes[0].split("::")[0], 1, "?")
        # edges carry module paths; map back to a target file path
        fpath = path if path in {sf.path for sf in tree.targets()} else nodes[0].split("::")[0]
        out.append(
            Finding(
                ORDER_RULE,
                fpath,
                line,
                "lock-order cycle: " + " -> ".join(nodes + [nodes[0]]) + f" (via {qual})",
                symbol="|".join(nodes),
            )
        )
    out.sort(key=lambda f: f.symbol)
    return out


@rule(
    MUT_RULE,
    "module-level collections mutated outside any lock",
    """
A module-level dict/list/set in a threading-using module is process-shared
state: the cop pool, program caches, observation sinks all live this way.
Mutating one outside any with-block races every other thread's access —
the PR 5 record_cop_detail incident (concurrent fan-out workers lost whole
exec-detail sets to an unlocked check-then-create) and the PR 13 sweep's
_MPP_FN_CACHE eviction (dict iteration during concurrent insert raises
RuntimeError) are both this shape. Fix: take the module's lock around the
mutation; if the structure is genuinely single-threaded or externally
serialized (e.g. under _MESH_EXEC_LOCK by construction), say so with a
`# graftcheck: off=shared-mutation` suppression at the site — the comment
IS the documentation.
""",
)
def check_mutation(tree: Tree) -> list:
    _, mutations = _analyze(tree)
    out = []
    for mi, name, line, how in mutations:
        out.append(
            Finding(
                MUT_RULE,
                mi.path,
                line,
                f"module-level collection {name!r} mutated ({how}) outside any "
                "with-lock block in a threading module",
                symbol=name,
            )
        )
    out.sort(key=lambda f: (f.path, f.line))
    return out
