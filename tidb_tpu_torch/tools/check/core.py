"""graftcheck core: the scan engine behind ``python -m tidb_tpu_torch.tools.check``.

Reference parity: TiDB ships its repo-native invariants as ``build/linter/``
analyzers wired into every build via nogo (util/prealloc, bodyclose, the
custom durability linters) — the insight being that a codebase's recurring
review findings ARE its invariant set, and the cheapest review is the one a
machine does on every commit. This package is that layer for this repo:
every rule in ``tidb_tpu_torch/tools/check/rules_*.py`` is grounded in a
bug class a past PR paid for by hand (see STATIC_ANALYSIS.md for the
catalog with incident history). This package's checker scans this
package (``tidb_tpu_torch/``) against its own baseline.

Mechanics:
- Rules are AST visitors over a :class:`Tree` (path → parsed source).
  Tests feed synthetic trees; the CLI feeds the real package.
- Per-line suppression: ``# graftcheck: off=rule-id`` (or ``off=a,b``,
  or bare ``off`` for every rule) on the finding's line or the line above.
- A committed baseline (``graftcheck_baseline_torch.json``) grandfathers legacy
  findings by (rule, path, symbol, line-content-hash) — line NUMBERS are
  deliberately not part of the key, so unrelated edits don't churn it —
  while NEW violations hard-fail. The baseline is meant to stay near-empty:
  fix or explicitly suppress, don't accumulate.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

# -- findings ----------------------------------------------------------------


@dataclass
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int  # 1-based
    msg: str
    symbol: str = ""  # stable anchor (verb / lock node / function name)

    def key(self, line_text: str) -> dict:
        """Baseline identity: survives reformatting elsewhere in the file
        (no line number), breaks when the offending line itself changes."""
        h = hashlib.sha1(line_text.strip().encode()).hexdigest()[:12]
        return {"rule": self.rule, "path": self.path, "symbol": self.symbol, "hash": h}

    def to_pb(self, line_text: str = "") -> dict:
        d = {"rule": self.rule, "path": self.path, "line": self.line, "msg": self.msg}
        if self.symbol:
            d["symbol"] = self.symbol
        d["key"] = self.key(line_text)
        return d

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.rule}] {self.msg}"


# -- sources -----------------------------------------------------------------

_SUPPRESS_RE = re.compile(r"#\s*graftcheck:\s*off(?:=([\w\-, ]+))?")


class SourceFile:
    def __init__(self, path: str, source: str):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self._tree: Optional[ast.Module] = None
        self._suppress: Optional[dict] = None

    @property
    def tree(self) -> ast.Module:
        if self._tree is None:
            self._tree = ast.parse(self.source, filename=self.path)
        return self._tree

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def suppressed(self, lineno: int, rule: str) -> bool:
        """``# graftcheck: off[=rule,...]`` on the finding's line, or on a
        comment line immediately ABOVE it. Deliberately not the line below:
        findings anchor at a statement's FIRST line, so a below-the-line
        probe could only ever suppress an adjacent unrelated statement."""
        if self._suppress is None:
            sup: dict[int, set] = {}
            for i, text in enumerate(self.lines, start=1):
                m = _SUPPRESS_RE.search(text)
                if m:
                    rules = m.group(1)
                    ids = (
                        {r.strip() for r in rules.split(",") if r.strip()}
                        if rules
                        else {"*"}
                    )
                    sup[i] = ids
            self._suppress = sup
        for ln in (lineno, lineno - 1):
            ids = self._suppress.get(ln)
            if ids and ("*" in ids or rule in ids):
                return True
        return False


class Tree:
    """The scan unit: repo-relative path → SourceFile. ``targets`` are the
    linted files; ``corpus`` adds reference-only sources (tests, entry
    points) that rules like dead-code count identifier uses in without
    linting them."""

    def __init__(self, files: dict[str, str], corpus: Optional[dict[str, str]] = None):
        self.files: dict[str, SourceFile] = {
            p: SourceFile(p, s) for p, s in sorted(files.items())
        }
        self.corpus: dict[str, str] = dict(corpus or {})

    def targets(self) -> Iterable[SourceFile]:
        return self.files.values()

    def get(self, suffix: str) -> Optional[SourceFile]:
        """First target whose path ends with ``suffix`` (rule anchors like
        kv/remote.py)."""
        for p, f in self.files.items():
            if p.endswith(suffix):
                return f
        return None

    def all_text(self) -> str:
        parts = [f.source for f in self.files.values()]
        parts.extend(self.corpus.values())
        return "\n".join(parts)


# -- rule registry -----------------------------------------------------------


@dataclass
class Rule:
    id: str
    title: str
    explain: str  # the catalog entry: invariant + historical incident
    check: Callable[[Tree], list]


RULES: dict[str, Rule] = {}


def rule(id: str, title: str, explain: str):
    def deco(fn):
        RULES[id] = Rule(id, title, explain.strip(), fn)
        return fn

    return deco


def load_rules() -> dict[str, Rule]:
    """Import every rules_* module exactly once (registration side effect)."""
    from tidb_tpu_torch.tools.check import (  # noqa: F401
        rules_compile,
        rules_dead,
        rules_hygiene,
        rules_locks,
        rules_pyopt,
        rules_robust,
        rules_wire,
    )

    return RULES


# -- tree assembly -----------------------------------------------------------

EXCLUDE_PARTS = ("__pycache__",)


def repo_root() -> str:
    """The directory containing the ``tidb_tpu_torch`` package."""
    here = os.path.dirname(os.path.abspath(__file__))  # .../tidb_tpu_torch/tools/check
    return os.path.dirname(os.path.dirname(os.path.dirname(here)))


def _read(path: str) -> str:
    with open(path, encoding="utf-8", errors="replace") as f:
        return f.read()


def build_tree(root: Optional[str] = None) -> Tree:
    root = root or repo_root()
    targets: dict[str, str] = {}
    corpus: dict[str, str] = {}
    pkg = os.path.join(root, "tidb_tpu_torch")
    for base, dirs, names in os.walk(pkg):
        dirs[:] = [d for d in dirs if d not in EXCLUDE_PARTS]
        for n in sorted(names):
            if n.endswith(".py"):
                p = os.path.join(base, n)
                rel = os.path.relpath(p, root).replace(os.sep, "/")
                targets[rel] = _read(p)
    # reference-only corpus: tests + entry points keep dead-code honest
    # (a helper only a test or the card's smoke calls is not dead)
    tdir = os.path.join(root, "tests")
    if os.path.isdir(tdir):
        for base, dirs, names in os.walk(tdir):
            dirs[:] = [d for d in dirs if d not in EXCLUDE_PARTS]
            for n in sorted(names):
                if n.endswith(".py"):
                    p = os.path.join(base, n)
                    rel = os.path.relpath(p, root).replace(os.sep, "/")
                    corpus[rel] = _read(p)
    for extra in ("bench.py", "__graft_entry__.py", "chip_smoke.py"):
        p = os.path.join(root, extra)
        if os.path.isfile(p):
            corpus[extra] = _read(p)
    return Tree(targets, corpus)


# -- scan --------------------------------------------------------------------


@dataclass
class Report:
    findings: list = field(default_factory=list)  # new (blocking) findings
    baselined: list = field(default_factory=list)  # matched the baseline
    suppressed: int = 0

    def to_pb(self, tree: Tree) -> dict:
        def rows(fs):
            out = []
            for f in fs:
                sf = tree.files.get(f.path)
                out.append(f.to_pb(sf.line_text(f.line) if sf else ""))
            return out

        return {
            "findings": rows(self.findings),
            "baselined": rows(self.baselined),
            "suppressed": self.suppressed,
            "ok": not self.findings,
        }


def scan(
    tree: Tree,
    rules: Optional[Iterable[str]] = None,
    baseline: Optional[list] = None,
) -> Report:
    all_rules = load_rules()
    ids = list(rules) if rules else sorted(all_rules)
    unknown = [i for i in ids if i not in all_rules]
    if unknown:
        raise ValueError(f"unknown rule(s): {unknown}; known: {sorted(all_rules)}")
    # a MULTISET of baseline keys: one baseline entry grandfathers exactly
    # one occurrence, so a second textually-identical violation in the same
    # file still hard-fails (a set would silently absorb it)
    base_keys: dict[tuple, int] = {}
    for entry in baseline or ():
        k = entry.get("key", entry)
        kk = (k["rule"], k["path"], k.get("symbol", ""), k["hash"])
        base_keys[kk] = base_keys.get(kk, 0) + 1
    rep = Report()
    for rid in ids:
        for f in all_rules[rid].check(tree):
            sf = tree.files.get(f.path)
            text = sf.line_text(f.line) if sf else ""
            if sf is not None and sf.suppressed(f.line, f.rule):
                rep.suppressed += 1
                continue
            k = f.key(text)
            kk = (k["rule"], k["path"], k["symbol"], k["hash"])
            if base_keys.get(kk, 0) > 0:
                base_keys[kk] -= 1
                rep.baselined.append(f)
            else:
                rep.findings.append(f)
    rep.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    rep.baselined.sort(key=lambda f: (f.path, f.line, f.rule))
    return rep


def load_baseline(path: str) -> list:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return data.get("findings", data) if isinstance(data, dict) else data


def write_baseline(path: str, tree: Tree, report: Report) -> None:
    rows = []
    for f in report.findings + report.baselined:
        sf = tree.files.get(f.path)
        rows.append(f.to_pb(sf.line_text(f.line) if sf else ""))
    rows.sort(key=lambda r: (r["path"], r["rule"], r.get("line", 0)))
    with open(path, "w", encoding="utf-8") as fh:
        json.dump({"findings": rows}, fh, indent=1)
        fh.write("\n")


# -- shared AST helpers (used by several rule modules) -----------------------


def call_name(func: ast.expr) -> str:
    """Dotted name of a call target, best-effort ('' if not name-shaped)."""
    parts = []
    node = func
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ".".join(reversed(parts)) if parts else ""


def module_aliases(tree: ast.Module) -> dict:
    """Alias → imported module path for plain and from-imports."""
    out: dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                out[a.asname or a.name.split(".")[0]] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                out[a.asname or a.name] = f"{node.module}.{a.name}"
    return out
