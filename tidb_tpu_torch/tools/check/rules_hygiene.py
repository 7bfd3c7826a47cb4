"""GC rules: thread hygiene (``thread-name``) and metric label cardinality
(``metric-labels``).

Threads: the tier-1 ``thread_hygiene`` fixture (tests/conftest.py) hunts
leaked background threads BY NAME — an anonymous ``Thread-42`` is invisible
to it, and the repo has already paid for stray per-request pool threads
(PR 3's cop_/rcop_ regression class) and leaked keepalives (PR 2). Every
``threading.Thread(...)`` must carry an explicit ``name=`` so leaks are
attributable and the fixture's pattern list stays meaningful.

Metrics: the in-process registry (utils/metrics.py) keeps one dict entry
per label combination FOREVER — a label fed from an unbounded domain (per
key, per address, per SQL digest) is a slow memory leak that also bloats
every sys_snapshot wire report and metrics-history ring (PR 9 ships whole
registry snapshots fleet-wide). Label NAMES must be a literal tuple (≤4)
so reviewers can see the cardinality contract at the constructor.
"""

from __future__ import annotations

import ast

from tidb_tpu_torch.tools.check.core import Finding, Tree, call_name, rule

THREAD_RULE = "thread-name"
METRIC_RULE = "metric-labels"
EVENTLOG_RULE = "eventlog-discipline"


@rule(
    THREAD_RULE,
    "threading.Thread(...) requires an explicit name=",
    """
Every threading.Thread construction must pass name= (a stable literal or a
purpose-prefixed f-string like f"mpp-task-{id}"). The tier-1 thread_hygiene
fixture asserts no stray background threads survive teardown by matching
thread NAMES — anonymous Thread-N workers are invisible to it, so a leak
ships silently. Incidents: PR 2's leaked owner-keepalive threads and PR 3's
per-request cop-pool threads were both caught (and are now guarded) purely
because they were nameable. Fix: name the thread after its role; if it's a
new long-lived background loop, also teach tests/conftest.py's
thread_hygiene stray() list about the prefix.
""",
)
def check_threads(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Call):
                name = call_name(node.func)
                if name.endswith("threading.Thread") or name == "Thread":
                    if not any(kw.arg == "name" for kw in node.keywords):
                        out.append(
                            Finding(
                                THREAD_RULE,
                                sf.path,
                                node.lineno,
                                "threading.Thread without name= — invisible to the "
                                "thread_hygiene leak guard; name it after its role",
                                symbol="Thread",
                            )
                        )
    return out


# CLI surfaces whose job IS stdout: the ecosystem tools, the bench
# runners, and module entry points
_PRINT_EXEMPT_PREFIXES = ("tidb_tpu_torch/tools/", "tidb_tpu_torch/bench/")


@rule(
    EVENTLOG_RULE,
    "package code must not print() — record an event or raise",
    """
Bare print() in library code is an observability leak: the line scrolls
off a terminal nobody is watching, never reaches information_schema
.tidb_log / cluster_log, carries no level, component, or trace_id, and is
invisible to the log_search wire verb and the tools.diag bundle. The repo
has a structured event log (utils/eventlog) precisely so load-bearing
state transitions survive for post-hoc diagnosis — a print is a signal
that dies at birth. Fix: emit an event (eventlog.on(level) gate + emit)
or raise a typed error. CLI surfaces whose contract IS stdout — tools/,
bench/, and __main__.py entry points — are exempt.
""",
)
def check_eventlog_discipline(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        if sf.path.startswith(_PRINT_EXEMPT_PREFIXES) or sf.path.endswith("__main__.py"):
            continue
        for node in ast.walk(sf.tree):
            if (
                isinstance(node, ast.Call)
                and call_name(node.func) == "print"
            ):
                out.append(
                    Finding(
                        EVENTLOG_RULE,
                        sf.path,
                        node.lineno,
                        "bare print() in package code — emit a structured "
                        "event (utils/eventlog) so the signal reaches "
                        "cluster_log and the diag bundle",
                        symbol="print",
                    )
                )
    return out


_METRIC_CTORS = {"counter", "gauge"}
MAX_LABELS = 4


@rule(
    METRIC_RULE,
    "registry metrics must declare a literal, bounded label tuple",
    """
REGISTRY.counter/gauge label sets must be literal tuples of at most 4
string names, declared at the constructor — the registry stores one entry
per label-value combination forever, and PR 9 ships full registry
snapshots over the wire in every sys_snapshot sweep and samples them into
per-series metrics-history rings (with an explicit series cap that
unbounded label growth would silently exhaust). A computed labels argument
hides the cardinality contract from review. Fix: declare the tuple
literally; if a dimension's value domain is unbounded (keys, addresses,
digests), it belongs in the slow log / Top-SQL rings, not in a metric
label.
""",
)
def check_metrics(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        for node in ast.walk(sf.tree):
            if not isinstance(node, ast.Call):
                continue
            fname = call_name(node.func)
            leaf = fname.rsplit(".", 1)[-1]
            if leaf not in _METRIC_CTORS or "REGISTRY" not in fname:
                continue
            labels = None
            if len(node.args) >= 3:
                labels = node.args[2]
            for kw in node.keywords:
                if kw.arg == "labels":
                    labels = kw.value
            if labels is None:
                continue  # label-less metric: nothing to bound
            ok = isinstance(labels, ast.Tuple) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in labels.elts
            )
            if ok and len(labels.elts) > MAX_LABELS:
                ok = False
            if not ok:
                out.append(
                    Finding(
                        METRIC_RULE,
                        sf.path,
                        node.lineno,
                        f"metric labels must be a literal tuple of ≤{MAX_LABELS} "
                        "string names (cardinality is a reviewable contract)",
                        symbol=leaf,
                    )
                )
    return out
