"""graftcheck in the port (``tidb_tpu_torch.tools.check``) against the
reference's (``tidb_tpu.tools.check``): every fixture of
``tests/test_graftcheck.py`` whose rule the port copies unchanged runs
through both scans, the snippet at ``tidb_tpu_torch/...`` paths in the port's
and at ``tidb_tpu/...`` paths in the reference's, and gives the same findings
(rule, line, symbol) and suppressions; the port's own compile rules
(``jit-cache``, ``traced-impure``) on the port's compile sites; the CLI."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tidb_tpu.tools import check as ref_check  # noqa: E402
from tidb_tpu_torch.tools import check as port_check  # noqa: E402

# -- the reference's fixtures, through both scans --------------------------------

_OPT_BAD = "def f(x):\n    assert x > 0, 'must be positive'\n    return x\n"
_OPT_OK = "def f(x, y):\n    assert x is not None\n    assert isinstance(y, int)\n    return x + y\n"
_THREAD_BAD = "import threading\n\ndef go(fn):\n    threading.Thread(target=fn, daemon=True).start()\n"
_PRINT_BAD = "def f(x):\n    print('migrated', x)\n    return x\n"
_PRINT_OK = (
    "from {pkg}.utils import eventlog as _ev\n"
    "def f(x):\n"
    "    lg = _ev.on(_ev.INFO)\n"
    "    if lg is not None:\n"
    "        lg.emit(_ev.INFO, 'placement', 'migrated', table=x)\n"
    "    return x\n"
)
_METRIC_BAD = (
    "from {pkg}.utils.metrics import REGISTRY\n"
    "def make(dims):\n"
    "    return REGISTRY.counter('x_total', 'help', tuple(dims))\n"
)
_METRIC_GRP = (
    "from {pkg}.utils.metrics import REGISTRY\n"
    "RU = REGISTRY.counter('ru_total', 'help', ('group',))\n"
    "STMTS = REGISTRY.counter('stmt_total', 'help', ('group',))\n"
)
_SYS_OK = (
    "SYS_SECTIONS = frozenset({'metrics', 'slow'})\n"
    "def sys_report(sections=None):\n"
    "    want = None if sections is None else set(sections)\n"
    "    def _want(k):\n"
    "        return want is None or k in want\n"
    "    rep = {}\n"
    "    if _want('metrics'):\n"
    "        rep['metrics'] = 1\n"
    "    if _want('slow'):\n"
    "        rep['slow'] = []\n"
    "    return rep\n"
)
_SYS_BAD = _SYS_OK.replace("    return rep\n", "    if _want('heatmap'):\n        rep['heatmap'] = []\n    return rep\n")
_MUT_BAD = "import threading\n_CACHE = {}\n_MU = threading.Lock()\ndef put(k, v):\n    _CACHE[k] = v\n"
_LOCK_REV = (
    "import threading\n_A = threading.Lock()\n_B = threading.Lock()\n"
    "def one():\n    with _A:\n        with _B:\n            pass\n"
    "def two():\n    with _B:\n        with _A:\n            pass\n"
)
_LOCK_CROSS = (
    "import threading\n_A = threading.Lock()\n_B = threading.Lock()\n"
    "def g():\n    with _B:\n        pass\n"
    "def f():\n    with _A:\n        g()\n"
    "def h():\n    with _B:\n        with _A:\n            pass\n"
)
_DEAD = "def used():\n    return 1\n\ndef unused_helper():\n    return used()\n"
_REPLAY = (
    'REPLAYABLE = frozenset({"ping"})\n'
    'NON_REPLAYABLE = frozenset({"boom"})\n'
    "class StoreServer:\n"
    "    def _dispatch(self, h, blobs):\n"
    '        cmd = h["cmd"]\n'
    '        if cmd == "ping":\n'
    "            return {}, []\n"
    '        if cmd == "boom":\n'
    "            return {}, []\n"
    '        if cmd == "mystery":\n'
    "            return {}, []\n"
    "class RemoteStore:\n"
    "    def _call(self, header):\n"
    '        cmd = header["cmd"]\n'
    "        replayable = cmd in REPLAYABLE\n"
    "        return None\n"
)
_FP_REGISTRY = "FAILPOINTS = frozenset({\n    'colcache_merge',\n    'remote_send',\n})\n"
# failpoint calls assembled by string concatenation, as the reference's test
# does, so the real-tree scan (which reads tests/ as corpus) never sees them
_FP_INJECTS = (
    "from {pkg}.utils import failpoint\n"
    "def merge():\n"
    "    failpoint.in" "ject('colcache_merge', 1)\n"
    "def send():\n"
    "    failpoint.in" "ject('remote_send', 'cop')\n"
)
_FP_ALIASED = (
    "from {pkg}.utils import failpoint as _fp\n"
    "def probe(i):\n"
    "    _fp.in" "ject('mystery', i)  # graftcheck: off=failpoint-registry\n"
)
_SWALLOW_BAD = (
    "def f():\n    try:\n        g()\n    except Exception:\n        pass\n"
    "def h():\n    try:\n        g()\n    except:\n        return 1\n"
)
_SWALLOW_OK = (
    "def f():\n    try:\n        g()\n    except ValueError:\n        pass\n"
    "def h(self):\n    try:\n        g()\n    except Exception as e:\n        self.errors += 1\n        self.last = e\n"
)
_SWALLOW_TUPLE = (
    "def f(xs):\n    for x in xs:\n        try:\n            g(x)\n        except (ValueError, Exception):\n            continue\n"
)
_SWALLOW_REASON = (
    "def f():\n    try:\n        g()\n    # advisory probe; sweep retries next tick\n"
    "    except Exception:  # graftcheck: off=except-swallow\n        pass\n"
)

# name → (rules, {path under the package: source}, corpus); "{pkg}" is the
# package's name in paths and sources
FIXTURES = {
    "opt_assert_bad": (["opt-assert"], {"kv/x.py": _OPT_BAD}, {}),
    "opt_assert_narrowing_ok": (["opt-assert"], {"kv/x.py": _OPT_OK}, {}),
    "thread_name_bad": (["thread-name"], {"kv/x.py": _THREAD_BAD}, {}),
    "thread_name_ok": (["thread-name"], {"kv/x.py": _THREAD_BAD.replace("daemon=True", "daemon=True, name='worker'")}, {}),
    "eventlog_bad": (["eventlog-discipline"], {"kv/x.py": _PRINT_BAD}, {}),
    "eventlog_structured_ok": (["eventlog-discipline"], {"kv/x.py": _PRINT_OK}, {}),
    "eventlog_tools_exempt": (["eventlog-discipline"], {"tools/x.py": _PRINT_BAD}, {}),
    "eventlog_bench_exempt": (["eventlog-discipline"], {"bench/x.py": _PRINT_BAD}, {}),
    "eventlog_main_exempt": (["eventlog-discipline"], {"kv/__main__.py": _PRINT_BAD}, {}),
    "eventlog_suppressed": (
        ["eventlog-discipline"],
        {"kv/x.py": _PRINT_BAD.replace("print('migrated', x)", "print('migrated', x)  # graftcheck: off=eventlog-discipline")},
        {},
    ),
    "metric_labels_bad": (["metric-labels"], {"utils/x.py": _METRIC_BAD}, {}),
    "metric_labels_ok": (["metric-labels"], {"utils/x.py": _METRIC_BAD.replace("tuple(dims)", "('kind', 'outcome')")}, {}),
    "metric_labels_group": (["metric-labels"], {"utils/x.py": _METRIC_GRP}, {}),
    "sys_sections_ok": (["sys-sections"], {"kv/remote.py": _SYS_OK}, {}),
    "sys_sections_undeclared": (["sys-sections"], {"kv/remote.py": _SYS_BAD}, {}),
    "sys_sections_stale": (["sys-sections"], {"kv/remote.py": _SYS_OK.replace("{'metrics', 'slow'}", "{'metrics', 'slow', 'traces'}")}, {}),
    "sys_sections_no_declaration": (["sys-sections"], {"kv/remote.py": _SYS_OK.replace("SYS_SECTIONS = frozenset({'metrics', 'slow'})\n", "")}, {}),
    "sys_sections_other_file": (["sys-sections"], {"kv/other.py": _SYS_BAD}, {}),
    "shared_mutation_bad": (["shared-mutation"], {"kv/x.py": _MUT_BAD}, {}),
    "shared_mutation_locked": (["shared-mutation"], {"kv/x.py": _MUT_BAD.replace("    _CACHE[k] = v\n", "    with _MU:\n        _CACHE[k] = v\n")}, {}),
    "lock_order_reversed": (["lock-order"], {"kv/x.py": _LOCK_REV}, {}),
    "lock_order_consistent": (["lock-order"], {"kv/x.py": _LOCK_REV.replace("with _B:\n        with _A:", "with _A:\n        with _B:")}, {}),
    "lock_order_cross_function": (["lock-order"], {"kv/x.py": _LOCK_CROSS}, {}),
    "dead_code": (["dead-code"], {"utils/x.py": _DEAD}, {}),
    "dead_code_test_keeps_alive": (["dead-code"], {"utils/x.py": _DEAD}, {"tests/test_x.py": "unused_helper()"}),
    "replay_registry": (["replay-registry"], {"kv/remote.py": _REPLAY}, {}),
    "replay_registry_open_gate": (["replay-registry"], {"kv/remote.py": _REPLAY.replace("cmd in REPLAYABLE", "cmd not in NON_REPLAYABLE")}, {}),
    "suppression_one_rule": (["opt-assert"], {"kv/x.py": "def f(x):\n    assert x > 0  # graftcheck: off=opt-assert\n    return x\n"}, {}),
    "suppression_other_rule": (["opt-assert"], {"kv/x.py": "def f(x):\n    assert x > 0  # graftcheck: off=thread-name\n    return x\n"}, {}),
    "suppression_bare": (["opt-assert"], {"kv/x.py": "def f(x):\n    assert x > 0  # graftcheck: off\n    return x\n"}, {}),
    "suppression_not_above": (
        ["opt-assert"],
        {"kv/x.py": "def f(x):\n    assert x > 0\n    # graftcheck: off=opt-assert\n    assert x < 9\n    return x\n"},
        {},
    ),
    "failpoint_clean": (
        ["failpoint-registry"],
        {"kv/fault_injection.py": _FP_REGISTRY, "copr/x.py": _FP_INJECTS},
        {"tests/test_x.py": "failpoint.en" "able('remote_send', boom)\n"},
    ),
    "failpoint_typo_in_test": (
        ["failpoint-registry"],
        {"kv/fault_injection.py": _FP_REGISTRY, "copr/x.py": _FP_INJECTS},
        {"tests/test_x.py": "failpoint.en" "able('remote_sned', boom)\n"},
    ),
    "failpoint_unregistered_inject": (
        ["failpoint-registry"],
        {"kv/fault_injection.py": _FP_REGISTRY, "copr/x.py": _FP_INJECTS + "def extra():\n    failpoint.in" "ject('new_point')\n"},
        {},
    ),
    "failpoint_stale_entry": (
        ["failpoint-registry"],
        {"kv/fault_injection.py": _FP_REGISTRY,
         "copr/x.py": _FP_INJECTS.replace("    failpoint.in" "ject('remote_send', 'cop')\n", "    pass\n")},
        {},
    ),
    "failpoint_alias_suppressed": (
        ["failpoint-registry"],
        {"kv/fault_injection.py": _FP_REGISTRY, "copr/x.py": _FP_INJECTS, "parallel/x.py": _FP_ALIASED},
        {},
    ),
    "failpoint_alias_seen": (
        ["failpoint-registry"],
        {"kv/fault_injection.py": _FP_REGISTRY, "copr/x.py": _FP_INJECTS,
         "parallel/x.py": _FP_ALIASED.replace("  # graftcheck: off=failpoint-registry", "")},
        {},
    ),
    "except_swallow_bad": (["except-swallow"], {"kv/x.py": _SWALLOW_BAD}, {}),
    "except_swallow_narrowed_ok": (["except-swallow"], {"kv/x.py": _SWALLOW_OK}, {}),
    "except_swallow_tuple_broad": (["except-swallow"], {"kv/x.py": _SWALLOW_TUPLE}, {}),
    "except_swallow_reasoned": (["except-swallow"], {"kv/x.py": _SWALLOW_REASON}, {}),
}


def _outcome(check, pkg: str, rules, files: dict, corpus: dict):
    tree = check.Tree({f"{pkg}/{p}": s.replace("{pkg}", pkg) for p, s in files.items()}, corpus=dict(corpus))
    rep = check.scan(tree, rules=rules)
    cut = len(pkg) + 1
    # a lock node's symbol names its module (package.path::name)
    return (
        [(f.rule, f.path[cut:] if f.path.startswith(pkg + "/") else f.path, f.line, f.symbol.replace(pkg + ".", "{pkg}."))
         for f in rep.findings],
        rep.suppressed,
    )


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_finds_what_the_reference_finds(name):
    rules, files, corpus = FIXTURES[name]
    want = _outcome(ref_check, "tidb_tpu", rules, files, corpus)
    assert _outcome(port_check, "tidb_tpu_torch", rules, files, corpus) == want


def test_the_fixtures_are_not_vacuous():
    """The table holds findings and clean shapes alike (each compared above
    against the reference's answer)."""
    found = {name: _outcome(port_check, "tidb_tpu_torch", *FIXTURES[name])[0] for name in FIXTURES}
    assert sum(1 for f in found.values() if f) >= 15
    assert sum(1 for f in found.values() if not f) >= 15
    assert [f[3] for f in found["replay_registry"]] == ["mystery"]
    assert [f[3] for f in found["failpoint_typo_in_test"]] == ["remote_sned"]


# seeded mutations of real files the port copies: the same finding in both
REAL_MUTATIONS = {
    "undeclared_verb_in_remote": (
        "replay-registry", "kv/remote.py", 'if cmd == "ping":',
        'if cmd == "snap_delete_range":\n            return {"ok": 1}, []\n        if cmd == "ping":',
    ),
    "assert_in_sharded": (
        "opt-assert", "kv/sharded.py", "segments = self.store.group_ranges",
        "assert req.concurrency > 0\n        segments = self.store.group_ranges",
    ),
    "lock_inversion_in_ddl": (
        "lock-order", "catalog/ddl.py", None,
        "\n\ndef _evil_reversed(worker):\n    with worker._mu:\n        with worker._run_mu:\n            pass\n",
    ),
}


@pytest.mark.parametrize("name", sorted(REAL_MUTATIONS))
def test_seeded_mutation_of_a_copied_file_finds_what_the_reference_finds(name):
    rule, rel, needle, repl = REAL_MUTATIONS[name]
    got = {}
    for check, pkg in ((ref_check, "tidb_tpu"), (port_check, "tidb_tpu_torch")):
        with open(os.path.join(REPO, pkg, rel), encoding="utf-8") as fh:
            src = fh.read()
        mut = src + repl if needle is None else src.replace(needle, repl, 1)
        assert mut != src
        assert not check.scan(check.Tree({f"{pkg}/{rel}": src}), rules=[rule]).findings
        rep = check.scan(check.Tree({f"{pkg}/{rel}": mut}), rules=[rule])
        got[pkg] = [(f.rule, f.line, f.symbol.replace(pkg + ".", "{pkg}.")) for f in rep.findings]
    assert got["tidb_tpu_torch"] == got["tidb_tpu"]
    assert len(got["tidb_tpu"]) == 1


# -- the port's compile sites -------------------------------------------------------


def _port(rules, files: dict):
    return port_check.scan(port_check.Tree(files), rules=rules).findings


def test_jit_cache_flags_an_uncached_program_build():
    bad = "def hot(dag):\n    return _build(dag, 1024, 64)\n"
    found = _port(["jit-cache"], {"tidb_tpu_torch/ops/x.py": bad})
    assert [(f.line, f.symbol) for f in found] == [(2, "_build")]
    # the same build through another module's builder is a build all the same
    imp = "from tidb_tpu_torch.ops import dag_kernel\ndef hot(dag):\n    return dag_kernel._build(dag, 1024, 64)\n"
    assert [f.symbol for f in _port(["jit-cache"], {"tidb_tpu_torch/copr/gpu_engine.py": imp})] == ["dag_kernel._build"]
    # get_kernel is _build's funnel in dag_kernel.py, get_window_fn in window_kernel.py
    ok = "def get_kernel(dag):\n    k = _COMPILE_CACHE.get(dag)\n    if k is None:\n        k = _build(dag, 1024, 64)\n    return k\n"
    assert not _port(["jit-cache"], {"tidb_tpu_torch/ops/dag_kernel.py": ok})
    assert _port(["jit-cache"], {"tidb_tpu_torch/ops/window_kernel.py": ok})
    win = ok.replace("get_kernel", "get_window_fn")
    assert not _port(["jit-cache"], {"tidb_tpu_torch/ops/window_kernel.py": win})
    # out of scope: not the rule's business
    assert not _port(["jit-cache"], {"tidb_tpu_torch/session/x.py": bad})


def test_jit_cache_holds_the_mpp_pipeline_to_its_cache():
    call = "def {fn}(self, mesh):\n    return build_dist_pipeline(mesh, [], None)\n"
    assert not _port(["jit-cache"], {"tidb_tpu_torch/parallel/gather.py": call.format(fn="_execute_attempt")})
    found = _port(["jit-cache"], {"tidb_tpu_torch/parallel/gather.py": call.format(fn="execute")})
    assert [f.symbol for f in found] == ["build_dist_pipeline"]
    assert not _port(["jit-cache"], {"tidb_tpu_torch/parallel/mpp.py": call.format(fn="build_dist_join_agg")})
    assert _port(["jit-cache"], {"tidb_tpu_torch/parallel/mpp.py": call.format(fn="build_dist_agg")})


def test_jit_cache_flags_a_compiler_launch_outside_its_funnel():
    start = (
        "import subprocess\n"
        "def _start(name):\n"
        "    return subprocess.Popen(['nvcc', name])\n"
    )
    assert not _port(["jit-cache"], {"tidb_tpu_torch/native/cuda.py": start})
    stray = start + "def load(name):\n    proc = subprocess.Popen(['nvcc', name])\n    return proc.wait()\n"
    found = _port(["jit-cache"], {"tidb_tpu_torch/native/cuda.py": stray})
    assert [(f.line, f.symbol) for f in found] == [(5, "subprocess.Popen")]
    # g++ in the row codec's _build (called once by lib()) is its funnel
    gxx = (
        "import subprocess\n"
        "def _build():\n    subprocess.run(['g++'], check=True)\n"
        "def lib():\n    return _build()\n"
        "def rebuild():\n    return _build()\n"
    )
    found = _port(["jit-cache"], {"tidb_tpu_torch/native/__init__.py": gxx})
    assert [(f.line, f.symbol) for f in found] == [(7, "_build")]
    assert [f.symbol for f in _port(["jit-cache"], {"tidb_tpu_torch/ops/x.py": stray})] == ["subprocess.Popen"] * 2


def test_seeded_uncached_build_in_the_real_dag_kernel():
    with open(os.path.join(REPO, "tidb_tpu_torch", "ops", "dag_kernel.py"), encoding="utf-8") as fh:
        src = fh.read()
    path = "tidb_tpu_torch/ops/dag_kernel.py"
    assert not _port(["jit-cache", "traced-impure"], {path: src})
    mut = src + "\n\ndef _hotpath_extra(dag):\n    return _build(dag, 1024, 64)\n"
    found = _port(["jit-cache"], {path: mut})
    assert [f.symbol for f in found] == ["_build"]


def test_traced_impure_holds_the_builders_and_their_closures():
    bad = (
        "import time\n"
        "def _build(dag):\n"
        "    def program(x):\n"
        "        t = time.perf_counter()\n"
        "        return x * t\n"
        "    return program\n"
        "def get_kernel(dag):\n"
        "    t0 = time.perf_counter()\n"
        "    k = _build(dag)\n"
        "    return k, time.perf_counter() - t0\n"
    )
    found = _port(["traced-impure"], {"tidb_tpu_torch/ops/dag_kernel.py": bad})
    assert [(f.line, f.symbol) for f in found] == [(4, "program:time.perf_counter")]
    # the builder's own body too, and a set's order
    body = "import random\ndef build_dist_pipeline(mesh, keys):\n    seed = random.random()\n    for k in set(keys):\n        pass\n"
    found = _port(["traced-impure"], {"tidb_tpu_torch/parallel/mpp.py": body})
    assert sorted(f.symbol for f in found) == ["build_dist_pipeline:random.random", "build_dist_pipeline:set-iter"]
    # native/'s _build starts a compiler; it builds no device program
    native = "import time\ndef _build():\n    t0 = time.time()\n    return t0\n"
    assert not _port(["traced-impure"], {"tidb_tpu_torch/native/__init__.py": native})


def test_the_port_tree_has_no_compile_finding_and_the_rules_see_its_sites():
    tree = port_check.build_tree(REPO)
    assert not port_check.scan(tree, rules=["jit-cache", "traced-impure"]).findings
    from tidb_tpu_torch.tools.check import rules_compile

    # every funnel names a function its file defines
    for path, names in rules_compile.CACHE_HELPERS.items():
        src = tree.files[path].source
        for name in names:
            assert f"def {name}(" in src, (path, name)


# -- the CLI ---------------------------------------------------------------------------

_CLI_PROBE = r"""
import json, sys
sys.path.insert(0, {repo!r})
from tidb_tpu_torch.tools.check.__main__ import main
rc_scan = main(["--json", {out!r}])
rc_explain = main(["--explain", "jit-cache"])
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.") or m == "tidb_tpu" or m.startswith("tidb_tpu."))
print(json.dumps({{"scan": rc_scan, "explain": rc_explain, "bad": bad}}))
"""


def test_cli_scans_clean_explains_and_writes_json_without_jax(tmp_path):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    p = subprocess.run([sys.executable, "-m", "tidb_tpu_torch.tools.check"], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert "graftcheck: clean (0 baselined" in p.stdout
    out = str(tmp_path / "report.json")
    p = subprocess.run([sys.executable, "-c", _CLI_PROBE.format(repo=REPO, out=out)], capture_output=True,
                       text=True, cwd=str(tmp_path), env=env, timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.strip().splitlines()
    assert json.loads(lines[-1]) == {"scan": 0, "explain": 0, "bad": []}
    assert "jit-cache" in p.stdout and "Fix:" in p.stdout and "get_kernel" in p.stdout
    with open(out, encoding="utf-8") as fh:
        rep = json.load(fh)
    assert rep["ok"] is True and rep["findings"] == [] and rep["baselined"] == []


def test_cli_refuses_a_partial_baseline_rewrite_and_an_unknown_rule():
    from tidb_tpu_torch.tools.check.__main__ import main

    assert main(["--root", REPO, "--rules", "opt-assert", "--update-baseline"]) == 2
    assert main(["--explain", "no-such-rule"]) == 2
