"""GC rules: compile-churn control (``jit-cache``) and program-builder
purity (``traced-impure``).

The incident class: the grouped MIN/MAX "compile bomb" — a kernel shape
that re-entered compilation per query walled tier-1 for 27+ minutes; the
fix forced every fragment program through ONE power-of-two-bucketed
cache. This package has no jit: its compile sites
are the calls that build a device program a cache keeps (the fused DAG
program, the window program, the MPP fragment program) and the calls that
start a compiler (nvcc for the hand-written kernels, g++ for the row
codec). A single such call outside its cache quietly reintroduces the
class: it rebuilds per CALL, invisible on toy shapes, catastrophic at
production shapes. So in the device-code directories every compile site
must live inside a recognized cache funnel — the functions whose callers
key builds structurally.

Purity: a cached program must be a pure function of its operands.
``time.*``/``random.*`` calls inside a builder or the closures it returns
bake ONE value in at build time and never move again (the first-call
compile probe exists precisely because timing must happen OUTSIDE the
kernel); iterating a set gives hash-order-dependent program structure,
which silently changes the program across runs.
"""

from __future__ import annotations

import ast

from tidb_tpu_torch.tools.check.core import Finding, Tree, call_name, rule

JIT_RULE = "jit-cache"
PURE_RULE = "traced-impure"

# directories whose code runs on (or builds programs and kernels for) the
# device
SCOPE_PREFIXES = ("tidb_tpu_torch/ops/", "tidb_tpu_torch/parallel/", "tidb_tpu_torch/native/")
SCOPE_FILES = ("tidb_tpu_torch/copr/gpu_engine.py",)

# the blessed program-cache funnels: (path suffix → enclosing function
# names allowed to make a compile-site call). Extend this mapping — and
# STATIC_ANALYSIS.md — when adding a new cached builder; the point is that
# adding an UNCACHED call site is loud.
CACHE_HELPERS = {
    "tidb_tpu_torch/ops/dag_kernel.py": {"get_kernel"},  # _build keyed by _COMPILE_CACHE
    "tidb_tpu_torch/ops/window_kernel.py": {"get_window_fn"},  # _build keyed by _CACHE
    # build_dist_pipeline keyed by _MPP_FN_CACHE
    "tidb_tpu_torch/parallel/gather.py": {"_execute_attempt"},
    # build_dist_join_agg: a thin wrapper over build_dist_pipeline, not a site
    "tidb_tpu_torch/parallel/mpp.py": {"build_dist_join_agg"},
    "tidb_tpu_torch/native/cuda.py": {"_start"},  # nvcc, kept by _LIBS and _build/
    # g++ for the row codec in _build, called once by lib() (_tried, _lib)
    "tidb_tpu_torch/native/__init__.py": {"_build", "lib"},
}

# the calls that build a device program a cache keeps (torch has no jit: a
# builder returns the program's closures, and each call builds anew)
_PROGRAM_BUILDERS = {"_build", "build_dist_pipeline"}
# the calls that start a compiler (nvcc, g++)
_JIT_NAMES = {
    "subprocess.Popen", "subprocess.run", "subprocess.call", "subprocess.check_call", "subprocess.check_output",
}


def _in_scope(path: str) -> bool:
    return path.startswith(SCOPE_PREFIXES) or path in SCOPE_FILES


def _is_jit_name(name: str) -> bool:
    return name in _JIT_NAMES or name.rsplit(".", 1)[-1] in _PROGRAM_BUILDERS


def _jit_decorator(dec: ast.expr):
    """The decorator spellings of a compile site: bare ``@jax.jit``,
    factory ``@jax.jit(...)``, and ``@partial(jax.jit, ...)``. Returns the
    matched dotted name or None."""
    if isinstance(dec, (ast.Name, ast.Attribute)):
        name = call_name(dec)
        return name if _is_jit_name(name) else None
    if isinstance(dec, ast.Call):
        fname = call_name(dec.func)
        if _is_jit_name(fname):
            return fname
        if fname.rsplit(".", 1)[-1] == "partial":
            for a in dec.args:
                aname = call_name(a)
                if _is_jit_name(aname):
                    return f"partial({aname})"
    return None


def _func_stack(tree: ast.Module):
    """Yield (call_node, [enclosing FunctionDef names]) for every Call and
    (funcdef, enclosing-chain) for every FunctionDef (decorator checks)."""
    calls = []
    defs = []

    def walk(node, chain):
        for child in ast.iter_child_nodes(node):
            nxt = chain
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.append((child, chain))
                nxt = chain + [child.name]
            elif isinstance(child, ast.Call):
                calls.append((child, chain))
            walk(child, nxt)

    walk(tree, [])
    return calls, defs


@rule(
    JIT_RULE,
    "program builds and compiler launches only inside recognized cache funnels",
    """
In ops/, parallel/, native/ and copr/gpu_engine.py every compile site must
sit inside one of the recognized cache funnels. The compile sites are the
calls that build a device program a cache keeps — dag_kernel._build (only
from get_kernel, keyed by _COMPILE_CACHE), window_kernel._build (only from
get_window_fn, keyed by _CACHE), mpp.build_dist_pipeline (only from
MPPGatherExec._execute_attempt under _MPP_FN_CACHE, and the
build_dist_join_agg wrapper) — and the calls that start a compiler: nvcc's
subprocess.Popen in native/cuda.py's _start (kept by _LIBS and _build/)
and g++ in native/__init__.py's _build (called once by lib()). A build
anywhere else rebuilds per call — the compile-bomb class, where one
uncached fragment shape walled tier-1 for 27+ minutes and every same-shape
query re-paid a full program build; a stray compiler launch re-pays
seconds of nvcc per call. Fix: route the program through an existing
cached builder, or build a new structurally-keyed cache and register its
funnel in rules_compile.CACHE_HELPERS (and STATIC_ANALYSIS.md) so the
funnel stays explicit.
""",
)
def check_jit(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        if not _in_scope(sf.path):
            continue
        allowed = set()
        for suffix, names in CACHE_HELPERS.items():
            if sf.path.endswith(suffix):
                allowed = names
                break
        calls, defs = _func_stack(sf.tree)
        for call, chain in calls:
            name = call_name(call.func)
            if _is_jit_name(name) and not (set(chain) & allowed):
                out.append(
                    Finding(
                        JIT_RULE,
                        sf.path,
                        call.lineno,
                        f"{name}(...) outside a recognized program-cache builder "
                        "— every compile must flow through a structurally-keyed "
                        "cache (see STATIC_ANALYSIS.md jit-cache)",
                        symbol=name,
                    )
                )
        # the decorator spellings compile too: @jax.jit / @partial(jax.jit)
        # on a def is a per-closure compile site exactly like the call form
        for fn, chain in defs:
            for dec in fn.decorator_list:
                if isinstance(dec, ast.Call) and _is_jit_name(call_name(dec.func)):
                    continue  # @jax.jit(...) factory form: the Call loop saw it
                name = _jit_decorator(dec)
                if name is not None and not (set(chain) & allowed):
                    out.append(
                        Finding(
                            JIT_RULE,
                            sf.path,
                            dec.lineno,
                            f"@{name} on {fn.name!r} outside a recognized "
                            "program-cache builder — decorator-jitted defs "
                            "compile per closure like the call form",
                            symbol=name,
                        )
                    )
    return out


_TIME_CALLS = {
    "time.time",
    "time.perf_counter",
    "time.monotonic",
    "time.time_ns",
    "time.perf_counter_ns",
}


def _traced_functions(tree: ast.Module):
    """FunctionDefs whose result a program cache keeps: the program
    builders (``_build``, ``build_dist_pipeline``), plus everything nested
    inside them — the closures the cached program runs."""
    traced = []

    def walk(node, inside):
        for child in ast.iter_child_nodes(node):
            nxt = inside
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nxt = inside or child.name in _PROGRAM_BUILDERS
                if nxt:
                    traced.append(child)
            walk(child, nxt)

    walk(tree, False)
    return traced


def _own_nodes(fn):
    """The nodes of ``fn``'s body outside the defs nested in it (each nested
    def is a traced function of its own, so a call is reported once, in the
    innermost function holding it)."""
    nested = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
    stack = [n for n in fn.body if not isinstance(n, nested)]
    while stack:
        node = stack.pop()
        yield node
        stack.extend(c for c in ast.iter_child_nodes(node) if not isinstance(c, nested))


@rule(
    PURE_RULE,
    "no wall-clock / RNG / set-iteration inside cached program builders",
    """
A program builder (dag_kernel._build, window_kernel._build,
mpp.build_dist_pipeline) runs ONCE per cache key; the closures it returns
are the cached program, and whatever the builder or a closure's captured
state read at build time is baked in for every later call, exactly as a
trace bakes it in. time.time() in a builder returns the timestamp of the
first build forever (why the first-call compile probe times around the kernel,
never in it); random.* bakes one draw; iterating a set makes program
STRUCTURE depend on hash order, so the same query can produce a different
program across processes — cache misses that look like nondeterministic
compile churn. Fix: hoist clocks/RNG to the host side and pass results as
operands; iterate sorted() or a tuple instead of a set.
""",
)
def check_pure(tree: Tree) -> list:
    out: list[Finding] = []
    for sf in tree.targets():
        # native/'s _build starts a compiler; it builds no device program
        if not _in_scope(sf.path) or "/native/" in sf.path:
            continue
        for fn in _traced_functions(sf.tree):
            for node in _own_nodes(fn):
                if isinstance(node, ast.Call):
                    name = call_name(node.func)
                    # stdlib random and numpy's global RNG bake one draw in
                    # at trace time; jax.random with an explicit key is the
                    # CORRECT trace-safe PRNG and must not be flagged
                    if name in _TIME_CALLS or name.split(".")[0] == "random" or (
                        name.startswith(("np.random.", "numpy.random."))
                    ):
                        out.append(
                            Finding(
                                PURE_RULE,
                                sf.path,
                                node.lineno,
                                f"{name}() inside traced function {fn.name!r} is "
                                "evaluated once at trace time — hoist to the host "
                                "and pass as an operand",
                                symbol=f"{fn.name}:{name}",
                            )
                        )
                elif isinstance(node, (ast.For, ast.comprehension)):
                    it = node.iter
                    if isinstance(it, ast.Set) or (
                        isinstance(it, ast.Call)
                        and isinstance(it.func, ast.Name)
                        and it.func.id in ("set", "frozenset")
                    ):
                        out.append(
                            Finding(
                                PURE_RULE,
                                sf.path,
                                getattr(node, "lineno", it.lineno),
                                f"set iteration inside traced function {fn.name!r}: "
                                "program structure depends on hash order — iterate "
                                "sorted() or a tuple",
                                symbol=f"{fn.name}:set-iter",
                            )
                        )
    return out
