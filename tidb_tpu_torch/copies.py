"""The host-side modules this package copies from the JAX package.

The SQL front (parser, planner, catalog, statistics, session, executors),
the MVCC store and the host engine hold no device code, so the port keeps
them as copies of the reference's text with the import prefix rewritten
(``tidb_tpu`` → ``tidb_tpu_torch`` on import lines, nothing else). The
port imports nothing of the reference; this module only reads its files.

``COPIES`` lists every copied file (paths under the package root).
``SEAMS`` names the copies the port changes and, for each, the top-level
units (functions, ``Class.method``, assigned names; ``<imports>`` and
``<doc>`` for the import block and the docstring) where the port's text
may differ from the rewritten reference. Everything else is byte-for-byte
the rewritten reference; ``tests/test_torch_copies.py`` holds both to that.

    python -m tidb_tpu_torch.copies          # rewrite every plain copy
    python -m tidb_tpu_torch.copies --check  # list the copies that drifted
"""

from __future__ import annotations

import ast
import re
import sys
from pathlib import Path

PORT_ROOT = Path(__file__).resolve().parent
REF_ROOT = PORT_ROOT.parent / "tidb_tpu"

COPIES = (
    # foundations
    "config.py",
    "utils/__init__.py",
    "utils/codec.py",
    "utils/collate.py",
    "utils/failpoint.py",
    "utils/eventlog.py",
    "utils/execdetails.py",
    "utils/metrics.py",
    "utils/tracing.py",
    "utils/backoff.py",
    "utils/memory.py",
    "utils/rowcontainer.py",
    "utils/stmtsummary.py",
    "utils/chunk.py",
    "utils/mysql_regex.py",  # REGEXP's host path (expression/eval.py)
    "types/__init__.py",
    "types/datum.py",
    "types/field_type.py",
    "kv/__init__.py",
    "kv/kv.py",
    "kv/tablecodec.py",
    "kv/rowcodec.py",
    "kv/memstore.py",
    "kv/txn.py",
    "kv/detector.py",
    "kv/election.py",
    "kv/owner.py",
    "kv/placement.py",
    "kv/gcworker.py",
    "native/src/rowcodec.cc",
    "native/__init__.py",
    "native/bulk.py",
    "extension/__init__.py",
    # SQL
    "parser/__init__.py",
    "parser/lexer.py",
    "parser/ast.py",
    "parser/parser.py",
    "catalog/__init__.py",
    "catalog/catalog.py",
    "catalog/schema.py",
    "statistics/__init__.py",
    "statistics/stats.py",
    "statistics/histogram.py",
    "statistics/sketch.py",
    "statistics/builder.py",
    "statistics/selectivity.py",
    "expression/__init__.py",
    "expression/registry.py",
    "expression/expr.py",
    "expression/eval.py",
    "planner/__init__.py",
    "planner/plans.py",
    "planner/builder.py",
    "planner/optimizer.py",
    "planner/ranger.py",
    "planner/pointget.py",
    "planner/cte.py",
    "planner/instcache.py",
    "resourcegroup/__init__.py",
    "resourcegroup/groups.py",
    # execution
    "executor/__init__.py",
    "executor/executors.py",
    "executor/write.py",
    "executor/load.py",
    "copr/__init__.py",
    "copr/dagpb.py",
    "copr/binder.py",
    "copr/colcache.py",
    "copr/client.py",
    "copr/host_engine.py",
    # session
    "session/__init__.py",
    "session/session.py",
    # MPP: the planner rewrite and the coordinator (the fragment program,
    # parallel/mpp.py, and the mesh, parallel/mesh.py, are the port's own)
    "parallel/gather.py",
    "parallel/probe.py",
    "parallel/mpptask.py",
)

SEAMS: dict[str, frozenset] = {
    # the engine name: StoreType.GPU in place of TPU
    "kv/kv.py": frozenset({"StoreType"}),
    "session/session.py": frozenset({"DEFAULT_SYSVARS", "Session._plan_select", "open_db"}),
    # window pushdown gated on StoreType.GPU
    "planner/optimizer.py": frozenset({"_demote_ci_order", "_pick_engine", "_try_push_window"}),
    # eval_expr hands a torch caller's bodies expression/arrays.py
    "expression/expr.py": frozenset({"can_push_down", "eval_expr"}),
    # every builtin legal on tpu is legal on gpu, as declared per builtin
    "expression/registry.py": frozenset({"ALL_ENGINES"}),
    "copr/binder.py": frozenset({"Binder.bind_expr"}),
    # the bodies that call the helpers of expression/arrays.py (the port's
    # own module, the device's array namespace: casts, float64 widening,
    # correctly rounded division, saturating float→int, logical shift,
    # popcount) where the reference's body relies on numpy or jax.numpy
    # semantics torch lacks
    "expression/eval.py": frozenset(
        {
            "<imports>",
            "_acos", "_and", "_asin", "_atan", "_atan2", "_bit_count", "_bitand", "_bitneg",
            "_bitor", "_bitxor", "_cast_decimal", "_cast_float", "_cast_int", "_ceil", "_civil_from_days",
            "_cmp", "_coerce_pair", "_cos", "_cot", "_days_from_civil", "_degrees",
            "_div", "_exp", "_floor", "_fold_extreme", "_in", "_intdiv", "_isnull", "_log_impl", "_not",
            "_nulleq", "_or", "_pow", "_radians", "_round", "_shift", "_sign", "_sin", "_sqrt", "_tan",
            "_truncate", "_tsdiff_months", "_xor",
        }
    ),
    # the engine registry; no device failure degrades to the host
    "copr/client.py": frozenset({"CopClient.send", "_engines", "run_task_resilient"}),
    # a store-less cache for carried regions, and the GPU engine's LRUs
    "copr/colcache.py": frozenset(
        {"ColumnCache", "ColumnCache.__init__", "ColumnCache.add_region", "ColumnCache.ensure_sorted_dict", "ColumnCache.next_region_id"}
    ),
    # the root window runs on the store's card through the port's window
    # program
    "executor/executors.py": frozenset({"WindowExec._try_device"}),
    # the engine name gpu in the device admission checks; the store's
    # device for the HBM budget and the mesh; the fragment program's lanes
    # are torch tensors on that device, copied off it once
    "parallel/gather.py": frozenset(
        {
            "_agg_mpp_ok", "_chain_cond_ok", "_reader_mpp_ok", "_stage_eligible", "try_mpp_rewrite",
            "MPPGatherExec.execute", "MPPGatherExec._execute_attempt",
        }
    ),
    # a tiny op and a synchronize on each device
    "parallel/probe.py": frozenset({"probe_and_blacklist"}),
    # the row codec builds into the package's _build/
    "native/__init__.py": frozenset({"_OUT_DIR"}),
}

_IMPORT_LINE = re.compile(r"^(\s*)(from|import)(\s+)tidb_tpu(?=[.\s])", re.M)


def rewrite(text: str) -> str:
    """The reference's text with its imports of the JAX package pointed at
    this package."""
    return _IMPORT_LINE.sub(r"\1\2\3tidb_tpu_torch", text)


def reference_text(rel: str) -> str:
    return rewrite((REF_ROOT / rel).read_text())


def port_text(rel: str) -> str:
    return (PORT_ROOT / rel).read_text()


def _units_of(body, prefix: str, src: str, out: dict) -> None:
    for i, node in enumerate(body):
        seg = _segment(src, node)
        if i == 0 and isinstance(node, ast.Expr) and isinstance(getattr(node, "value", None), ast.Constant) and isinstance(node.value.value, str):
            name = "<doc>"
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            name = "<imports>"
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            name = node.name
        elif isinstance(node, ast.ClassDef):
            name = node.name
            methods = [m for m in node.body if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))]
            _units_of(methods, prefix + name + ".", src, out)
            # the class's own unit: its text with the methods (and blank
            # lines) cut out
            for m in methods:
                seg = seg.replace(_segment(src, m), "", 1)
            seg = "".join(ln for ln in seg.splitlines(keepends=True) if ln.strip())
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            name = ",".join(ast.unparse(t) for t in targets)
        else:
            name = f"<stmt {seg.splitlines()[0].strip() if seg else i}>"
        key = prefix + name
        out[key] = out.get(key, "") + seg + "\n"


def _segment(src: str, node) -> str:
    """The node's whole lines, decorators included."""
    lines = src.splitlines(keepends=True)
    start = node.decorator_list[0].lineno if getattr(node, "decorator_list", None) else node.lineno
    return "".join(lines[start - 1 : node.end_lineno])


def units(src: str) -> dict[str, str]:
    """Top-level units of a module's source → their text."""
    out: dict[str, str] = {}
    _units_of(ast.parse(src).body, "", src, out)
    return out


def drift(rel: str) -> list[str]:
    """Units of ``rel`` whose text differs from the rewritten reference
    (present in one only, or different), outside what ``SEAMS`` allows.
    A non-Python copy is compared whole."""
    ref, port = reference_text(rel), port_text(rel)
    if rel not in SEAMS:
        return [] if ref == port else ["<whole file>"]
    if not rel.endswith(".py"):
        return ["<whole file>"]
    allowed = SEAMS[rel]
    ru, pu = units(ref), units(port)
    return sorted(k for k in set(ru) | set(pu) if ru.get(k) != pu.get(k) and k not in allowed)


def seam_units(rel: str) -> list[str]:
    """The units of a seam module that do differ from the reference."""
    ru, pu = units(reference_text(rel)), units(port_text(rel))
    return sorted(k for k in set(ru) | set(pu) if ru.get(k) != pu.get(k))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--check" in argv:
        bad = {rel: d for rel in COPIES if (d := drift(rel))}
        for rel, d in bad.items():
            print(f"{rel}: {', '.join(d)}")
        return 1 if bad else 0
    for rel in COPIES:
        if rel in SEAMS:
            continue
        dst = PORT_ROOT / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(reference_text(rel))
    return 0


if __name__ == "__main__":
    sys.exit(main())
