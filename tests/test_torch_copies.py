"""The drift guard: the host-side modules the port copies from the reference
(``tidb_tpu_torch.copies.COPIES``) stay the reference's text with the import
prefix rewritten, byte for byte, except the seam modules, whose differences
stay inside the units ``SEAMS`` names (and every named unit does differ)."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidb_tpu_torch import copies  # noqa: E402

PLAIN = [rel for rel in copies.COPIES if rel not in copies.SEAMS]


@pytest.mark.parametrize("rel", PLAIN)
def test_copy_equals_rewritten_reference(rel):
    assert copies.port_text(rel) == copies.reference_text(rel)


@pytest.mark.parametrize("rel", sorted(copies.SEAMS))
def test_seam_differs_only_where_declared(rel):
    assert rel in copies.COPIES
    assert copies.drift(rel) == []
    assert copies.seam_units(rel) == sorted(copies.SEAMS[rel])


def test_rewrite_touches_import_lines_only():
    src = (
        "import tidb_tpu\n"
        "from tidb_tpu.kv import kv\n"
        "    from tidb_tpu import config as c\n"
        "import tidb_tpu_helpers\n"
        '"tidb_tpu_copr_task_total"\n'
        "# see tidb_tpu.copr.client\n"
    )
    assert copies.rewrite(src) == (
        "import tidb_tpu_torch\n"
        "from tidb_tpu_torch.kv import kv\n"
        "    from tidb_tpu_torch import config as c\n"
        "import tidb_tpu_helpers\n"
        '"tidb_tpu_copr_task_total"\n'
        "# see tidb_tpu.copr.client\n"
    )


def test_units_split_methods_from_their_class():
    src = 'class A:\n    """doc"""\n\n    x = 1\n\n    def f(self):\n        return 1\n\n\ndef g():\n    pass\n'
    u = copies.units(src)
    assert set(u) == {"A", "A.f", "g"}
    assert "def f" not in u["A"] and "return 1" in u["A.f"]


# partitioned tables, online DDL, TTL, the logical dump and graftfuzz
SLICE_10 = (
    "planner/partition.py", "statistics/globalstats.py", "tools/__init__.py", "tools/dumpling.py",
    "catalog/ddl.py", "utils/timer.py", "ttl/__init__.py", "ttl/worker.py", "tools/fuzz/__init__.py",
    "tools/fuzz/gen.py", "tools/fuzz/oracles.py", "tools/fuzz/shrink.py", "tools/fuzz/harness.py",
    "tools/fuzz/runner.py", "tools/fuzz/__main__.py",
)


@pytest.mark.parametrize("rel", SLICE_10)
def test_slice_module_is_a_registered_copy(rel):
    assert rel in copies.COPIES
    assert copies.drift(rel) == []
    # only the fuzzer's runner and CLI are seams
    assert (rel in copies.SEAMS) == (rel in ("tools/fuzz/runner.py", "tools/fuzz/__main__.py"))


# getting data in and out: LOAD DATA / IMPORT INTO over disttask, BACKUP /
# RESTORE, PITR, the plan replayer, the inspection rules and the diag bundle
SLICE_11 = (
    "tools/storage.py", "disttask/framework.py", "disttask/__init__.py", "tools/importer.py", "tools/brie.py",
    "tools/pitr.py", "tools/replayer.py", "utils/inspection.py", "tools/diag.py",
)


@pytest.mark.parametrize("rel", SLICE_11)
def test_slice_11_module_is_a_registered_copy(rel):
    assert rel in copies.COPIES
    assert copies.drift(rel) == []
    # only the inspection rules are a seam: the hbm-pressure rule's budget
    assert (rel in copies.SEAMS) == (rel == "utils/inspection.py")


def test_the_inspection_seam_is_the_budget_alone():
    assert copies.seam_units("utils/inspection.py") == ["InspectionContext.from_db", "_hbm_pressure"]
    port = copies.units(copies.port_text("utils/inspection.py"))
    assert "planning_budget" in port["InspectionContext.from_db"]
    assert "TIDB_TPU_HBM_GB" not in copies.port_text("utils/inspection.py")


# the last reference modules: the runtime lock-order detector, graftcheck and
# the bench harnesses
SLICE_12 = (
    "utils/lockcheck.py", "tools/check/__init__.py", "tools/check/core.py", "tools/check/rules_compile.py",
    "tools/check/rules_dead.py", "tools/check/rules_hygiene.py", "tools/check/rules_locks.py",
    "tools/check/rules_pyopt.py", "tools/check/rules_robust.py", "tools/check/rules_wire.py",
    "tools/check/__main__.py", "bench/__init__.py", "bench/qps.py", "bench/benchdb.py", "bench/benchdaily.py",
)
SLICE_12_PLAIN = (
    "tools/check/rules_dead.py", "tools/check/rules_locks.py", "tools/check/rules_pyopt.py",
    "tools/check/rules_robust.py", "tools/check/rules_wire.py", "bench/__init__.py", "bench/qps.py",
)


@pytest.mark.parametrize("rel", SLICE_12)
def test_slice_12_module_is_a_registered_copy(rel):
    assert rel in copies.COPIES
    assert copies.drift(rel) == []
    assert (rel in copies.SEAMS) == (rel not in SLICE_12_PLAIN)


def test_every_reference_module_has_a_counterpart():
    """Every ``.py`` of the reference has one in the port, but the device
    engine and the Pallas kernel, whose counterparts are the port's own
    (``copr/gpu_engine.py``, ``ops/grouped_sums.py`` and ``csrc/``)."""

    def py_files(root):
        return {str(p.relative_to(root)) for p in root.rglob("*.py") if "__pycache__" not in p.parts}

    missing = py_files(copies.REF_ROOT) - py_files(copies.PORT_ROOT)
    assert missing == {"copr/tpu_engine.py", "ops/pallas_groupby.py"}


def test_the_lockcheck_seam_binds_raw_locks_and_restores_what_it_replaced():
    port = copies.units(copies.port_text("utils/lockcheck.py"))
    assert "_thread.allocate_lock" in port["_ORIG_LOCK"] and "_thread.RLock" in port["_ORIG_RLOCK"]
    assert "_REPLACED" in port["install"] and "_REPLACED" in port["uninstall"]
    assert "_ORIG_LOCK" not in port["uninstall"]


def test_the_benchdaily_seam_reaches_no_reference_name():
    text = copies.port_text("bench/benchdaily.py")
    for name in ("tidb_tpu.open(", "tpu_engine", "'tpu'", "jax"):
        assert name not in text
    assert text.count("device=DEVICE") == 16


# the device modules: the reference's file → the port's counterpart
DEVICE_PAIRS = {
    "copr/tpu_engine.py": "copr/gpu_engine.py",
    **{f"ops/{m}.py": f"ops/{m}.py" for m in ("dag_kernel", "mxu_groupby", "window_core", "window_kernel")},
    **{f"parallel/{m}.py": f"parallel/{m}.py" for m in ("mpp", "gather", "mesh", "mpptask", "probe")},
    **{f"copr/{m}.py": f"copr/{m}.py" for m in ("colcache", "binder", "client")},
}
# reference top-level functions and classes with no namesake in the port,
# each with the reason
NOT_CARRIED = {
    "copr/tpu_engine.py": {
        "AggFromPb": "an alias of AggDesc.from_pb, which gpu_engine calls by that name",
        "_block_device_inputs": "folded into _device_inputs (unit = the block index)",
        "_single_device_inputs": 'folded into _device_inputs (unit "s")',
        "_device_ranges": "the eager program reads the padded range array on the host (_range_mask): no device copy",
        "_device_nvalid": "the live-row count reaches the eager program as a Python int: no device scalar",
        "_delta_counts": "the delta's (mask_n, union_lo, union_hi) reach the program as a host tuple (_delta_args)",
        "_misc_cached": "the cache of _device_ranges, _device_nvalid and _delta_counts, none of them carried",
    },
    "ops/dag_kernel.py": {
        "_ensure_x64": "JAX only: torch's int64 needs no switch, and an eager program has no compile cache on disk",
    },
    "ops/window_kernel.py": {
        "is_compiled": "eager torch compiles nothing, so the compile gate is left out (window_kernel.py's docstring)",
    },
}


def _top_level(root, rel):
    import ast

    tree = ast.parse((root / rel).read_text(encoding="utf-8"))
    return {n.name for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("ref_rel", sorted(DEVICE_PAIRS))
def test_every_reference_function_has_a_counterpart_or_a_reason(ref_rel):
    """Function by function: each top-level function and class of a device
    module of the reference has a namesake in its counterpart, or stands in
    ``NOT_CARRIED`` with a reason — and nothing stands there that the port
    carries after all."""
    missing = _top_level(copies.REF_ROOT, ref_rel) - _top_level(copies.PORT_ROOT, DEVICE_PAIRS[ref_rel])
    declared = NOT_CARRIED.get(ref_rel, {})
    assert missing == set(declared)
    assert all(reason.strip() for reason in declared.values())
