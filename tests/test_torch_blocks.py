"""Regions of several device blocks in the PyTorch port
(tidb_tpu_torch.copr.gpu_engine) against the reference's device engine.

The 6,000-row lineitem of tests/test_torch_engine.py stays one region;
``_BLOCK`` (and ``_FUSE_MAX_NB``) shrink equally in both engines so the CPU
reaches every block path: per-block stacked programs (12 blocks of 512),
fused programs over 6 and over 2 blocks, K1 per block (6 blocks of 1024 with
fusion capped at 4), the blockwise int8 dot, paged LIMIT and LIMIT 0.
Partial results must equal ``tpu_engine`` row for row — blocks come back in
handle order — and, merged, the host engine.
"""

import copy
import dataclasses
import json

import jax
import jax.experimental
import numpy as np
import pytest
import test_torch_engine as te

from tidb_tpu.copr import dagpb as ref_dagpb
from tidb_tpu.copr import host_engine, tpu_engine
from tidb_tpu_torch.copr import carry, gpu_engine
from tidb_tpu_torch.copr.binder import UnsupportedForDevice
from tidb_tpu_torch.expression.expr import AggDesc
from tidb_tpu_torch.ops import dag_kernel

EXTRA = {
    "limit": "SELECT l_extendedprice, l_shipmode FROM lineitem WHERE l_discount >= 0.01 LIMIT 5",
    # (7+1)(4+1) = 40 buckets: the reference's blockwise int8 dot on 2..8 blocks
    "dot40": """SELECT l_shipmode, l_shipinstruct, COUNT(*), SUM(l_quantity), SUM(l_tax)
  FROM lineitem GROUP BY l_shipmode, l_shipinstruct""",
}
NAMES = list(te.QUERIES) + ["rows", "limit", "limit0", "dot40", "project"]

# (rows per block, most blocks fused, {DAG: engine path})
LAYOUTS = {
    "stacked12": (512, 8, {}),
    "fused6": (1024, 8, {"dot40": "blockwise dot"}),
    "fused2": (4096, 8, {"dot40": "blockwise dot"}),
    "k1_per_block6": (1024, 4, {}),
}
_AGG = set(te.QUERIES) - {"q10"} | {"dot40"}


def _path(layout: str, name: str) -> str:
    block, fuse_max, special = LAYOUTS[layout]
    if name in special:
        return special[name]
    if name.startswith("limit"):
        return "paged limit"
    nb = -(-6000 // block)
    return "fused" if name in _AGG and nb <= fuse_max else "per-block stacked"


@pytest.fixture(scope="module")
def setup():
    db = te._lineitem_db()
    caps = te._capture(db)
    caps.update(te._capture(db, EXTRA))
    dag, region, ranges, ts = caps["limit"]
    dag0 = copy.deepcopy(dag)
    dag0.executors[-1].limit = 0
    caps["limit0"] = (dag0, region, ranges, ts)
    # scan → selection → projection (price * price, the ship mode)
    dag, region, ranges, ts = caps["rows"]
    pb = dag.to_pb()
    scan_cols = pb["executors"][0]["columns"]
    at = {c["id"]: i for i, c in enumerate(scan_cols)}
    col = lambda slot: {"tp": "col", "idx": at[slot], "ft": scan_cols[at[slot]]["ft"]}  # noqa: E731
    pb["executors"].append({
        "tp": "projection",
        "exprs": [{"tp": "func", "sig": "mul", "children": [col(1), col(1)], "ft": [3, 25, 4, 1, "bin", 0]}, col(7)],
    })
    pb["output_offsets"] = []
    caps["project"] = (type(dag).from_pb(pb), region, ranges, ts)
    return db, caps, te._carry_region(db, caps["count"][0], region, ts)


@pytest.fixture(autouse=True)
def _reference_pallas(monkeypatch):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _blocks(monkeypatch, block: int, fuse_max: int = 8):
    for mod in (tpu_engine, gpu_engine):
        monkeypatch.setattr(mod, "_BLOCK", block)
        monkeypatch.setattr(mod, "_FUSE_MAX_NB", fuse_max)


def _reference(db, dag, region, ranges, ts):
    # the device path itself: tpu_engine.execute_dag would answer an
    # unsupported shape on the host instead
    return tpu_engine._execute_dag_device(db.store, dag, region, ranges, ts).rows()


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", NAMES)
def test_blocked_region_matches_reference(setup, monkeypatch, layout, name):
    db, caps, reg = setup
    block, fuse_max, _ = LAYOUTS[layout]
    _blocks(monkeypatch, block, fuse_max)
    dag, region, ranges, ts = caps[name]
    ref = _reference(db, dag, region, ranges, ts)
    calls = te._spy(monkeypatch)
    stats = {}
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu", stats=stats)
    assert got.rows() == ref
    assert stats["path"] == _path(layout, name)
    if name == "band":
        # K1 needs n % 1024 == 0: one launch over the fused blocks, one per
        # 1024-row block, none on 512-row blocks (they sort instead)
        want_k1 = {"stacked12": 0, "fused6": 1, "fused2": 1, "k1_per_block6": 6}[layout]
        assert calls["k1"] == want_k1
        assert stats["routes"] == (("k1",) if want_k1 else ("lex",))
    if name in ("q18sub", "q15rev", "extremes"):
        assert stats["routes"] == ("lex",)
    if name in ("limit", "limit0", "q10"):
        host = host_engine.execute_dag(db.store, dag, region, ranges, ts).rows()
        if name == "q10":
            # per-block candidates: the root re-sorts and cuts
            host_top = sorted(host, key=lambda r: -r[0])
            assert sorted(got.rows(), key=lambda r: -r[0])[:20] == host_top
        else:
            assert got.rows() == host
    if name not in ("limit", "limit0", "q10"):
        host = host_engine.execute_dag(db.store, dag, region, ranges, ts).rows()
        assert _merged(got.rows(), dag) == _merged(host, dag)


def _merged(rows, dag):
    """Partial rows merged per group key the way the root does (COUNT/SUM
    add, MIN/MAX keep the extreme, the bit aggregates fold); rows-kind
    output as a sorted list."""
    last = dag.executors[-1]
    if last.tp != "aggregation":
        return sorted(rows, key=repr)
    n_keys = len(last.group_by)
    ops = [k for a in last.aggs for k in AggDesc.from_pb(a).partial_kinds]
    fold = {
        "count": lambda a, b: a + b,
        "sum": lambda a, b: a + b,
        "min": min,
        "max": max,
        "bit_and": lambda a, b: a & b,
        "bit_or": lambda a, b: a | b,
        "bit_xor": lambda a, b: a ^ b,
    }
    acc = {}
    for r in rows:
        key, vals = r[len(r) - n_keys :], r[: len(r) - n_keys]
        cur = acc.setdefault(key, [None] * len(vals))
        for i, (op, v) in enumerate(zip(ops, vals)):
            if v is not None:
                cur[i] = v if cur[i] is None else fold[op](cur[i], v)
    return {k: tuple(v) for k, v in acc.items()}


def test_paged_limit_stops_early(setup, monkeypatch):
    """An unselective LIMIT 5 over 12 blocks reads the first block only."""
    db, caps, reg = setup
    _blocks(monkeypatch, 512)
    seen = []
    real = gpu_engine._device_inputs

    def counting(region, scan, unit, *args):
        seen.append(unit)
        return real(region, scan, unit, *args)

    monkeypatch.setattr(gpu_engine, "_device_inputs", counting)
    dag, _region, ranges, _ts = caps["limit"]
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu")
    assert len(got) == 5 and seen == [0]


def test_blockwise_dot_with_the_size_gate_lowered(setup, monkeypatch):
    """Q1 (B = 12) takes the blockwise int8 dot once the reference's 2^21-row
    gate is lowered for this small region; the result equals the reference's
    fused program (equality-mask buckets, the same bucket order) row for
    row and the host engine as a set."""
    db, caps, reg = setup
    _blocks(monkeypatch, 1024)
    dag, region, ranges, ts = caps["q1"]
    ref = _reference(db, dag, region, ranges, ts)
    host = host_engine.execute_dag(db.store, dag, region, ranges, ts).rows()
    monkeypatch.setattr(dag_kernel, "_MXU_MIN_ROWS", 1024)
    monkeypatch.setattr(dag_kernel, "_COMPILE_CACHE", {})
    stats = {}
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu", stats=stats)
    assert stats["path"] == "blockwise dot" and stats["routes"] == ("dot",)
    assert got.rows() == ref
    assert sorted(got.rows(), key=repr) == sorted(host, key=repr)


def test_device_lru_stays_under_budget(setup, monkeypatch):
    db, caps, reg = setup
    _blocks(monkeypatch, 512)
    small = gpu_engine._DeviceLRU(200_000)
    monkeypatch.setitem(reg.cache.device_lrus, "cpu", small)
    for name in ("band", "q10"):
        dag, region, ranges, ts = caps[name]
        ref = _reference(db, dag, region, ranges, ts)
        assert gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu").rows() == ref
    assert 0 < small.total <= 200_000 * 2  # at most one over-budget resident entry


def test_lru_evicts_superseded_versions():
    lru = gpu_engine._DeviceLRU(1 << 30)
    lru.put((2, 3, 4, 0, 10, 0, 64), ("a",), 100)
    lru.put((2, 3, 4, 1, 10, 0, 64), ("a1",), 100)
    lru.put((2, 3, 4, 0, 11, 0, 64), ("b",), 100)
    lru.evict_superseded((2, 3, 4, 0), (11, 0))
    assert lru.get((2, 3, 4, 0, 10, 0, 64)) is None
    assert lru.get((2, 3, 4, 0, 11, 0, 64)) == ("b",)
    # a sibling block keeps its own (version, epoch) until its own put
    assert lru.get((2, 3, 4, 1, 10, 0, 64)) == ("a1",)
    assert lru.total == 200


def _unsupported(caps, name, edit):
    dag, _region, ranges, _ts = caps[name]
    pb = json.loads(json.dumps(dag.to_pb()))
    ranges = te._port_ranges(ranges)
    ranges = edit(pb) or ranges
    return carry.dag_from_pb(pb), ranges


def _complete(pb):
    pb["executors"][-1]["agg_mode"] = "complete"


def _rollup(pb):
    pb["executors"][-1]["rollup"] = True


def _desc(pb):
    pb["executors"][0]["desc"] = True


def _many_ranges(pb):
    from tidb_tpu_torch.kv import tablecodec

    tid = pb["executors"][0]["table_id"]
    return [tablecodec.handle_range(tid, 10 * i, 10 * i + 5) for i in range(dag_kernel.MAX_RANGES + 1)]


@pytest.mark.parametrize(
    "name,edit",
    [("q1", _complete), ("band", _rollup), ("rows", _desc), ("count", _many_ranges)],
    ids=["complete", "rollup", "desc", "too_many_ranges"],
)
def test_unported_shapes_raise_on_a_blocked_region(setup, monkeypatch, name, edit):
    """Shapes the device path refuses raise on a blocked region. Complete
    mode, once among them, is ported: Q1 in complete mode (the fused
    blockwise dot, finalized on the device) equals the reference's device
    path."""
    db, caps, reg = setup
    _blocks(monkeypatch, 1024)
    dag, ranges = _unsupported(caps, name, edit)
    if edit is _complete:
        _d, region, ref_ranges, ts = caps[name]
        ref_dag = ref_dagpb.DAGRequest.from_pb(json.loads(json.dumps(dag.to_pb())))
        want = _reference(db, ref_dag, region, ref_ranges, ts)
        assert gpu_engine.execute_region(reg, dag, ranges, device="cpu").rows() == want
        return
    with pytest.raises(UnsupportedForDevice):
        gpu_engine.execute_region(reg, dag, ranges, device="cpu")


WINDOW_SQL = """SELECT l_returnflag, l_quantity,
    ROW_NUMBER() OVER (PARTITION BY l_returnflag ORDER BY l_extendedprice),
    SUM(l_quantity) OVER (PARTITION BY l_returnflag ORDER BY l_extendedprice)
  FROM lineitem WHERE l_discount >= 0.02"""


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_window_runs_as_one_program_on_a_blocked_region(setup, monkeypatch, layout):
    """A partition's rows must share one computation: a window DAG runs as
    one program over every block, whatever the fusion cap, and equals the
    reference's fused window program row for row."""
    db, _caps, reg = setup
    _blocks(monkeypatch, *LAYOUTS[layout][:2])
    dag, region, ranges, ts = te._capture(db, {"win": WINDOW_SQL})["win"]
    assert any(ex.tp == "window" for ex in dag.executors)
    ref = _reference(db, dag, region, ranges, ts)
    stats = {}
    got = gpu_engine.execute_region(reg, te._port_dag(dag), te._port_ranges(ranges), device="cpu", stats=stats)
    assert got.rows() == ref
    assert stats["path"] == "fused"


def test_delta_operand_raises(setup, monkeypatch):
    """A delta past the operand's fixed capacity is the column cache's to
    merge (``get_split`` folds it into the base); handed to the engine
    directly, it raises rather than run a program it would overflow."""
    db, caps, reg = setup
    from tidb_tpu_torch import config as port_config
    from tidb_tpu_torch.copr.colcache import DeltaOverlay

    monkeypatch.setattr(port_config, "_CURRENT", port_config.Config(device_delta_cap=2))
    h = reg.entry.handles
    delta = DeltaOverlay(handles=h[:3].copy(), tomb=np.ones(3, bool), data_version=1, built_ts=1)
    with pytest.raises(ValueError, match="capacity"):
        gpu_engine.execute_region(
            dataclasses.replace(reg, delta=delta), te._port_dag(caps["count"][0]), te._port_ranges(caps["count"][2]),
            device="cpu",
        )
