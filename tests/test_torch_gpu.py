"""The port on a CUDA card: K1 against its plain version and the engine's
card path against its CPU path. Every test is marked ``gpu`` and skips
without a card. The file imports neither jax nor tidb_tpu, so on a machine
with a card and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from tidb_tpu_torch.copr import carry, gpu_engine  # noqa: E402
from tidb_tpu_torch.ops import grouped_sums as gs  # noqa: E402

DAGS = os.path.join(REPO, "tidb_tpu_torch", "bench", "dags")


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.gpu
@pytest.mark.parametrize("B,n_pad,L", [(65, 1024, 3), (160, 1 << 20, 4), (512, 8192, 3), (160, 8192, 20)])
def test_k1_kernel_matches_plain_on_card(B, n_pad, L):
    _need_card()
    seg, pairs = chip_smoke._k1_synthetic(n_pad, B, L, seed=B + n_pad + L)
    before = gs.LAUNCHES
    c, s = gs.grouped_sums(seg, pairs, B, n_pad, device="cuda")
    torch.cuda.synchronize()
    assert gs.LAUNCHES == before + -(-L // 32)  # up to 32 lanes per launch
    pc, ps = gs.grouped_sums_plain(seg, pairs, B, n_pad)
    assert torch.equal(c, pc) and torch.equal(s, ps)


@pytest.mark.gpu
@pytest.mark.parametrize(
    "n_pad,B,hot,extra",
    [(7_999_488, 160, True, 0), (131_072, 65, True, 0), (1 << 20, 65, False, 12), (1 << 20, 512, True, 12)],
)
def test_k1_adversarial_lanes_on_card(n_pad, B, hot, extra):
    """Every live row in one bucket at ±(2^45 - 1) up to the largest n_pad,
    int32 lanes at ±(2^31 - 1), constant lanes, lanes sharing one weight
    tensor, L = 20; through the port's build and the stress build (one
    table copy, the fewest blocks: up to 65,536 rows per 32-bit cell)."""
    _need_card()
    from tidb_tpu_torch.native import cuda as native

    seg, pairs, bounds = chip_smoke._k1_adversarial(n_pad, B, seed=n_pad + B, hot=hot, extra=extra)
    want = gs.grouped_sums_plain(seg, pairs, B, n_pad, bounds)
    before = gs.LAUNCHES
    got = gs.grouped_sums(seg, pairs, B, n_pad, bounds, device="cuda")
    assert gs.LAUNCHES == before + -(-len(pairs) // 32)
    stressed = gs.launch(gs.entry(native.load("grouped_sums", chip_smoke.STRESS_DEFINES)), seg, pairs, B, n_pad, bounds)
    torch.cuda.synchronize()
    for c, s in (got, stressed):
        assert torch.equal(c, want[0]) and torch.equal(s, want[1])


@pytest.mark.gpu
def test_dot_route_at_the_chunk_edge_on_card():
    """grouped_sums_dot past its real 2^23-row int32 chunk (a ragged second
    chunk) equals the plain grouped sum."""
    _need_card()
    from tidb_tpu_torch.ops.mxu_groupby import grouped_sums_dot

    n, B = (1 << 23) + (1 << 20), 64
    g = torch.Generator(device="cuda").manual_seed(7)
    seg = torch.randint(0, B + 3, (n,), generator=g, device="cuda", dtype=torch.int32)
    mask = torch.rand(n, generator=g, device="cuda") < 0.9
    big = torch.randint(-(1 << 40), 1 << 40, (n,), generator=g, device="cuda", dtype=torch.int64)
    small = torch.randint(0, 256, (n,), generator=g, device="cuda", dtype=torch.int32)
    pairs = [(torch.zeros(n, dtype=torch.int64, device="cuda"), mask), (big, mask), (small, mask)]
    bounds = [(0, 0), (-(1 << 40), 1 << 40), (0, 255)]
    got = grouped_sums_dot(seg, pairs, B, n, bounds)
    want = gs.grouped_sums_plain(seg, pairs, B, n, bounds)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.gpu
@pytest.mark.parametrize("name", chip_smoke.DAG_NAMES)
def test_engine_on_card_matches_cpu_path(name):
    _need_card()
    with open(os.path.join(DAGS, f"{name}.json")) as f:
        dag = carry.dag_from_pb(json.load(f))
    cols = chip_smoke.lineitem_sf1(seed=3, n=50_000)
    regions = chip_smoke.make_regions(cols, dag.executors[0].table_id)
    for region, ranges in regions:
        cpu = gpu_engine.execute_region(region, dag, ranges, device="cpu").rows()
        gpu = gpu_engine.execute_region(region, dag, ranges, device="cuda").rows()
        assert gpu == cpu


@pytest.mark.gpu
def test_rows_path_on_card_matches_cpu_path():
    """scan → selection (rows-kind output past 65,536 padded rows)."""
    _need_card()
    with open(os.path.join(DAGS, "q6.json")) as f:
        pb = json.load(f)
    pb["executors"] = pb["executors"][:2]
    dag = carry.dag_from_pb(pb)
    cols = chip_smoke.lineitem_sf1(seed=4, n=140_000)
    for region, ranges in chip_smoke.make_regions(cols, dag.executors[0].table_id):
        cpu = gpu_engine.execute_region(region, dag, ranges, device="cpu").rows()
        gpu = gpu_engine.execute_region(region, dag, ranges, device="cuda").rows()
        assert gpu == cpu and len(gpu) > 0


def _limit_dag():
    """scan → selection → LIMIT 5: the rows query of Q6's predicate."""
    with open(os.path.join(DAGS, "q6.json")) as f:
        pb = json.load(f)
    pb["executors"] = pb["executors"][:2] + [{"tp": "limit", "limit": 5}]
    return carry.dag_from_pb(pb)


@pytest.mark.gpu
@pytest.mark.parametrize("block,fuse_max", [(8192, 8), (4096, 8), (4096, 20)])
@pytest.mark.parametrize("name", chip_smoke.DAG_NAMES + ("limit",))
def test_blocked_region_on_card_matches_cpu_path(monkeypatch, name, block, fuse_max):
    """One 50,000-row region in blocks of 8,192 (7 blocks: aggregations
    fuse, Q1 never reaches the blockwise dot at this size) or 4,096 (13
    blocks: per-block programs, K1 per block for the band query, paged
    LIMIT; or all 13 fused): the card's Chunk equals the CPU path's, and
    the lex route runs on the card."""
    _need_card()
    monkeypatch.setattr(gpu_engine, "_BLOCK", block)
    monkeypatch.setattr(gpu_engine, "_FUSE_MAX_NB", fuse_max)
    if name == "limit":
        dag = _limit_dag()
    else:
        with open(os.path.join(DAGS, f"{name}.json")) as f:
            dag = carry.dag_from_pb(json.load(f))
    cols = chip_smoke.lineitem_sf1(seed=5, n=50_000)
    ((region, ranges),) = chip_smoke.make_regions(cols, dag.executors[0].table_id, parts=1)
    cpu_stats, gpu_stats = {}, {}
    cpu = gpu_engine.execute_region(region, dag, ranges, device="cpu", stats=cpu_stats)
    before = gs.LAUNCHES
    gpu = gpu_engine.execute_region(region, dag, ranges, device="cuda", stats=gpu_stats)
    torch.cuda.synchronize()
    assert chip_smoke._same_chunk(gpu, cpu) and gpu.rows() == cpu.rows()
    assert gpu_stats == cpu_stats
    if name == "band":
        assert gs.LAUNCHES - before == (13 if (block, fuse_max) == (4096, 8) else 1)


@pytest.mark.gpu
def test_blockwise_dot_on_card_matches_cpu_path(monkeypatch):
    """Q1 over 13 fused blocks with the dot route's 2^21-row size gate
    lowered: one limb matrix accumulates block by block on the card."""
    _need_card()
    from tidb_tpu_torch.ops import dag_kernel

    monkeypatch.setattr(gpu_engine, "_BLOCK", 4096)
    monkeypatch.setattr(gpu_engine, "_FUSE_MAX_NB", 20)
    monkeypatch.setattr(dag_kernel, "_MXU_MIN_ROWS", 4096)
    monkeypatch.setattr(dag_kernel, "_COMPILE_CACHE", {})
    with open(os.path.join(DAGS, "q1.json")) as f:
        dag = carry.dag_from_pb(json.load(f))
    cols = chip_smoke.lineitem_sf1(seed=6, n=50_000)
    ((region, ranges),) = chip_smoke.make_regions(cols, dag.executors[0].table_id, parts=1)
    stats = {}
    gpu = gpu_engine.execute_region(region, dag, ranges, device="cuda", stats=stats)
    cpu = gpu_engine.execute_region(region, dag, ranges, device="cpu")
    assert stats["path"] == "blockwise dot"
    assert gpu.rows() == cpu.rows()


@pytest.mark.gpu
def test_sql_front_on_card_matches_cpu_and_oracle():
    """The seven SQL statements through ``tidb_tpu_torch.open`` on the card
    and on the CPU, over the same 200,000-row lineitem in two regions:
    equal rows, equal to the numpy oracle, every cop task on ``gpu``."""
    _need_card()
    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.tablecodec import record_key

    cols = chip_smoke.lineitem_sf1(seed=6, n=200_000)
    sessions = {}
    for device in ("cuda", "cpu"):
        db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
        chip_smoke.lineitem_sql(db, bulk_load, record_key, cols, parts=2)
        sessions[device] = (db, db.session())
    for name, sql in chip_smoke.SQL_QUERIES.items():
        got = {}
        for device, (_db, s) in sessions.items():
            got[device] = chip_smoke.sql_rows(name, s.query(sql))
            assert s.exec_summary.engines == {"gpu": 2} and not s.exec_summary.degraded
        assert got["cuda"] == got["cpu"] == chip_smoke.sql_oracle(name, cols)
    for db, _s in sessions.values():
        db.stop_background()


@pytest.mark.gpu
@pytest.mark.parametrize("block,fuse_max", [(1 << 22, 8), (8192, 8), (8192, 2)])
def test_band_dag_with_a_delta_on_card_matches_cpu_path(monkeypatch, block, fuse_max):
    """The band DAG over a 50,000-row region with committed changes pending
    (updates, deletes and fresh rows, one price past the int32 envelope):
    the card's Chunk equals the CPU path's at one block (n = 65,536 +
    8,192 rows: K1), over fused blocks and per block, and K1 launches."""
    _need_card()
    import dataclasses

    import numpy as np

    from tidb_tpu_torch.copr.colcache import DeltaOverlay

    monkeypatch.setattr(gpu_engine, "_BLOCK", block)
    monkeypatch.setattr(gpu_engine, "_FUSE_MAX_NB", fuse_max)
    with open(os.path.join(DAGS, "band.json")) as f:
        dag = carry.dag_from_pb(json.load(f))
    cols = chip_smoke.lineitem_sf1(seed=8, n=50_000)
    ((region, ranges),) = chip_smoke.make_regions(cols, dag.executors[0].table_id, parts=1)
    rng = np.random.default_rng(8)
    n = region.entry.n
    handles = np.unique(np.concatenate([rng.choice(region.entry.handles, 3000, replace=False), n + 1 + np.arange(500)]))
    tomb = rng.random(len(handles)) < 0.2
    fresh = chip_smoke.lineitem_sf1(seed=9, n=len(handles))
    fresh[1][0] = 3_000_000_000
    dcols = {s: (np.where(tomb, 0, c).astype(c.dtype), ~tomb) for s, c in fresh.items()}
    delta = DeltaOverlay(handles=handles, tomb=tomb, data_version=7, built_ts=1, cols=dcols)
    view = dataclasses.replace(region, delta=delta)
    cpu_stats, gpu_stats = {}, {}
    cpu = gpu_engine.execute_region(view, dag, ranges, device="cpu", stats=cpu_stats)
    before = gs.LAUNCHES
    gpu = gpu_engine.execute_region(view, dag, ranges, device="cuda", stats=gpu_stats)
    torch.cuda.synchronize()
    assert gs.LAUNCHES > before
    assert chip_smoke._same_chunk(gpu, cpu) and gpu.rows() == cpu.rows()
    assert gpu_stats == cpu_stats and gpu_stats["delta_rows"] == len(handles)
    assert gpu_stats["routes"] == ("k1",)


@pytest.mark.gpu
def test_builtin_statements_on_card_match_cpu_and_oracle():
    """The seven statements of ``chip_smoke.BUILTIN_QUERIES`` on the card
    and on the CPU over the same 200,000-row lineitem in two regions: equal
    rows, equal to the numpy oracle, every cop task on ``gpu`` with bytes
    copied off the card, and K1 launching for ``bandf``."""
    _need_card()
    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.kv.tablecodec import record_key

    cols = chip_smoke.lineitem_sf1(seed=12, n=200_000)
    sessions = {}
    for device in ("cuda", "cpu"):
        db = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
        chip_smoke.lineitem_sql(db, bulk_load, record_key, cols, parts=2)
        sessions[device] = (db, db.session())
    for name, sql in chip_smoke.BUILTIN_QUERIES.items():
        got = {}
        before = gs.LAUNCHES
        for device, (_db, s) in sessions.items():
            got[device] = sorted(s.query(sql), key=repr)
            assert s.exec_summary.engines == {"gpu": 2} and not s.exec_summary.degraded
            assert s.exec_summary.d2h_bytes > 0
        assert (gs.LAUNCHES > before) == (name == "bandf"), name
        assert chip_smoke.rows_match(got["cuda"], got["cpu"]), name
        assert chip_smoke.rows_match(got["cuda"], chip_smoke.builtin_oracle(name, cols)), name
    for db, _s in sessions.values():
        db.stop_background()


@pytest.mark.gpu
def test_every_builtin_on_card_matches_numpy():
    """Every gpu-legal builtin over 65,536-row lanes on the card against the
    same body in numpy on the host (``chip_smoke._builtins_check``: exact
    integer, decimal, date and boolean lanes and validity, floats within a
    relative 1e-12)."""
    _need_card()
    out = chip_smoke._builtins_check(seed=3, n=65_536)
    assert out["names"] == 91 and out["exact"] + out["within_tolerance"] == 91
    assert out["worst_float_ulp"] < 1e4


def _window_lanes(pairs, device):
    return [(torch.from_numpy(d).to(device), torch.from_numpy(v).to(device)) for d, v in pairs]


@pytest.mark.gpu
@pytest.mark.parametrize("frame", ["range_cur", "rows_cur", ("rows", "preceding", 3, "following", 1)], ids=str)
@pytest.mark.parametrize("sort", ["int32", "int64", "multilane"])
def test_window_program_on_card_matches_cpu(sort, frame):
    """window_core.window_program at 1,048,576 rows on the card against the
    same call on the CPU: the stable sorts (an int32 key, an int64 key, the
    chain of argsorts over bool and double lanes) give the same
    permutation; integer, decimal, rank-ratio and extreme lanes are exact,
    the float SUM/AVG lanes within a relative 1e-12 of the prefix
    magnitude."""
    _need_card()
    from tidb_tpu_torch.ops import window_core as wc

    n = 1 << 20
    mask, parts, orders, descs, args, bounds = chip_smoke.window_batch(sort, n, seed=17)
    funcs = [f for f in chip_smoke.WINDOW_SPECS if not (isinstance(frame, tuple) and f[0][0] in ("min", "max"))]
    specs = tuple(f for f, _ in funcs)
    arg_np = [args[k] if k else None for _, k in funcs]
    got = {}
    for device in ("cuda", "cpu"):
        res = wc.window_program(
            mask=torch.from_numpy(mask).to(device), part_lanes=_window_lanes(parts, device),
            order_lanes=_window_lanes(orders, device), order_descs=descs, frame_tag=frame, specs=specs,
            arg_lanes=[_window_lanes([a], device)[0] if a is not None else None for a in arg_np], n=n, bounds=bounds,
        )
        got[device] = ([(d.cpu().numpy(), v.cpu().numpy()) for d, v in res[0]], res[1].cpu().numpy(), res[2].cpu().numpy())
    (gout, gperm, gsm), (cout, cperm, csm) = got["cuda"], got["cpu"]
    assert np.array_equal(gperm, cperm) and np.array_equal(gsm, csm)
    for (spec, k), (gd, gv), (cd, cv) in zip(funcs, gout, cout):
        assert np.array_equal(gv, cv), spec
        gd, cd = np.where(cv, gd, 0), np.where(cv, cd, 0)
        if spec[2] and spec[0] in ("sum", "avg"):
            mag = max(float(np.abs(args[k][0][args[k][1]]).sum()), 1.0)
            assert np.allclose(gd, cd, rtol=0, atol=1e-12 * mag), spec
        else:
            assert np.array_equal(gd, cd), spec


def _mpp_lanes(seed, ndev, n):
    """Group keys (with NULLs), a live mask and SUM/MIN/MAX lanes, [ndev, n]."""
    rng = np.random.default_rng(seed)
    k = rng.integers(-3, 4000, (ndev, n)).astype(np.int64)
    kv = rng.random((ndev, n)) > 0.05
    mask = rng.random((ndev, n)) > 0.2
    vd = rng.integers(-(1 << 40), 1 << 40, (ndev, n)).astype(np.int64)
    vv = rng.random((ndev, n)) > 0.1
    keys = [np.where(kv, k, 0), kv.astype(np.int64)]
    vals = [np.where(vv, vd, 0), vv.astype(np.int64), np.where(vv, vd, np.iinfo(np.int64).max),
            np.where(vv, vd, np.iinfo(np.int64).min), rng.normal(0.0, 1e3, (ndev, n))]
    return keys, mask, vals


def _on(arrays, device):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


def _host(x):
    if isinstance(x, (list, tuple)):
        return [_host(y) for y in x]
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else x


def _same(a, b, atol=0.0):
    """Equal lanes: integers and booleans exact, doubles within ``atol``."""
    for x, y in zip(_host(a), _host(b)):
        if isinstance(x, list):
            _same(x, y, atol)
        elif np.asarray(x).dtype.kind == "f":
            assert np.allclose(x, y, rtol=0, atol=atol)
        else:
            assert np.array_equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("ndev,cap", [(1, 8192), (4, 4096), (4, 512)], ids=["ndev1", "ndev4", "ndev4_overflow"])
def test_mpp_segment_partial_and_exchanges_on_card_match_cpu(ndev, cap):
    """The fragment program's grouped partial agg (packed and lane keys),
    row routing and group-slot exchange at 262,144 rows per shard on the
    card against the same calls on the CPU: every lane exact, but the SUM
    of doubles, a difference of prefix sums that the card's scan adds in
    another order: within 1e-12 of the lane's absolute sum."""
    _need_card()
    from tidb_tpu_torch.parallel import mpp

    n = 1 << 18
    keys, mask, vals = _mpp_lanes(ndev + cap, ndev, n)
    kinds = ("sum", "sum", "min", "max", "sum")
    got = {}
    for device in ("cuda", "cpu"):
        k, (m,), v = _on(keys, device), _on([mask], device), _on(vals, device)
        packed = mpp._segment_partial(k, v, m, cap, ((-3, 4000), (0, 1)), kinds)
        lanes = mpp._segment_partial(k, v, m, cap, (), kinds)
        owner = k[0].abs() % ndev
        routed = mpp._route_rows([k[0], v[0]], m, owner, ndev, 2 * n // max(ndev, 1) if cap > 512 else 4096)
        slots = mpp._exchange_group_slots(ndev, cap, packed[0], packed[1][:2], packed[2]) if ndev > 1 else ()
        torch.cuda.synchronize()
        got[device] = (packed, lanes, routed, slots)
    for a, b in zip(got["cuda"], got["cpu"]):
        _same(a, b, atol=1e-12 * float(np.abs(vals[4]).sum()))
    if cap == 512:
        assert int(got["cpu"][0][3].sum()) > 0 and int(got["cpu"][2][2].sum()) > 0  # overflow and drops seen


@pytest.mark.gpu
@pytest.mark.parametrize("exchange", ["hash", "broadcast"])
@pytest.mark.parametrize("ndev", [1, 4])
def test_mpp_join_agg_pipeline_on_card_matches_cpu(exchange, ndev):
    """build_dist_join_agg (selection, join, two-phase agg) over 4,194,304
    probe rows on the card against the CPU: every output lane exact."""
    _need_card()
    from tidb_tpu_torch.parallel import make_mesh, mpp

    rng = np.random.default_rng(ndev)
    nl, nr = 1 << 22, 1 << 16
    cols = [rng.integers(0, nr, nl), rng.integers(1, 10, nl), rng.permutation(nr), rng.integers(0, 500, nr)]
    join = mpp.DistJoinSpec(left_keys=[0], right_keys=[0], exchange=exchange, row_cap=2 * nl // ndev)
    agg = mpp.DistAggSpec(n_keys=1, sums=[1], group_cap=1024, key_bounds=((0, 499),))
    got = {}
    for device in ("cuda", "cpu"):
        fn = mpp.build_dist_join_agg(
            make_mesh(n_devices=ndev, devices=[torch.device(device)]), join, agg, n_left=2, n_right=2,
            left_selection=lambda cid, qty: qty > 2, agg_inputs=lambda c: [c[3], c[1]],
        )
        got[device] = mpp.to_host(fn(*_on(cols, device)))
    _same(got["cuda"], got["cpu"])
    assert int(got["cuda"][-1]) == 0 and int(got["cuda"][-2]) == 0


@pytest.mark.gpu
def test_mpp_local_joins_and_finalize_on_card_match_cpu():
    _need_card()
    from tidb_tpu_torch.expression.expr import AggDesc, ColumnRef
    from tidb_tpu_torch.ops import dag_kernel
    from tidb_tpu_torch.parallel import mpp
    from tidb_tpu_torch.types import field_type

    rng = np.random.default_rng(3)
    ndev, nprobe, nbuild = 2, 1 << 18, 1 << 16
    lk = rng.integers(0, nbuild, (ndev, nprobe)).astype(np.int64)
    rk_u = np.stack([rng.permutation(4 * nbuild)[:nbuild] for _ in range(ndev)]).astype(np.int64)
    rk_n = rng.integers(0, nbuild // 4, (ndev, nbuild)).astype(np.int64)
    lv, rv = rng.random((ndev, nprobe)) > 0.1, rng.random((ndev, nbuild)) > 0.1
    lc, rc = rng.integers(0, 7, (ndev, nprobe)), rng.integers(0, 7, (ndev, nbuild))
    cnt = rng.integers(0, 5, 4096)
    s = rng.integers(-(10**9), 10**9, 4096)
    sq = s.astype(np.float64) ** 2 + 1.0
    got = {}
    for device in ("cuda", "cpu"):
        a = _on([lk, rk_u, rk_n, lv, rv, lc, rc, cnt, s, sq], device)
        uniq = mpp._local_unique_join(a[0], [a[0]], a[3], a[1], [a[1]], [a[6]], a[4])
        expand = mpp._local_expand_join(a[0], [a[0]], a[3], a[2], [a[2]], [a[6]], a[4], [a[0], a[5]], 1 << 21,
                                        left_outer=True)
        exists = mpp._local_filtered_exists(a[0], [a[0]], a[3], a[2], [a[2]], [a[6]], a[4], [a[0], a[5]], 1 << 21,
                                            lambda ol, orr: ol[1] != orr[0])
        fin = [dag_kernel._finalize_device([AggDesc(name, ColumnRef(0, ft))], lanes, [torch.ones_like(a[7], dtype=torch.bool)] * 3)
               for name in ("avg", "var_samp", "stddev_pop")
               for ft in (field_type.decimal_type(12, 2), field_type.double_type())
               for lanes in ([a[7], a[8] if ft.kind.name == "DECIMAL" else a[8].double(), a[9]],)]
        torch.cuda.synchronize()
        # expansion slots follow the build side's stable sort: equal on both
        got[device] = (uniq, expand, exists, fin)
    _same(got["cuda"][0], got["cpu"][0])
    _same(got["cuda"][1], got["cpu"][1])
    _same(got["cuda"][2], got["cpu"][2])
    # finalized doubles within a relative 1e-12 (the CPU tests' tolerance):
    # the card's double sqrt and the CPU's differ by an ulp (STDDEV)
    for (gd, gv), (cd, cv) in zip(got["cuda"][3], got["cpu"][3]):
        _same(gv, cv)
        valid = _host(cv[0])
        a, b = _host(gd[0])[valid], _host(cd[0])[valid]
        assert np.allclose(a, b, rtol=1e-12, atol=0) if a.dtype.kind == "f" else np.array_equal(a, b)


@pytest.mark.gpu
def test_mpp_statements_on_card_match_cpu_and_oracle():
    """chip_smoke.MPP_QUERIES over 200,000 lineitem rows through
    ``tidb_tpu_torch.open`` on the card and on the CPU, at 1 and 4
    virtual shards: equal rows, each the numpy oracle's, each statement one
    gather with the expected fragments and stages and no retry."""
    _need_card()
    import tidb_tpu_torch
    from tidb_tpu_torch.executor.load import bulk_load
    from tidb_tpu_torch.parallel import mesh

    n = 200_000
    cols = chip_smoke.lineitem_sf1(seed=8, n=n)
    tables = chip_smoke.mpp_tables(cols, chip_smoke.lineitem_partkey(8, n) % 20_000 + 1, 8, n_part=20_000, n_cust=15_000)
    dbs = {}
    for device in ("cuda", "cpu"):
        dbs[device] = tidb_tpu_torch.open(region_split_keys=1 << 62, device=device)
        chip_smoke.mpp_sql(dbs[device], bulk_load, tables)
    try:
        for nd in (1, 4):
            mesh.FORCE_NDEV = nd
            for name, sql in chip_smoke.MPP_QUERIES.items():
                want = chip_smoke.mpp_oracle(name, tables)
                rows = {}
                for device, db in dbs.items():
                    s = db.session()
                    rows[device] = s.query(sql)
                    det = s.mpp_details[-1]
                    assert (det.n_fragments, det.stages, det.ndev, det.retries) == (*chip_smoke.MPP_PLANS[name], nd, 0)
                assert rows["cuda"] == rows["cpu"], name
                assert chip_smoke.mpp_rows_match(name, rows["cuda"], want, chip_smoke.MPP_LIMITS[name]), name
    finally:
        mesh.FORCE_NDEV = None
        for db in dbs.values():
            db.stop_background()
