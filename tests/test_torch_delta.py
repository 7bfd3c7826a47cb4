"""Reads after writes in the PyTorch port: the delta operand held against
the reference.

The column cache pins a region's base entry across DML and hands the
committed changes on top of it to the device engine as a delta operand
(``colcache.get_split``). The same table and the same DML go through
``tidb_tpu.open()`` and ``tidb_tpu_torch.open(device="cpu")``; the port's
``gpu`` engine (every kernel's plain version on the CPU) must equal the
reference's ``tpu`` engine (JAX on the CPU) and ``host`` engine row for
row, with every cop task on ``gpu``, none degraded and the delta folded in.
As in tests/test_delta_merge.py the device block and the delta knobs
shrink equally in both packages (``device_delta_cap`` 64, merge at 8 rows,
delta-tracking from 1 row) so the CPU reaches every block path: one
block, per-block programs, one fused program and the paged LIMIT.

A kernel-level case runs the port's ``get_kernel(..., delta_cap=D)`` and
the reference's on the same bound DAG and the same arrays.
"""

import dataclasses
import os
import sys

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu import config as ref_config  # noqa: E402
from tidb_tpu.copr import binder as ref_binder  # noqa: E402
from tidb_tpu.copr import colcache as ref_colcache  # noqa: E402
from tidb_tpu.copr import tpu_engine  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv import tablecodec as ref_tablecodec  # noqa: E402
from tidb_tpu.kv.tablecodec import record_key as ref_record_key  # noqa: E402
from tidb_tpu.ops import dag_kernel as ref_dag_kernel  # noqa: E402
from tidb_tpu.types import TypeKind  # noqa: E402
from tidb_tpu_torch import config as port_config  # noqa: E402
from tidb_tpu_torch.copr import colcache as port_colcache  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key  # noqa: E402
from tidb_tpu_torch.ops import dag_kernel  # noqa: E402

import test_torch_engine as te  # noqa: E402

CAP = 64
N = 1000
# (rows per device block, most blocks fused, {query kind: engine path})
LAYOUTS = {
    "single": (2048, 8, {}),
    "per_block": (256, 2, {"limit": "paged limit"}),
    "fused": (256, 8, {"limit": "paged limit", "agg": "fused"}),
}
# the DML of tests/test_delta_merge.py: 10 updates, 5 deletes, 2 inserts
DML = (
    "UPDATE d SET v = v + 1, p = p + 0.5 WHERE id < 10",
    "DELETE FROM d WHERE id BETWEEN 20 AND 24",
    "INSERT INTO d VALUES (5000, 'aa', 7, 1.25), (5001, 'bb', 8, NULL)",
)
FRESH = {
    "sum": ("agg", "SELECT COUNT(*), SUM(v), SUM(p) FROM d"),
    "minmax": ("agg", "SELECT g, COUNT(*), SUM(v), MIN(v), MAX(v), MIN(p), MAX(p) FROM d GROUP BY g ORDER BY g"),
    "select": ("rows", "SELECT id, v, p FROM d WHERE v >= 90"),
    "topn": ("rows", "SELECT id, v FROM d ORDER BY v DESC, id LIMIT 9"),
    "topn_dec": ("rows", "SELECT id, p FROM d ORDER BY p LIMIT 9"),
    "scan": ("rows", "SELECT id, g, p FROM d"),
    "limit": ("limit", "SELECT id, g FROM d LIMIT 7"),
}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _reference_pallas(monkeypatch):
    # the reference's Pallas kernel imports enable_x64 from jax.experimental,
    # which this jax no longer has; the test provides the name (the frozen
    # JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _shrink(monkeypatch, block: int, fuse_max: int = 8, **knobs):
    """The device block and the delta knobs, equally in both packages."""
    for mod in (ref_colcache, port_colcache):
        monkeypatch.setattr(mod, "DEVICE_BLOCK_ROWS", block)
    for mod in (tpu_engine, gpu_engine):
        monkeypatch.setattr(mod, "_BLOCK", block)
        monkeypatch.setattr(mod, "_FUSE_MAX_NB", fuse_max)
    knobs = {"device_delta_cap": CAP, "device_delta_merge_rows": 8, "device_delta_min_rows": 1, **knobs}
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "_CURRENT", dataclasses.replace(cfg.current(), **knobs))


def _spy_tasks(monkeypatch):
    """The engine ``stats`` of every port task, in order."""
    seen = []
    real = gpu_engine.execute_region

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        st = {} if stats is None else stats
        seen.append(st)
        return real(region, dag, ranges, warn, device, st)

    monkeypatch.setattr(gpu_engine, "execute_region", spy)
    return seen


def _open_d():
    """(reference, port): table d (id BIGINT PRIMARY KEY, g VARCHAR(2),
    v BIGINT, p DECIMAL(10,2)) with the same 1,000 rows, read once so the
    cache holds the base entry the DML then leaves pinned."""
    rng = np.random.default_rng(7)
    p = rng.integers(0, 20, N).astype(np.int64) * 25  # cents: ~50 rows per value
    data = [
        np.arange(N, dtype=np.int64),
        np.array([b"aa", b"bb", b"cc"], dtype="S2")[rng.integers(0, 3, N)],
        rng.integers(0, 100, N).astype(np.int64),
        [None if i % 97 == 5 else int(x) for i, x in enumerate(p)],
    ]
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    for db, load in ((ref, ref_bulk_load), (port, bulk_load)):
        db.execute("CREATE TABLE d (id BIGINT PRIMARY KEY, g VARCHAR(2), v BIGINT, p DECIMAL(10,2))")
        load(db, "d", data)
        db.query("SELECT COUNT(*) FROM d")
    return ref, port


def _write(dbs, *stmts):
    for sql in stmts:
        for db in dbs:
            db.execute(sql)


def _engine_rows(db, sql, engine):
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines='{engine}'")
    return s.query(sql), s.exec_summary


def _check(ref, port, sql, ordered=True):
    """Port gpu == reference tpu == reference host; → the port's summary."""
    got, summ = _engine_rows(port, sql, "gpu")
    tpu, _ = _engine_rows(ref, sql, "tpu")
    host, _ = _engine_rows(ref, sql, "host")
    if not ordered:
        got, tpu, host = (sorted(r, key=repr) for r in (got, tpu, host))
    assert got == tpu, (sql, got[:8], tpu[:8])
    assert got == host, (sql, got[:8], host[:8])
    assert summ.engines == {"gpu": 1} and summ.degraded == {}
    return summ


def _stop(*dbs):
    for db in dbs:
        db.stop_background()


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fresh_read_parity(monkeypatch, layout):
    block, fuse_max, paths = LAYOUTS[layout]
    _shrink(monkeypatch, block, fuse_max)
    ref, port = _open_d()
    _write((ref, port), *DML)
    tasks = _spy_tasks(monkeypatch)
    for name, (kind, sql) in FRESH.items():
        del tasks[:]
        summ = _check(ref, port, sql)
        assert summ.delta_rows == 17, name
        (st,) = tasks
        assert st["delta_rows"] == 17
        want = "single" if layout == "single" else paths.get(kind, "per-block stacked")
        assert st["path"] == want, (name, st)
    # the delta stays pending: the reads never merged it
    assert port_colcache.cache_for(port.store).delta_rows_pending() == 17
    _stop(ref, port)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_ties_and_scan_order_across_base_and_delta(monkeypatch, layout):
    """Delta rows sit after the base rows in the program but come out in
    handle order: unordered scans, LIMIT without ORDER BY, sort-key ties
    (the lex sort and the single-key rank code), NULL keys and first_row
    across base and delta rows follow the host engine's scan order."""
    block, fuse_max, _ = LAYOUTS[layout]
    _shrink(monkeypatch, block, fuse_max)
    ref, port = _open_d()
    _write(
        (ref, port),
        "UPDATE d SET v = 50, p = 0.00 WHERE id IN (3, 700)",
        "DELETE FROM d WHERE id = 450",
        "INSERT INTO d VALUES (450, 'aa', 50, 0.00), (5002, 'cc', 50, NULL), (-4, 'bb', 50, 0.00)",
        "UPDATE d SET p = NULL WHERE id = 260",
    )
    for sql in (
        "SELECT id, v FROM d WHERE v >= 50 AND v < 51 ORDER BY v LIMIT 5",
        # ~50 rows tie at the lowest price, more than the TopN's 32
        # candidates: the rank code must pack the handle rank
        "SELECT id, p FROM d WHERE p >= 0.00 ORDER BY p LIMIT 6",
        "SELECT id, p FROM d ORDER BY p LIMIT 12",
        "SELECT id, p FROM d ORDER BY p DESC LIMIT 12",
        "SELECT id FROM d WHERE v >= 50 AND v < 51",
        "SELECT id FROM d LIMIT 12",
    ):
        _check(ref, port, sql)
    # first_row: the group's lowest-handle row, on the equality-mask reduce
    # (3 buckets) and on the lex sort (v has no dictionary)
    _check(ref, port, "SELECT g, ANY_VALUE(id) FROM d WHERE v >= 50 AND v < 51 GROUP BY g", ordered=False)
    _check(ref, port, "SELECT v, ANY_VALUE(id) FROM d WHERE v >= 49 AND v < 52 GROUP BY v", ordered=False)
    _stop(ref, port)


def test_band_query_k1_route_with_a_delta_beyond_the_base_envelope(monkeypatch):
    """The band query (B = 160) over two 10,000-row regions with a
    1,024-row delta operand: n = 16,384 + 1,024 rows per task, a multiple
    of 1,024, so both engines route it to their grouped-sum kernel (K1 in
    the port). One line's price is set past the int32 envelope and its
    quantity past the table's maximum: the binder's bounds must cover them
    (K1 trusts its bounds; its plain version raises on a weighted live
    value outside them) and the narrow price lane widens."""
    _shrink(monkeypatch, 1 << 22, device_delta_cap=1024, device_delta_min_rows=1000)
    cols = chip_smoke.lineitem_sf1(seed=5, n=20_000)
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    chip_smoke.lineitem_sql(ref, ref_bulk_load, ref_record_key, cols, 2)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(port, bulk_load, record_key, cols, 2)
    sql = chip_smoke.SQL_QUERIES["band"]
    for db in (ref, port):
        db.query(sql)
    _write(
        (ref, port),
        "UPDATE lineitem SET l_extendedprice = 99999999.99, l_quantity = 75.00 WHERE l_orderkey = 1",
        "INSERT INTO lineitem VALUES (3.00, 4500.00, 0.06, 0.00, 'N', 'O', DATE '1997-01-09', 'MAIL', "
        "'COLLECT COD', 8, 4, 2, DATE '1996-12-20', DATE '1997-01-30')",
    )
    tasks = _spy_tasks(monkeypatch)
    calls = te._spy(monkeypatch)
    got, summ = _engine_rows(port, sql, "gpu")
    assert summ.engines == {"gpu": 2} and summ.degraded == {}
    assert [st["routes"] for st in tasks] == [("k1",), ("k1",)]
    assert [st["delta_rows"] > 0 for st in tasks] == [True, True]
    assert calls["k1"] == 2
    got = sorted(got, key=repr)
    assert got == sorted(_engine_rows(ref, sql, "host")[0], key=repr)
    assert got == sorted(_engine_rows(ref, sql, "tpu")[0], key=repr)
    assert any(r[5] > 99999999 for r in got)
    _stop(ref, port)


def test_delta_past_the_cap_merges_and_stays_on_gpu(monkeypatch):
    _shrink(monkeypatch, 256)
    ref, port = _open_d()
    _write((ref, port), "UPDATE d SET v = v + 1 WHERE id < 100")  # 100 handles > CAP
    tasks = _spy_tasks(monkeypatch)
    summ = _check(ref, port, "SELECT g, COUNT(*), SUM(v) FROM d GROUP BY g ORDER BY g")
    assert summ.delta_rows == 0 and [st["delta_rows"] for st in tasks] == [0]
    assert port_colcache.cache_for(port.store).delta_rows_pending() == 0
    _stop(ref, port)


def test_older_snapshot_keeps_its_result(monkeypatch):
    _shrink(monkeypatch, 256)
    ref, port = _open_d()
    sql = "SELECT g, COUNT(*), SUM(v), MAX(p) FROM d GROUP BY g ORDER BY g"
    reader = port.session()
    reader.execute("BEGIN")
    before = reader.query(sql)
    _write((ref, port), *DML)
    summ = _check(ref, port, sql)
    assert summ.delta_rows == 17
    assert reader.query(sql) == before != _engine_rows(port, sql, "gpu")[0]
    assert reader.exec_summary.engines == {"gpu": 1} and reader.exec_summary.delta_rows == 0
    reader.execute("COMMIT")
    _stop(ref, port)


def test_exec_details_and_explain_analyze_show_the_delta(monkeypatch):
    _shrink(monkeypatch, 256)
    ref, port = _open_d()
    _write((ref, port), "UPDATE d SET v = v + 1 WHERE id = 1")
    s = port.session()
    rows = s.query("EXPLAIN ANALYZE SELECT COUNT(*), SUM(v) FROM d")
    txt = "\n".join(str(r) for r in rows)
    assert "delta_rows: 1" in txt and "engine: gpu×1" in txt, txt
    assert _check(ref, port, "SELECT COUNT(*), SUM(v) FROM d").delta_rows == 1
    _stop(ref, port)


# -- the program on its own: both get_kernel()s on the same inputs ------------------

D_KERNEL = 1024
KERNEL_CASES = {
    # (rows per block, blocks, union slice of the delta or None for all)
    "one_block": (8192, 1, None),
    "two_blocks_fused": (4096, 2, None),
    "one_block_union_slice": (8192, 1, (40, 300)),
}


@pytest.fixture(scope="module")
def kernel_setup():
    db = te._lineitem_db()
    caps = te._capture(db)
    return db, caps, te._carry_region(db, caps["count"][0], caps["count"][1], caps["count"][3])


def _synthetic_delta(entry, rng, doms):
    """(handles, tomb, {slot: (data, valid)}): updates of 300 base rows,
    60 deletes and 200 fresh handles past the last, values in the base's
    domains (string codes inside their dictionaries) with NULLs, one price
    past the int32 envelope."""
    h = entry.handles
    touched = rng.choice(len(h), 360, replace=False)
    handles = np.concatenate([h[touched], h[-1] + 1 + np.arange(200) * 3])
    order = np.argsort(handles)
    handles = handles[order]
    tomb = np.concatenate([np.zeros(300, bool), np.ones(60, bool), np.zeros(200, bool)])[order]
    n = len(handles)
    cols = {}
    for slot, (data, valid) in entry.cols.items():
        if slot in doms:
            d = rng.integers(0, doms[slot], n).astype(data.dtype)
        else:
            lo, hi = int(data[valid].min()), int(data[valid].max())
            d = rng.integers(lo, hi + 1, n).astype(np.int64)
        v = rng.random(n) > 0.03
        d[tomb] = 0
        v[tomb] = False
        cols[slot] = (d, v)
    d1 = cols[1][0]
    d1[np.flatnonzero(~tomb)[7]] = 3_000_000_000  # l_extendedprice past int32
    return handles, tomb, cols


def _overlay(mod, handles, tomb, cols):
    return mod.DeltaOverlay(handles=handles, tomb=tomb, data_version=99, built_ts=1, cols=dict(cols))


@pytest.mark.parametrize("case", list(KERNEL_CASES))
@pytest.mark.parametrize("name", list(te.QUERIES) + ["rows"])
def test_program_matches_reference_program(kernel_setup, monkeypatch, case, name):
    """The same bound DAG (the reference binder over base ⊕ delta) and the
    same arrays through both programs: rows equal, bit for bit."""
    monkeypatch.setattr(port_config, "_CURRENT", port_config.Config(device_delta_cap=D_KERNEL))
    db, caps, reg = kernel_setup
    n_pad, nb, union = KERNEL_CASES[case]
    dag, region, ranges, read_ts = caps[name]
    scan = dag.executors[0]
    cache = ref_colcache.cache_for(db.store)
    entry = reg.entry
    doms = {
        c.column_id: len(cache.dictionary(scan.table_id, c.column_id))
        for c in scan.columns
        if c.ftype.kind == TypeKind.STRING
    }
    handles, tomb, dcols = _synthetic_delta(entry, np.random.default_rng(11), doms)
    ref_delta = _overlay(ref_colcache, handles, tomb, dcols)
    view = tpu_engine._BinderView(entry, ref_delta)
    bound = ref_binder.Binder(cache, scan.table_id, scan.columns, view).bind_dag(dag)
    port_bound = te._port_dag(bound)
    rarr = np.zeros((dag_kernel.MAX_RANGES, 2), dtype=np.int64)
    for i, kr in enumerate(ranges):
        rarr[i] = ref_tablecodec.range_to_handles(kr, scan.table_id)
    u_lo, u_hi = union or (0, len(handles))
    dn = (len(handles), u_lo, u_hi)

    # the base blocks and the delta operand as each engine ships them
    bounds = [(lo, min(lo + n_pad, entry.n)) for lo in range(0, entry.n, n_pad)]
    assert len(bounds) == nb
    port_region = dataclasses.replace(reg, delta=_overlay(port_colcache, handles, tomb, dcols))

    def base_block(lo, hi, narrow):
        hb = np.zeros(n_pad, np.int64)
        hb[: hi - lo] = entry.handles[lo:hi]
        lanes = []
        for c in scan.columns:
            if c.is_handle:
                lanes.append((hb, np.arange(n_pad) < hi - lo))
                continue
            d, v = entry.cols[c.column_id]
            d = narrow(entry, c.column_id, d[lo:hi])
            pd, pv = np.zeros(n_pad, d.dtype), np.zeros(n_pad, bool)
            pd[: hi - lo], pv[: hi - lo] = d, v[lo:hi]
            lanes.append((pd, pv))
        return hb, lanes

    ref_blocks = [base_block(lo, hi, tpu_engine._narrowed) for lo, hi in bounds]
    port_blocks = [base_block(lo, hi, gpu_engine._narrowed) for lo, hi in bounds]
    dh = np.full(D_KERNEL, np.iinfo(np.int64).max, np.int64)
    dh[: len(handles)] = handles
    dt = np.zeros(D_KERNEL, bool)
    dt[: len(handles)] = tomb
    ref_dcols = []
    for c in scan.columns:
        d, v = (handles, np.ones(len(handles), bool)) if c.is_handle else dcols[c.column_id]
        pd, pv = np.zeros(D_KERNEL, d.dtype), np.zeros(D_KERNEL, bool)
        pd[: len(d)], pv[: len(v)] = d, v
        ref_dcols.append((jnp.asarray(pd), jnp.asarray(pv)))
    port_dh, port_dcols, port_dtomb = gpu_engine._delta_device_inputs(
        dataclasses.replace(port_region, cacheable=False), port_bound.executors[0], torch.device("cpu")
    )
    assert torch.equal(port_dh, torch.from_numpy(dh)) and torch.equal(port_dtomb, torch.from_numpy(dt))

    fs = tpu_engine._covers_all(rarr, entry, ref_delta)
    agg_cap = 4096
    rk = ref_dag_kernel.get_kernel(bound, n_pad, agg_cap, nb=nb, full_scan=fs, delta_cap=D_KERNEL)
    pk = dag_kernel.get_kernel(port_bound, n_pad, agg_cap, nb=nb, full_scan=fs, delta_cap=D_KERNEL)
    jcols = [[(jnp.asarray(d), jnp.asarray(v)) for d, v in lanes] for _h, lanes in ref_blocks]
    tcols = [[(torch.from_numpy(d), torch.from_numpy(v)) for d, v in lanes] for _h, lanes in port_blocks]
    nvalids = [hi - lo for lo, hi in bounds]
    if nb == 1:
        rargs = (jnp.asarray(ref_blocks[0][0]), tuple(jcols[0]), jnp.asarray(rarr), jnp.asarray(nvalids[0]))
        pargs = (torch.from_numpy(port_blocks[0][0]), tuple(tcols[0]), rarr, nvalids[0])
    else:
        rargs = (
            tuple(jnp.asarray(h) for h, _ in ref_blocks),
            tuple(tuple(b[ci] for b in jcols) for ci in range(len(scan.columns))),
            jnp.asarray(rarr),
            jnp.asarray(np.asarray(nvalids, np.int64)),
        )
        pargs = (
            tuple(torch.from_numpy(h) for h, _ in port_blocks),
            tuple(tuple(b[ci] for b in tcols) for ci in range(len(scan.columns))),
            rarr,
            tuple(nvalids),
        )
    rpacked = rk.fn(*rargs, jnp.asarray(dh), tuple(ref_dcols), jnp.asarray(dt), jnp.asarray(np.asarray(dn, np.int64)))
    ppacked = pk.fn(*pargs, port_dh, port_dcols, port_dtomb, dn)
    rbuf, rfbuf = (np.asarray(rpacked[0]), np.asarray(rpacked[1])) if isinstance(rpacked, tuple) else (np.asarray(rpacked), None)
    pbuf, pfbuf = gpu_engine._to_host(ppacked)
    assert int(pbuf[0, 0]) == int(rbuf[0, 0]) and int(pbuf[0, 1]) == int(rbuf[0, 1])
    want = tpu_engine._chunk_from_bufs(rbuf, rfbuf, int(rbuf[0, 0]), rk, dag, cache, scan).rows()
    got = gpu_engine._chunk_from_bufs(pbuf, pfbuf, int(pbuf[0, 0]), pk, te._port_dag(dag), reg.cache, port_bound.executors[0]).rows()
    # every lane of these DAGs is an integer, decimal, date or string: exact
    assert got == want and len(got) > 0
    if name == "band":
        # n = 8,192 + 1,024 (K1's n % 1024 == 0 holds): the grouped-sum kernel
        assert pk.routes == ("k1",)
