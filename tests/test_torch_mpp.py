"""The port's MPP fragment program (``tidb_tpu_torch/parallel/mpp.py``) and
complete-mode finalize (``ops/dag_kernel._finalize_device``) held against
the reference's, function by function, on the same numpy inputs drawn
from a seed.

The reference's per-shard functions run on each shard's 1-D lanes; its
collectives (``_route_rows``, ``_exchange_group_slots``, the whole
pipeline) run under ``shard_map`` on the conftest's 8-device CPU mesh cut
to ``ndev`` devices. The port runs every shard at once over a leading
shard axis, ``[ndev, rows]``, on the CPU.

Tolerance: integer and decimal lanes equal bit for bit; double lanes
within a relative 1e-12 (``REL``). Where the reference sorts unstably and
the port stably (a non-unique build side's rows within one key), the
expansion join's rows compare as multisets per shard.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tidb_tpu.expression.expr import AggDesc as RefAggDesc  # noqa: E402
from tidb_tpu.expression.expr import ColumnRef as RefColumnRef  # noqa: E402
from tidb_tpu.ops import dag_kernel as ref_dk  # noqa: E402
from tidb_tpu.parallel import make_mesh as ref_make_mesh  # noqa: E402
from tidb_tpu.parallel import mpp as ref  # noqa: E402
from tidb_tpu.parallel import shard_map_compat  # noqa: E402
from tidb_tpu.types import field_type as ref_ft  # noqa: E402
from tidb_tpu_torch.expression.expr import AggDesc, ColumnRef  # noqa: E402
from tidb_tpu_torch.ops import dag_kernel  # noqa: E402
from tidb_tpu_torch.parallel import make_mesh, mesh  # noqa: E402
from tidb_tpu_torch.parallel import mpp  # noqa: E402
from tidb_tpu_torch.types import field_type  # noqa: E402

REL = 1e-12  # double lanes, relative
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind == "f" or b.dtype.kind == "f":
        np.testing.assert_allclose(a.astype(np.float64), b.astype(np.float64), rtol=REL, atol=0)
    else:
        assert a.dtype.kind == b.dtype.kind or {a.dtype.kind, b.dtype.kind} <= {"i", "b", "u"}
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def _ref_shards(fn, ndev, arrays, n_out):
    """``fn`` over the reference mesh cut to ``ndev`` devices: every input
    sharded on ``dp``, every output concatenated over the shards."""
    m = ref_make_mesh(ndev)
    f = shard_map_compat(
        fn, mesh=m, in_specs=tuple(P("dp") for _ in arrays), out_specs=(P("dp"),) * n_out, check_vma=False
    )
    return [np.asarray(o) for o in jax.jit(f)(*[jnp.asarray(a) for a in arrays])]


# -- _pack_keys / _segment_partial -------------------------------------------


def _group_case(seed, ndev, n, nkeys=2, nulls=True, floats=False):
    rng = np.random.default_rng(seed)
    keys = []
    for i in range(nkeys):
        d = rng.integers(-3, 9 + 4 * i, (ndev, n)).astype(np.int64)
        v = rng.random((ndev, n)) > (0.1 if nulls else -1)
        keys += [np.where(v, d, 0), v.astype(np.int64)]
    mask = rng.random((ndev, n)) > 0.2
    if floats:
        vd = rng.normal(100.0, 40.0, (ndev, n))
    else:
        vd = rng.integers(-(1 << 40), 1 << 40, (ndev, n)).astype(np.int64)
    vv = rng.random((ndev, n)) > 0.15
    big = np.inf if floats else np.iinfo(np.int64).max
    small = -np.inf if floats else np.iinfo(np.int64).min
    vals = [np.where(vv, vd, 0), vv.astype(np.int64), np.where(vv, vd, big), np.where(vv, vd, small)]
    return keys, vals, mask


@pytest.mark.parametrize("packed", [True, False], ids=["packed", "lanes"])
@pytest.mark.parametrize("floats", [False, True], ids=["int", "double"])
@pytest.mark.parametrize("cap", [64, 8], ids=["fits", "overflow"])
def test_segment_partial_matches_reference(packed, floats, cap):
    ndev, n = 4, 256
    keys, vals, mask = _group_case(11 + cap, ndev, n, floats=floats)
    bounds = ((-3, 8), (0, 1), (-3, 12), (0, 1)) if packed else ()
    kinds = ("sum", "sum", "min", "max")
    pk, ps, pc, pof = mpp._segment_partial([_t(k) for k in keys], [_t(v) for v in vals], _t(mask), cap, bounds, kinds)
    for s in range(ndev):
        rk, rs, rc, rof = ref._segment_partial(
            jnp, [jnp.asarray(k[s]) for k in keys], [jnp.asarray(v[s]) for v in vals], jnp.asarray(mask[s]),
            cap, bounds, kinds,
        )
        assert int(pof[s]) == int(rof)
        _close(pc[s], rc)
        for a, b in zip(pk, rk):
            _close(a[s], b)
        for a, b in zip(ps, rs):
            _close(a[s], b)
    if cap == 8:
        assert int(pof.sum()) > 0  # the case really overflows


def test_pack_keys_matches_reference():
    rng = np.random.default_rng(5)
    k1 = rng.integers(-50, 50, (2, 300))
    k2 = rng.integers(0, 1 << 20, (2, 300))
    for bounds in (((-50, 49), (0, (1 << 20) - 1)), ((-50, 49),), ((0, 10), None)):
        ks = [k1, k2][: len(bounds)]
        got = mpp._pack_keys([_t(k) for k in ks], bounds)
        want = ref._pack_keys(jnp, [jnp.asarray(k) for k in ks], bounds)
        if want is None:
            assert got is None
            continue
        assert got[1] == want[1]
        assert str(got[0].dtype).split(".")[-1] == str(want[0].dtype)
        _close(got[0], want[0])


# -- the exchanges -------------------------------------------------------------


@pytest.mark.parametrize("ndev,cap", [(1, 64), (4, 64), (4, 12)], ids=["ndev1", "ndev4", "ndev4_overflow"])
def test_route_rows_matches_reference(ndev, cap):
    n = 64
    rng = np.random.default_rng(21)
    # skewed keys: one owner takes most rows, so a small cap drops some
    key = np.where(rng.random(ndev * n) < 0.5, 8, rng.integers(0, 100, ndev * n)).astype(np.int64)
    payload = rng.integers(-1000, 1000, ndev * n).astype(np.int64)
    valid = rng.random(ndev * n) > 0.1
    owner = np.abs(key) % ndev

    def rfn(k, p, v, o):
        outs, ov, dropped = ref._route_rows(jax, jnp, [k, p], v, o, ndev, cap)
        return outs[0], outs[1], ov, jnp.reshape(dropped, (1,))

    want = _ref_shards(rfn, ndev, [key, payload, valid, owner], 4)
    view = lambda a: _t(a.reshape(ndev, n))  # noqa: E731
    outs, ov, dropped = mpp._route_rows([view(key), view(payload)], view(valid), view(owner), ndev, cap)
    _close(outs[0].reshape(-1), want[0])
    _close(outs[1].reshape(-1), want[1])
    _close(ov.reshape(-1), want[2])
    _close(dropped, want[3])
    if cap == 12:
        assert int(dropped.sum()) > 0


def test_exchange_group_slots_matches_reference():
    ndev, cap = 4, 32
    rng = np.random.default_rng(8)
    k = rng.integers(-(1 << 62), 1 << 62, ndev * cap).astype(np.int64)
    k[::7] = np.iinfo(np.int64).min  # abs() wraps: ownership must still agree
    kv = (rng.random(ndev * cap) > 0.1).astype(np.int64)
    s = rng.integers(-100, 100, ndev * cap).astype(np.int64)
    cnt = np.where(rng.random(ndev * cap) < 0.7, rng.integers(1, 5, ndev * cap), 0).astype(np.int64)

    def rfn(k_, kv_, s_, c_):
        rk, rs, rc, of = ref._exchange_group_slots(jax, jnp, ndev, cap, [k_, kv_], [s_], c_)
        return rk[0], rk[1], rs[0], rc, jnp.reshape(of, (1,))

    want = _ref_shards(rfn, ndev, [k, kv, s, cnt], 5)
    view = lambda a: _t(a.reshape(ndev, cap))  # noqa: E731
    rk, rs, rc, of = mpp._exchange_group_slots(ndev, cap, [view(k), view(kv)], [view(s)], view(cnt))
    for got, w in zip([rk[0], rk[1], rs[0], rc, of], want):
        _close(got.reshape(-1), w)


# -- the local joins -------------------------------------------------------------


def _join_case(seed, ndev, n_probe, n_build, unique):
    rng = np.random.default_rng(seed)
    if unique:
        rk = np.stack([rng.permutation(3 * n_build)[:n_build] for _ in range(ndev)]).astype(np.int64)
    else:
        rk = rng.integers(0, n_build // 3, (ndev, n_build)).astype(np.int64)
    lk = rng.integers(0, 3 * n_build if unique else n_build // 2, (ndev, n_probe)).astype(np.int64)
    lvalid = rng.random((ndev, n_probe)) > 0.1
    rvalid = rng.random((ndev, n_build)) > 0.1
    lcol = rng.integers(0, 1000, (ndev, n_probe)).astype(np.int64)
    rcol = rng.integers(0, 1000, (ndev, n_build)).astype(np.int64)
    return lk, lvalid, rk, rvalid, lcol, rcol


def test_local_unique_join_matches_reference():
    ndev = 3
    lk, lvalid, rk, rvalid, lcol, rcol = _join_case(1, ndev, 200, 80, True)
    g, m = mpp._local_unique_join(_t(lk), [_t(lk)], _t(lvalid), _t(rk), [_t(rk)], [_t(rcol)], _t(rvalid))
    for s in range(ndev):
        rg, rm = ref._local_unique_join(
            jax, jnp, jnp.asarray(lk[s]), [jnp.asarray(lk[s])], jnp.asarray(lvalid[s]), jnp.asarray(rk[s]),
            [jnp.asarray(rk[s])], [jnp.asarray(rcol[s])], jnp.asarray(rvalid[s]),
        )
        _close(m[s], rm)
        _close(g[0][s][m[s]], np.asarray(rg[0])[np.asarray(rm)])
    assert int(m.sum()) > 0


def _multiset(lanes, live):
    return sorted(zip(*[np.asarray(x)[np.asarray(live)].tolist() for x in lanes]))


@pytest.mark.parametrize("left_outer", [False, True], ids=["inner", "left"])
@pytest.mark.parametrize("out_cap", [2048, 64], ids=["fits", "overflow"])
def test_local_expand_join_matches_reference(left_outer, out_cap):
    ndev = 2
    lk, lvalid, rk, rvalid, lcol, rcol = _join_case(2, ndev, 150, 90, False)
    ol, orr, live, of = mpp._local_expand_join(
        _t(lk), [_t(lk)], _t(lvalid), _t(rk), [_t(rk)], [_t(rcol)], _t(rvalid), [_t(lk), _t(lcol)], out_cap,
        left_outer=left_outer,
    )
    for s in range(ndev):
        rl, rr, rlive, rof = ref._local_expand_join(
            jax, jnp, jnp.asarray(lk[s]), [jnp.asarray(lk[s])], jnp.asarray(lvalid[s]), jnp.asarray(rk[s]),
            [jnp.asarray(rk[s])], [jnp.asarray(rcol[s])], jnp.asarray(rvalid[s]),
            [jnp.asarray(lk[s]), jnp.asarray(lcol[s])], out_cap, left_outer=left_outer,
        )
        assert int(of[s]) == int(rof)
        if int(rof) == 0:
            assert _multiset([ol[0][s], ol[1][s], orr[0][s]], live[s]) == _multiset(list(rl) + list(rr), rlive)
    if out_cap == 64:
        assert int(of.sum()) > 0


def test_local_filtered_exists_and_match_counts_match_reference():
    ndev, out_cap = 2, 4096
    lk, lvalid, rk, rvalid, lcol, rcol = _join_case(3, ndev, 120, 90, False)
    lcol %= 3
    rcol %= 3

    def pf_port(out_l, out_r):
        return out_l[1] != out_r[0]

    def pf_ref(out_l, out_r):
        return out_l[1] != out_r[0]

    cnt, of = mpp._local_filtered_exists(
        _t(lk), [_t(lk)], _t(lvalid), _t(rk), [_t(rk)], [_t(rcol)], _t(rvalid), [_t(lk), _t(lcol)], out_cap, pf_port
    )
    mc = mpp._local_match_counts(_t(lk), [_t(lk)], _t(lvalid), _t(rk), [_t(rk)], _t(rvalid))
    for s in range(ndev):
        a = [jnp.asarray(x[s]) for x in (lk, lvalid, rk, rvalid, lcol, rcol)]
        rcnt, rof = ref._local_filtered_exists(
            jax, jnp, a[0], [a[0]], a[1], a[2], [a[2]], [a[5]], a[3], [a[0], a[4]], out_cap, pf_ref
        )
        assert int(of[s]) == int(rof) == 0
        _close(cnt[s], rcnt)
        _close(mc[s], ref._local_match_counts(jax, jnp, a[0], [a[0]], a[1], a[2], [a[2]], a[3]))
    assert int((cnt > 0).sum()) > 0 and int((mc > cnt).sum()) > 0


def test_exact_pair_lanes_match_reference():
    rng = np.random.default_rng(4)
    l1, l2 = rng.integers(0, 5, (2, 40)), rng.integers(-3, 3, (2, 40))
    r1, r2 = rng.integers(0, 5, (2, 30)), rng.integers(-3, 3, (2, 30))
    gl, gr, span = mpp._exact_pair_lanes([_t(l1), _t(l2)], [_t(r1), _t(r2)])
    for s in range(2):
        wl, wr, wspan = ref._exact_pair_lanes(
            jnp, [jnp.asarray(l1[s]), jnp.asarray(l2[s])], [jnp.asarray(r1[s]), jnp.asarray(r2[s])]
        )
        assert span == wspan
        _close(gl[s], wl)
        _close(gr[s], wr)


# -- the pipeline ---------------------------------------------------------------


def _star(seed, ndev, skew=False):
    nl, nr = ndev * 256, ndev * 32
    rng = np.random.default_rng(seed)
    l_cid = np.zeros(nl, np.int64) if skew else rng.integers(0, nr, nl)
    l_qty = rng.integers(1, 10, nl)
    r_id = rng.permutation(nr)
    r_cat = rng.integers(0, 5, nr)
    return [l_cid, l_qty, r_id, r_cat]


def _run_both(ndev, join, agg, cols, sel=True):
    kw = dict(n_left=2, n_right=2, agg_inputs=lambda c: [c[3], c[1]])
    if sel:
        kw["left_selection"] = lambda cid, qty: qty > 2
    ref_fn = ref.build_dist_join_agg(ref_make_mesh(ndev), join, agg, **kw)
    want = [np.asarray(o) for o in ref_fn(*[jnp.asarray(c) for c in cols])]
    fn = mpp.build_dist_join_agg(make_mesh(n_devices=ndev, devices=[CPU]), join, agg, **kw)
    got = mpp.to_host(fn(*[_t(c) for c in cols]))
    return got, want


@pytest.mark.parametrize("exchange", ["hash", "broadcast"])
@pytest.mark.parametrize("ndev", [1, 4])
def test_build_dist_join_agg_matches_reference(exchange, ndev):
    join = mpp.DistJoinSpec(left_keys=[0], right_keys=[0], exchange=exchange, row_cap=2048)
    got, want = _run_both(ndev, join, mpp.DistAggSpec(n_keys=1, sums=[1], group_cap=64), _star(3, ndev))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g, w)
    keys, sums, cnt, total = mpp.finalize_dist_agg(got[:-2], 1, 1)
    assert int(got[-2]) == 0 and int(got[-1]) == 0 and len(keys[0]) == 5


def test_route_overflow_dropped_counts_match_reference():
    """Every probe row joins build id 0, so the hash exchange sends every row
    to one owner past its capacity: the dropped rows are reported, and the
    port's count is the reference's."""
    ndev = 4
    join = mpp.DistJoinSpec(left_keys=[0], right_keys=[0], exchange="hash", row_cap=16)
    got, want = _run_both(ndev, join, mpp.DistAggSpec(n_keys=1, sums=[1], group_cap=16), _star(9, ndev, skew=True), sel=False)
    assert int(got[-2]) > 0
    assert int(got[-2]) == int(want[-2])
    assert int(got[-1]) == int(want[-1])


def test_build_dist_agg_grows_its_cap_like_the_reference():
    ndev = 4
    rng = np.random.default_rng(2)
    k = rng.integers(0, 300, ndev * 128)
    v = rng.integers(0, 1000, ndev * 128)
    spec = mpp.DistAggSpec(n_keys=1, sums=[1], group_cap=8)
    got = mpp.finalize_dist_agg(mpp.build_dist_agg(make_mesh(n_devices=ndev, devices=[CPU]), spec)(_t(k), _t(v)), 1, 1)
    want = ref.finalize_dist_agg(ref.build_dist_agg(ref_make_mesh(ndev), spec)(jnp.asarray(k), jnp.asarray(v)), 1, 1)
    as_map = lambda r: {int(a): (int(b), int(c)) for a, b, c in zip(r[0][0], r[1][0], r[2])}  # noqa: E731
    assert as_map(got) == as_map(want)
    assert got[3] == want[3]


def test_mesh_collectives():
    x = torch.arange(2 * 6).view(2, 6)
    assert mesh.all_to_all(x, 2).tolist() == [[0, 1, 2, 6, 7, 8], [3, 4, 5, 9, 10, 11]]
    assert mesh.all_gather(torch.tensor([[1, 2], [3, 4]])).tolist() == [[1, 2, 3, 4], [1, 2, 3, 4]]
    assert mesh.psum(torch.tensor([[1, 2], [3, 4]])).tolist() == [[4, 6], [4, 6]]
    mesh.FORCE_NDEV = 3
    try:
        m = make_mesh()
        assert m.devices.size == 3 and m is make_mesh()
    finally:
        mesh.FORCE_NDEV = None
    assert make_mesh(devices=[CPU]).devices.size == 1


# -- complete-mode finalize ------------------------------------------------------


def _finalize_case(name, decimal):
    """(port aggs, reference aggs, state lanes) for one aggregate over 8
    groups: counts 0, 1 and more, negative sums (half-up ties included)."""
    cnt = np.array([0, 1, 1, 2, 3, 7, 4, 2], np.int64)
    if decimal:
        pt, rt = field_type.decimal_type(12, 2), ref_ft.decimal_type(12, 2)
        s = np.array([0, -250, 251, -5, -12345, 9_999_999, 2, 3], np.int64)
        sq = np.array([0, 62500.0, 63001.0, 13.0, 6e7, 1.5e13, 2.0, 9.0])
    else:
        pt, rt = field_type.double_type(), ref_ft.double_type()
        s = np.array([0.0, -2.5, 2.5, -0.5, -123.45, 1e6, 0.1, 0.3])
        sq = np.array([0.0, 6.25, 6.25, 0.13, 6000.1, 1.5e11, 0.01, 0.09])
    pa = [AggDesc(name, ColumnRef(0, pt))]
    ra = [RefAggDesc(name, RefColumnRef(0, rt))]
    lanes = [cnt, s] if name == "avg" else [cnt, s, sq]
    return pa, ra, lanes


@pytest.mark.parametrize("decimal", [True, False], ids=["decimal", "double"])
@pytest.mark.parametrize("name", ["avg", "var_pop", "var_samp", "stddev_pop", "stddev_samp"])
def test_finalize_device_matches_reference(name, decimal):
    pa, ra, lanes = _finalize_case(name, decimal)
    ones = [np.ones(8, bool)] * len(lanes)
    gd, gv = dag_kernel._finalize_device(pa, [_t(x) for x in lanes], [_t(x) for x in ones])
    wd, wv = ref_dk._finalize_device(jnp, ra, [jnp.asarray(x) for x in lanes], [jnp.asarray(x) for x in ones])
    _close(gv[0], wv[0])
    valid = np.asarray(wv[0])
    _close(_np(gd[0])[valid], np.asarray(wd[0])[valid])
    if name == "avg" and decimal:
        # -123.45 / 3 = -41.15 exactly; 0.02 / 4 = 0.005; 99999.99 / 7 =
        # 14285.712857 (at scale 6, half away from zero)
        assert _np(gd[0])[[4, 6, 5]].tolist() == [-41150000, 5000, 14285712857]
