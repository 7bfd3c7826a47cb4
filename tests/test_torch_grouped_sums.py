"""The port's dense grouped-sum routes against the reference's.

K1 (tidb_tpu_torch.ops.grouped_sums): its plain PyTorch version against the
reference Pallas kernel run in interpret mode and against the NumPy oracle,
bit for bit. The int8 dot route
(tidb_tpu_torch.ops.mxu_groupby) against the reference's XLA version.
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tidb_tpu.ops import mxu_groupby as ref_dot
from tidb_tpu.ops import pallas_groupby
from tidb_tpu_torch.ops import grouped_sums as gs
from tidb_tpu_torch.ops import mxu_groupby as port_dot

_VMAX = (1 << 45) - 1  # the kernels' contract: |value| < 2^45


def _k1_inputs(seed, n_pad, B, L=3):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, B, n_pad)
    dead = rng.random(n_pad) < 0.1  # ~10% dead rows, both kinds
    seg[dead] = np.where(rng.random(dead.sum()) < 0.5, B + rng.integers(0, 50, dead.sum()), -1 - rng.integers(0, 50, dead.sum()))
    pairs = []
    for k in range(L):
        v = rng.integers(-_VMAX, _VMAX + 1, n_pad)
        v[rng.random(n_pad) < 0.05] = _VMAX
        v[rng.random(n_pad) < 0.05] = -_VMAX
        if k == L - 1:
            v = rng.integers(-(1 << 20), 1 << 20, n_pad).astype(np.int32)  # a narrow int32 lane
        pairs.append((v, rng.random(n_pad) < 0.8))
    return seg.astype(np.int32), pairs


@pytest.mark.parametrize("B", [65, 160, 512])
@pytest.mark.parametrize("n_pad", [1024, 8192])
def test_k1_plain_matches_pallas_and_oracle(monkeypatch, B, n_pad):
    # the reference imports enable_x64 from jax.experimental, which this jax
    # no longer has; provide the name (the frozen JAX package is not edited)
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    seg, pairs = _k1_inputs(B * 7 + n_pad, n_pad, B)
    ref_c, ref_s = jax.jit(lambda s, p: pallas_groupby.grouped_sums(s, p, B, n_pad, interpret=True))(
        jnp.asarray(seg), [(jnp.asarray(v.astype(np.int64)), jnp.asarray(w)) for v, w in pairs]
    )
    orc_c, orc_s = pallas_groupby.np_reference(seg, [(v.astype(np.int64), w) for v, w in pairs], B)
    launches = gs.LAUNCHES
    c, s = gs.grouped_sums(
        torch.from_numpy(seg), [(torch.from_numpy(v), torch.from_numpy(w)) for v, w in pairs], B, n_pad, device="cpu"
    )
    assert gs.LAUNCHES == launches  # the CPU path launches nothing
    assert c.dtype == s.dtype == torch.int64 and tuple(c.shape) == (B, len(pairs))
    assert np.array_equal(c.numpy(), np.asarray(ref_c)) and np.array_equal(s.numpy(), np.asarray(ref_s))
    assert np.array_equal(c.numpy(), orc_c) and np.array_equal(s.numpy(), orc_s)


def _bounded_inputs(seed, n_pad, B):
    """Lanes as the engine builds them, with bounds: COUNT(*) and occupancy
    (zero values, constant (0, 0)), a constant lane lo == hi != 0, lanes
    sharing one weight object, a lane sharing its (value, weight) pair with
    another, a narrow int32 lane at ±(2^31 - 1), an int64 lane near ±2^45
    without bounds, and an int64 lane with a narrow proven span."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, B, n_pad)
    seg[rng.random(n_pad) < 0.1] = B + 3
    seg[rng.random(n_pad) < 0.05] = -2
    mask = rng.random(n_pad) < 0.85
    other = rng.random(n_pad) < 0.6
    zero = np.zeros(n_pad, np.int64)
    const = np.full(n_pad, -7, np.int64)
    narrow = rng.integers(100, 5001, n_pad).astype(np.int32)
    i32 = rng.integers(-(2**31) + 1, 2**31, n_pad).astype(np.int32)
    i32[rng.random(n_pad) < 0.05] = 2**31 - 1
    i32[rng.random(n_pad) < 0.05] = -(2**31) + 1
    big = rng.integers(-_VMAX, _VMAX + 1, n_pad)
    big[rng.random(n_pad) < 0.05] = _VMAX
    span = rng.integers(9_000_000, 9_500_000, n_pad)
    lanes = [
        ((zero, mask), (0, 0)),  # COUNT(*)
        ((narrow, mask), (100, 5000)),
        ((narrow, mask), (100, 5000)),  # SUM and AVG of one argument
        ((const, other), (-7, -7)),
        ((i32, other), (-(2**31) + 1, 2**31 - 1)),
        ((i32, mask), None),
        ((big, mask), None),
        ((span, other), (9_000_000, 9_499_999)),
        ((zero, mask), (0, 0)),  # occupancy
    ]
    return seg.astype(np.int32), [p for p, _ in lanes], [b for _, b in lanes]


def _port_pairs(pairs):
    # a numpy array shared by identity stays one tensor object, as the
    # engine shares its mask
    memo = {}
    return [(memo.setdefault(id(v), torch.from_numpy(v)), memo.setdefault(id(w), torch.from_numpy(w))) for v, w in pairs]


@pytest.mark.parametrize("B,n_pad", [(65, 1024), (160, 8192), (512, 8192)])
def test_k1_plain_with_bounds_matches_pallas_and_oracle(monkeypatch, B, n_pad):
    """The bounds argument (constant lanes, shared weights, shared
    value/weight pairs) leaves the function the reference's: zero and
    constant lanes go to the reference as explicit value tensors."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    seg, pairs, bounds = _bounded_inputs(B + n_pad, n_pad, B)
    ref_c, ref_s = jax.jit(lambda s, p: pallas_groupby.grouped_sums(s, p, B, n_pad, interpret=True))(
        jnp.asarray(seg), [(jnp.asarray(v.astype(np.int64)), jnp.asarray(w)) for v, w in pairs]
    )
    orc_c, orc_s = pallas_groupby.np_reference(seg, [(v.astype(np.int64), w) for v, w in pairs], B)
    c, s = gs.grouped_sums(torch.from_numpy(seg), _port_pairs(pairs), B, n_pad, bounds, device="cpu")
    assert np.array_equal(c.numpy(), np.asarray(ref_c)) and np.array_equal(s.numpy(), np.asarray(ref_s))
    assert np.array_equal(c.numpy(), orc_c) and np.array_equal(s.numpy(), orc_s)


def _emulate_kernel(seg, pairs, B, bounds, rows_per_block):
    """The kernel's arithmetic in numpy, launch by launch as ``gs.plan``
    lays it out: per block of rows, u32 counts per weight column and u32
    sums of each slot's 16-bit pieces of (value - lo), each checked to stay
    below 2^32; recombined modulo 2^64 with count × lo."""
    L = len(pairs)
    out_c = np.zeros((B, L), np.uint64)
    out_s = np.zeros((B, L), np.uint64)
    live = (seg >= 0) & (seg < B)
    for g in gs.plan(pairs, bounds, B):
        for r0 in range(0, len(seg), rows_per_block):
            sl = slice(r0, r0 + rows_per_block)
            cnt = []
            for w in g.weights:
                m = live[sl] & w[sl].numpy()
                cnt.append(np.bincount(seg[sl][m], minlength=B).astype(np.uint64))
            pieces = []
            for v, lo, wcol, npieces in g.slots:
                m = live[sl] & g.weights[wcol][sl].numpy()
                u = v[sl].numpy()[m].astype(np.int64).astype(np.uint64) - np.uint64(lo % 2**64)
                ps = []
                for q in range(npieces):
                    part = np.zeros(B, np.uint64)
                    np.add.at(part, seg[sl][m], (u >> np.uint64(16 * q)) & np.uint64(0xFFFF))
                    assert int(part.max(initial=0)) < 2**32  # the u32 cell never wraps
                    ps.append(part)
                pieces.append(ps)
            for col, wcol, slot, lo in g.lanes:
                c = cnt[wcol]
                base = pieces[slot] if slot >= 0 else []
                lo_k = g.slots[slot][1] if slot >= 0 else lo
                with np.errstate(over="ignore"):
                    s = c * np.uint64(lo_k % 2**64)
                    for q, part in enumerate(base):
                        s = s + (part << np.uint64(16 * q))
                    out_c[:, col] += c
                    out_s[:, col] += s
    return out_c.astype(np.int64), out_s.astype(np.int64)


@pytest.mark.parametrize("B,rows_per_block", [(65, 2048), (160, 65536)])
def test_k1_launch_plan_arithmetic_matches_oracle(B, rows_per_block):
    """The launch plan the kernel receives (slots, biases, piece counts,
    lane map) gives the oracle's answer under the kernel's arithmetic, with
    no 32-bit cell wrapping at the kernel's 65,536 rows per block, including
    every row of the block in one bucket at the 2^45 edge."""
    n_pad = 65536 * 2
    seg, pairs, bounds = _bounded_inputs(B, n_pad, B)
    hot = np.full(n_pad, B - 1, np.int32)
    edge = np.full(n_pad, _VMAX, np.int64)
    edge[1::2] = -_VMAX
    every = np.ones(n_pad, bool)
    for s_, p_, b_ in ((seg, pairs, bounds), (hot, pairs + [(edge, every)], bounds + [None])):
        port = _port_pairs(p_)
        got = _emulate_kernel(s_, port, B, b_, rows_per_block)
        want = pallas_groupby.np_reference(s_, [(v.astype(np.int64), w) for v, w in p_], B)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])


def test_k1_launch_plan_dedups_and_splits():
    n = 1024
    mask = torch.ones(n, dtype=torch.bool)
    v = torch.arange(n, dtype=torch.int64)
    v32 = torch.arange(n, dtype=torch.int32)
    pairs = [(torch.zeros(n, dtype=torch.int64), mask), (v32, mask), (v32, mask), (v, mask), (v, torch.ones(n, dtype=torch.bool))]
    bounds = [(0, 0), (0, 1023), (0, 1023), None, (0, 1023)]
    (g,) = gs.plan(pairs, bounds, 160)
    assert len(g.weights) == 2  # mask and the second weight tensor
    assert [(sv.dtype, lo, w, p) for sv, lo, w, p in g.slots] == [
        (torch.int32, 0, 0, 1),  # int32 slots first; lanes 1 and 2 share it
        (torch.int64, -(1 << 45), 0, 3),  # no bounds: the 2^45 contract
        (torch.int64, 0, 1, 1),
    ]
    assert [lane[2] for lane in g.lanes] == [-1, 0, 0, 1, 2]
    # 40 unbounded int64 lanes with their own weights (4 cells each): the
    # 32-lane cap splits them at B = 65, the 200 KB table cap (100 cells) at
    # B = 512
    many = [(torch.zeros(n, dtype=torch.int64), torch.ones(n, dtype=torch.bool)) for _ in range(40)]
    assert [len(x.lanes) for x in gs.plan(many, None, 65)] == [32, 8]
    assert [len(x.lanes) for x in gs.plan(many, None, 512)] == [25, 15]


@pytest.mark.parametrize(
    "values,bounds",
    [
        (np.full(1024, -6, np.int64), (-7, -7)),  # a constant lane off its value
        (np.full(1024, 5001, np.int32), (100, 5000)),  # past a proven span
        (np.full(1024, 1 << 46, np.int64), None),  # past the 2^45 contract
    ],
)
def test_k1_plain_rejects_values_outside_their_bounds(values, bounds):
    """The kernel trusts a lane's bounds, so the plain version holds every
    weighted live value to them; dead and unweighted rows may hold anything."""
    n = 1024
    seg = torch.full((n,), 3, dtype=torch.int32)
    seg[:512] = 70  # dead at B = 65
    w = torch.zeros(n, dtype=torch.bool)
    w[256:] = True
    v = torch.from_numpy(values)
    inside = v.clone()
    inside[512:] = bounds[0] if bounds is not None else 0
    gs.grouped_sums(seg, [(inside, w)], 65, n, [bounds], device="cpu")  # outside only where dead or unweighted
    with pytest.raises(ValueError, match="outside the lane's bounds"):
        gs.grouped_sums(seg, [(v, w)], 65, n, [bounds], device="cpu")


def test_k1_rejects_what_the_kernel_does_not_take():
    seg = torch.zeros(1024, dtype=torch.int32)
    pair = [(torch.zeros(1024, dtype=torch.int64), torch.ones(1024, dtype=torch.bool))]
    with pytest.raises(ValueError, match="multiple"):
        gs.grouped_sums(torch.zeros(1000, dtype=torch.int32), pair, 65, 1000, device="cpu")
    with pytest.raises(ValueError, match="B must be"):
        gs.grouped_sums(seg, pair, 513, 1024, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        gs.grouped_sums(seg.long(), pair, 65, 1024, device="cpu")
    with pytest.raises(ValueError, match="bool"):
        gs.grouped_sums(seg, [(pair[0][0], pair[0][1].to(torch.int8))], 65, 1024, device="cpu")


def _dot_inputs(seed, n, B):
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, B + 3, n).astype(np.int32)  # dead rows >= B
    specs = [
        (rng.integers(-5000, 9_000_000, n), (-5000, 9_000_000)),
        (rng.integers(0, 11, n), (0, 10)),
        (rng.integers(-(2**40), 2**40, n), (-(2**40), 2**40)),
        (np.zeros(n, dtype=np.int64), (0, 0)),  # count lane
        (rng.integers(-(2**31) + 1, 2**31 - 1, n).astype(np.int32), None),  # dtype envelope
    ]
    mask = rng.random(n) < 0.85
    weights = [mask, rng.random(n) < 0.7, mask, mask, rng.random(n) < 0.9]
    return seg, [(d, w) for (d, _), w in zip(specs, weights)], [b for _, b in specs]


def _as_ref(pairs):
    # weight lanes shared by identity stay shared, as the dot plan dedups them
    memo = {}
    out = []
    for v, w in pairs:
        out.append((jnp.asarray(v), memo.setdefault(id(w), jnp.asarray(w))))
    return out


def _as_port(pairs):
    memo = {}
    return [(torch.from_numpy(v), memo.setdefault(id(w), torch.from_numpy(w))) for v, w in pairs]


@pytest.mark.parametrize("B", [12, 64])
@pytest.mark.parametrize("with_bounds", [True, False])
def test_dot_route_matches_reference(B, with_bounds):
    n = 20_000
    seg, pairs, bounds = _dot_inputs(B, n, B)
    if not with_bounds:
        # unbounded lanes must fit the int32 dtype envelope
        pairs = [(v.astype(np.int32) if v.dtype == np.int64 and np.abs(v).max() < 2**31 else v, w) for v, w in pairs]
        pairs = [p for p in pairs if p[0].dtype == np.int32]
        bounds = None
    rc, rs = ref_dot.grouped_sums_dot(jnp.asarray(seg), _as_ref(pairs), B, n, bounds)
    pc, ps = port_dot.grouped_sums_dot(torch.from_numpy(seg), _as_port(pairs), B, n, bounds)
    assert np.array_equal(pc.numpy(), np.asarray(rc)) and np.array_equal(ps.numpy(), np.asarray(rs))
    oc, os_ = pallas_groupby.np_reference(seg, [(v.astype(np.int64), w) for v, w in pairs], B)
    assert np.array_equal(pc.numpy(), oc) and np.array_equal(ps.numpy(), os_)


def test_dot_route_chunks_sum_exactly(monkeypatch):
    """Several int32-accumulated chunks (the 2^23-row chunk edge, shrunk)
    sum to the unchunked result, with a ragged last chunk."""
    n, B = 5000, 40
    seg, pairs, bounds = _dot_inputs(5, n, B)
    whole = port_dot.grouped_sums_dot(torch.from_numpy(seg), _as_port(pairs), B, n, bounds)
    monkeypatch.setattr(port_dot, "_CHUNK", 1024)
    chunked = port_dot.grouped_sums_dot(torch.from_numpy(seg), _as_port(pairs), B, n, bounds)
    assert torch.equal(whole[0], chunked[0]) and torch.equal(whole[1], chunked[1])
