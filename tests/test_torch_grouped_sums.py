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
