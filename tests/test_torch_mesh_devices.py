"""The port's device mesh (``tidb_tpu_torch/parallel/mesh.py``) over
logical devices on the CPU.

A mesh entry is a device handle; the shards of one handle form a slab run
by one worker, distinct handles are distinct workers (threads), even on one
physical device. Random lanes from a numpy seed go through the three
collectives at four layouts of four shards — one handle four times (the
virtual slab), four logical devices, two workers of two shards, three plus
one — and every result must equal the virtual slab's bit for bit. The
fragment program (``mpp.build_dist_join_agg``) at those layouts must equal
the reference's at width 4 (``tests/test_torch_mpp.py``'s tolerance).
Further cases: a worker that raises fails every worker, a worker that
never arrives fails the rest after the rendezvous timeout, and no thread
is left behind; which devices a mesh may use, and how ``FORCE_NDEV`` cuts
them (the reference's rule, but one device keeps its virtual slab).
"""

import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_mpp as tm  # noqa: E402
from tidb_tpu_torch.parallel import mesh, mpp  # noqa: E402
from tidb_tpu_torch.parallel.probe import DeviceProber, probe_and_blacklist  # noqa: E402

CPU = torch.device("cpu")
H = mesh.handle(CPU)
L = mesh.logical_devices(CPU, 4)
LAYOUTS = {
    "virtual": [H] * 4,
    "logical": L,
    "2x2": [L[0], L[0], L[1], L[1]],
    "3+1": [L[0]] * 3 + [L[1]],
}


@pytest.fixture(autouse=True)
def clean_mesh_state():
    before = threading.active_count()
    yield
    mesh.FORCE_NDEV = mesh.FORCE_DEVICES = None
    deadline = time.monotonic() + 10
    while threading.active_count() > before and time.monotonic() < deadline:
        time.sleep(0.01)
    assert threading.active_count() == before, "a mesh worker thread outlived its run"


def _lanes(seed, ndev=4):
    """Four shards of three lanes (int64, float64, bool), 3 blocks of 5
    slots per destination."""
    rng = np.random.default_rng(seed)
    n = ndev * 15
    return [
        torch.from_numpy(rng.integers(-(1 << 60), 1 << 60, (ndev, n))),
        torch.from_numpy(rng.normal(0.0, 1e6, (ndev, n))),
        torch.from_numpy(rng.random((ndev, n)) > 0.5),
    ]


def _collective(op):
    def body(sl, *lanes):
        if op == "all_to_all":
            return sl.all_to_all(list(lanes))
        if op == "all_to_all_one":
            return [sl.all_to_all(lanes[0])]
        if op == "all_gather":
            return sl.all_gather(list(lanes))
        return sl.psum([lanes[0], lanes[1]])

    return body


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("op", ["all_to_all", "all_to_all_one", "all_gather", "psum"])
def test_collectives_equal_the_virtual_slab(layout, op):
    lanes = _lanes(3)
    flat = [x.reshape(-1) for x in lanes]
    want = mesh.make_mesh(devices=LAYOUTS["virtual"]).run(_collective(op), flat)[0]
    m = mesh.make_mesh(devices=LAYOUTS[layout])
    per = m.run(_collective(op), flat)
    assert len(per) == len(m.workers)
    for i, w in enumerate(want):
        got = torch.cat([p[i] for p in per])
        assert got.dtype == w.dtype and torch.equal(got, w), (layout, op, i)


def test_module_collectives_are_the_one_slab_ops():
    x = _lanes(4)[0]
    sl = mesh.Slab.of(4)
    assert torch.equal(sl.all_to_all(x), mesh.all_to_all(x, 4))
    assert torch.equal(sl.all_gather(x), mesh.all_gather(x))
    assert torch.equal(sl.psum(x), mesh.psum(x))


def test_placed_lanes_split_by_worker():
    a = np.arange(4 * 8, dtype=np.int64)
    m = mesh.make_mesh(devices=LAYOUTS["3+1"])
    parts = m.place(a)
    assert [tuple(p.shape) for p in parts] == [(24,), (8,)]
    out = m.run(lambda sl, x: (sl.first, sl.k, sl.ndev, x), [parts])
    assert [o[:3] for o in out] == [(0, 3, 4), (3, 1, 4)]
    assert torch.equal(torch.cat([o[3].reshape(-1) for o in out]), torch.from_numpy(a))
    assert m.placement == (("cpu#0", 3), ("cpu#1", 1))
    assert torch.is_tensor(mesh.make_mesh(devices=LAYOUTS["virtual"]).place(a))


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("exchange", ["hash", "broadcast"])
def test_fragment_program_equals_the_reference_at_every_layout(layout, exchange):
    join = mpp.DistJoinSpec(left_keys=[0], right_keys=[0], exchange=exchange, row_cap=2048)
    agg = mpp.DistAggSpec(n_keys=1, sums=[1], group_cap=64)
    cols = tm._star(3, 4)
    want_port, want = tm._run_both(4, join, agg, cols)
    kw = dict(n_left=2, n_right=2, agg_inputs=lambda c: [c[3], c[1]], left_selection=lambda cid, qty: qty > 2)
    m = mesh.make_mesh(devices=LAYOUTS[layout])
    walls: list = []
    out = mpp.build_dist_pipeline(
        m, [join], agg, n_lanes=[2, 2], selections=[kw["left_selection"], None], agg_inputs=kw["agg_inputs"],
        shard_stats=True,
    )(*[tm._t(c) for c in cols], walls=walls)
    got = mpp.to_host(out)
    stats = got.pop()
    assert stats.shape == (2, 4) and int(stats[0].sum()) == 5
    assert [(f, k) for f, k, _t in walls] == [(f, k) for _h, f, k in m.workers]
    assert all(t.ms >= 0 for _f, _k, t in walls)
    assert len(got) == len(want)
    for g, p, w in zip(got, want_port, want):
        tm._close(g, w)
        assert np.array_equal(np.asarray(g), np.asarray(p))
    if len(m.workers) > 1:
        assert isinstance(out, mpp.Sharded)


def test_a_worker_that_raises_fails_every_worker():
    m = mesh.make_mesh(devices=L)
    seen = []

    def body(sl, x):
        if sl.first == 2:
            raise RuntimeError("device lost: injected")
        try:
            return sl.all_gather(x)
        except Exception as exc:
            seen.append(type(exc).__name__)
            raise

    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="device lost") as ei:
        m.run(body, [torch.arange(8)])
    assert ei.value.mpp_device is L[2]
    # the workers that reached the exchange left it with an error (the
    # others never got their turn)
    assert seen and set(seen) == {"_PeerFailed"}
    assert time.monotonic() - t0 < 5


def test_a_worker_that_never_arrives_times_out_the_rest(monkeypatch):
    monkeypatch.setattr(mesh, "RENDEZVOUS_TIMEOUT_S", 0.3)
    m = mesh.make_mesh(devices=LAYOUTS["2x2"])

    def body(sl, x):
        if sl.first == 2:
            time.sleep(1.0)  # past the timeout, then finds the exchange broken
        return sl.psum(x)

    t0 = time.monotonic()
    with pytest.raises(mesh.RendezvousTimeout) as ei:
        m.run(body, [torch.arange(8)])
    assert getattr(ei.value, "mpp_device", None) is None  # blamed by probing
    assert time.monotonic() - t0 < 1.0


def test_cross_worker_bytes_are_counted():
    m = mesh.make_mesh(devices=LAYOUTS["2x2"])
    before = list(m.moved)
    m.run(lambda sl, x: sl.all_gather(x), [torch.arange(8, dtype=torch.int64)])
    # each worker hands its [2, 2] int64 slab to the other
    assert [a - b for a, b in zip(m.moved, before)] == [32, 32]


def test_one_device_keeps_its_virtual_slab():
    assert mesh.available_devices("cpu") == [H]
    mesh.FORCE_NDEV = 4
    m = mesh.make_mesh()
    assert m.devices.size == 4 and len(m.workers) == 1 and m is mesh.make_mesh()
    assert mesh.make_mesh(devices=[CPU]) is m  # a torch device maps to its handle
    mesh.FORCE_NDEV = None
    assert mesh.make_mesh(devices=[CPU]).devices.size == 1
    assert mesh.make_mesh(n_devices=3, devices=[H]).devices.tolist() == [H] * 3


def test_several_devices_are_cut_as_the_reference_cuts_them():
    mesh.FORCE_DEVICES = L
    assert mesh.available_devices("cpu") == L
    assert mesh.make_mesh().devices.tolist() == L
    mesh.FORCE_NDEV = 2
    assert mesh.make_mesh().devices.tolist() == L[:2]
    mesh.FORCE_NDEV = 8
    with pytest.raises(RuntimeError, match="only 4 available"):
        mesh.make_mesh()
    # the survivors of a device loss: FORCE_NDEV takes what there is
    mesh.FORCE_NDEV = 4
    assert mesh.make_mesh(devices=L[1:]).devices.tolist() == L[1:]
    with pytest.raises(RuntimeError):
        mesh.make_mesh(n_devices=4, devices=L[1:])
    with pytest.raises(ValueError, match="contiguous"):
        mesh.make_mesh(n_devices=None, devices=[L[0], L[1], L[0]])


def test_which_devices_a_store_meshes_over():
    # a CUDA store with no index means every visible card (none here)
    assert mesh.available_devices("cuda") == [
        mesh.handle(torch.device("cuda", i)) for i in range(torch.cuda.device_count())
    ]
    assert mesh.handle("cpu") is H and mesh.logical_devices("cpu", 2) == L[:2]
    assert str(L[3]) == "cpu" and L[3].device == CPU and L[3] is not H


def test_the_prober_blames_handles_one_by_one():
    p = DeviceProber()
    p.report_failure(L[1])
    assert p.alive(L) == [L[0], L[2], L[3]]
    assert p.alive([H]) == [H]
    assert probe_and_blacklist(L, p) == 0  # every logical CPU device answers
    assert p.alive(L) == L


def test_many_workers_many_exchanges_under_a_short_switch_interval():
    """16 workers (more than the cores) through 40 rounds of exchanges
    with the interpreter switching threads every 10 µs: every round's
    results equal the virtual slab's and every handed byte is counted."""
    n = 16
    lg = mesh.logical_devices(CPU, n)
    m = mesh.make_mesh(devices=lg)
    rng = np.random.default_rng(29)
    x = torch.from_numpy(rng.integers(-1000, 1000, (n, n * 4)))

    def body(sl, a):
        outs = []
        for r in range(40):
            a = sl.all_to_all(a + r)
            outs.append(sl.psum(a[:, :4]))
        return torch.stack(outs)

    want = mesh.make_mesh(devices=[CPU] * n).run(body, [x.reshape(-1)])[0]
    before = list(m.moved)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        t0 = time.monotonic()
        got = m.run(body, [x.reshape(-1)])
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    assert torch.equal(torch.cat(got, dim=1), want)
    # per round: 15 blocks of 4 int64 to the all_to_all, 15 copies of 4
    # int64 to the psum's gather
    assert [a - b for a, b in zip(m.moved, before)] == [40 * (15 * 4 * 8 + 15 * 4 * 8)] * n
