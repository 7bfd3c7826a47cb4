"""The port on a CUDA card: K1 against its plain version and the engine's
card path against its CPU path. Every test is marked ``gpu`` and skips
without a card. The file imports neither jax nor tidb_tpu, so on a machine
with a card and no JAX it runs alone:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""

import json
import os
import sys

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
    assert gs.LAUNCHES == before + -(-L // gs._MAX_LANES)
    pc, ps = gs.grouped_sums_plain(seg, pairs, B, n_pad)
    assert torch.equal(c, pc) and torch.equal(s, ps)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["count", "q6", "q1", "q10", "band"])
def test_engine_on_card_matches_cpu_path(name):
    _need_card()
    with open(os.path.join(DAGS, f"{name}.json")) as f:
        dag = carry.dag_from_pb(json.load(f))
    cols = chip_smoke.lineitem_sf1(seed=3, n=50_000)
    regions = chip_smoke.make_regions(cols, dag.executors[0].table_id)
    for region, ranges in regions:
        cpu = gpu_engine.execute_dag(region, dag, ranges, device="cpu").rows()
        gpu = gpu_engine.execute_dag(region, dag, ranges, device="cuda").rows()
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
        cpu = gpu_engine.execute_dag(region, dag, ranges, device="cpu").rows()
        gpu = gpu_engine.execute_dag(region, dag, ranges, device="cuda").rows()
        assert gpu == cpu and len(gpu) > 0
