"""The port's bench harnesses (``tidb_tpu_torch.bench``: benchdb,
benchdaily, qps) against the reference's: benchdb's jobs on both packages
leave the same table, the regression guard gives the reference's messages,
and benchdaily's lanes that open databases run on ``DEVICE = "cpu"`` with
their device work on the port's ``gpu`` engine (its plain versions)."""

import os
import random
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu.bench import benchdaily as ref_daily  # noqa: E402
from tidb_tpu.bench import benchdb as ref_benchdb  # noqa: E402
from tidb_tpu_torch.bench import benchdaily, benchdb  # noqa: E402
from tidb_tpu_torch.copr import client, gpu_engine, host_engine  # noqa: E402
from tidb_tpu_torch.kv.kv import StoreType  # noqa: E402
from tidb_tpu_torch.parallel import gather  # noqa: E402

JOBS = "create,insert:500,update-random:20,select:20,query:5,analyze,delete:100,gc"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread keeps the lanes' timing gates from racing the
    other test workers for every core of the machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_benchdb_jobs_leave_the_references_table():
    out = {}
    for label, db, run_jobs in (
        ("reference", tidb_tpu.open(), ref_benchdb.run_jobs),
        ("port", tidb_tpu_torch.open(device="cpu"), benchdb.run_jobs),
    ):
        random.seed(7)  # update-random draws its keys from the global RNG
        recs = run_jobs(db, JOBS)
        assert all(r["seconds"] >= 0 for r in recs)
        out[label] = ([r["job"] for r in recs], db.query("SELECT COUNT(*), SUM(id), SUM(v) FROM bench_db"))
        db.stop_background()
    assert out["port"] == out["reference"]
    assert out["port"][0] == JOBS.split(",") and out["port"][1][0][0] == 400


def test_benchdb_cli_opens_on_the_device_it_is_given(monkeypatch, capsys):
    opened = []
    real = tidb_tpu_torch.open
    monkeypatch.setattr(tidb_tpu_torch, "open", lambda *a, **k: opened.append(k) or real(*a, **k))
    benchdb.main(["--device", "cpu", "--run", "create,insert:30,query:2", "--json"])
    assert opened == [{"device": "cpu"}]
    assert '"job": "insert:30"' in capsys.readouterr().out


def test_regression_guard_gives_the_references_messages():
    base = [
        {"name": "q3_join_mpp_ms", "ms": 161.6},
        {"name": "BenchmarkPointGet", "ops_per_sec": 10_000},
        {"name": "BenchmarkOnlyInBaseline", "ops_per_sec": 5},
    ]
    cases = [
        [{"name": "q3_join_mpp_ms", "ms": 207.6}, {"name": "BenchmarkPointGet", "ops_per_sec": 9_500},
         {"name": "BenchmarkBrandNew", "ms": 1.0}],
        [{"name": "q3_join_mpp_ms", "ms": 180.0}, {"name": "BenchmarkPointGet", "ops_per_sec": 9_000}],
        [{"name": "BenchmarkPointGet", "ops_per_sec": 5_000}],
    ]
    got = [benchdaily.check_regression(c, base, tolerance=0.25) for c in cases]
    assert got == [ref_daily.check_regression(c, base, tolerance=0.25) for c in cases]
    assert [len(g) for g in got] == [1, 0, 1] and "q3_join_mpp_ms" in got[0][0]


def test_run_all_records_one_positive_number():
    recs = benchdaily.run_all(["BenchmarkChunkCodec"])
    assert len(recs) == 1 and recs[0]["name"] == "BenchmarkChunkCodec"
    assert recs[0]["ops_per_sec"] > 0 and recs[0]["date"]


def test_the_lanes_are_the_references():
    assert list(benchdaily._BENCHES) == list(ref_daily._BENCHES)
    assert len(benchdaily._BENCHES) == 31


@pytest.fixture
def on_cpu(monkeypatch):
    """``DEVICE = "cpu"``, a spy on the gpu engine's cop tasks and on the
    host engine's, and one on the MPP gathers (the mesh width of each)."""
    monkeypatch.setattr(benchdaily, "DEVICE", "cpu")
    seen = {"gpu": 0, "host": 0, "gathers": []}
    real_gpu, real_host = gpu_engine.execute_dag, host_engine.execute_dag

    def gpu(*a, **k):
        seen["gpu"] += 1
        return real_gpu(*a, **k)

    def host(*a, **k):
        seen["host"] += 1
        return real_host(*a, **k)

    real_attempt = gather.MPPGatherExec._execute_attempt

    def attempt(self, mesh):
        seen["gathers"].append((int(mesh.devices.size), str(mesh.devices[0])))
        return real_attempt(self, mesh)

    # the cop client's engine registry holds the functions it was built with
    engines = client._engines()
    monkeypatch.setitem(engines, StoreType.GPU, gpu)
    monkeypatch.setitem(engines, StoreType.HOST, host)
    monkeypatch.setattr(gather.MPPGatherExec, "_execute_attempt", attempt)
    return seen


@pytest.mark.parametrize("lane", ["freshness_lag_ms", "incremental_load_ms", "qps_q1_concurrent"])
def test_a_device_lane_runs_on_the_gpu_engine(lane, on_cpu):
    assert benchdaily._BENCHES[lane]() > 0
    assert on_cpu["gpu"] > 0 and on_cpu["host"] == 0


@pytest.mark.parametrize("lane,widths", [("q3_join_mpp_ms", {1}), ("scaling_q3_rows_per_s_per_chip", {1, 2, 4, 8})])
def test_an_mpp_lane_runs_its_gathers_on_the_device(lane, widths, on_cpu):
    assert benchdaily._BENCHES[lane]() > 0
    assert on_cpu["gathers"] and {w for w, _ in on_cpu["gathers"]} == widths
    assert {d for _, d in on_cpu["gathers"]} == {"cpu"}


def test_a_fleet_lane_puts_the_device_on_every_store(monkeypatch, on_cpu):
    placed = []
    real = benchdaily._on_device
    monkeypatch.setattr(benchdaily, "_on_device", lambda store: placed.append(type(store).__name__) or real(store))
    assert benchdaily._BENCHES["cluster_snapshot_ms"]() > 0
    # the three served stores, then the SQL layer's fleet over them
    assert placed == ["MemStore"] * 3 + ["ShardedStore"]
    assert on_cpu["host"] == 0
