"""The device builtins through SQL: ``chip_smoke.BUILTIN_QUERIES`` (Q12's and
Q19's lineitem predicates, YEAR/MONTH keys, the band query under NOT, =,
OR and IS NULL, DIV/%/ABS/ROUND/CAST, BIT_COUNT/>>/SQRT/LN) on a
4,000-row lineitem from ``chip_smoke.lineitem_sf1`` split into two
regions, in ``tidb_tpu.open()`` and ``tidb_tpu_torch.open(device="cpu")``.

Each statement must plan ``[gpu]`` on the port where the reference plans
``[tpu]``, run every cop task on ``gpu`` with none degraded and bytes
copied off the device, and return the reference's ``tpu`` and ``host``
rows, the port's ``host`` rows and the numpy oracle's. One case writes
first, so the builtins also run on the delta operand.
"""

import dataclasses
import os
import sys

import jax
import jax.experimental
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu import config as ref_config  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu.kv.tablecodec import record_key as ref_record_key  # noqa: E402
from tidb_tpu_torch import config as port_config  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402
from tidb_tpu_torch.kv.tablecodec import record_key  # noqa: E402

N_ROWS = 4000
BQ = chip_smoke.BUILTIN_QUERIES


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def x64_shim(monkeypatch):
    # the reference's Pallas kernel (band's route) imports enable_x64 from
    # jax.experimental, which this jax no longer has
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


@pytest.fixture(scope="module")
def cols():
    return chip_smoke.lineitem_sf1(seed=11, n=N_ROWS)


def _open_pair(cols):
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    chip_smoke.lineitem_sql(ref, ref_bulk_load, ref_record_key, cols, 2)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(port, bulk_load, record_key, cols, 2)
    return ref, port


@pytest.fixture(scope="module")
def dbs(cols):
    ref, port = _open_pair(cols)
    yield ref, port
    ref.stop_background()
    port.stop_background()


def _rows(db, sql, engine):
    """(rows sorted by repr, the statement's cop-task summary)."""
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines='{engine}'")
    return sorted(s.query(sql), key=repr), s.exec_summary


def _spy_tasks(monkeypatch):
    seen = []
    real = gpu_engine.execute_region

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        st = {} if stats is None else stats
        seen.append(st)
        return real(region, dag, ranges, warn, device, st)

    monkeypatch.setattr(gpu_engine, "execute_region", spy)
    return seen


def test_each_statement_needs_more_than_the_first_six_builtins(monkeypatch, cols):
    """With gpu legal only for plus, minus, mul, lt, le and ge (the port's
    set before the device builtins), every statement plans on the host:
    each needs a builtin this slice made device-legal."""
    from tidb_tpu_torch.expression.registry import REGISTRY

    for name, spec in list(REGISTRY.items()):
        if name not in ("plus", "minus", "mul", "lt", "le", "ge"):
            monkeypatch.setitem(REGISTRY, name, dataclasses.replace(spec, engines=spec.engines - {"gpu"}))
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    chip_smoke.lineitem_sql(port, bulk_load, record_key, {k: v[:200] for k, v in cols.items()}, 2)
    for name, sql in BQ.items():
        plan = "\n".join(r[0] for r in port.query("EXPLAIN " + sql))
        assert "[host]" in plan and "[gpu]" not in plan, name
    port.stop_background()


@pytest.mark.parametrize("name", list(BQ))
def test_builtin_statement_on_gpu_matches_reference(monkeypatch, dbs, cols, name):
    ref, port = dbs
    sql = BQ[name]
    ref_plan = "\n".join(r[0] for r in ref.query("EXPLAIN " + sql))
    port_plan = "\n".join(r[0] for r in port.query("EXPLAIN " + sql))
    assert "[tpu]" in ref_plan and "[host]" not in ref_plan
    assert "[gpu]" in port_plan and "[host]" not in port_plan
    tasks = _spy_tasks(monkeypatch)
    got, summ = _rows(port, sql, "gpu")
    assert summ.engines == {"gpu": 2} and summ.degraded == {}
    assert summ.d2h_bytes > 0
    assert len(tasks) == 2 and all(st["path"] == "single" for st in tasks)
    if name == "bandf":
        # the band query's 160 buckets under a filter: K1's route
        assert [st["routes"] for st in tasks] == [("k1",), ("k1",)]
    assert got == _rows(ref, sql, "tpu")[0]
    assert got == _rows(ref, sql, "host")[0]
    assert got == _rows(port, sql, "host")[0]
    assert chip_smoke.rows_match(got, chip_smoke.builtin_oracle(name, cols))


def test_builtin_statements_after_writes_fold_the_delta(monkeypatch, cols):
    """An UPDATE and an INSERT, then every statement: the port's tasks fold
    the pending changes in as the delta operand (the reference's tpu engine
    folds its own) and both equal the host engines."""
    knobs = {"device_delta_cap": 64, "device_delta_merge_rows": 8, "device_delta_min_rows": 1}
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "_CURRENT", dataclasses.replace(cfg.current(), **knobs))
    ref, port = _open_pair(cols)
    for db in (ref, port):
        db.query(BQ["bandf"])  # the base entries, built before the writes
        db.execute("UPDATE lineitem SET l_quantity = 25.00, l_discount = 0.00 WHERE l_orderkey <= 12")
        db.execute(
            "INSERT INTO lineitem VALUES (30.00, 45000.00, 0.00, 0.05, 'R', 'F', DATE '1994-03-05', 'MAIL', "
            "'DELIVER IN PERSON', 900000, 17, 1, DATE '1994-02-01', DATE '1994-03-20'), (7.00, 9100.00, 0.04, "
            "0.03, 'N', 'O', DATE '1996-02-29', 'AIR', 'DELIVER IN PERSON', 900001, 2, 1, DATE '1996-03-10', "
            "DATE '1996-03-15')"
        )
    tasks = _spy_tasks(monkeypatch)
    for name, sql in BQ.items():
        tasks.clear()
        got, summ = _rows(port, sql, "gpu")
        assert summ.engines == {"gpu": 2} and summ.degraded == {}, name
        assert summ.delta_rows > 0 and any(st["delta_rows"] for st in tasks), name
        assert got == _rows(ref, sql, "tpu")[0], name
        assert got == _rows(ref, sql, "host")[0], name
        assert got == _rows(port, sql, "host")[0], name
    for db in (ref, port):
        db.stop_background()
