"""GROUP BY ... WITH ROLLUP in the PyTorch port, held against the reference.

The planner pushes one rollup partial aggregation into the reader; the
port's program computes every grouping set in one pass, a (G+1)-hot int8
dot over dictionary-coded keys. The shapes of tests/test_rollup.py (two
keys, one key, GROUPING(), GROUPING in HAVING) run over string keys (a
rollup key needs a dictionary domain on the device) through
``tidb_tpu_torch.open(device="cpu")`` on ``gpu`` and through
``tidb_tpu.open()`` on ``tpu`` and ``host``: equal rows, every cop task on
``gpu``, none degraded, at one block, over fused blocks (the blockwise dot)
and over per-block programs.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import tidb_tpu  # noqa: E402
import tidb_tpu_torch  # noqa: E402
from tidb_tpu import config as ref_config  # noqa: E402
from tidb_tpu.copr import colcache as ref_colcache  # noqa: E402
from tidb_tpu.copr import tpu_engine  # noqa: E402
from tidb_tpu.executor.load import bulk_load as ref_bulk_load  # noqa: E402
from tidb_tpu_torch import config as port_config  # noqa: E402
from tidb_tpu_torch.copr import colcache as port_colcache  # noqa: E402
from tidb_tpu_torch.copr import gpu_engine  # noqa: E402
from tidb_tpu_torch.executor.load import bulk_load  # noqa: E402

N = 4000
# (rows per device block, most blocks fused, engine path)
LAYOUTS = {
    "one_block": (1 << 22, 8, "single"),
    "blockwise": (1024, 8, "blockwise dot"),
    "per_block": (1024, 2, "per-block stacked"),
}
QUERIES = {
    "two_keys": "SELECT r, c, SUM(v), COUNT(*) FROM s GROUP BY r, c WITH ROLLUP",
    "one_key": "SELECT r, SUM(v) FROM s GROUP BY r WITH ROLLUP",
    "grouping": (
        "SELECT r, GROUPING(r), GROUPING(c), SUM(v) FROM s"
        " GROUP BY r, c WITH ROLLUP ORDER BY GROUPING(r), r, GROUPING(c), SUM(v)"
    ),
    "grouping_having": (
        "SELECT r, SUM(v) FROM s GROUP BY r, c WITH ROLLUP HAVING GROUPING(c) = 1 AND GROUPING(r) = 0 ORDER BY r"
    ),
    "count_avg": "SELECT c, COUNT(v), AVG(v), COUNT(*) FROM s WHERE v >= 10 GROUP BY c WITH ROLLUP",
}
ORDERED = ("grouping", "grouping_having")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _layout(monkeypatch, block: int, fuse_max: int):
    for mod in (ref_colcache, port_colcache):
        monkeypatch.setattr(mod, "DEVICE_BLOCK_ROWS", block)
    for mod in (tpu_engine, gpu_engine):
        monkeypatch.setattr(mod, "_BLOCK", block)
        monkeypatch.setattr(mod, "_FUSE_MAX_NB", fuse_max)


def _open_s():
    """(reference, port): s (r VARCHAR(2), c VARCHAR(3), v BIGINT) with the
    same 4,000 rows, NULLs in every column."""
    rng = np.random.default_rng(3)
    r = np.array([b"r1", b"r2", b"r3", b"r4"])[rng.integers(0, 4, N)]
    c = np.array([b"c1", b"c2", b"c3", b"c4", b"c5", b"c6", b"c7"])[rng.integers(0, 7, N)]
    v = rng.integers(1, 100, N)
    data = [
        [None if i % 53 == 1 else x for i, x in enumerate(r)],
        [None if i % 61 == 2 else x for i, x in enumerate(c)],
        [None if i % 47 == 3 else int(x) for i, x in enumerate(v)],
    ]
    ref = tidb_tpu.open(region_split_keys=1 << 62)
    port = tidb_tpu_torch.open(region_split_keys=1 << 62, device="cpu")
    for db, load in ((ref, ref_bulk_load), (port, bulk_load)):
        db.execute("CREATE TABLE s (r VARCHAR(2), c VARCHAR(3), v BIGINT)")
        load(db, "s", data)
    return ref, port


def _rows(db, sql, engine, ordered):
    s = db.session()
    s.execute(f"SET tidb_isolation_read_engines='{engine}'")
    rows = s.query(sql)
    return (rows if ordered else sorted(rows, key=repr)), s.exec_summary


def _spy_tasks(monkeypatch):
    seen = []
    real = gpu_engine.execute_region

    def spy(region, dag, ranges, warn=None, device="cuda", stats=None):
        st = {} if stats is None else stats
        seen.append(st)
        return real(region, dag, ranges, warn, device, st)

    monkeypatch.setattr(gpu_engine, "execute_region", spy)
    return seen


def _check(ref, port, name, tasks, path):
    sql, ordered = QUERIES[name], name in ORDERED
    del tasks[:]
    got, summ = _rows(port, sql, "gpu", ordered)
    assert summ.engines == {"gpu": 1} and summ.degraded == {}
    assert [(st["path"], st["routes"]) for st in tasks] == [(path, ("rollup",))]
    assert got == _rows(ref, sql, "tpu", ordered)[0]
    assert got == _rows(ref, sql, "host", ordered)[0]
    return got


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("name", list(QUERIES))
def test_rollup_matches_reference_engines(monkeypatch, layout, name):
    block, fuse_max, path = LAYOUTS[layout]
    _layout(monkeypatch, block, fuse_max)
    ref, port = _open_s()
    tasks = _spy_tasks(monkeypatch)
    got = _check(ref, port, name, tasks, path)
    if name == "two_keys":
        # one grand total over every line: both keys rolled up
        totals = [r for r in got if r[3] == N]
        assert len(totals) == 1 and totals[0][:2] == (None, None)
    for db in (ref, port):
        db.stop_background()


def test_rollup_after_writes_reads_the_delta(monkeypatch):
    """WITH ROLLUP over a pinned entry with committed changes pending: the
    delta operand folds in on the concatenated path."""
    _layout(monkeypatch, 1024, 8)
    knobs = {"device_delta_cap": 64, "device_delta_merge_rows": 8, "device_delta_min_rows": 1}
    for cfg in (ref_config, port_config):
        monkeypatch.setattr(cfg, "_CURRENT", dataclasses.replace(cfg.current(), **knobs))
    ref, port = _open_s()
    for db in (ref, port):
        db.query("SELECT COUNT(*) FROM s")
        db.execute("UPDATE s SET v = v + 1000 WHERE v < 2")
        db.execute("INSERT INTO s VALUES ('r2', 'c7', 5), (NULL, 'c1', 7)")
    tasks = _spy_tasks(monkeypatch)
    _check(ref, port, "two_keys", tasks, "fused")
    assert tasks[0]["delta_rows"] > 0  # the delta has no per-block shape: no blockwise dot
    for db in (ref, port):
        db.stop_background()
