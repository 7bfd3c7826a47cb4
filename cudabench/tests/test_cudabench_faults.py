"""A run with the timed path broken underneath comes out not correct.

Each fault a SQL cell can have, planted where the answer is produced:
an answer altered (a value of a cop task's chunk, or of the MPP gather's),
half the work left out (every other region's cop task, or half the
gather's rows), and a stale answer (a session handing back the previous
statement's rows: the state left unchanged). One card has no exchange
between cards to leave out."""

import dataclasses

import pytest
import rehearsal


def _altered(chunk):
    from tidb_tpu_torch.utils.chunk import Chunk

    if not len(chunk):
        return chunk
    cols = list(chunk.columns)
    for i, c in enumerate(cols):
        if c.data.dtype.kind in "iuf" and c.validity[0]:
            data = c.data.copy()
            data[0] += 1
            cols[i] = dataclasses.replace(c, data=data)
            break
    return Chunk(cols)


def _halved(chunk):
    return chunk.slice(0, len(chunk) // 2)


@pytest.fixture
def cop_fault(monkeypatch):
    from tidb_tpu_torch.copr import client
    from tidb_tpu_torch.kv.kv import StoreType

    def plant(fault):
        engines = client._engines()
        orig = engines[StoreType.GPU]

        def broken(store, dag, region, ranges, read_ts, **kw):
            chunk = orig(store, dag, region, ranges, read_ts, **kw)
            if fault == "altered":
                return _altered(chunk)
            return chunk.slice(0, 0) if region.region_id % 2 else chunk

        monkeypatch.setitem(engines, StoreType.GPU, broken)

    return plant


@pytest.fixture
def gather_fault(monkeypatch):
    from tidb_tpu_torch.parallel.gather import MPPGatherExec

    def plant(fault):
        orig = MPPGatherExec.execute

        def broken(self):
            chunk = orig(self)
            return _altered(chunk) if fault == "altered" else _halved(chunk)

        monkeypatch.setattr(MPPGatherExec, "execute", broken)

    return plant


@pytest.fixture
def stale(monkeypatch):
    from tidb_tpu_torch.session.session import Session

    orig = Session.query

    def previous(self, sql):
        rows = orig(self, sql)
        last = getattr(self, "_stale_rows", None)
        self._stale_rows = rows
        return rows if last is None else last

    monkeypatch.setattr(Session, "query", previous)


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_lineitem_cop_faults_are_not_correct(cop_fault, fault):
    cop_fault(fault)
    res = rehearsal.run("lineitem.agg")
    assert not res["correct"] and res["checks"]["wrong_statements"]["value"] > 0


@pytest.mark.parametrize("fault", ["altered", "half"])
def test_star_gather_faults_are_not_correct(gather_fault, fault):
    gather_fault(fault)
    res = rehearsal.run("star.joins")
    assert not res["correct"] and res["checks"]["wrong_statements"]["value"] > 0


@pytest.mark.parametrize("cell", ["lineitem.agg", "star.joins"])
def test_stale_answers_are_not_correct(stale, cell):
    res = rehearsal.run(cell)
    assert not res["correct"] and res["checks"]["wrong_statements"]["value"] > 0
