"""The numpy reference against the port on the CPU, and the control: the
reference in the next lower precision has to come out as not correct."""

import pytest
import rehearsal

from cudabench import control, data, harness


@pytest.mark.parametrize("cell", ["lineitem.agg", "star.joins"])
def test_port_on_the_cpu_equals_the_reference_on_every_statement(cell):
    res = rehearsal.run(cell)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell, rows", [("lineitem.agg", 1_000_000), ("star.joins", 200_000)])
def test_the_control_is_not_correct(cell, rows):
    """At the cell's size the control runs on the chip machine
    (``python3 -m cudabench.control``); here at a size whose sums still
    pass 2**53 (Q1's charge at scale 6) or 2**24 (float32)."""
    _entry, config, traffic, _e, _p = harness.cell_spec(rehearsal.bench(), cell)
    tables = data.generate(config, rehearsal.SEED, {"lineitem": rows})
    wrong = control.wrong_statements(traffic, tables, traffic["control"])
    assert wrong > control.LIMIT
    assert control.wrong_statements(traffic, tables, "exact") == 0
