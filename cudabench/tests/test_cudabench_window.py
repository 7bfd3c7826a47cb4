"""A traced rehearsal with the program's window
(``tidb_tpu_torch.utils.tracing.start_window``) recording beside the
harness: the harness reads what it read without it, and the window holds
the phase spans of the cell's device path."""

import pytest
import rehearsal

COP_PHASES = {"cop.snapshot", "cop.bind", "cop.inputs", "cop.program", "cop.issue", "cop.sync", "cop.decode"}
MPP_PHASES = {"mpp.prepare", "mpp-inputs", "mpp.program", "mpp.issue", "mpp.drain", "mpp.merge"}


@pytest.mark.parametrize("cell", ["lineitem.agg", "star.joins"])
def test_rehearsal_with_the_window_recording(cell):
    from tidb_tpu_torch.utils import tracing

    plain = rehearsal.run(cell, trace=True)
    tracing.start_window()
    try:
        recorded = rehearsal.run(cell, trace=True)
    finally:
        win = tracing.stop_window()
    assert plain["correct"] and recorded["correct"]
    # every existing metric is still reported; the programs built in the
    # window, the one reading a 1 s rehearsal repeats exactly, are unchanged
    assert set(plain["metrics"]) == set(recorded["metrics"])
    assert recorded["metrics"]["ops.builds_in_window"] == plain["metrics"]["ops.builds_in_window"]
    names = {sp.name for sp in win.spans}
    assert "statement" in names
    assert (COP_PHASES if cell == "lineitem.agg" else MPP_PHASES) <= names
