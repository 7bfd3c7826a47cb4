"""TPC-H lineitem alone: the fourteen columns of ``data.lineitem_sf1``,
string codes decoded to their bytes."""

import numpy as np

from cudabench.data import LINESTATUS, RETURNFLAGS, SHIPINSTRUCTS, SHIPMODES, lineitem_sf1, named

STRINGS = {4: RETURNFLAGS, 5: LINESTATUS, 7: SHIPMODES, 8: SHIPINSTRUCTS}


def generate(seed: int, rows: dict, config: dict) -> dict:
    cols = lineitem_sf1(seed, rows["lineitem"])
    for slot, values in STRINGS.items():
        cols[slot] = np.array(values)[cols[slot]]
    return {"lineitem": named(config, "lineitem", [cols[i] for i in range(len(cols))])}
