"""The frozen generators equal the smoke script's at a small size."""

import numpy as np
import pytest

import chip_smoke
from cudabench import data

N = 20_000


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_lineitem_generators_equal_the_smoke_scripts(seed):
    a, b = data.lineitem_sf1(seed, N), chip_smoke.lineitem_sf1(seed, N)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert np.array_equal(data.lineitem_partkey(seed, N), chip_smoke.lineitem_partkey(seed, N))


@pytest.mark.parametrize("seed", [5, 2**31 + 3])
def test_mpp_tables_equal_the_smoke_scripts(seed):
    cols = data.lineitem_sf1(seed, N)
    pk = data.lineitem_partkey(seed, N)
    a = data.mpp_tables(cols, pk, seed, n_part=3_000, n_cust=1_500)
    b = chip_smoke.mpp_tables(cols, pk, seed, n_part=3_000, n_cust=1_500)
    assert a.keys() == b.keys()
    for t in a:
        assert len(a[t]) == len(b[t]) and all(np.array_equal(x, y) for x, y in zip(a[t], b[t]))


def test_generate_names_the_configurations_columns():
    from cudabench import harness

    for cell in ("lineitem.agg", "star.joins"):
        config = harness.cell_spec(harness.load_json(harness.Path(__file__).resolve().parents[2] / "BENCHMARK.json"),
                                   cell)[1]
        t = data.generate(config, 11, {"lineitem": 1_000})
        assert list(t) == list(config["tables"])
        for name, spec in config["tables"].items():
            assert list(t[name]) == [c["name"] for c in spec["columns"]]
            assert len({len(v) for v in t[name].values()}) == 1
