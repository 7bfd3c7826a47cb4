"""The benchmark's data: TPC-H tables generated from ``--seed`` in numpy.

Frozen copies of the smoke script's generators (``lineitem_keys``,
``lineitem_sf1``, ``lineitem_partkey``, ``mpp_tables``), kept here so that
no later change to the program or its scripts moves the yardstick. A
configuration names its generator (``generators/<name>.py``); each returns
``{table: {column: array}}`` under the configuration's column names, with
strings as fixed-width bytes, decimals as scaled integers (DECIMAL(12,2))
and dates as days since 1970-01-01.
"""

from __future__ import annotations

import datetime as dt

import numpy as np

RETURNFLAGS = [b"A", b"N", b"R"]
LINESTATUS = [b"F", b"O"]
SHIPMODES = [b"REG AIR", b"AIR", b"RAIL", b"SHIP", b"TRUCK", b"MAIL", b"FOB"]
SHIPINSTRUCTS = [b"DELIVER IN PERSON", b"COLLECT COD", b"NONE", b"TAKE BACK RETURN"]
SEGMENTS = [b"AUTOMOBILE", b"BUILDING", b"FURNITURE", b"HOUSEHOLD", b"MACHINERY"]
CONTAINER_SIZES = ("SM", "LG", "MED", "JUMBO", "WRAP")
CONTAINER_KINDS = ("CASE", "BOX", "BAG", "JAR", "PKG", "PACK", "CAN", "DRUM")
CONTAINERS = [f"{size} {kind}".encode() for size in CONTAINER_SIZES for kind in CONTAINER_KINDS]
SF1_ROWS = 6_001_215


def days(d: dt.date) -> int:
    return (d - dt.date(1970, 1, 1)).days


def lineitem_keys(rng, partkey: np.ndarray, n_supp: int):
    """(l_orderkey, l_suppkey, l_linenumber) in TPC-H §4.2.3's domains:
    consecutive orders of 1..7 lines under the spec's sparse order keys
    (the first 8 of every 32), line numbers 1..7 within an order, and each
    line's supplier one of its part's four."""
    n = len(partkey)
    lines = rng.integers(1, 8, n)  # n orders of at least one line cover n rows
    ends = np.cumsum(lines)
    order = np.searchsorted(ends, np.arange(n), side="right")
    orderkey = (order // 8) * 32 + order % 8 + 1
    linenumber = np.arange(n) - (ends - lines)[order] + 1
    i = rng.integers(0, 4, n)
    suppkey = (partkey + i * (n_supp // 4 + (partkey - 1) // n_supp)) % n_supp + 1
    return orderkey.astype(np.int64), suppkey.astype(np.int64), linenumber.astype(np.int64)


def lineitem_sf1(seed: int, n: int = SF1_ROWS) -> dict:
    """Fourteen lineitem columns by slot, in TPC-H §4.2.3's domains
    (quantity, extendedprice, discount, tax, returnflag, linestatus,
    shipdate, shipmode, shipinstruct, orderkey, suppkey, linenumber,
    commitdate, receiptdate); strings as codes into the lists above."""
    rng = np.random.default_rng(seed)
    qty = rng.integers(1, 51, n)
    partkey = rng.integers(1, 200_001, n)
    retail = 90_000 + (partkey // 10) % 20_001 + 100 * (partkey % 1000)  # cents
    orderdate = rng.integers(days(dt.date(1992, 1, 1)), days(dt.date(1998, 8, 2)) + 1, n)
    ship = orderdate + rng.integers(1, 122, n)
    receipt = ship + rng.integers(1, 31, n)
    current = days(dt.date(1995, 6, 17))
    rf = np.where(receipt <= current, np.where(rng.random(n) < 0.5, 2, 0), 1).astype(np.int32)
    cols = {
        0: qty.astype(np.int64) * 100,
        1: (qty * retail).astype(np.int64),
        2: rng.integers(0, 11, n).astype(np.int64),
        3: rng.integers(0, 9, n).astype(np.int64),
        4: rf,
        5: (ship > current).astype(np.int32),
        6: ship.astype(np.int64),
        7: rng.integers(0, len(SHIPMODES), n).astype(np.int32),
        8: rng.integers(0, len(SHIPINSTRUCTS), n).astype(np.int32),
    }
    cols[9], cols[10], cols[11] = lineitem_keys(rng, partkey, 10_000)
    cols[12] = orderdate + rng.integers(30, 91, n)
    cols[13] = receipt.astype(np.int64)
    return cols


def lineitem_partkey(seed: int, n: int = SF1_ROWS) -> np.ndarray:
    """``lineitem_sf1``'s part keys: its second draw, replayed."""
    rng = np.random.default_rng(seed)
    rng.integers(1, 51, n)
    return rng.integers(1, 200_001, n)


def mpp_tables(cols: dict, partkey: np.ndarray, seed: int, n_part: int = 200_000, n_cust: int = 150_000) -> dict:
    """{table: column arrays}: lineitem (l_orderkey, l_partkey, l_quantity,
    l_extendedprice, l_discount, l_shipdate) from ``cols`` and
    ``partkey``; orders, one per distinct l_orderkey, o_custkey uniform
    over the customer keys not divisible by 3, o_orderdate uniform in
    [1992-01-01, 1998-08-02], o_shippriority 0; customer, c_mktsegment
    uniform over the five segments; part, p_brand 'Brand#MN' (M, N in
    1..5) and p_container one of the 40."""
    rng = np.random.default_rng([seed, 3])
    okeys = np.unique(cols[9])
    with_orders = np.arange(1, n_cust + 1)
    with_orders = with_orders[with_orders % 3 != 0]
    lo, hi = days(dt.date(1992, 1, 1)), days(dt.date(1998, 8, 2))
    brands = np.array([f"Brand#{m}{k}".encode() for m in range(1, 6) for k in range(1, 6)])
    return {
        "lineitem": [cols[9], partkey.astype(np.int64), cols[0], cols[1], cols[2], cols[6]],
        "orders": [
            okeys,
            with_orders[rng.integers(0, len(with_orders), len(okeys))].astype(np.int64),
            rng.integers(lo, hi + 1, len(okeys)).astype(np.int64),
            np.zeros(len(okeys), np.int64),
        ],
        "customer": [np.arange(1, n_cust + 1, dtype=np.int64), np.array(SEGMENTS)[rng.integers(0, 5, n_cust)]],
        "part": [
            np.arange(1, n_part + 1, dtype=np.int64),
            brands[rng.integers(0, len(brands), n_part)],
            np.array(CONTAINERS)[rng.integers(0, len(CONTAINERS), n_part)],
        ],
    }


def named(config: dict, table: str, lanes: list) -> dict:
    """A table's lanes under the configuration's column names."""
    names = [c["name"] for c in config["tables"][table]["columns"]]
    if len(names) != len(lanes):
        raise ValueError(f"{config['name']}: {table} has {len(names)} columns, the generator {len(lanes)}")
    return dict(zip(names, lanes))


def generate(config: dict, seed: int, rows: dict | None = None) -> dict:
    """The configuration's tables from ``seed``, by the generator it names
    (``generators/<name>.py``); ``rows`` overrides the configuration's row
    counts (the CPU tests' small sizes)."""
    import importlib

    counts = {name: t["rows"] for name, t in config["tables"].items()}
    counts.update(rows or {})
    return importlib.import_module(f"cudabench.generators.{config['generator']}").generate(seed, counts, config)
