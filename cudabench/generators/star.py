"""lineitem, orders, customer and part of ``data.mpp_tables``. ``rows``
gives lineitem's, part's and customer's row counts; orders has one row
per distinct order key."""

from cudabench.data import lineitem_partkey, lineitem_sf1, mpp_tables, named


def generate(seed: int, rows: dict, config: dict) -> dict:
    n = rows["lineitem"]
    tables = mpp_tables(lineitem_sf1(seed, n), lineitem_partkey(seed, n), seed,
                        n_part=rows["part"], n_cust=rows["customer"])
    return {name: named(config, name, lanes) for name, lanes in tables.items()}
