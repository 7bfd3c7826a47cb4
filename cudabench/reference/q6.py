"""TPC-H Q6 (forecasting revenue change) over lineitem."""

from decimal import Decimal

from cudabench.reference import days, dec, lane

LIMIT = None


def _cents(text: str) -> int:
    return int(Decimal(text).scaleb(2))


def rows(t: dict, p: dict, numeric: str) -> list[tuple]:
    li = t["lineitem"]
    ship, disc, qty = li["l_shipdate"], li["l_discount"], li["l_quantity"]
    m = (ship >= days(p["date"])) & (ship < days(p["date_end"]))
    m &= (disc >= _cents(p["disc_lo"])) & (disc <= _cents(p["disc_hi"])) & (qty < int(p["quantity"]) * 100)
    if not m.any():
        return [(None,)]
    return [(dec((lane(li["l_extendedprice"][m], numeric) * lane(disc[m], numeric)).sum(), 4),)]
