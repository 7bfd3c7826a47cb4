"""TPC-H Q1 (pricing summary report) over lineitem."""

import numpy as np

from cudabench.reference import avg, by_key, days, dec, lane

LIMIT = None


def rows(t: dict, p: dict, numeric: str) -> list[tuple]:
    li = t["lineitem"]
    m = li["l_shipdate"] <= days(p["date"])
    # one-byte flags: the group is (returnflag byte, linestatus byte), in
    # ORDER BY order
    group = li["l_returnflag"][m].view(np.uint8).astype(np.uint16) << 8 | li["l_linestatus"][m].view(np.uint8)
    qty, price, disc, tax = (lane(li[c][m], numeric) for c in ("l_quantity", "l_extendedprice", "l_discount", "l_tax"))
    dp = price * (100 - disc)
    keys, (sq, sp, sd, sdp, sch, cnt) = by_key(group, qty, price, disc, dp, dp * (100 + tax), np.ones(len(qty), np.int64))
    return [
        (chr(k >> 8), chr(k & 0xFF), dec(a, 2), dec(b, 2), dec(c, 4), dec(d, 6),
         dec(avg(a, int(n)), 6), dec(avg(b, int(n)), 6), dec(avg(s, int(n)), 6), int(n))
        for k, a, b, s, c, d, n in zip(keys.tolist(), sq, sp, sd, sdp, sch, cnt)
    ]
