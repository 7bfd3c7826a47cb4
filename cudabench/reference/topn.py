"""The twenty highest-priced lines of lineitem ⋈ orders, ties broken by
order key and part key."""

import numpy as np

from cudabench.reference import date, dec, lookup

LIMIT = 20


def rows(t: dict, p: dict, numeric: str) -> list[tuple]:
    li, o = t["lineitem"], t["orders"]
    oi, found = lookup(o["o_orderkey"], li["l_orderkey"])
    price = li["l_extendedprice"].astype(np.int64 if numeric == "exact" else np.dtype(numeric))
    idx = np.flatnonzero(found)
    # every line priced at or above the LIMIT-th highest is a candidate
    cut = np.partition(price[idx], len(idx) - min(LIMIT, len(idx)))[len(idx) - min(LIMIT, len(idx))]
    cand = idx[price[idx] >= cut]
    order = cand[np.lexsort((li["l_partkey"][cand], li["l_orderkey"][cand], -price[cand]))]
    return [(dec(price[i], 2), int(li["l_orderkey"][i]), int(li["l_partkey"][i]), date(o["o_orderdate"][oi[i]]))
            for i in order]
