"""Revenue by order date over lineitem ⋈ orders, the ten largest (the
reference bench's Q3 shape)."""

import numpy as np

from cudabench.reference import by_key, date, dec, lane, lookup

LIMIT = 10


def rows(t: dict, p: dict, numeric: str) -> list[tuple]:
    li, o = t["lineitem"], t["orders"]
    oi, found = lookup(o["o_orderkey"], li["l_orderkey"])
    keys, (rev,) = by_key(o["o_orderdate"][oi[found]], lane(li["l_extendedprice"][found], numeric))
    order = np.lexsort((keys, -rev))
    return [(date(keys[i]), dec(rev[i], 2)) for i in order]
