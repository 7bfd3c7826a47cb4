"""TPC-H Q17 (small-quantity-order revenue) over lineitem ⋈ part."""

import numpy as np

from cudabench.reference import avg, dec, lane

LIMIT = None


def rows(t: dict, p: dict, numeric: str) -> list[tuple]:
    li, part = t["lineitem"], t["part"]
    lpk, lq, lp = li["l_partkey"], li["l_quantity"], li["l_extendedprice"]
    chosen = part["p_partkey"][(part["p_brand"] == p["brand"].encode()) & (part["p_container"] == p["container"].encode())]
    rows_of = np.isin(lpk, chosen)
    pk, q = lpk[rows_of], lane(lq[rows_of], numeric)
    keys, (sq, cnt) = _sums(pk, q)
    # AVG(l_quantity) per part at scale 6; 0.2 * AVG at scale 7 against
    # the quantity at scale 2 (exact), or the float product (control)
    limit = {int(k): avg(s, int(n)) for k, s, n in zip(keys, sq, cnt)}
    if numeric == "exact":
        m = q * 10**5 < 2 * np.array([limit[int(k)] for k in pk], dtype=np.int64)
    else:
        m = q < np.array([limit[int(k)] for k in pk], dtype=q.dtype) * q.dtype.type(0.2) / 10**4
    if not m.any():
        return [(None,)]
    total = lane(lp[rows_of][m], numeric).sum()
    if numeric == "exact":
        v = (abs(int(total)) * 10**4 + 3) // 7  # over 7.0 at scale 6, half away from zero
        return [(dec(v if total >= 0 else -v, 6),)]
    return [(dec(total * 10**4 / 7, 6),)]


def _sums(pk: np.ndarray, q: np.ndarray):
    order = np.argsort(pk, kind="stable")
    ks = pk[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    return ks[starts], (np.add.reduceat(q[order], starts), np.diff(np.r_[starts, len(ks)]))
