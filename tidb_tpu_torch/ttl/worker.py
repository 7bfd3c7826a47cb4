"""The TTL worker: for every TTL-enabled table, delete rows whose TTL column
fell behind now - interval, in bounded batches through the normal DML path
(so MVCC, indexes, partitions, and stats counters all stay consistent) —
the ttlworker job/scan/delete pipeline collapsed to its SQL essence."""

from __future__ import annotations

import datetime


def run_ttl_once(db, now: datetime.datetime | None = None, batch: int = 10_000) -> dict[str, int]:
    """One sweep over all databases; returns {db.table: rows deleted}."""
    now = now or datetime.datetime.now()
    out: dict[str, int] = {}
    s = db.session()
    for db_name in db.catalog.databases():
        for tname in db.catalog.tables(db_name):
            t = db.catalog.table(db_name, tname)
            if t.ttl_col_offset < 0 or not t.ttl_enable:
                continue
            col = t.columns[t.ttl_col_offset]
            cutoff = now - datetime.timedelta(days=t.ttl_days)
            from tidb_tpu_torch.types import TypeKind

            if col.ftype.kind == TypeKind.DATE:
                lit = cutoff.date().isoformat()
            else:
                lit = cutoff.isoformat(sep=" ", timespec="seconds")
            total = 0
            while True:
                n = s.execute(
                    f"DELETE FROM `{db_name}`.`{tname}` WHERE `{col.name}` < '{lit}' LIMIT {batch}"
                ).affected
                total += n
                if n < batch:
                    break
            if total:
                out[f"{db_name}.{tname}"] = total
    return out
