"""Plan replayer — capture and restore everything a plan decision depends on
(ref: pkg/domain/plan_replayer.go + PLAN REPLAYER DUMP/LOAD in parser.y).

A dump is one zip with the reference's layout in spirit:

- ``meta.json``      version + timestamp + source db
- ``schema.sql``     SHOW CREATE TABLE for every referenced table
- ``stats.json``     per-table stats (row count, per-column TopN/histogram
                     serialized as plain lists)
- ``variables.json`` the planner-relevant session variables
- ``sql.sql``        the statement being replayed
- ``explain.txt``    EXPLAIN output at dump time

``load`` replays the zip into a fresh database: schema first, then stats
injected straight into the stats cache (no re-ANALYZE — the whole point is
reproducing the ORIGINAL cardinalities), then variables; running the SQL
under EXPLAIN should reproduce the dumped plan."""

from __future__ import annotations

import io
import json
import os
import time
import zipfile

import numpy as np


def _referenced_tables(session, sql: str) -> list[tuple[str, str]]:
    """(db, table) pairs a statement touches, via an AST walk."""
    from tidb_tpu_torch.parser import ast
    from tidb_tpu_torch.parser.parser import parse

    node = parse(sql)
    out: list[tuple[str, str]] = []
    seen = set()

    def walk(n):
        if isinstance(n, ast.TableRef):
            key = (n.db or session.current_db, n.name.lower())
            # subquery aliases parse as TableRefs too — only keep real tables
            try:
                session.catalog.table(*key)
            except Exception:
                return
            if key not in seen:
                seen.add(key)
                out.append(key)
            return
        if isinstance(n, (list, tuple)):
            for x in n:
                walk(x)
            return
        if hasattr(n, "__dataclass_fields__"):
            for f in n.__dataclass_fields__:
                walk(getattr(n, f))

    walk(node)
    return out


_PLANNER_VARS = (
    "tidb_allow_mpp",
    "tidb_enforce_mpp",
    "tidb_isolation_read_engines",
    "tidb_broadcast_join_threshold_count",
    "tidb_opt_agg_push_down",
    "tidb_index_lookup_concurrency",
)


def dump(session, sql: str, out_dir: str | None = None) -> str:
    """→ path of the written zip."""
    tables = _referenced_tables(session, sql)
    schema_lines = []
    stats: dict = {}
    for dbn, tn in tables:
        t = session.catalog.table(dbn, tn)
        create = session.execute(f"SHOW CREATE TABLE `{dbn}`.`{tn}`").rows[0][1]
        schema_lines.append(f"-- {dbn}.{tn}\n{create};\n")
        ts = session._db.stats.get(t.id)
        if ts is None:
            continue
        cols = {}
        for off, cs in ts.cols.items():
            cols[str(off)] = {
                "null_count": cs.null_count,
                "ndv": cs.ndv,
                "is_string": cs.is_string,
                "topn_values": np.asarray(cs.topn.values).tolist(),
                "topn_counts": np.asarray(cs.topn.counts).tolist(),
                "hist_lowers": np.asarray(cs.hist.lowers).tolist(),
                "hist_uppers": np.asarray(cs.hist.uppers).tolist(),
                "hist_cum": np.asarray(cs.hist.cum_counts).tolist(),
                "hist_repeats": np.asarray(cs.hist.repeats).tolist(),
                "hist_ndv": cs.hist.ndv,
                # string stats refer to sorted-dictionary codes; ship the
                # dictionary so load() can re-rank on the target
                "dict": [v.decode("utf-8", "surrogateescape") for v in cs.dictionary._values]
                if cs.is_string and cs.dictionary is not None
                else None,
            }
        stats[f"{dbn}.{tn}"] = {
            "row_count": ts.row_count,
            "version": ts.version,
            "cols": cols,
            "idxs": {str(i): s.ndv for i, s in ts.idxs.items()},
        }
    explain = "\n".join(r[0] for r in session.execute("EXPLAIN " + sql).rows)
    variables = {k: session.vars.get(k) for k in _PLANNER_VARS if k in session.vars}

    out_dir = out_dir or os.path.join(os.path.expanduser("~"), ".tidb_tpu_replayer")
    os.makedirs(out_dir, exist_ok=True)
    name = f"replayer_{int(time.time() * 1000)}.zip"
    path = os.path.join(out_dir, name)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("meta.json", json.dumps({"version": "tidb-tpu", "time": time.time(), "db": session.current_db}))
        z.writestr("schema.sql", "".join(schema_lines))
        z.writestr("stats.json", json.dumps(stats))
        z.writestr("variables.json", json.dumps(variables))
        z.writestr("sql.sql", sql)
        z.writestr("explain.txt", explain)
    return path


def load(session, path: str) -> str:
    """Replay a dump into this session's database; → the dumped SQL."""
    from tidb_tpu_torch.statistics.histogram import Histogram, TopN
    from tidb_tpu_torch.statistics.sketch import CMSketch, FMSketch
    from tidb_tpu_torch.statistics.stats import ColumnStats, IndexStats, TableStats

    with zipfile.ZipFile(path) as z:
        schema = z.read("schema.sql").decode()
        stats = json.loads(z.read("stats.json"))
        variables = json.loads(z.read("variables.json"))
        sql = z.read("sql.sql").decode()

    for stmt in schema.split(";"):
        s = "\n".join(l for l in stmt.splitlines() if not l.strip().startswith("--")).strip()
        if s:
            session.execute(s)
    for k, v in variables.items():
        session.vars[k] = v
    for key, ts_pb in stats.items():
        dbn, _, tn = key.partition(".")
        t = session.catalog.table(dbn, tn)
        cols: dict[int, ColumnStats] = {}
        for off_s, c in ts_pb["cols"].items():
            dictionary = None
            if c.get("dict") is not None:
                from tidb_tpu_torch.utils.chunk import Dictionary

                dictionary = Dictionary([s.encode("utf-8", "surrogateescape") for s in c["dict"]])
            cols[int(off_s)] = ColumnStats(
                offset=int(off_s),
                null_count=c["null_count"],
                ndv=c["ndv"],
                topn=TopN(np.asarray(c["topn_values"]), np.asarray(c["topn_counts"], dtype=np.int64)),
                hist=Histogram(
                    np.asarray(c["hist_lowers"]),
                    np.asarray(c["hist_uppers"]),
                    np.asarray(c["hist_cum"], dtype=np.int64),
                    np.asarray(c["hist_repeats"], dtype=np.int64),
                    c["hist_ndv"],
                ),
                cm=CMSketch(),
                fm=FMSketch(),
                is_string=c["is_string"],
                dictionary=dictionary,
            )
        session._db.stats.put(
            TableStats(
                table_id=t.id,
                version=ts_pb["version"],
                row_count=ts_pb["row_count"],
                cols=cols,
                idxs={int(i): IndexStats(int(i), n) for i, n in ts_pb["idxs"].items()},
            )
        )
    return sql
