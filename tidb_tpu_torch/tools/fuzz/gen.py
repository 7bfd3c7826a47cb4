"""graftfuzz generators: schemas, data, queries, and DML — all deterministic.

Design (ref: SQLancer's schema/statement generators + CSmith's seed policy):

- A **profile** is a schema template derived purely from ``(campaign_seed,
  profile_id)``: column types/collations, per-column constant pools, PK/
  index/partition layout. Cases share profiles, so distinct device-kernel
  fingerprints (which include predicate *constants* — see
  ``dagpb.DAGRequest.fingerprint``) are drawn from a finite vocabulary and
  the XLA compile cost amortizes across the whole campaign instead of
  recompiling per case.
- A **case** is the randomized part: row counts (including zero), per-column
  NULL densities, value distributions (dense/skewed/wide), the query list,
  and the DML round. Everything comes from ``random.Random`` streams keyed
  by ``(campaign_seed, case_index)``; nothing reads the clock or global RNG
  state, so a campaign is replayable byte-for-byte from its seed.
- Queries are small IRs (lists of SQL fragments), not opaque strings, so the
  shrinker can drop select items / conjuncts / group keys structurally and
  re-render (see shrink.py).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field, replace
from typing import Optional

# -- column kinds ------------------------------------------------------------

_INT_POOLS = [
    list(range(0, 8)),  # dense
    [0, 0, 1, 2, 100, 1000],  # skewed
    [-5, -1, 0, 3, 99999],  # wide incl. negatives
]
_FLOAT_POOL = [-1.5, 0.0, 0.5, 2.5, 3.25]
_DEC_POOL = ["0.00", "1.50", "-2.25", "10.00", "10.01"]
# 'a'/'A'/'B' matter: general_ci weight order ('a' ≡ 'A' < 'B') disagrees
# with byte order ('A' < 'B' < 'a'), so collation-blind orderings show up
_STR_POOL = ["", "a", "A", "B", "b", "aa", "zz"]
_DATE_POOL = ["1999-12-31", "2024-01-01", "2024-06-15"]

# per-case NULL density choices (0 keeps NOT-NULL-ish lanes hot; 0.9 makes
# IS NULL partitions and null-group aggregates non-trivial)
_NULL_PS = [0.0, 0.0, 0.1, 0.5, 0.9]


@dataclass
class ColumnSpec:
    name: str
    sql_type: str  # BIGINT / DOUBLE / DECIMAL(12,2) / VARCHAR(8) / DATE
    kind: str  # int / float / dec / str / date
    collate: str = ""  # "" or utf8mb4_general_ci
    pool: list = field(default_factory=list)  # data-value pool (rows only)
    # predicate constants are a tiny profile-fixed subset of the pool: device
    # kernel fingerprints include predicate constants (dagpb fingerprint), so
    # the constant vocabulary bounds the campaign's XLA compile count —
    # data diversity lives in the rows, which never enter a fingerprint
    pred_consts: list = field(default_factory=list)

    def ddl(self) -> str:
        c = f" COLLATE {self.collate}" if self.collate else ""
        return f"{self.name} {self.sql_type}{c}"


@dataclass
class TableSpec:
    name: str
    columns: list  # list[ColumnSpec]; columns[0] is the PK when pk=True
    pk: bool = False
    indexes: list = field(default_factory=list)  # list[list[str]]
    partition: str = ""  # rendered PARTITION BY tail, or ""

    def create_sql(self) -> str:
        parts = []
        for i, c in enumerate(self.columns):
            d = c.ddl()
            if self.pk and i == 0:
                d += " PRIMARY KEY"
            parts.append(d)
        for cols in self.indexes:
            parts.append(f"KEY ({', '.join(cols)})")
        tail = f" {self.partition}" if self.partition else ""
        return f"CREATE TABLE {self.name} ({', '.join(parts)}){tail}"

    def col(self, name: str) -> ColumnSpec:
        for c in self.columns:
            if c.name == name:
                return c
        raise KeyError(name)


@dataclass
class Profile:
    tables: list  # list[TableSpec]
    mpp: bool = False
    # the profile's fixed query pool + TLP predicate pool: cases sample from
    # these (data stays fully case-random). Bounding the per-profile query
    # vocabulary is what makes the campaign's XLA compile bill sublinear in
    # case count — every distinct (query, table-id) pair is a fresh compile
    queries: list = field(default_factory=list)
    tlp_preds: dict = field(default_factory=dict)  # table name -> [pred sql]


@dataclass
class Query:
    """Renderable query IR. ``join`` is a rendered LEFT JOIN tail (or "");
    every fragment list is independently shrinkable."""

    table: str
    select: list  # list[str], non-empty
    join: str = ""
    where: list = field(default_factory=list)  # conjunct fragments
    group_by: list = field(default_factory=list)
    order_by: list = field(default_factory=list)
    limit: str = ""  # "LIMIT n [OFFSET m]" or ""
    agg: bool = False  # has aggregate functions (TLP applies only when False)

    def sql(self) -> str:
        s = f"SELECT {', '.join(self.select)} FROM {self.table}"
        if self.join:
            s += f" {self.join}"
        if self.where:
            s += " WHERE " + " AND ".join(f"({c})" for c in self.where)
        if self.group_by:
            s += " GROUP BY " + ", ".join(self.group_by)
        if self.order_by:
            s += " ORDER BY " + ", ".join(self.order_by)
        if self.limit:
            s += f" {self.limit}"
        return s

    def sql_with_extra_where(self, extra: str) -> str:
        q = replace(self, where=list(self.where) + [extra])
        return q.sql()


def ci_rep_positions(q: Query, tables: list) -> tuple:
    """(fold_positions, free_positions) for grouped-query representative
    ambiguity. MySQL lets a group's representative be ANY member row:

    - fold: bare ci-collated columns in a GROUP BY query — the engines may
      return different members of the weight class, so those positions
      compare by general_ci weight instead of byte equality;
    - free: when a GROUP KEY itself is ci-collated, groups merge across
      byte-distinct rows, so EVERY bare non-grouped output (implicit
      first_row, any type) may come from either member row — those
      positions are excluded from comparison entirely.

    Triaged in STATIC_ANALYSIS.md § graftfuzz; aggregates stay strict (the
    merged group's row SET is identical on both engines)."""
    if not q.group_by:
        return (), ()
    cols = {c.name: c for t in tables for c in t.columns}
    ci = {n for n, c in cols.items() if c.collate}
    fold = tuple(i for i, s in enumerate(q.select) if s in ci)
    free = ()
    if any(g in ci for g in q.group_by):
        free = tuple(
            i for i, s in enumerate(q.select) if s in cols and s not in q.group_by
        )
    return fold, free


@dataclass
class CaseSpec:
    """One scenario: schema + literal rows + queries + a DML round. The
    shrinker mutates copies of this; the runner executes it (see runner.py)."""

    seed: int
    index: int
    tables: list  # list[TableSpec]
    rows: dict  # table name -> list of row tuples (python literals)
    queries: list  # list[Query]
    dml: list = field(default_factory=list)  # rendered SQL statements
    merge: bool = False  # run the delta merge after DML and re-check
    mpp: bool = False
    # forced mesh width for mpp cases (0 = every available device): the
    # differential/TLP oracles must cover the staged repartition path at
    # real multi-shard widths, not just whatever the box exposes
    ndev: int = 0
    tlp_pred: str = ""  # TLP partition predicate (applies to queries[0])
    region_split_keys: int = 1 << 62
    # campaign DB-pool identity: cases of one profile share a live DB (and
    # so table ids, and so device-kernel fingerprints — see runner.DBPool);
    # () means "always build fresh" (shrinker probes, repro replays)
    profile_key: tuple = ()


# -- literal rendering -------------------------------------------------------


def sql_literal(v, kind: str) -> str:
    if v is None:
        return "NULL"
    if kind in ("str", "date", "dec"):
        return "'" + str(v).replace("'", "''") + "'"
    return str(v)


def _row_literal(row, cols) -> str:
    return "(" + ", ".join(sql_literal(v, c.kind) for v, c in zip(row, cols)) + ")"


def insert_sql(table: TableSpec, rows: list, batch: int = 40) -> list:
    out = []
    for i in range(0, len(rows), batch):
        vals = ", ".join(_row_literal(r, table.columns) for r in rows[i : i + batch])
        out.append(f"INSERT INTO {table.name} VALUES {vals}")
    return out


# -- profiles ----------------------------------------------------------------


def _mk_column(rng: random.Random, name: str) -> ColumnSpec:
    pick = rng.randrange(10)
    if pick < 4:
        c = ColumnSpec(name, "BIGINT", "int", pool=list(rng.choice(_INT_POOLS)))
    elif pick < 6:
        c = ColumnSpec(name, "DOUBLE", "float", pool=list(_FLOAT_POOL))
    elif pick < 7:
        c = ColumnSpec(name, "DECIMAL(12,2)", "dec", pool=list(_DEC_POOL))
    elif pick < 9:
        collate = "utf8mb4_general_ci" if rng.random() < 0.5 else ""
        c = ColumnSpec(name, "VARCHAR(8)", "str", collate=collate, pool=list(_STR_POOL))
    else:
        c = ColumnSpec(name, "DATE", "date", pool=list(_DATE_POOL))
    c.pred_consts = rng.sample(c.pool, min(2, len(c.pool)))
    return c


def _mk_table(rng: random.Random, t: int, ncols: int, force_int_first: bool = False) -> TableSpec:
    cols = []
    pk = rng.random() < 0.5
    for j in range(ncols):
        name = f"c{t}_{j}"
        if j == 0 and (pk or force_int_first):
            # PK / join-key column: BIGINT with a dense-ish pool
            c = ColumnSpec(name, "BIGINT", "int", pool=list(rng.choice(_INT_POOLS)))
            c.pred_consts = rng.sample(c.pool, min(2, len(c.pool)))
            cols.append(c)
        else:
            cols.append(_mk_column(rng, name))
    ts = TableSpec(f"t{t}", cols, pk=pk)
    # secondary index on 0-2 random columns (non-unique: random data collides)
    for _ in range(rng.randrange(3)):
        c = rng.choice(cols[1:] if len(cols) > 1 else cols)
        if [c.name] not in ts.indexes:
            ts.indexes.append([c.name])
    int_cols = [c.name for c in cols if c.kind == "int"]
    if int_cols and rng.random() < 0.30:
        col = rng.choice(int_cols)
        if rng.random() < 0.5:
            ts.partition = f"PARTITION BY HASH ({col}) PARTITIONS {rng.choice([2, 3, 4])}"
        else:
            ts.partition = (
                f"PARTITION BY RANGE ({col}) (PARTITION p0 VALUES LESS THAN (2), "
                "PARTITION p1 VALUES LESS THAN (101), "
                "PARTITION p2 VALUES LESS THAN MAXVALUE)"
            )
            # RANGE routes on the column value: NULLs land in p0 per MySQL,
            # negatives too — pools already cover both
    return ts


def make_profile(seed: int, pid: int, mpp: bool = False, pool_size: int = 12) -> Profile:
    rng = random.Random(f"graftfuzz-profile-{seed}-{pid}-{int(mpp)}")
    if mpp:
        # fact + dim pair shaped at the device join tier: int join keys,
        # one aggregable lane each, a string tag lane
        fact = _mk_table(rng, 0, 4, force_int_first=True)
        dim = _mk_table(rng, 1, 3, force_int_first=True)
        p = Profile([fact, dim], mpp=True)
    else:
        ntab = 2 if rng.random() < 0.6 else 1
        tables = [_mk_table(rng, t, rng.randrange(3, 5), force_int_first=(t > 0)) for t in range(ntab)]
        p = Profile(tables)
    _fill_query_pool(rng, p, pool_size if not mpp else max(pool_size // 2, 6))
    for t in p.tables:
        preds = p.tlp_preds.setdefault(t.name, [])
        for _ in range(2):
            pred = _pred(rng, [t])
            if pred not in preds:
                preds.append(pred)
    return p


# -- data --------------------------------------------------------------------


def gen_rows(rng: random.Random, table: TableSpec, n: int) -> list:
    rows = []
    null_ps = [0.0 if (table.pk and j == 0) else rng.choice(_NULL_PS) for j in range(len(table.columns))]
    pk_vals = rng.sample(range(max(n * 3, 1)), n) if table.pk and n else []
    for i in range(n):
        row = []
        for j, c in enumerate(table.columns):
            if table.pk and j == 0:
                row.append(pk_vals[i])
            elif rng.random() < null_ps[j]:
                row.append(None)
            else:
                row.append(rng.choice(c.pool))
        rows.append(tuple(row))
    return rows


# -- predicates --------------------------------------------------------------
#
# the op set and the per-column pred_consts pair keep the per-profile
# predicate vocabulary small: <= / >= / <> add little semantic coverage over
# < / > / = on discrete pools but would double the fingerprint space (and so
# the campaign's compile bill)

_CMP_OPS = ["=", "<", ">"]


def _pred(rng: random.Random, tables: list) -> str:
    t = rng.choice(tables)
    c = rng.choice(t.columns)
    r = rng.random()
    if r < 0.12:
        return f"{c.name} IS NULL"
    if r < 0.24:
        return f"{c.name} IS NOT NULL"
    op = rng.choice(_CMP_OPS)
    return f"{c.name} {op} {sql_literal(rng.choice(c.pred_consts), c.kind)}"


def _wheres(rng: random.Random, tables: list, p_each: float = 0.5) -> list:
    out = [_pred(rng, tables)] if rng.random() < p_each else []
    if out and rng.random() < 0.2:
        out.append(_pred(rng, tables))
    return out


def _agg_item(rng: random.Random, t: TableSpec) -> str:
    numeric = [c for c in t.columns if c.kind in ("int", "float", "dec")]
    fn = rng.choice(["COUNT", "SUM", "AVG", "MIN", "MAX", "COUNT(*)"])
    if fn == "COUNT(*)" or not numeric:
        return "COUNT(*)"
    c = rng.choice(numeric if fn in ("SUM", "AVG") else t.columns)
    return f"{fn}({c.name})"


# -- query shapes ------------------------------------------------------------


def _subset(rng: random.Random, cols: list) -> list:
    """One of three order-stable projections (all / leading pair / one
    column): arbitrary subsets-with-permutations would multiply the kernel
    fingerprint space ~2^n without touching new engine behavior."""
    r = rng.random()
    if r < 0.4 or len(cols) == 1:
        return list(cols)
    if r < 0.7 and len(cols) > 2:
        return cols[:2]
    return [rng.choice(cols)]


def _q_scan(rng: random.Random, t: TableSpec) -> Query:
    cols = [c.name for c in t.columns]
    sel = _subset(rng, cols)
    q = Query(t.name, sel, where=_wheres(rng, [t]))
    if rng.random() < 0.5:
        # TopN with ties: order by a (usually low-cardinality) column; ties
        # break on host scan order, which the device engines must preserve
        ob = rng.choice(cols)
        q.order_by = [f"{ob} {rng.choice(['ASC', 'DESC'])}"]
        q.limit = rng.choice(["LIMIT 1", "LIMIT 4", "LIMIT 4 OFFSET 2"])
    elif rng.random() < 0.25:
        q.limit = rng.choice(["LIMIT 1", "LIMIT 4"])
    return q


def _q_agg(rng: random.Random, t: TableSpec) -> Query:
    cols = [c.name for c in t.columns]
    grouped = rng.random() < 0.7
    sel, gb = [], []
    if grouped:
        gb = cols[:2] if (len(cols) > 1 and rng.random() < 0.2) else [rng.choice(cols)]
        sel.extend(gb)
        if rng.random() < 0.25:
            # bare non-grouped column: implicit first_row (MySQL non-strict)
            extra = rng.choice(cols)
            if extra not in sel:
                sel.append(extra)
    for _ in range(rng.randrange(1, 3)):
        a = _agg_item(rng, t)
        if a not in sel:
            sel.append(a)
    q = Query(t.name, sel, where=_wheres(rng, [t]), group_by=gb, agg=True)
    if gb and rng.random() < 0.5:
        q.order_by = [f"{g} ASC" for g in gb]
        if rng.random() < 0.4:
            q.limit = f"LIMIT {rng.choice([1, 4])}"
    return q


def _join_key(rng: random.Random, a: TableSpec, b: TableSpec) -> tuple:
    ia = [c.name for c in a.columns if c.kind == "int"]
    ib = [c.name for c in b.columns if c.kind == "int"]
    if not ia or not ib:
        return None
    return rng.choice(ia), rng.choice(ib)


def _q_semi(rng: random.Random, a: TableSpec, b: TableSpec) -> Optional[Query]:
    k = _join_key(rng, a, b)
    if k is None:
        return None
    ka, kb = k
    sub_where = _wheres(rng, [b], p_each=0.4)
    neg = rng.random() < 0.4
    kind = rng.random()
    if kind < 0.4:
        sub = f"SELECT {kb} FROM {b.name}"
        if sub_where:
            sub += " WHERE " + " AND ".join(f"({c})" for c in sub_where)
        pred = f"{ka} {'NOT IN' if neg else 'IN'} ({sub})"
    else:
        conj = [f"{b.name}.{kb} = {a.name}.{ka}"]
        # multi-key existence: add a second correlated equality when possible
        k2 = _join_key(rng, a, b)
        if kind > 0.7 and k2 is not None and k2 != k:
            conj.append(f"{b.name}.{k2[1]} = {a.name}.{k2[0]}")
        conj.extend(sub_where)
        pred = f"{'NOT EXISTS' if neg else 'EXISTS'} (SELECT 1 FROM {b.name} WHERE " + " AND ".join(conj) + ")"
    sel = ["COUNT(*)"]
    numeric = [c for c in a.columns if c.kind in ("int", "float", "dec")]
    if numeric and rng.random() < 0.6:
        sel.append(f"SUM({rng.choice(numeric).name})")
    return Query(a.name, sel, where=[pred] + _wheres(rng, [a], p_each=0.3), agg=True)


def _q_left_join(rng: random.Random, a: TableSpec, b: TableSpec) -> Optional[Query]:
    k = _join_key(rng, a, b)
    if k is None:
        return None
    ka, kb = k
    join = f"LEFT JOIN {b.name} ON {a.name}.{ka} = {b.name}.{kb}"
    gcol = rng.choice([c.name for c in b.columns])
    sel = [gcol, "COUNT(*)"]
    numeric = [c for c in a.columns if c.kind in ("int", "float", "dec")]
    if numeric:
        sel.append(f"SUM({rng.choice(numeric).name})")
    q = Query(a.name, sel, join=join, where=_wheres(rng, [a], p_each=0.3), group_by=[gcol], agg=True)
    q.order_by = [f"{gcol} ASC"]
    return q


def _q_corr_agg(rng: random.Random, a: TableSpec, b: TableSpec) -> Optional[Query]:
    k = _join_key(rng, a, b)
    ia = [c.name for c in a.columns if c.kind in ("int", "float", "dec")]
    ib = [c.name for c in b.columns if c.kind in ("int", "float", "dec")]
    if k is None or not ia or not ib:
        return None
    ka, kb = k
    fn = rng.choice(["AVG", "MAX", "MIN", "SUM"])
    sub = f"SELECT {fn}({rng.choice(ib)}) FROM {b.name} WHERE {b.name}.{kb} = {a.name}.{ka}"
    pred = f"{rng.choice(ia)} {rng.choice(['>', '<', '>='])} ({sub})"
    sel = ["COUNT(*)"]
    if rng.random() < 0.5:
        sel.append(f"SUM({rng.choice(ia)})")
    return Query(a.name, sel, where=[pred], agg=True)


def _q_two_stage(rng: random.Random, a: TableSpec, b: TableSpec) -> Optional[Query]:
    """Two-stage fragment shape: a derived AGGREGATE over b re-keyed into a
    join with a — the staged-pipeline vocabulary (the device stage's output
    slots repartition on the join key inside ONE composed program; see
    parallel/mpp.DistStageSpec)."""
    k = _join_key(rng, a, b)
    ia = [c.name for c in a.columns if c.kind in ("int", "float", "dec")]
    ib = [c.name for c in b.columns if c.kind in ("int", "float", "dec")]
    if k is None or not ia or not ib:
        return None
    ka, kb = k
    fn = rng.choice(["SUM", "COUNT", "AVG", "MIN", "MAX"])
    arg = "*" if fn == "COUNT" else rng.choice(ib)
    sub = f"SELECT {kb} AS sk, {fn}({arg}) AS sv FROM {b.name}"
    sub_where = _wheres(rng, [b], p_each=0.3)
    if sub_where:
        sub += " WHERE " + " AND ".join(f"({c})" for c in sub_where)
    sub += f" GROUP BY {kb}"
    join = f"JOIN ({sub}) ds ON {a.name}.{ka} = ds.sk"
    sel = ["COUNT(*)", f"SUM({rng.choice(ia)})"]
    if rng.random() < 0.5:
        sel.append("SUM(sv)")
    return Query(a.name, sel, join=join, where=_wheres(rng, [a], p_each=0.3), agg=True)


def gen_query(rng: random.Random, profile: Profile) -> Query:
    tables = profile.tables
    a = tables[0]
    b = tables[1] if len(tables) > 1 else None
    if profile.mpp:
        # gather-path vocabulary: join-shaped plans that try_mpp_rewrite lifts
        for _ in range(4):
            q = rng.choice([_q_left_join, _q_semi, _q_corr_agg, _q_two_stage])(rng, a, b)
            if q is not None:
                return q
        return _q_agg(rng, a)
    r = rng.random()
    q = None
    if r < 0.30:
        q = _q_scan(rng, rng.choice(tables))
    elif r < 0.62:
        q = _q_agg(rng, rng.choice(tables))
    elif b is not None:
        q = rng.choice([_q_semi, _q_left_join, _q_corr_agg])(rng, a, b)
    return q if q is not None else _q_agg(rng, a)


def _fill_query_pool(rng: random.Random, profile: Profile, size: int) -> None:
    """Quota'd pool: the first entries pin one of each device shape the
    library ships (plain scan ×2 — the TLP targets — TopN, grouped agg,
    global agg, and the join shapes on two-table profiles), the rest are
    free draws. Dedup by rendered SQL keeps the pool honest."""
    t0 = profile.tables[0]
    t1 = profile.tables[1] if len(profile.tables) > 1 else None
    seen: set = set()

    def add(q) -> None:
        if q is not None and q.sql() not in seen:
            seen.add(q.sql())
            profile.queries.append(q)

    plain = replace(_q_scan(rng, t0), order_by=[], limit="")
    add(plain)
    add(replace(_q_scan(rng, rng.choice(profile.tables)), order_by=[], limit=""))
    tt = rng.choice(profile.tables)
    topn = _q_scan(rng, tt)
    if not topn.limit:
        # force the TopN shape onto the SCANNED table's own leading column
        topn.order_by, topn.limit = [f"{tt.columns[0].name} ASC"], "LIMIT 4"
    add(topn)
    add(_q_agg(rng, rng.choice(profile.tables)))
    ga = _q_agg(rng, rng.choice(profile.tables))
    add(replace(ga, group_by=[], select=[s for s in ga.select if "(" in s] or ["COUNT(*)"], order_by=[], limit=""))
    if t1 is not None:
        add(_q_semi(rng, t0, t1))
        add(_q_left_join(rng, t0, t1))
        add(_q_corr_agg(rng, t0, t1))
        if profile.mpp:
            # one pinned two-stage shape per mesh profile: the smoke lane
            # must exercise the staged repartition path every campaign
            add(_q_two_stage(rng, t0, t1))
    guard = 0
    while len(profile.queries) < size and guard < size * 20:
        add(gen_query(rng, profile))
        guard += 1


# -- DML ---------------------------------------------------------------------


def gen_dml(rng: random.Random, table: TableSpec, nstmts: int) -> list:
    out = []
    for _ in range(nstmts):
        r = rng.random()
        if r < 0.45:
            rows = gen_rows(rng, table, rng.randrange(1, 4))
            out.extend(insert_sql(table, rows))
        elif r < 0.75:
            c = rng.choice(table.columns[1:] if table.pk and len(table.columns) > 1 else table.columns)
            val = sql_literal(rng.choice(c.pool + [None]), c.kind)
            out.append(f"UPDATE {table.name} SET {c.name} = {val} WHERE {_pred(rng, [table])}")
        else:
            out.append(f"DELETE FROM {table.name} WHERE {_pred(rng, [table])}")
    return out


# -- cases -------------------------------------------------------------------

N_PROFILES = 4
MPP_EVERY = 40  # case_index % MPP_EVERY == MPP_EVERY-1 → mesh case
_MAX_ROWS = 48


def gen_case(seed: int, index: int, n_queries: int = 2, pool_size: int = 12) -> CaseSpec:
    """Even case indexes run the TLP oracle, odd ones the DML/freshness
    phases: each oracle axis costs extra device-kernel fingerprints (TLP's
    three partitions, freshness's delta-variant compiles), and alternating
    spreads the compile budget over twice the scenarios."""
    rng = random.Random(f"graftfuzz-case-{seed}-{index}")
    mpp = (index % MPP_EVERY) == MPP_EVERY - 1
    pid = rng.randrange(2) if mpp else rng.randrange(N_PROFILES)
    profile = make_profile(seed, pid, mpp=mpp, pool_size=pool_size)
    rows = {}
    for t in profile.tables:
        # 0 rows sometimes: empty-table shapes (empty groups, empty build sides)
        n = 0 if rng.random() < 0.06 else rng.randrange(1, _MAX_ROWS + 1)
        rows[t.name] = gen_rows(rng, t, n)
    queries = rng.sample(profile.queries, min(n_queries, len(profile.queries)))
    dml = []
    if index % 2 == 1:
        for t in profile.tables:
            if rng.random() < 0.9:
                dml.extend(gen_dml(rng, t, rng.randrange(1, 3)))
    tlp_pred = ""
    non_agg = [q for q in queries if not q.agg and not q.limit and not q.order_by] if index % 2 == 0 else []
    if non_agg:
        tgt = non_agg[0]
        queries.remove(tgt)
        queries.insert(0, tgt)  # TLP always targets queries[0]
        ts = {t.name: t for t in profile.tables}[tgt.table]
        # the partition predicate must read the TARGET's table only (it is
        # appended to the target query's WHERE)
        preds = profile.tlp_preds.get(tgt.table)
        tlp_pred = rng.choice(preds) if preds else _pred(rng, [ts])
    return CaseSpec(
        seed=seed,
        index=index,
        tables=profile.tables,
        rows=rows,
        queries=queries,
        dml=dml,
        merge=rng.random() < 0.7,
        mpp=mpp,
        # mesh cases force multi-shard widths so the oracles cover the
        # repartition/staged paths at ndev > 1, whatever the box default
        ndev=rng.choice((2, 4, 8)) if mpp else 0,
        tlp_pred=tlp_pred,
        region_split_keys=16 if mpp else 1 << 62,
        profile_key=(seed, pid, mpp),
    )
