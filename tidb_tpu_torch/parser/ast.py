"""AST nodes (ref: pkg/parser/ast — trimmed to the supported surface)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


class Node:
    pass


# -- expressions ------------------------------------------------------------


@dataclass
class Literal(Node):
    value: Any  # int | float | str | bytes | None | bool
    # hints: "date"/"time"/"decimal" for typed literals (DATE '1994-01-01')
    hint: str = ""
    # which EXECUTE parameter produced this literal (-1 = a plain literal);
    # the value-agnostic prepared-plan cache traces parameters through the
    # builder by this index (ref: plan-cache parameter markers)
    param_idx: int = -1


@dataclass
class ParamMarker(Node):
    """``?`` placeholder in a prepared statement (ref: ast.ParamMarkerExpr)."""

    idx: int


@dataclass
class UserVar(Node):
    """``@name`` user variable or ``@@name`` system variable reference."""

    name: str
    sys: bool = False
    scope: str = "session"


@dataclass
class ColumnName(Node):
    name: str
    table: str = ""
    db: str = ""

    def __str__(self):
        parts = [p for p in (self.db, self.table, self.name) if p]
        return ".".join(parts)


@dataclass
class BinaryOp(Node):
    op: str  # or/xor/and/eq/ne/lt/le/gt/ge/plus/minus/mul/div/intdiv/mod
    left: Node
    right: Node


@dataclass
class UnaryOp(Node):
    op: str  # not/unaryminus/unaryplus
    operand: Node


@dataclass
class IsNull(Node):
    operand: Node
    negated: bool = False


@dataclass
class InList(Node):
    operand: Node
    items: list[Node]
    negated: bool = False


@dataclass
class Between(Node):
    operand: Node
    low: Node
    high: Node
    negated: bool = False


@dataclass
class Like(Node):
    operand: Node
    pattern: Node
    negated: bool = False
    regexp: bool = False  # a REGEXP/RLIKE b (search semantics, not LIKE)


@dataclass
class Collate(Node):
    """expr COLLATE name / BINARY expr — explicit collation override; the
    strongest coercibility level, it wins over both operands' implicit
    collations (ref: parser.y "Expression COLLATE", expression/collation.go
    deriveCollation explicit-priority rule)."""

    operand: Node
    collation: str  # lowercased MySQL collation name, or "binary"


@dataclass
class FuncCall(Node):
    name: str  # lowercased
    args: list[Node] = field(default_factory=list)
    distinct: bool = False
    star: bool = False  # COUNT(*)
    over: Optional["WindowSpec"] = None  # window call when set
    separator: Optional[str] = None  # GROUP_CONCAT(... SEPARATOR 'x')
    order_by: Optional[list] = None  # GROUP_CONCAT(... ORDER BY e [DESC])


@dataclass
class WindowSpec(Node):
    """OVER (PARTITION BY ... ORDER BY ... [frame]) (ref: ast.WindowSpec)."""

    partition_by: list[Node] = field(default_factory=list)
    order_by: list["OrderItem"] = field(default_factory=list)
    # frames: whole-partition (no ORDER BY, or UNBOUNDED..UNBOUNDED),
    # RANGE UNBOUNDED..CURRENT (default with ORDER BY; peers share the
    # frame), or ROWS UNBOUNDED..CURRENT (exact cut at the current row)
    whole_partition: bool = False
    rows_frame: bool = False
    # bounded ROWS frame: (start_kind, start_n, end_kind, end_n) with kinds
    # "preceding"/"current"/"following"/"unbounded" (ref: ast.FrameBound)
    frame: Optional[tuple] = None

    def key(self) -> str:
        return repr((self.partition_by, self.order_by, self.whole_partition, self.rows_frame, self.frame))


@dataclass
class CaseWhen(Node):
    operand: Optional[Node]  # CASE x WHEN ... vs CASE WHEN ...
    branches: list[tuple[Node, Node]] = field(default_factory=list)
    else_value: Optional[Node] = None


@dataclass
class Cast(Node):
    operand: Node
    target: "TypeDef"


@dataclass
class Wildcard(Node):  # t.* or *
    table: str = ""


@dataclass
class SubqueryExpr(Node):
    select: "Select"
    # modifier: "" (scalar) | "exists" | "in" | "any" | "all"
    modifier: str = ""


@dataclass
class QuantifiedCmp(Node):
    """`left OP ANY|ALL (subquery)` — lowered by the planner per context
    (WHERE: EXISTS rewrite; value: NULL-correct extreme comparison)."""

    op: str  # eq/ne/lt/le/gt/ge
    left: Node
    select: "Select"
    is_all: bool = False


# -- type definitions (DDL) -------------------------------------------------


@dataclass
class TypeDef(Node):
    name: str  # bigint/int/double/varchar/decimal/date/datetime/...
    length: int = -1
    scale: int = 0
    unsigned: bool = False
    collate: str = ""  # e.g. utf8mb4_general_ci


# -- statements -------------------------------------------------------------


@dataclass
class SelectItem(Node):
    expr: Node
    alias: str = ""


@dataclass
class TableRef(Node):
    name: str
    db: str = ""
    alias: str = ""
    as_of: Optional[Node] = None  # stale read: AS OF TIMESTAMP expr
    # USE/IGNORE/FORCE INDEX (...) table hints: [(kind, [index names])]
    index_hints: Optional[list] = None
    # t PARTITION (p0, p1) explicit partition selection (ref: parser.y
    # TableFactor PartitionNameListOpt; logical_plan_builder partition check)
    partitions: Optional[list] = None


@dataclass
class Join(Node):
    left: Node  # TableRef | Join | SubquerySource
    right: Node
    kind: str = "inner"  # inner/left/right/cross
    on: Optional[Node] = None


@dataclass
class SubquerySource(Node):
    select: "Select"
    alias: str = ""
    # CTE column renames: WITH c(a, b) AS (...) — applied over the built
    # subquery's schema by the planner
    col_aliases: list[str] = field(default_factory=list)


@dataclass
class ValuesSource(Node):
    """A materialized in-memory rowset used as a table source (the planner's
    landing pad for recursive-CTE fixpoints and memtable feeds)."""

    rows: list  # list[tuple] of logical Python values
    names: list[str]
    ftypes: list  # list[FieldType]
    alias: str = ""


@dataclass
class CTEDef(Node):
    """One WITH-list entry (ref: ast.CommonTableExpression)."""

    name: str
    columns: list[str]
    query: Node  # Select | SetOp
    recursive: bool = False


@dataclass
class OrderItem(Node):
    expr: Node
    desc: bool = False


@dataclass
class Select(Node):
    items: list[SelectItem]
    from_: Optional[Node] = None  # TableRef | Join | SubquerySource
    where: Optional[Node] = None
    group_by: list[Node] = field(default_factory=list)
    # GROUP BY ... WITH ROLLUP (ref: parser.y WITH ROLLUP production)
    rollup: bool = False
    having: Optional[Node] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    distinct: bool = False
    for_update: bool = False
    # WITH clause attached to this query block (ref: SelectStmt.With)
    ctes: list["CTEDef"] = field(default_factory=list)
    # optimizer hints: [(name_lower, [args...])] (ref: TableOptimizerHint)
    hints: list = field(default_factory=list)


@dataclass
class SetOp(Node):
    """UNION / INTERSECT / EXCEPT chain (ref: ast.SetOprStmt).

    ``order_by``/``limit`` apply to the whole compound result (MySQL: a
    trailing ORDER BY binds to the union, not the last operand)."""

    left: Node  # Select | SetOp
    right: Node  # Select | SetOp
    op: str  # "union" | "intersect" | "except"
    all: bool = False
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None
    offset: int = 0
    ctes: list["CTEDef"] = field(default_factory=list)


@dataclass
class Insert(Node):
    table: TableRef
    columns: list[str] = field(default_factory=list)
    values: list[list[Node]] = field(default_factory=list)
    select: Optional[Select] = None
    replace: bool = False
    ignore: bool = False
    on_dup_update: list[tuple[str, Node]] = field(default_factory=list)


@dataclass
class Update(Node):
    table: TableRef
    assignments: list[tuple[ColumnName, Node]] = field(default_factory=list)
    where: Optional[Node] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class Delete(Node):
    table: TableRef
    where: Optional[Node] = None
    order_by: list[OrderItem] = field(default_factory=list)
    limit: Optional[int] = None


@dataclass
class ColumnDef(Node):
    name: str
    type: TypeDef
    not_null: bool = False
    default: Optional[Node] = None
    primary_key: bool = False
    unique: bool = False
    auto_increment: bool = False


@dataclass
class IndexDef(Node):
    name: str
    columns: list[str]
    unique: bool = False
    primary: bool = False


@dataclass
class FKDef(Node):
    """FOREIGN KEY (cols) REFERENCES tbl (cols) with referential actions
    (ref: ast.Constraint ConstraintForeignKey + model.FKInfo)."""

    name: str
    columns: list[str]
    ref_table: "TableRef"
    ref_columns: list[str]
    on_delete: str = "restrict"  # restrict | cascade | set_null | no_action
    on_update: str = "restrict"


@dataclass
class PartitionByDef(Node):
    """PARTITION BY RANGE (col) (...) | HASH (col) PARTITIONS n."""

    type: str  # "range" | "hash"
    column: str
    defs: list[tuple[str, Optional[int]]] = field(default_factory=list)  # (name, less_than)
    num: int = 0  # hash partition count


@dataclass
class CreateTable(Node):
    table: TableRef
    columns: list[ColumnDef] = field(default_factory=list)
    indexes: list[IndexDef] = field(default_factory=list)
    foreign_keys: list[FKDef] = field(default_factory=list)
    if_not_exists: bool = False
    partition_by: Optional[PartitionByDef] = None
    ttl: Optional[tuple[str, int]] = None  # (column, days)
    ttl_enable: bool = True
    auto_increment_base: Optional[int] = None  # AUTO_INCREMENT = n option


@dataclass
class CreateSequence(Node):
    name: str
    db: str = ""
    start: int = 1
    increment: int = 1
    if_not_exists: bool = False


@dataclass
class DropSequence(Node):
    names: list[str]
    if_exists: bool = False


@dataclass
class CreateView(Node):
    """CREATE [OR REPLACE] VIEW v [(cols)] AS <select> — definition kept as
    SQL text (ref: model.ViewInfo.SelectStmt)."""

    table: TableRef
    columns: list[str]
    text: str
    or_replace: bool = False


@dataclass
class DropView(Node):
    tables: list[TableRef]
    if_exists: bool = False


@dataclass
class DropTable(Node):
    tables: list[TableRef]
    if_exists: bool = False


@dataclass
class TruncateTable(Node):
    table: TableRef


@dataclass
class AlterTable(Node):
    table: TableRef
    # one action per statement (reference supports lists; keep one)
    # actions: add_column/drop_column/add_index/drop_index/rename/
    #          add_partition/drop_partition/truncate_partition
    action: str = ""
    column: Optional[ColumnDef] = None
    index: Optional[IndexDef] = None
    fk: Optional[FKDef] = None  # add_fk payload
    name: str = ""  # drop target, rename target, or partition name
    less_than: Optional[int] = None  # add_partition bound (None = MAXVALUE)
    ttl: Optional[tuple[str, int]] = None  # set_ttl payload
    ttl_enable: bool = True


@dataclass
class CreateIndex(Node):
    index: IndexDef
    table: TableRef


@dataclass
class DropIndex(Node):
    name: str
    table: TableRef


@dataclass
class CreateDatabase(Node):
    name: str
    if_not_exists: bool = False


@dataclass
class DropDatabase(Node):
    name: str
    if_exists: bool = False


@dataclass
class UseDatabase(Node):
    name: str


@dataclass
class Explain(Node):
    stmt: Node
    analyze: bool = False


@dataclass
class SetVariable(Node):
    name: str
    value: Node
    scope: str = "session"  # session | global


@dataclass
class ImportInto(Node):
    """IMPORT INTO t FROM 'file.csv' [WITH opt=val, ...] (ref:
    disttask/importinto SQL surface)."""

    table: TableRef
    path: str
    options: dict = field(default_factory=dict)


@dataclass
class Backup(Node):
    """BACKUP DATABASE db | TABLE t[, t2] TO 'dest' (ref: executor/brie.go)."""

    dest: str
    db: str = ""
    tables: list[TableRef] = field(default_factory=list)


@dataclass
class Restore(Node):
    """RESTORE DATABASE [db] FROM 'src' (ref: executor/brie.go)."""

    src: str
    db: str = ""


@dataclass
class Prepare(Node):
    """PREPARE name FROM 'text' | @var (ref: ast.PrepareStmt)."""

    name: str
    text: Optional[str] = None
    from_var: Optional[str] = None


@dataclass
class ExecutePrepared(Node):
    """EXECUTE name [USING @a, @b] (ref: ast.ExecuteStmt)."""

    name: str
    using: list[str] = field(default_factory=list)


@dataclass
class Deallocate(Node):
    """DEALLOCATE PREPARE name (ref: ast.DeallocateStmt)."""

    name: str


@dataclass
class Show(Node):
    kind: str  # tables/databases/create_table/variables/columns
    target: str = ""
    like: Optional[str] = None


@dataclass
class RenameTables(Node):
    pairs: list = field(default_factory=list)  # [(old, new)]


@dataclass
class DoStmt(Node):
    exprs: list = field(default_factory=list)


@dataclass
class ChecksumTable(Node):
    tables: list = field(default_factory=list)


@dataclass
class Begin(Node):
    mode: str = ""  # "" (session default) | pessimistic | optimistic


@dataclass
class Commit(Node):
    pass


@dataclass
class Rollback(Node):
    pass


@dataclass
class UserSpec(Node):
    name: str
    host: str = "%"
    password: str = ""
    plugin: str = "mysql_native_password"
    # IDENTIFIED clause present? (ALTER USER without one must not touch
    # the stored credential)
    has_auth: bool = False


@dataclass
class CreateUser(Node):
    users: list[UserSpec] = field(default_factory=list)
    if_not_exists: bool = False


@dataclass
class DropUser(Node):
    users: list[UserSpec] = field(default_factory=list)
    if_exists: bool = False


@dataclass
class PlanReplayer(Node):
    """PLAN REPLAYER DUMP EXPLAIN <sql> | LOAD '<path>' (ref:
    ast.PlanReplayerStmt)."""

    kind: str  # dump | load
    sql: str = ""
    path: str = ""


@dataclass
class AlterUser(Node):
    """ALTER USER ... IDENTIFIED BY (ref: ast.AlterUserStmt)."""

    users: list[UserSpec] = field(default_factory=list)
    if_exists: bool = False


@dataclass
class Grant(Node):
    """GRANT privs ON level TO user (ref: ast.GrantStmt). REVOKE shares the
    shape via ``revoke=True``."""

    privs: list[str] = field(default_factory=list)  # lowercase; ["all"] = all
    db: str = ""  # "" = *.* (global)
    table: str = ""  # "" = db.* (db level)
    user: str = ""
    host: str = "%"
    revoke: bool = False


@dataclass
class ResourceGroupStmt(Node):
    """CREATE/ALTER/DROP RESOURCE GROUP (ref: ast.CreateResourceGroupStmt)."""

    op: str  # create | alter | drop
    name: str
    ru_per_sec: int = 0
    burstable: bool = False
    exec_elapsed_s: float = 0.0
    action: str = "KILL"
    if_not_exists: bool = False
    if_exists: bool = False


@dataclass
class SetResourceGroup(Node):
    name: str


@dataclass
class Trace(Node):
    """TRACE <stmt> (ref: ast.TraceStmt)."""

    stmt: Node


@dataclass
class CreateBinding(Node):
    """CREATE [GLOBAL|SESSION] BINDING FOR <stmt> USING <stmt>
    (ref: ast.CreateBindingStmt / pkg/bindinfo)."""

    for_text: str
    using_text: str
    is_global: bool = False


@dataclass
class DropBinding(Node):
    for_text: str
    is_global: bool = False


@dataclass
class RecoverTable(Node):
    """RECOVER TABLE t / FLASHBACK TABLE t [TO t2] (ref: ast.RecoverTableStmt,
    FlashBackTableStmt)."""

    table: TableRef
    new_name: str = ""


@dataclass
class Admin(Node):
    """ADMIN CHECK TABLE / CHECK INDEX / SHOW DDL JOBS (ref: ast.AdminStmt)."""

    kind: str  # check_table | check_index | show_ddl_jobs
    table: Optional[TableRef] = None
    index: str = ""


@dataclass
class Kill(Node):
    """KILL [QUERY|CONNECTION] conn_id (ref: ast.KillStmt)."""

    conn_id: int
    query_only: bool = True


@dataclass
class AnalyzeTable(Node):
    tables: list[TableRef] = field(default_factory=list)


@dataclass
class LoadData(Node):
    """LOAD DATA [LOCAL] INFILE 'path' INTO TABLE t ... (ref:
    pkg/executor/load_data.go; the INSERT-like bulk path over a CSV file —
    IMPORT INTO's statement-level sibling)."""

    path: str
    table: TableRef
    local: bool = False
    fields_terminated: str = "\t"  # MySQL default: TAB
    fields_enclosed: str = ""
    ignore_lines: int = 0
    columns: list = field(default_factory=list)  # subset/reorder; [] = all
    dup_mode: str = ""  # "" | "ignore" | "replace"


def bind_params(node, values, mark: bool = False):
    """Return a copy of the AST with each ParamMarker replaced by a Literal
    of the corresponding value (EXECUTE ... USING binding). With ``mark``,
    each produced Literal remembers its parameter index so the builder's
    Constants stay traceable to EXECUTE parameters (the value-agnostic
    prepared-plan cache mutates them in place on later executions)."""
    import dataclasses

    def conv(v):
        if isinstance(v, ParamMarker):
            return Literal(values[v.idx], param_idx=v.idx if mark else -1)
        if isinstance(v, Node) and dataclasses.is_dataclass(v):
            return type(v)(**{f.name: conv(getattr(v, f.name)) for f in dataclasses.fields(v)})
        if isinstance(v, list):
            return [conv(x) for x in v]
        if isinstance(v, tuple):
            return tuple(conv(x) for x in v)
        return v

    return conv(node)
