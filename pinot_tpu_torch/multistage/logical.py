"""Multistage (v2) logical planner: SQL AST -> staged relational plan.

Reference parity: QueryEnvironment's Calcite pipeline
(pinot-query-planner/.../query/QueryEnvironment.java:100): parse -> validate ->
logical tree -> exchange placement -> DispatchableSubPlan (stage cutting with
worker assignment, planner/physical/). The node set mirrors Pinot's plan nodes
(pinot-common proto plan.proto / pinot-query-planner PlanNode impls):
TableScan, Filter, Project, Aggregate, Join, Window, Sort, SetOp, Exchange —
built TPU-first: leaf Scan+Filter stages execute on-device via the
single-stage engine, intermediate stages operate on columnar blocks.

Exchange placement (BlockExchange.getExchange parity,
pinot-query-runtime/.../runtime/operator/exchange/BlockExchange.java:50-59):
HASH below Aggregate/Join/Window/Distinct/SetOp, SINGLETON into the root
(broker) stage, BROADCAST for key-less join build sides, RANDOM for
repartition-only unions.

This is the JAX package's `multistage/logical.py`, unchanged but for its
imports, which point at the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.context import AGG_FUNCS, AggregationInfo, canonical


class PlanV2Error(ValueError):
    pass


@dataclass(frozen=True)
class Field:
    qualifier: str | None  # table alias/name the field came from
    name: str  # bare column name
    canon: str  # canonical string form producing this field


def resolve(fields: list[Field], ident: str) -> int:
    """Resolve an identifier ("x" or "alias.x") to a field index."""
    cands = [i for i, f in enumerate(fields) if f.canon == ident]
    if len(cands) == 1:
        return cands[0]
    if "." in ident:
        q, n = ident.split(".", 1)
        cands = [i for i, f in enumerate(fields) if f.qualifier == q and f.name == n]
    else:
        cands = [i for i, f in enumerate(fields) if f.name == ident]
    if len(cands) == 1:
        return cands[0]
    if len(cands) > 1:
        raise PlanV2Error(f"ambiguous column reference {ident!r}")
    raise PlanV2Error(f"unknown column {ident!r}")


def try_resolve(fields: list[Field], ident: str) -> int | None:
    try:
        return resolve(fields, ident)
    except PlanV2Error:
        return None


# ---------------------------------------------------------------------------
# Logical nodes
# ---------------------------------------------------------------------------


@dataclass
class Node:
    fields: list[Field] = dfield(default_factory=list, init=False)


@dataclass
class Scan(Node):
    table: str
    qualifier: str | None
    columns: list[str]  # pruned column set actually read
    filter: ast.FilterExpr | None = None  # pushed-down leaf filter

    def __post_init__(self):
        self.fields = [Field(self.qualifier, c, c) for c in self.columns]


@dataclass
class FilterNode(Node):
    input: Node
    condition: ast.FilterExpr

    def __post_init__(self):
        self.fields = self.input.fields


@dataclass
class Project(Node):
    input: Node
    exprs: list[ast.Expr]
    names: list[str]
    n_visible: int = -1  # trailing cols beyond this are hidden order-by keys

    def __post_init__(self):
        if self.n_visible < 0:
            self.n_visible = len(self.exprs)
        self.fields = [Field(None, n, n) for n in self.names]


@dataclass
class Aggregate(Node):
    """mode (two-phase aggregation, AggregateOperator partial/final parity):
    - direct:  single-phase, computes final values (pre-split behavior)
    - partial: emits mergeable partials [keys..., per-agg part columns]
    - final:   merges partial columns per group and finalizes"""

    input: Node
    group_exprs: list[ast.Expr]
    aggs: list[AggregationInfo]
    mode: str = "direct"

    def __post_init__(self):
        gf = []
        for g in self.group_exprs:
            c = canonical(g)
            if isinstance(g, ast.Identifier) and "." in g.name:
                q, n = g.name.split(".", 1)
                gf.append(Field(q, n, c))
            else:
                gf.append(Field(None, c, c))
        if self.mode == "partial":
            from pinot_tpu_torch.query.reduce import parts_of

            pf = []
            for a in self.aggs:
                for j in range(parts_of(a.func)):
                    pf.append(Field(None, f"{a.name}#p{j}", f"{a.name}#p{j}"))
            self.fields = gf + pf
        else:
            self.fields = gf + [Field(None, a.name, a.name) for a in self.aggs]


@dataclass
class Distinct(Node):
    input: Node

    def __post_init__(self):
        self.fields = self.input.fields


@dataclass
class Join(Node):
    left: Node
    right: Node
    kind: str  # inner | left | right | full | cross
    left_keys: list[ast.Expr]
    right_keys: list[ast.Expr]
    post_filter: ast.FilterExpr | None = None

    def __post_init__(self):
        self.fields = self.left.fields + self.right.fields


@dataclass
class WindowNode(Node):
    input: Node
    windows: list[ast.WindowFunction]
    names: list[str]

    def __post_init__(self):
        self.fields = self.input.fields + [Field(None, n, n) for n in self.names]


@dataclass
class Sort(Node):
    input: Node
    keys: list[tuple[int, bool]]  # (column index, desc)
    limit: int | None
    offset: int = 0
    drop_hidden_after: int | None = None  # keep only first N cols post-sort

    def __post_init__(self):
        fs = self.input.fields
        if self.drop_hidden_after is not None:
            fs = fs[: self.drop_hidden_after]
        self.fields = fs


@dataclass
class SetOp(Node):
    left: Node
    right: Node
    kind: str  # union | intersect | except
    all: bool

    def __post_init__(self):
        if len(self.left.fields) != len(self.right.fields):
            raise PlanV2Error(f"{self.kind.upper()} inputs have different column counts")
        self.fields = self.left.fields


@dataclass
class Rename(Node):
    """Subquery alias boundary: re-qualify visible columns under the alias."""

    input: Node
    alias: str
    n_visible: int

    def __post_init__(self):
        self.fields = [Field(self.alias, f.name, f.name) for f in self.input.fields[: self.n_visible]]


# Exchange distributions (BlockExchange.java:50-59 parity)
SINGLETON = "singleton"
HASH = "hash"
BROADCAST = "broadcast"
RANDOM = "random"


@dataclass
class Exchange(Node):
    input: Node
    dist: str
    key_exprs: list[ast.Expr] = dfield(default_factory=list)

    def __post_init__(self):
        self.fields = self.input.fields


@dataclass
class StageInput(Node):
    """Placeholder left where a child stage's Exchange was cut out."""

    stage_id: int
    src_fields: list[Field]

    def __post_init__(self):
        self.fields = self.src_fields


# ---------------------------------------------------------------------------
# Identifier collection
# ---------------------------------------------------------------------------


def _idents_expr(e: ast.Expr, out: set[str]) -> None:
    if isinstance(e, ast.Identifier):
        out.add(e.name)
    elif isinstance(e, ast.FunctionCall):
        for a in e.args:
            _idents_expr(a, out)
        if e.filter is not None:
            _idents_filter(e.filter, out)
    elif isinstance(e, ast.CaseWhen):
        for cond, val in e.whens:
            _idents_filter(cond, out)
            _idents_expr(val, out)
        if e.else_ is not None:
            _idents_expr(e.else_, out)
    elif isinstance(e, ast.BinaryOp):
        _idents_expr(e.left, out)
        _idents_expr(e.right, out)
    elif isinstance(e, ast.WindowFunction):
        _idents_expr(e.func, out)
        for p in e.partition_by:
            _idents_expr(p, out)
        for o in e.order_by:
            _idents_expr(o.expr, out)


def _idents_filter(f: ast.FilterExpr | None, out: set[str]) -> None:
    if f is None:
        return
    if isinstance(f, (ast.And, ast.Or)):
        for c in f.children:
            _idents_filter(c, out)
    elif isinstance(f, ast.Not):
        _idents_filter(f.child, out)
    elif isinstance(f, ast.Compare):
        _idents_expr(f.left, out)
        _idents_expr(f.right, out)
    elif isinstance(f, ast.Between):
        _idents_expr(f.expr, out)
        _idents_expr(f.low, out)
        _idents_expr(f.high, out)
    elif isinstance(f, ast.In):
        _idents_expr(f.expr, out)
        for v in f.values:
            _idents_expr(v, out)
    elif isinstance(f, (ast.Like, ast.RegexpLike, ast.IsNull, ast.BoolAssert)):
        _idents_expr(f.expr, out)
    elif isinstance(f, ast.DistinctFrom):
        _idents_expr(f.left, out)
        _idents_expr(f.right, out)


def _statement_idents(stmt: ast.SelectStatement) -> set[str] | None:
    """Identifiers used by the statement, or None for SELECT * (no pruning)."""
    out: set[str] = set()
    for it in stmt.select_list:
        if isinstance(it.expr, ast.Star):
            return None
        _idents_expr(it.expr, out)
    _idents_filter(stmt.where, out)
    for g in stmt.group_by:
        _idents_expr(g, out)
    _idents_filter(stmt.having, out)
    for o in stmt.order_by:
        _idents_expr(o.expr, out)
    rel = stmt.relation
    stack = [rel]
    while stack:
        r = stack.pop()
        if isinstance(r, ast.JoinRel):
            _idents_filter(r.condition, out)
            stack.append(r.left)
            stack.append(r.right)
    return out


# ---------------------------------------------------------------------------
# Plan builder
# ---------------------------------------------------------------------------


class Catalog:
    """table name -> list of column names (from the segment schema), plus
    optional row counts feeding the cost-based exchange decisions and
    optional per-column NDV estimates (dictionary cardinalities) feeding
    cardinality-gated rules (AggregateJoinTranspose)."""

    def __init__(
        self,
        tables: dict[str, list[str]],
        row_counts: dict[str, int] | None = None,
        ndv: dict[str, dict[str, int]] | None = None,
    ):
        self.tables = tables
        self.row_counts = dict(row_counts or {})
        self.ndv = {t: dict(cols) for t, cols in (ndv or {}).items()}

    def columns(self, table: str) -> list[str]:
        cols = self.tables.get(table)
        if cols is None:
            raise PlanV2Error(f"unknown table {table!r}")
        return list(cols)

    @classmethod
    def from_segments(
        cls,
        catalog: "dict[str, list]",
        schemas: "dict[str, list[str]] | None" = None,
    ) -> "Catalog":
        """Build the planning catalog from table -> segment lists: column
        names from the first segment's schema (overridable via `schemas` for
        empty tables), row counts, and per-column NDV upper bounds (sum of
        per-segment dictionary cardinalities) for cardinality-gated rules.
        The ONE construction shared by the engine and plan-shape tests."""
        cols = dict(schemas or {})
        for t, segs in catalog.items():
            if t not in cols and segs:
                cols[t] = list(segs[0].schema.columns)
        rows = {t: sum(s.n_docs for s in segs) for t, segs in catalog.items()}
        ndv: dict[str, dict[str, int]] = {}
        for t, segs in catalog.items():
            if not segs:
                continue
            per: dict[str, int] = {}
            for c in cols[t]:
                cards = [getattr(s.columns[c], "cardinality", 0) for s in segs if c in s.columns]
                # A zero/absent per-segment cardinality means "unknown", and a
                # column missing from any segment makes the sum a non-bound;
                # omit the entry so cardinality-gated rules see None and fail
                # closed instead of firing on a bogus NDV of 0.
                if len(cards) == len(segs) and cards and all(card > 0 for card in cards):
                    per[c] = sum(cards)
            ndv[t] = per
        return cls(cols, row_counts=rows, ndv=ndv)


def _conjuncts(f: ast.FilterExpr) -> list[ast.FilterExpr]:
    if isinstance(f, ast.And):
        out = []
        for c in f.children:
            out.extend(_conjuncts(c))
        return out
    return [f]


def _and_all(cs: list[ast.FilterExpr]) -> ast.FilterExpr | None:
    if not cs:
        return None
    if len(cs) == 1:
        return cs[0]
    return ast.And(tuple(cs))


def _filter_resolves(f: ast.FilterExpr, fields: list[Field]) -> bool:
    ids: set[str] = set()
    _idents_filter(f, ids)
    return all(try_resolve(fields, i) is not None for i in ids)


def _push_filter(node: Node, conjunct: ast.FilterExpr) -> bool:
    """Push a conjunct to the deepest Scan that can evaluate it."""
    if isinstance(node, Scan):
        if _filter_resolves(conjunct, node.fields):
            node.filter = _and_all(([node.filter] if node.filter else []) + [_strip_qualifiers(conjunct, node)])
            return True
        return False
    if isinstance(node, Join):
        if node.kind in ("inner", "cross"):
            sides = [node.left, node.right]
        elif node.kind == "left":
            sides = [node.left]
        elif node.kind == "right":
            sides = [node.right]
        else:
            sides = []
        for side in sides:
            if _filter_resolves(conjunct, side.fields) and _push_filter(side, conjunct):
                return True
    return False


def _strip_qualifiers(f, scan: Scan):
    """Rewrite alias.col -> col for a filter landing on a single scan."""

    def fix_e(e: ast.Expr) -> ast.Expr:
        if isinstance(e, ast.Identifier):
            return ast.Identifier(scan.fields[resolve(scan.fields, e.name)].name)
        if isinstance(e, ast.FunctionCall):
            f = fix_f(e.filter) if e.filter is not None else None
            return ast.FunctionCall(e.name, tuple(fix_e(a) for a in e.args), e.distinct, f)
        if isinstance(e, ast.BinaryOp):
            return ast.BinaryOp(e.op, fix_e(e.left), fix_e(e.right))
        if isinstance(e, ast.CaseWhen):
            return ast.CaseWhen(
                tuple((fix_f(c), fix_e(v)) for c, v in e.whens),
                fix_e(e.else_) if e.else_ is not None else None,
            )
        return e

    def fix_f(x):
        if isinstance(x, ast.And):
            return ast.And(tuple(fix_f(c) for c in x.children))
        if isinstance(x, ast.Or):
            return ast.Or(tuple(fix_f(c) for c in x.children))
        if isinstance(x, ast.Not):
            return ast.Not(fix_f(x.child))
        if isinstance(x, ast.Compare):
            return ast.Compare(x.op, fix_e(x.left), fix_e(x.right))
        if isinstance(x, ast.Between):
            return ast.Between(fix_e(x.expr), fix_e(x.low), fix_e(x.high), x.negated)
        if isinstance(x, ast.In):
            return ast.In(fix_e(x.expr), tuple(fix_e(v) for v in x.values), x.negated)
        if isinstance(x, ast.Like):
            return ast.Like(fix_e(x.expr), x.pattern, x.negated)
        if isinstance(x, ast.RegexpLike):
            return ast.RegexpLike(fix_e(x.expr), x.pattern)
        if isinstance(x, ast.IsNull):
            return ast.IsNull(fix_e(x.expr), x.negated)
        if isinstance(x, ast.DistinctFrom):
            return ast.DistinctFrom(fix_e(x.left), fix_e(x.right), x.negated)
        return x

    return fix_f(f)


def _split_equi_join(cond: ast.FilterExpr | None, left: Node, right: Node):
    """ON condition -> (left_keys, right_keys, residual filter)."""
    if cond is None:
        return [], [], None
    lkeys, rkeys, rest = [], [], []
    for c in _conjuncts(cond):
        if isinstance(c, ast.Compare) and c.op == ast.CompareOp.EQ:
            lids: set[str] = set()
            rids: set[str] = set()
            _idents_expr(c.left, lids)
            _idents_expr(c.right, rids)
            l_in_l = all(try_resolve(left.fields, i) is not None for i in lids)
            l_in_r = all(try_resolve(right.fields, i) is not None for i in lids)
            r_in_l = all(try_resolve(left.fields, i) is not None for i in rids)
            r_in_r = all(try_resolve(right.fields, i) is not None for i in rids)
            if lids and rids and l_in_l and r_in_r and not (l_in_r and r_in_l):
                lkeys.append(c.left)
                rkeys.append(c.right)
                continue
            if lids and rids and l_in_r and r_in_l:
                lkeys.append(c.right)
                rkeys.append(c.left)
                continue
        rest.append(c)
    return lkeys, rkeys, _and_all(rest)


class PlanBuilder:
    def __init__(self, catalog: Catalog):
        self.catalog = catalog

    # -- relations ----------------------------------------------------------

    def _build_relation(self, rel: ast.Relation, idents: set[str] | None) -> Node:
        if isinstance(rel, ast.TableRef):
            qualifier = rel.alias or rel.name
            all_cols = self.catalog.columns(rel.name)
            if idents is None:  # SELECT *: no pruning
                used = all_cols
            else:
                used = [
                    c
                    for c in all_cols
                    if c in idents or f"{qualifier}.{c}" in idents or f"{rel.name}.{c}" in idents
                ]
            if not used:
                used = all_cols[:1]  # COUNT(*)-style: need at least one column
            return Scan(rel.name, qualifier, used)
        if isinstance(rel, ast.SubqueryRef):
            inner = self.build(rel.stmt)
            nvis = _visible_count(inner)
            return Rename(inner, rel.alias, nvis)
        if isinstance(rel, ast.JoinRel):
            left = self._build_relation(rel.left, idents)
            right = self._build_relation(rel.right, idents)
            lkeys, rkeys, residual = _split_equi_join(rel.condition, left, right)
            if residual is not None and rel.kind == "inner":
                # try pushing residual conjuncts below the join
                keep = []
                for c in _conjuncts(residual):
                    if not (_push_filter(left, c) or _push_filter(right, c)):
                        keep.append(c)
                residual = _and_all(keep)
            return Join(left, right, rel.kind, lkeys, rkeys, residual)
        raise PlanV2Error(f"unsupported relation {rel!r}")

    # -- statements ---------------------------------------------------------

    def build(self, stmt) -> Node:
        if isinstance(stmt, ast.SetOpStatement):
            left = self.build(stmt.left)
            right = self.build(stmt.right)
            left = _visible_project(left)
            right = _visible_project(right)
            return SetOp(left, right, stmt.kind, stmt.all)
        return self._build_select(stmt)

    def _build_select(self, stmt: ast.SelectStatement) -> Node:
        from pinot_tpu_torch.query.context import _extract_aggs, _filter_agg_scan

        if stmt.relation is None:
            raise PlanV2Error("statement has no FROM relation")
        idents = _statement_idents(stmt)
        node = self._build_relation(stmt.relation, idents)

        # WHERE: push conjuncts to scans where possible, residual Filter above
        if stmt.where is not None:
            keep = []
            for c in _conjuncts(stmt.where):
                if not _push_filter(node, c):
                    keep.append(c)
            residual = _and_all(keep)
            if residual is not None:
                node = FilterNode(node, residual)

        # aggregations from SELECT/HAVING/ORDER BY
        aggs: dict[str, AggregationInfo] = {}
        has_agg = False
        for it in stmt.select_list:
            if not isinstance(it.expr, ast.Star):
                has_agg |= _extract_aggs_no_window(it.expr, aggs)
        if stmt.having is not None:
            _filter_agg_scan(stmt.having, aggs)
        for ob in stmt.order_by:
            _extract_aggs_no_window(ob.expr, aggs)

        if stmt.group_by or aggs:
            node = Aggregate(node, list(stmt.group_by), list(aggs.values()))

        if stmt.having is not None:
            node = FilterNode(node, stmt.having)

        # window functions: compute as extra columns, replace with placeholders
        windows: list[ast.WindowFunction] = []
        wnames: list[str] = []

        def strip_windows(e: ast.Expr) -> ast.Expr:
            if isinstance(e, ast.WindowFunction):
                name = f"__w{len(windows)}"
                windows.append(e)
                wnames.append(name)
                return ast.Identifier(name)
            if isinstance(e, ast.FunctionCall):
                return ast.FunctionCall(
                    e.name, tuple(strip_windows(a) for a in e.args), e.distinct, e.filter
                )
            if isinstance(e, ast.BinaryOp):
                return ast.BinaryOp(e.op, strip_windows(e.left), strip_windows(e.right))
            return e

        select_items = []
        for it in stmt.select_list:
            if isinstance(it.expr, ast.Star):
                for f in node.fields:
                    select_items.append(ast.SelectItem(ast.Identifier(f.canon if f.qualifier is None else f"{f.qualifier}.{f.name}"), None))
            else:
                select_items.append(ast.SelectItem(strip_windows(it.expr), it.alias))
        if windows:
            # one WindowNode per distinct PARTITION BY key set: each gets its
            # own hash exchange, so every window sees complete partitions
            groups: dict[tuple, list[int]] = {}
            for i, wf in enumerate(windows):
                key = tuple(canonical(p) for p in wf.partition_by)
                groups.setdefault(key, []).append(i)
            for idxs in groups.values():
                node = WindowNode(node, [windows[i] for i in idxs], [wnames[i] for i in idxs])

        # projection
        exprs = [it.expr for it in select_items]
        names = [it.alias or canonical(it.expr) for it in select_items]
        n_visible = len(exprs)

        # order-by keys: alias/canonical match into projection, else hidden col
        sort_keys: list[tuple[int, bool]] = []
        for i, ob in enumerate(stmt.order_by):
            key_expr = strip_windows(ob.expr)
            c = canonical(key_expr)
            idx = None
            for j, it in enumerate(select_items):
                if (it.alias and it.alias == c) or canonical(it.expr) == c:
                    idx = j
                    break
            if idx is None:
                exprs.append(key_expr)
                names.append(f"__ob{i}")
                idx = len(exprs) - 1
            sort_keys.append((idx, ob.desc))

        node = Project(node, exprs, names, n_visible)

        if stmt.distinct:
            if len(exprs) != n_visible:
                raise PlanV2Error("SELECT DISTINCT with non-projected ORDER BY")
            node = Distinct(node)

        if sort_keys or stmt.limit is not None:
            node = Sort(
                node,
                sort_keys,
                stmt.limit,
                stmt.offset,
                drop_hidden_after=n_visible if len(exprs) > n_visible else None,
            )
        return node


def _extract_aggs_no_window(expr: ast.Expr, out: dict[str, AggregationInfo]) -> bool:
    """Like context._extract_aggs but does not descend into window functions
    (their inner aggregates are computed by the Window operator)."""
    from pinot_tpu_torch.query.context import _extract_aggs

    if isinstance(expr, ast.WindowFunction):
        return False
    if isinstance(expr, ast.FunctionCall):
        if expr.name in AGG_FUNCS or (expr.name == "count" and expr.distinct):
            return _extract_aggs(expr, out)
        found = False
        for a in expr.args:
            found |= _extract_aggs_no_window(a, out)
        return found
    if isinstance(expr, ast.BinaryOp):
        l = _extract_aggs_no_window(expr.left, out)
        r = _extract_aggs_no_window(expr.right, out)
        return l or r
    return False


def _visible_count(node: Node) -> int:
    if isinstance(node, Project):
        return node.n_visible
    if isinstance(node, Sort):
        return len(node.fields)
    if isinstance(node, (Distinct, FilterNode)):
        return _visible_count(node.input)
    return len(node.fields)


def _visible_project(node: Node) -> Node:
    """Ensure the node exposes exactly its visible columns (drop hidden)."""
    nvis = _visible_count(node)
    if nvis == len(node.fields):
        return node
    exprs = [ast.Identifier(f.canon) for f in node.fields[:nvis]]
    names = [f.name for f in node.fields[:nvis]]
    return Project(node, exprs, names, nvis)


# ---------------------------------------------------------------------------
# Exchange placement + stage cutting (DispatchableSubPlan parity)
# ---------------------------------------------------------------------------


def _all_field_exprs(node: Node) -> list[ast.Expr]:
    return [ast.Identifier(f.canon if f.qualifier is None else f"{f.qualifier}.{f.name}") for f in node.fields]


# funcs with a mergeable-partial layout the v2 runtime implements (the v1
# reduce formats); others run single-phase
SPLITTABLE_AGGS = {
    "count",
    "sum",
    "min",
    "max",
    "avg",
    "minmaxrange",
    "distinctcount",
    "distinctcountbitmap",
    "distinctcounthll",
    "percentile",
    "percentiletdigest",
}
_SPLIT_FILTERED = {"count", "sum", "min", "max", "avg", "minmaxrange"}


def _splittable(aggs) -> bool:
    for a in aggs:
        if a.func not in SPLITTABLE_AGGS:
            return False
        if a.filter is not None and a.func not in _SPLIT_FILTERED:
            return False
        if a.func in ("percentile", "percentiletdigest") and a.arg2 is not None:
            return False
    return True


# cost model (the cost-based slice of QueryEnvironment's optimizer): row
# estimates from catalog counts drive the broadcast-vs-hash join decision
_FILTER_SELECTIVITY = 0.25
_UNKNOWN_ROWS = 1 << 40  # unknown tables never qualify for broadcast
#: build sides estimated at or below this broadcast instead of hashing
BROADCAST_ROW_LIMIT = 50_000
#: and the probe side must be at least this many times larger
BROADCAST_SKEW = 4.0


def estimate_rows(node: Node, row_counts: dict[str, int]) -> float:
    """Conservative row estimate for a subtree (selectivity heuristics in
    the style of Calcite's default RelMdRowCount)."""
    if isinstance(node, Scan):
        n = float(row_counts.get(node.table, _UNKNOWN_ROWS))
        return n * _FILTER_SELECTIVITY if node.filter is not None else n
    if isinstance(node, FilterNode):
        return _FILTER_SELECTIVITY * estimate_rows(node.input, row_counts)
    if isinstance(node, Join):
        # conservative: no reduction assumed from the join itself
        return max(
            estimate_rows(node.left, row_counts), estimate_rows(node.right, row_counts)
        )
    if isinstance(node, SetOp):
        return estimate_rows(node.left, row_counts) + estimate_rows(node.right, row_counts)
    child = getattr(node, "input", None)
    if isinstance(child, Node):
        return estimate_rows(child, row_counts)
    return float(_UNKNOWN_ROWS)


def insert_exchanges(node: Node, row_counts: dict[str, int] | None = None) -> Node:
    """Recursively insert Exchange nodes where distribution must change."""
    rc = row_counts or {}
    if isinstance(node, Scan):
        return node
    if isinstance(node, FilterNode):
        node.input = insert_exchanges(node.input, rc)
        return node
    if isinstance(node, Project):
        node.input = insert_exchanges(node.input, rc)
        return node
    if isinstance(node, Rename):
        node.input = insert_exchanges(node.input, rc)
        return node
    if isinstance(node, Aggregate):
        inp = insert_exchanges(node.input, rc)
        if _splittable(node.aggs):
            # two-phase aggregation (AggregateOperator LEAF/FINAL parity):
            # partials compute on the data's side of the exchange — the
            # shuffle then carries one row per (worker, group) instead of
            # every input row, and leaf partials can run the fused v1
            # device path (LeafStageTransferableBlockOperator parity)
            partial = Aggregate(inp, list(node.group_exprs), list(node.aggs), mode="partial")
            node.mode = "final"
            if node.group_exprs:
                # canon (qualified) names: bare names collide when two group
                # keys share one (GROUP BY a.k, b.k after a self-join)
                keys = [ast.Identifier(f.canon) for f in partial.fields[: len(node.group_exprs)]]
                node.input = Exchange(partial, HASH, keys)
            else:
                node.input = Exchange(partial, SINGLETON)
            return node
        if node.group_exprs:
            node.input = Exchange(inp, HASH, list(node.group_exprs))
        else:
            node.input = Exchange(inp, SINGLETON)
        return node
    if isinstance(node, Distinct):
        inp = insert_exchanges(node.input, rc)
        node.input = Exchange(inp, HASH, _all_field_exprs(inp))
        return node
    if isinstance(node, Join):
        left = insert_exchanges(node.left, rc)
        right = insert_exchanges(node.right, rc)
        if node.left_keys:
            # cost-based broadcast: a small build side replicates to every
            # worker so the (large) probe side never reshuffles. Correct for
            # inner/left joins only: each probe row lives on exactly one
            # worker, and the broadcast side is complete everywhere.
            est_r = estimate_rows(right, rc)
            est_l = estimate_rows(left, rc)
            if (
                node.kind in ("inner", "left")
                and est_r <= BROADCAST_ROW_LIMIT
                and est_l >= BROADCAST_SKEW * est_r
            ):
                node.left = Exchange(left, RANDOM)
                node.right = Exchange(right, BROADCAST)
            else:
                node.left = Exchange(left, HASH, list(node.left_keys))
                node.right = Exchange(right, HASH, list(node.right_keys))
        elif node.kind in ("right", "full"):
            # key-less outer joins must see both sides whole, or broadcast-side
            # unmatched rows would duplicate per worker
            node.left = Exchange(left, SINGLETON)
            node.right = Exchange(right, SINGLETON)
        else:
            # key-less inner/left/cross: randomly distribute probe, broadcast build
            node.left = Exchange(left, RANDOM)
            node.right = Exchange(right, BROADCAST)
        return node
    if isinstance(node, WindowNode):
        inp = insert_exchanges(node.input, rc)
        if node.windows and node.windows[0].partition_by:
            node.input = Exchange(inp, HASH, list(node.windows[0].partition_by))
        else:
            node.input = Exchange(inp, SINGLETON)
        return node
    if isinstance(node, Sort):
        inp = insert_exchanges(node.input, rc)
        node.input = Exchange(inp, SINGLETON)
        return node
    if isinstance(node, SetOp):
        left = insert_exchanges(node.left, rc)
        right = insert_exchanges(node.right, rc)
        if node.all and node.kind == "union":
            node.left = Exchange(left, RANDOM)
            node.right = Exchange(right, RANDOM)
        else:
            node.left = Exchange(left, HASH, _all_field_exprs(left))
            node.right = Exchange(right, HASH, _all_field_exprs(right))
        return node
    raise PlanV2Error(f"cannot place exchanges around {type(node).__name__}")


@dataclass
class Stage:
    id: int
    root: Node  # subtree with StageInput leaves
    dist: str | None  # output distribution toward the parent stage
    key_exprs: list[ast.Expr]
    parallelism: int
    inputs: list[int] = dfield(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.inputs


def _contains_scan(node: Node) -> bool:
    if isinstance(node, Scan):
        return True
    for attr in ("input", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, Node) and _contains_scan(child):
            return True
    return False


class StagePlan:
    """The cut plan: stage 0 is the root/broker stage."""

    def __init__(self, stages: dict[int, Stage], visible_names: list[str]):
        self.stages = stages
        self.visible_names = visible_names
        # per-query SET options (enableNullHandling etc.) — threaded into
        # leaf-stage QueryContexts so v1 and v2 answer identically
        self.options: dict[str, str] = {}
        #: rule-framework hit counts (rules.py), surfaced in EXPLAIN
        self.rule_stats: dict[str, int] = {}

    def __repr__(self) -> str:
        lines = []
        for sid in sorted(self.stages):
            s = self.stages[sid]
            lines.append(
                f"stage {sid} (x{s.parallelism}, ->{s.dist}, inputs={s.inputs}): {_explain(s.root)}"
            )
        if self.rule_stats:
            fired = ", ".join(f"{k}:{v}" for k, v in sorted(self.rule_stats.items()))
            lines.append(f"rules fired: {fired}")
        return "\n".join(lines)


def _explain(node: Node) -> str:
    name = type(node).__name__
    kids = [getattr(node, a) for a in ("input", "left", "right") if isinstance(getattr(node, a, None), Node)]
    if isinstance(node, Scan):
        return f"Scan({node.table}{'|' + str(node.filter) if node.filter else ''})"
    if isinstance(node, StageInput):
        return f"[stage {node.stage_id}]"
    inner = ", ".join(_explain(k) for k in kids)
    return f"{name}({inner})"


def cut_stages(root: Node, n_workers: int, visible_names: list[str]) -> StagePlan:
    stages: dict[int, Stage] = {}
    counter = [0]

    def cut(node: Node, stage_inputs: list[int]) -> Node:
        for attr in ("input", "left", "right"):
            child = getattr(node, attr, None)
            if not isinstance(child, Node):
                continue
            if isinstance(child, Exchange):
                counter[0] += 1
                sid = counter[0]
                child_inputs: list[int] = []
                sub = cut(child.input, child_inputs)
                par = n_workers
                stages[sid] = Stage(sid, sub, child.dist, child.key_exprs, par, child_inputs)
                setattr(node, attr, StageInput(sid, child.fields))
                stage_inputs.append(sid)
            else:
                cut(child, stage_inputs)
        return node

    # root stage always exists; if the tree root itself needs a SINGLETON
    # boundary (e.g. plain leaf select), wrap it
    if not isinstance(root, (Sort,)) or not isinstance(getattr(root, "input", None), Exchange):
        root = _RootCollect(Exchange(root, SINGLETON))
    root_inputs: list[int] = []
    new_root = cut(root, root_inputs)
    stages[0] = Stage(0, new_root, None, [], 1, root_inputs)
    return StagePlan(stages, visible_names)


@dataclass
class _RootCollect(Node):
    input: Node

    def __post_init__(self):
        self.fields = self.input.fields


def build_stage_plan(stmt, catalog: Catalog, n_workers: int = 2) -> StagePlan:
    from pinot_tpu_torch.multistage.rules import LOGICAL_RULES, PHYSICAL_RULES, optimize

    builder = PlanBuilder(catalog)
    root = builder.build(stmt)
    nvis = _visible_count(root)
    visible = [f.name for f in root.fields[:nvis]]
    rule_stats: dict[str, int] = {}
    from pinot_tpu_torch.multistage.rules import PLAN_CATALOG

    token = PLAN_CATALOG.set(catalog)  # stat-gated physical rules read this
    try:
        root = optimize(root, LOGICAL_RULES, rule_stats)
        root = insert_exchanges(root, catalog.row_counts)
        root = optimize(root, PHYSICAL_RULES, rule_stats)
    finally:
        PLAN_CATALOG.reset(token)
    plan = cut_stages(root, n_workers, visible)
    plan.options = dict(getattr(stmt, "options", None) or {})
    plan.rule_stats = rule_stats
    return plan
