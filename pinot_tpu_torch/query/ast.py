"""SQL abstract syntax tree.

Reference parity: the thrift `PinotQuery` produced by CalciteSqlParser
(pinot-common sql-utils; pinot-common/src/thrift/query.thrift:21). We model the
same SELECT surface Pinot's single-stage engine accepts: projections with
expressions and aliases, boolean filter trees, GROUP BY / HAVING / ORDER BY /
LIMIT-OFFSET, DISTINCT, and function calls (aggregation + transform).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum
from typing import Any


class Expr:
    """Base class for expressions."""


@dataclass(frozen=True)
class Literal(Expr):
    value: Any  # int | float | str | bool | None

    def __str__(self) -> str:
        if isinstance(self.value, str):
            return "'" + self.value.replace("'", "''") + "'"
        return str(self.value)


@dataclass(frozen=True)
class Identifier(Expr):
    name: str

    def __str__(self) -> str:
        return self.name


@dataclass(frozen=True)
class Star(Expr):
    def __str__(self) -> str:
        return "*"


@dataclass(frozen=True)
class FunctionCall(Expr):
    name: str  # canonical lower-case
    args: tuple[Expr, ...]
    distinct: bool = False
    # FILTER (WHERE ...) on an aggregation call
    # (parity: FilteredAggregationFunction,
    #  pinot-core/.../aggregation/function/FilteredAggregationFunction.java)
    filter: "FilterExpr | None" = None

    def __str__(self) -> str:
        d = "DISTINCT " if self.distinct else ""
        base = f"{self.name}({d}{','.join(map(str, self.args))})"
        if self.filter is not None:
            base += f" FILTER(WHERE {self.filter})"
        return base


@dataclass(frozen=True)
class CaseWhen(Expr):
    """Searched CASE (parity: CaseTransformFunction,
    pinot-core/.../operator/transform/function/CaseTransformFunction.java).
    Simple CASE (`CASE x WHEN v ...`) is desugared to equality compares at
    parse time. A missing ELSE takes the type's default value (Pinot's
    null-handling-disabled behavior: 0 for numerics, 'null' for strings)."""

    whens: tuple  # ((FilterExpr, Expr), ...)
    else_: "Expr | None" = None

    def __str__(self) -> str:
        parts = " ".join(f"WHEN {c} THEN {v}" for c, v in self.whens)
        e = f" ELSE {self.else_}" if self.else_ is not None else ""
        return f"CASE {parts}{e} END"


@dataclass(frozen=True)
class BinaryOp(Expr):
    """Arithmetic: + - * / %"""

    op: str
    left: Expr
    right: Expr

    def __str__(self) -> str:
        return f"({self.left}{self.op}{self.right})"


# ---------------------------------------------------------------------------
# Filter (boolean) expressions — kept distinct from value expressions, like
# Pinot's FilterContext vs ExpressionContext split (pinot-common
# request/context/FilterContext.java).
# ---------------------------------------------------------------------------


class FilterExpr:
    """Base class for boolean filter nodes."""


class CompareOp(Enum):
    EQ = "="
    NEQ = "!="
    LT = "<"
    LTE = "<="
    GT = ">"
    GTE = ">="


@dataclass(frozen=True)
class Compare(FilterExpr):
    op: CompareOp
    left: Expr
    right: Expr

    def __str__(self) -> str:
        return f"{self.left} {self.op.value} {self.right}"


@dataclass(frozen=True)
class Between(FilterExpr):
    expr: Expr
    low: Expr
    high: Expr
    negated: bool = False

    def __str__(self) -> str:
        n = "NOT " if self.negated else ""
        return f"{self.expr} {n}BETWEEN {self.low} AND {self.high}"


@dataclass(frozen=True)
class In(FilterExpr):
    expr: Expr
    values: tuple[Expr, ...]
    negated: bool = False

    def __str__(self) -> str:
        n = "NOT " if self.negated else ""
        return f"{self.expr} {n}IN ({','.join(map(str, self.values))})"


@dataclass(frozen=True)
class Like(FilterExpr):
    expr: Expr
    pattern: str
    negated: bool = False

    def __str__(self) -> str:
        n = "NOT " if self.negated else ""
        return f"{self.expr} {n}LIKE '{self.pattern}'"


@dataclass(frozen=True)
class RegexpLike(FilterExpr):
    expr: Expr
    pattern: str

    def __str__(self) -> str:
        return f"REGEXP_LIKE({self.expr}, '{self.pattern}')"


@dataclass(frozen=True)
class ArrayLiteral(Expr):
    """ARRAY[1.0, 2.0, ...] — vector literals for VECTOR_SIMILARITY etc."""

    values: tuple

    def __str__(self) -> str:
        return "ARRAY[" + ",".join(map(str, self.values)) + "]"


@dataclass(frozen=True)
class PredicateExpr(Expr):
    """A boolean predicate used in VALUE position — function arguments that
    are conditions, e.g. the step conditions of the funnel aggregations:
    FUNNELCOUNT(STEPS(url = '/cart', url = '/buy'), CORRELATE_BY(uid)).
    Reference parity: Pinot passes funnel steps as filter-context arguments
    (core/query/aggregation/function/funnel/)."""

    pred: "FilterExpr"

    def __str__(self) -> str:
        return str(self.pred)


@dataclass(frozen=True)
class PredicateFunction(FilterExpr):
    """Boolean index-probe functions used as WHERE predicates: TEXT_MATCH,
    JSON_MATCH, VECTOR_SIMILARITY, ST_WITHIN-style geo probes.

    Reference parity: Pinot models these as function-call filter contexts
    lowering to TextMatchFilterOperator / JsonMatchFilterOperator /
    VectorSimilarityFilterOperator (core/operator/filter/)."""

    name: str  # canonical lower-case
    args: tuple[Expr, ...]

    def __str__(self) -> str:
        return f"{self.name}({','.join(map(str, self.args))})"


@dataclass(frozen=True)
class IsNull(FilterExpr):
    expr: Expr
    negated: bool = False  # negated => IS NOT NULL

    def __str__(self) -> str:
        return f"{self.expr} IS {'NOT ' if self.negated else ''}NULL"


@dataclass(frozen=True)
class BoolAssert(FilterExpr):
    """IS [NOT] TRUE / IS [NOT] FALSE (reference:
    core/operator/transform/function/Is{,Not}{True,False}TransformFunction).
    The positive forms exclude nulls; the NOT forms include them (SQL
    three-valued assertion semantics)."""

    expr: Expr
    want_true: bool  # IS TRUE vs IS FALSE
    negated: bool = False

    def __str__(self) -> str:
        return f"{self.expr} IS {'NOT ' if self.negated else ''}{'TRUE' if self.want_true else 'FALSE'}"


@dataclass(frozen=True)
class DistinctFrom(FilterExpr):
    """Null-aware inequality: `a IS DISTINCT FROM b` is true when the values
    differ OR exactly one side is null; never null itself."""

    left: Expr
    right: Expr
    negated: bool = False  # negated => IS NOT DISTINCT FROM

    def __str__(self) -> str:
        return f"{self.left} IS {'NOT ' if self.negated else ''}DISTINCT FROM {self.right}"


@dataclass(frozen=True)
class And(FilterExpr):
    children: tuple[FilterExpr, ...]

    def __str__(self) -> str:
        return "(" + " AND ".join(map(str, self.children)) + ")"


@dataclass(frozen=True)
class Or(FilterExpr):
    children: tuple[FilterExpr, ...]

    def __str__(self) -> str:
        return "(" + " OR ".join(map(str, self.children)) + ")"


@dataclass(frozen=True)
class Not(FilterExpr):
    child: FilterExpr

    def __str__(self) -> str:
        return f"NOT ({self.child})"


# HAVING predicates compare aggregate expressions; reuse Compare/And/Or/Not
# with FunctionCall leaves.


@dataclass(frozen=True)
class OrderByItem:
    expr: "Expr"
    desc: bool = False

    def __str__(self) -> str:
        return f"{self.expr} {'DESC' if self.desc else 'ASC'}"


@dataclass(frozen=True)
class WindowFunction(Expr):
    """fn(args) OVER (PARTITION BY ... ORDER BY ...).

    Reference parity: WindowNode / WindowAggregateOperator
    (pinot-query-runtime/.../runtime/operator/WindowAggregateOperator.java).
    """

    func: FunctionCall
    partition_by: tuple[Expr, ...] = ()
    order_by: tuple[OrderByItem, ...] = ()

    def __str__(self) -> str:
        parts = []
        if self.partition_by:
            parts.append("PARTITION BY " + ",".join(map(str, self.partition_by)))
        if self.order_by:
            parts.append("ORDER BY " + ",".join(map(str, self.order_by)))
        return f"{self.func} OVER ({' '.join(parts)})"


# ---------------------------------------------------------------------------
# Relations (FROM clause) — multistage engine surface. Reference parity: the
# Calcite relational tree QueryEnvironment plans over
# (pinot-query-planner/.../query/QueryEnvironment.java:100).
# ---------------------------------------------------------------------------


class Relation:
    """Base class for FROM-clause relations."""


@dataclass(frozen=True)
class TableRef(Relation):
    name: str
    alias: str | None = None

    def __str__(self) -> str:
        return f"{self.name} AS {self.alias}" if self.alias else self.name


@dataclass(frozen=True)
class SubqueryRef(Relation):
    stmt: "SelectStatement | SetOpStatement"
    alias: str

    def __str__(self) -> str:
        return f"(<subquery>) AS {self.alias}"


@dataclass(frozen=True)
class JoinRel(Relation):
    left: Relation
    right: Relation
    kind: str  # inner | left | right | full | cross
    condition: FilterExpr | None

    def __str__(self) -> str:
        on = f" ON {self.condition}" if self.condition is not None else ""
        return f"({self.left} {self.kind.upper()} JOIN {self.right}{on})"


@dataclass(frozen=True)
class SelectItem:
    expr: Expr
    alias: str | None = None

    def __str__(self) -> str:
        return f"{self.expr} AS {self.alias}" if self.alias else str(self.expr)


@dataclass
class SelectStatement:
    select_list: list[SelectItem]
    from_table: str  # simple-table name ("" when relation is a join/subquery)
    distinct: bool = False
    where: FilterExpr | None = None
    group_by: list[Expr] = field(default_factory=list)
    having: FilterExpr | None = None
    order_by: list[OrderByItem] = field(default_factory=list)
    limit: int | None = None
    offset: int = 0
    options: dict[str, str] = field(default_factory=dict)
    relation: Relation | None = None  # full FROM tree (multistage engine)
    # EXPLAIN PLAN FOR ... : return the operator tree instead of executing
    explain: bool = False
    # EXPLAIN ANALYZE ... : execute AND return the tree annotated with the
    # merged runtime stats
    explain_analyze: bool = False

    @property
    def needs_multistage(self) -> bool:
        """True when the statement requires the v2 engine (joins, subqueries,
        aliased tables, window functions)."""
        if self.relation is not None and not (
            isinstance(self.relation, TableRef) and self.relation.alias is None
        ):
            return True
        return any(_has_window(it.expr) for it in self.select_list)


def _has_window(expr: Expr) -> bool:
    if isinstance(expr, WindowFunction):
        return True
    if isinstance(expr, FunctionCall):
        return any(_has_window(a) for a in expr.args)
    if isinstance(expr, BinaryOp):
        return _has_window(expr.left) or _has_window(expr.right)
    return False


@dataclass
class SetOpStatement:
    """UNION / INTERSECT / EXCEPT of two queries.

    Reference parity: SetOpNode → Union/Intersect/MinusOperator
    (pinot-query-runtime/.../runtime/operator/set/)."""

    kind: str  # union | intersect | except
    all: bool
    left: "SelectStatement | SetOpStatement"
    right: "SelectStatement | SetOpStatement"
    options: dict[str, str] = field(default_factory=dict)

    @property
    def needs_multistage(self) -> bool:
        return True
