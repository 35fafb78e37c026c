"""QueryContext: resolved, canonicalized form of a parsed query.

Reference parity: QueryContext (pinot-core/.../query/request/context/
QueryContext.java:74) built from the thrift PinotQuery. Classifies the query
(selection / aggregation / group-by / distinct), extracts the aggregation set
from SELECT + HAVING + ORDER BY (deduped by canonical name), and applies
Pinot's default LIMIT 10.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

from pinot_tpu_torch.common.errors import QueryErrorCode
from pinot_tpu_torch.query.aggregates import TWO_ARG_AGGS
from pinot_tpu_torch.query.ast import (
    Expr,
    FilterExpr,
    FunctionCall,
    Identifier,
    Literal,
    OrderByItem,
    SelectItem,
    SelectStatement,
    Star,
    And,
    Or,
    Not,
    Compare,
    Between,
    In,
    Like,
    RegexpLike,
    IsNull,
    DistinctFrom,
)
from pinot_tpu_torch.query.sql import parse_sql

DEFAULT_LIMIT = 10  # Pinot's default broker LIMIT

# Aggregation functions the engine recognizes (the core set plus the
# extended registry in aggregates.py; reference: the 94 classes in
# pinot-core/.../query/aggregation/function/).
AGG_FUNCS = {
    "count",
    "sum",
    "min",
    "max",
    "avg",
    "distinctcount",
    "distinctcountbitmap",
    "minmaxrange",
    "distinctcounthll",
    "percentile",
    "percentileest",
    "percentiletdigest",
    "mode",
    # extended registry (query/aggregates.py)
    "variance",
    "var_pop",
    "var_samp",
    "stddev_pop",
    "stddev_samp",
    "skewness",
    "kurtosis",
    "covar_pop",
    "covar_samp",
    "firstwithtime",
    "lastwithtime",
    "distinctsum",
    "distinctavg",
    "bool_and",
    "bool_or",
    "histogram",
    "percentilekll",
    "distinctcounttheta",
    "distinctcounthllplus",
    "distinctcountcpc",
    "distinctcountull",
    "segmentpartitioneddistinctcount",
    # MV variants (Count/Sum/Min/Max/Avg/DistinctCount-MVAggregationFunction)
    "countmv",
    "summv",
    "minmv",
    "maxmv",
    "avgmv",
    "distinctcountmv",
    "minmaxrangemv",
    "distinctsummv",
    "distinctavgmv",
    "distinctcountbitmapmv",
    "distinctcounthllmv",
    "percentilemv",
    # funnel family (core/query/aggregation/function/funnel/)
    "funnelcount",
    "funnelcompletecount",
    "funnelmatchstep",
    "funnelmaxstep",
    "funnelstepdurationstats",
    # smart / raw-sketch / misc long tail
    "distinctcountsmarthll",
    "percentilesmarttdigest",
    "sumprecision",
    "idset",
    "frequentlongssketch",
    "frequentstringssketch",
    "distinctcountrawhll",
    "distinctcountrawthetasketch",
    "percentilerawest",
    "percentilerawtdigest",
    # expr min/max, tuple sketches, ST_UNION, remaining raw variants
    # (ExprMinMax / *IntegerTupleSketch / StUnion / DistinctCountRaw*)
    "exprmin",
    "exprmax",
    "distinctcounttuplesketch",
    "distinctcountrawintegersumtuplesketch",
    "sumvaluesintegersumtuplesketch",
    "avgvalueintegersumtuplesketch",
    "fasthll",
    "stunion",
    "percentilerawkll",
    "distinctcountrawhllplus",
    "distinctcountrawull",
    "distinctcountrawcpcsketch",
    "distinctcountcpcsketch",
    "arrayagg",
    "listagg",
    "sum0",
    "sumarraylong",
    "sumarraydouble",
    "fourthmoment",
    # additional MV variants riding the MV-twin reduce machinery
    "percentileestmv",
    "percentiletdigestmv",
    "percentilekllmv",
    "percentilerawestmv",
    "percentilerawtdigestmv",
    "percentilerawkllmv",
    "distinctcounthllplusmv",
    "distinctcountrawhllmv",
    "distinctcountrawhllplusmv",
}

FUNNEL_AGGS = {
    "funnelcount",
    "funnelcompletecount",
    "funnelmatchstep",
    "funnelmaxstep",
    "funnelstepdurationstats",
}


def null_handling_enabled(options: dict) -> bool:
    """`SET enableNullHandling = true` (case-insensitive key lookup —
    QueryOptionsUtils.isNullHandlingEnabled parity). When on, aggregations
    skip rows whose argument column is null (per the null vector index)."""
    for k, v in options.items():
        if k.lower() == "enablenullhandling":
            return str(v).lower() in ("true", "1")
    return False


def query_option(options: dict, name: str, default=None):
    """Case-insensitive query-option lookup (QueryOptionsUtils parity —
    option keys arrive as the user typed them in `SET key = value;`)."""
    want = name.lower()
    for k, v in options.items():
        if k.lower() == want:
            return v
    return default


class QueryTimeoutError(RuntimeError):
    """Query exceeded its deadline (BrokerResponse EXECUTION_TIMEOUT_ERROR,
    errorCode 250). Deliberately NOT an OSError subtype: the scatter paths
    treat OSError as a connection-class failure and would fail over — a
    timed-out query must surface its distinct code instead."""

    error_code = QueryErrorCode.EXECUTION_TIMEOUT


class QueryCancelledError(RuntimeError):
    """Query was cancelled via DELETE /query/{id} (QueryCancelledException
    parity, errorCode 503)."""

    error_code = QueryErrorCode.QUERY_CANCELLATION


class Deadline:
    """Per-query deadline + cancel flag carried in QueryContext and shipped
    (as an absolute wall-clock timestamp) in scatter requests and multistage
    stage-plan envelopes — QueryThreadContext deadline parity.

    `deadline_ts` is `time.time()`-based so the same value is meaningful on
    every process of the cluster; None means no time limit (cancel-only)."""

    __slots__ = ("deadline_ts", "_cancelled")

    def __init__(self, deadline_ts: float | None = None):
        import threading as _threading

        self.deadline_ts = deadline_ts
        self._cancelled = _threading.Event()

    @staticmethod
    def from_timeout_ms(timeout_ms: float | None) -> "Deadline":
        import time as _time

        if timeout_ms is None:
            return Deadline(None)
        return Deadline(_time.time() + float(timeout_ms) / 1e3)

    def remaining(self) -> float | None:
        """Seconds until expiry (may be <= 0); None when unbounded."""
        if self.deadline_ts is None:
            return None
        import time as _time

        return self.deadline_ts - _time.time()

    @property
    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def cancel(self) -> None:
        self._cancelled.set()

    def check(self, where: str = "") -> None:
        """Raise if cancelled or expired — the per-block / per-segment
        enforcement point. A checkpoint that fires leaves a span event on the
        active trace (no-op otherwise) before raising."""
        from pinot_tpu_torch.common.trace import trace_event

        if self._cancelled.is_set():
            trace_event("deadline.cancelled", where=where)
            raise QueryCancelledError(f"query cancelled{f' at {where}' if where else ''}")
        if self.expired:
            trace_event("deadline.expired", where=where)
            raise QueryTimeoutError(
                f"query exceeded its deadline{f' at {where}' if where else ''}"
            )


class QueryType(Enum):
    SELECTION = "SELECTION"
    SELECTION_ORDER_BY = "SELECTION_ORDER_BY"
    AGGREGATION = "AGGREGATION"
    GROUP_BY = "GROUP_BY"
    DISTINCT = "DISTINCT"


def canonical(expr: Expr) -> str:
    """Canonical output/column name for an expression (Pinot emits lowercase
    function names with raw args, e.g. `sum(runs)`, `count(*)`)."""
    if isinstance(expr, FunctionCall):
        d = "distinct " if expr.distinct else ""
        base = f"{expr.name}({d}{','.join(canonical(a) for a in expr.args)})"
        if expr.filter is not None:
            # two aggs differing only in FILTER must not merge by name
            base += f" filter(where {expr.filter})"
        return base
    if isinstance(expr, Star):
        return "*"
    if isinstance(expr, Identifier):
        return expr.name
    if isinstance(expr, Literal):
        return str(expr)
    # BinaryOp
    return str(expr)


@dataclass(frozen=True)
class AggregationInfo:
    func: str  # canonical lower-case function name
    arg: Expr | None  # None for count(*)
    name: str  # canonical output name
    extra: tuple = ()  # literal args beyond the column (e.g. percentile rank)
    arg2: Expr | None = None  # second value expression (covar, firstwithtime)
    # FILTER (WHERE ...) clause (FilteredAggregationFunction parity): the
    # aggregation sees only docs matching BOTH the query filter and this
    filter: object | None = None

    def __str__(self) -> str:
        return self.name


def _parse_funnel_args(fname: str, expr: FunctionCall):
    """Parse the funnel dialect (see query/funnel.py docstring). Returns
    (arg, arg2, extra): count variants -> (correlate, None, ('steps', steps));
    windowed -> (ts_expr, correlate, ('steps', window, steps))."""
    from pinot_tpu_torch.query.ast import PredicateExpr

    windowed = fname in ("funnelmatchstep", "funnelmaxstep", "funnelstepdurationstats")
    pos = list(expr.args)
    ts = None
    window = 0.0
    if windowed:
        if len(pos) < 3 or not isinstance(pos[1], Literal):
            raise ValueError(f"{fname} requires (ts_expr, window, STEPS(...), CORRELATE_BY(col))")
        ts, window, pos = pos[0], float(pos[1].value), pos[2:]
    steps = None
    corr = None
    for a in pos:
        if isinstance(a, FunctionCall) and a.name == "steps":
            parsed = []
            for x in a.args:
                if not isinstance(x, PredicateExpr):
                    raise ValueError(f"{fname} STEPS entries must be predicates (col = value)")
                parsed.append(x.pred)
            steps = tuple(parsed)
        elif isinstance(a, FunctionCall) and a.name == "correlate_by":
            if len(a.args) != 1:
                raise ValueError("CORRELATE_BY takes one column")
            corr = a.args[0]
        elif isinstance(a, FunctionCall) and a.name == "settings":
            continue  # accepted, currently advisory
        else:
            raise ValueError(f"unexpected {fname} argument: {a}")
    if not steps or corr is None:
        raise ValueError(f"{fname} requires STEPS(...) and CORRELATE_BY(col)")
    if windowed:
        return ts, corr, ("steps", window, steps)
    return corr, None, ("steps", steps)


def _extract_aggs(expr: Expr, out: dict[str, AggregationInfo]) -> bool:
    """Collect aggregations in expr; returns True if expr contains any."""
    from pinot_tpu_torch.query.ast import BinaryOp

    if isinstance(expr, FunctionCall):
        fname = expr.name
        if fname in AGG_FUNCS or (fname == "count" and expr.distinct):
            extra: tuple = ()
            arg2: Expr | None = None
            if fname == "count" and expr.distinct:
                # COUNT(DISTINCT x) is DISTINCTCOUNT(x) (Pinot rewrites the same)
                func, arg = "distinctcount", expr.args[0]
                name = canonical(FunctionCall("distinctcount", expr.args))
            elif fname == "count":
                # COUNT(col) keeps its argument: identical to COUNT(*) in
                # default mode, but with enableNullHandling it counts only
                # non-null rows of that column (Pinot parity)
                carg = expr.args[0] if expr.args and not isinstance(expr.args[0], Star) else None
                func, arg, name = "count", carg, canonical(expr)
            elif fname in FUNNEL_AGGS:
                func, name = fname, canonical(expr)
                arg, arg2, extra = _parse_funnel_args(fname, expr)
            else:
                func, arg, name = fname, (expr.args[0] if expr.args else None), canonical(expr)
                if fname in (
                    "percentile",
                    "percentileest",
                    "percentiletdigest",
                    "percentilekll",
                    "percentilemv",
                    "percentilesmarttdigest",
                    "percentilerawest",
                    "percentilerawtdigest",
                    "percentilerawkll",
                    "percentileestmv",
                    "percentiletdigestmv",
                    "percentilekllmv",
                    "percentilerawestmv",
                    "percentilerawtdigestmv",
                    "percentilerawkllmv",
                ):
                    if len(expr.args) < 2 or not isinstance(expr.args[1], Literal):
                        raise ValueError(f"{fname} requires (column, percentile) arguments")
                    # optional 3rd literal: t-digest compression / KLL k
                    # (PercentileTDigestAggregationFunction(col, pct, compression),
                    #  PercentileKLLAggregationFunction(col, pct, kValue))
                    extra = (float(expr.args[1].value),) + tuple(
                        float(a.value) for a in expr.args[2:3] if isinstance(a, Literal)
                    )
                elif fname in (
                    "distinctcounthllplus",
                    "distinctcountrawhllplus",
                    "distinctcounthllplusmv",
                    "distinctcountrawhllplusmv",
                ):
                    # DISTINCTCOUNTHLLPLUS(col[, p[, sp]]) — sp accepted and
                    # ignored (no sparse mode in the dense implementation)
                    extra = tuple(
                        int(a.value) for a in expr.args[1:3] if isinstance(a, Literal)
                    )
                elif fname == "distinctcounttheta" and len(expr.args) > 1:
                    # DISTINCTCOUNTTHETASKETCH(col, 'params', 'pred1', ...,
                    # 'SET_OP($1,$2)') — trailing string literals carry the
                    # filtered-sketch definitions + post-agg set expression
                    # (DistinctCountThetaSketchAggregationFunction parity)
                    extra = tuple(
                        str(a.value) for a in expr.args[1:] if isinstance(a, Literal)
                    )
                elif fname in ("arrayagg", "listagg"):
                    # trailing literals: dataType[/distinct] or the separator
                    extra = tuple(
                        a.value for a in expr.args[1:] if isinstance(a, Literal)
                    )
                    if fname == "arrayagg" and not extra:
                        raise ValueError("arrayagg requires (column, 'dataType'[, distinct]) arguments")
                elif fname in ("frequentlongssketch", "frequentstringssketch"):
                    # optional maxMapSize literal (FrequentItems sketch size)
                    extra = (
                        int(expr.args[1].value)
                        if len(expr.args) > 1 and isinstance(expr.args[1], Literal)
                        else 64,
                    )
                elif fname == "histogram":
                    if len(expr.args) != 4 or not all(isinstance(a, Literal) for a in expr.args[1:]):
                        raise ValueError("histogram requires (column, lo, hi, numBins) arguments")
                    extra = tuple(float(a.value) for a in expr.args[1:])
                elif fname in TWO_ARG_AGGS:
                    if len(expr.args) < 2:
                        # distinct tuple-sketch counts don't need a value column
                        if fname in (
                            "distinctcounttuplesketch",
                            "distinctcountrawintegersumtuplesketch",
                        ):
                            out.setdefault(name, AggregationInfo(func, arg, name, (), None, expr.filter))
                            return True
                        raise ValueError(f"{fname} requires two column arguments")
                    arg2 = expr.args[1]
                    # trailing literal args (e.g. firstwithtime dataType) -> extra
                    extra = tuple(a.value for a in expr.args[2:] if isinstance(a, Literal))
            out.setdefault(name, AggregationInfo(func, arg, name, extra, arg2, expr.filter))
            return True
        # transform function: recurse into args
        found = False
        for a in expr.args:
            found |= _extract_aggs(a, out)
        return found
    if isinstance(expr, BinaryOp):
        left = _extract_aggs(expr.left, out)
        right = _extract_aggs(expr.right, out)
        return left or right
    return False


def _filter_agg_scan(f: FilterExpr, out: dict[str, AggregationInfo]) -> None:
    if isinstance(f, (And, Or)):
        for c in f.children:
            _filter_agg_scan(c, out)
    elif isinstance(f, Not):
        _filter_agg_scan(f.child, out)
    elif isinstance(f, Compare):
        _extract_aggs(f.left, out)
        _extract_aggs(f.right, out)
    elif isinstance(f, Between):
        _extract_aggs(f.expr, out)
    elif isinstance(f, (In, Like, RegexpLike, IsNull)):
        _extract_aggs(f.expr, out)
    elif isinstance(f, DistinctFrom):
        _extract_aggs(f.left, out)
        _extract_aggs(f.right, out)
    else:
        from pinot_tpu_torch.query.ast import BoolAssert

        if isinstance(f, BoolAssert):
            _extract_aggs(f.expr, out)
    # PredicateFunction args never contain aggregates (index probes only)


def _collect_identifiers(expr: Expr, out: set[str]) -> None:
    from pinot_tpu_torch.query.ast import BinaryOp, PredicateExpr

    if isinstance(expr, Identifier):
        out.add(expr.name)
    elif isinstance(expr, PredicateExpr):
        _collect_filter_identifiers(expr.pred, out)
    elif isinstance(expr, FunctionCall):
        for a in expr.args:
            _collect_identifiers(a, out)
        if expr.filter is not None:
            _collect_filter_identifiers(expr.filter, out)
    elif isinstance(expr, BinaryOp):
        _collect_identifiers(expr.left, out)
        _collect_identifiers(expr.right, out)
    else:
        from pinot_tpu_torch.query.ast import CaseWhen

        if isinstance(expr, CaseWhen):
            for cond, val in expr.whens:
                _collect_filter_identifiers(cond, out)
                _collect_identifiers(val, out)
            if expr.else_ is not None:
                _collect_identifiers(expr.else_, out)


def _collect_filter_identifiers(f: FilterExpr | None, out: set[str]) -> None:
    if f is None:
        return
    if isinstance(f, (And, Or)):
        for c in f.children:
            _collect_filter_identifiers(c, out)
    elif isinstance(f, Not):
        _collect_filter_identifiers(f.child, out)
    elif isinstance(f, Compare):
        _collect_identifiers(f.left, out)
        _collect_identifiers(f.right, out)
    elif isinstance(f, Between):
        _collect_identifiers(f.expr, out)
        _collect_identifiers(f.low, out)
        _collect_identifiers(f.high, out)
    elif isinstance(f, In):
        _collect_identifiers(f.expr, out)
    elif isinstance(f, (Like, RegexpLike, IsNull)):
        _collect_identifiers(f.expr, out)
    elif isinstance(f, DistinctFrom):
        _collect_identifiers(f.left, out)
        _collect_identifiers(f.right, out)
    else:
        from pinot_tpu_torch.query.ast import BoolAssert, PredicateFunction

        if isinstance(f, PredicateFunction):
            for a in f.args:
                _collect_identifiers(a, out)
        elif isinstance(f, BoolAssert):
            _collect_identifiers(f.expr, out)


def expand_star(stmt: SelectStatement, schema) -> None:
    """Expand SELECT * into explicit schema columns, in place. Shared by the
    single-node engine and the broker (one definition, one semantics)."""
    if schema is None or not any(isinstance(it.expr, Star) for it in stmt.select_list):
        return
    new_items = []
    for it in stmt.select_list:
        if isinstance(it.expr, Star):
            new_items.extend(SelectItem(Identifier(c), None) for c in schema.columns)
        else:
            new_items.append(it)
    stmt.select_list = new_items


@dataclass(frozen=True)
class GapfillSpec:
    """Broker-side gap filling for time-bucketed results (simplified
    GapfillProcessor parity, pinot-core/.../reduce/GapfillProcessor.java):
    `GAPFILL(time_expr, start, end, step [, FILL(col, 'MODE')...])` in the
    SELECT list emits one row per [start, end) step bucket, synthesizing
    missing buckets. Modes: FILL_PREVIOUS_VALUE, FILL_DEFAULT_VALUE
    (0 / 'null'), default null. Times are numeric epoch buckets."""

    col_index: int
    start: float
    end: float
    step: float
    fills: dict[int, str]  # select-column index -> fill mode


def _extract_gapfill(stmt: SelectStatement) -> "GapfillSpec | None":
    """Find `GAPFILL(time_expr, start, end, step [, FILL(col,'MODE')...])` in
    the SELECT list. When present, unwrap the call to its inner time expression
    (so planning/execution see a normal bucketed time column) and return the
    GapfillSpec the broker reduce applies; otherwise return None.

    Reference parity: GapfillQueryContext extraction feeding GapfillProcessor
    (pinot-core/.../query/reduce/GapfillProcessor.java).
    """
    gf_index = -1
    gf_call: FunctionCall | None = None
    for i, item in enumerate(stmt.select_list):
        e = item.expr
        if isinstance(e, FunctionCall) and e.name.lower() == "gapfill":
            if gf_call is not None:
                raise ValueError("only one GAPFILL() call is supported")
            gf_index, gf_call = i, e
    if gf_call is None:
        return None
    if len(gf_call.args) < 4:
        raise ValueError("GAPFILL requires (time_expr, start, end, step [, FILL(col,'MODE')...])")
    time_expr = gf_call.args[0]
    bounds = []
    for arg in gf_call.args[1:4]:
        if not isinstance(arg, Literal) or isinstance(arg.value, str):
            raise ValueError("GAPFILL start/end/step must be numeric literals")
        bounds.append(float(arg.value))
    start, end, step = bounds
    if step <= 0:
        raise ValueError("GAPFILL step must be positive")

    # Unwrap in the select list (and any matching group-by entry) in place.
    old_canonical = canonical(gf_call)
    stmt.select_list[gf_index] = SelectItem(time_expr, stmt.select_list[gf_index].alias)
    stmt.group_by = [
        time_expr if canonical(g) == old_canonical else g for g in stmt.group_by
    ]

    # Output-name -> select index, for resolving FILL(col, ...) targets.
    name_to_idx: dict[str, int] = {}
    for i, item in enumerate(stmt.select_list):
        name_to_idx[canonical(item.expr)] = i
        if item.alias:
            name_to_idx[item.alias] = i

    fills: dict[int, str] = {}
    for arg in gf_call.args[4:]:
        if not (isinstance(arg, FunctionCall) and arg.name.lower() == "fill" and len(arg.args) == 2):
            raise ValueError("GAPFILL extra args must be FILL(col, 'MODE') calls")
        col, mode = arg.args
        if not isinstance(mode, Literal) or not isinstance(mode.value, str):
            raise ValueError("FILL mode must be a string literal")
        key = col.name if isinstance(col, Identifier) else canonical(col)
        if key not in name_to_idx:
            raise ValueError(f"FILL column {key!r} is not in the SELECT list")
        mode_u = mode.value.upper()
        if mode_u not in ("FILL_PREVIOUS_VALUE", "FILL_DEFAULT_VALUE"):
            raise ValueError(f"unsupported FILL mode {mode.value!r}")
        fills[name_to_idx[key]] = mode_u

    return GapfillSpec(col_index=gf_index, start=start, end=end, step=step, fills=fills)


@dataclass
class QueryContext:
    statement: SelectStatement
    table: str
    query_type: QueryType
    select_items: list[SelectItem]
    aggregations: list[AggregationInfo]  # from SELECT + HAVING + ORDER BY
    group_by: list[Expr]
    filter: FilterExpr | None
    having: FilterExpr | None
    order_by: list[OrderByItem]
    limit: int
    offset: int
    options: dict[str, str] = field(default_factory=dict)
    # engine-computed cross-segment planning hints (e.g. global min/max bounds
    # for histogram-based percentile sketches)
    hints: dict = field(default_factory=dict)
    gapfill: "GapfillSpec | None" = None
    # per-query deadline + cancel flag (QueryThreadContext parity); set by
    # the broker (timeoutMs option / ResilienceConfig default) or by the
    # server from the shipped absolute timestamp. None = unbounded.
    deadline: "Deadline | None" = None

    @property
    def columns_used(self) -> set[str]:
        out: set[str] = set()
        for item in self.select_items:
            _collect_identifiers(item.expr, out)
        for g in self.group_by:
            _collect_identifiers(g, out)
        for o in self.order_by:
            _collect_identifiers(o.expr, out)
        _collect_filter_identifiers(self.filter, out)
        _collect_filter_identifiers(self.having, out)
        return out

    @property
    def post_filter_columns(self) -> set[str]:
        """Columns read AFTER the filter phase (projection, grouping,
        ordering, having) — the multiplier behind Pinot's
        numEntriesScannedPostFilter (docsMatched x projected columns)."""
        out: set[str] = set()
        for item in self.select_items:
            _collect_identifiers(item.expr, out)
        for g in self.group_by:
            _collect_identifiers(g, out)
        for o in self.order_by:
            _collect_identifiers(o.expr, out)
        _collect_filter_identifiers(self.having, out)
        return out

    def output_name(self, item: SelectItem) -> str:
        return item.alias or canonical(item.expr)

    @staticmethod
    def from_sql(sql: str) -> "QueryContext":
        return QueryContext.from_statement(parse_sql(sql))

    @staticmethod
    def from_statement(stmt: SelectStatement) -> "QueryContext":
        # GROUP BY alias substitution (reference: alias replacement in
        # QueryContextConverterUtils.getQueryContext, pinot-core/.../request/
        # context/utils/QueryContextConverterUtils.java): `GROUP BY c` where c
        # aliases a select expression groups by that expression.
        alias_sub = {
            it.alias: it.expr
            for it in stmt.select_list
            if it.alias and not isinstance(it.expr, Star)
        }
        if alias_sub:
            def _sub(e: Expr) -> Expr:
                if isinstance(e, Identifier):
                    rep = alias_sub.get(e.name)
                    if rep is not None and canonical(rep) != e.name:
                        return rep
                return e

            stmt.group_by = [_sub(g) for g in stmt.group_by]
        gapfill = _extract_gapfill(stmt)
        # dedup identical GROUP BY expressions (GROUP BY a, a == GROUP BY a):
        # duplicate canonical keys would collide in the reduce row env
        seen_gb: set[str] = set()
        deduped_gb = []
        for g in stmt.group_by:
            cn = canonical(g)
            if cn not in seen_gb:
                seen_gb.add(cn)
                deduped_gb.append(g)
        stmt.group_by = deduped_gb
        aggs: dict[str, AggregationInfo] = {}
        has_agg = False
        for item in stmt.select_list:
            has_agg |= _extract_aggs(item.expr, aggs)
        if stmt.having is not None:
            _filter_agg_scan(stmt.having, aggs)
        for ob in stmt.order_by:
            _extract_aggs(ob.expr, aggs)

        if stmt.distinct:
            qt = QueryType.DISTINCT
            if has_agg:
                raise ValueError("SELECT DISTINCT with aggregations is not supported")
        elif stmt.group_by:
            qt = QueryType.GROUP_BY
        elif has_agg or aggs:
            qt = QueryType.AGGREGATION
        elif stmt.order_by:
            qt = QueryType.SELECTION_ORDER_BY
        else:
            qt = QueryType.SELECTION

        limit = stmt.limit if stmt.limit is not None else DEFAULT_LIMIT
        return QueryContext(
            statement=stmt,
            table=stmt.from_table,
            query_type=qt,
            select_items=list(stmt.select_list),
            aggregations=list(aggs.values()),
            group_by=list(stmt.group_by),
            filter=stmt.where,
            having=stmt.having,
            order_by=list(stmt.order_by),
            limit=limit,
            offset=stmt.offset,
            options=dict(stmt.options),
            gapfill=gapfill,
        )
