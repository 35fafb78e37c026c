"""Per-segment physical planning: QueryContext -> (static spec, dynamic operands).

Reference parity: InstancePlanMakerImplV2.makeSegmentPlanNode (pinot-core/.../
plan/maker/InstancePlanMakerImplV2.java:291) + the filter operators
(core/operator/filter/) and predicate evaluators. This is the JAX package's
planner (`pinot_tpu/query/plan.py`) carried over: for the lowerings it keeps,
it emits the same spec tuples and the same operands, so one spec means the
same program in both packages.

 * The *spec* is a hashable nested tuple describing the program shape
   (predicate kinds, aggregation set, group layout, static padded sizes).
 * All literals/bounds/LUTs are *operands* (numpy arrays/scalars staged to the
   device per query), so `WHERE league='NL'` and `WHERE league='AL'` share one
   spec.
 * Predicates on dictionary-encoded columns lower to integer id compares with
   host-resolved bounds (the sorted-dictionary trick from
   BaseDictionaryBasedPredicateEvaluator); IN/LIKE/REGEXP lower to a boolean
   LUT over dict ids, gathered per doc.
 * Dense group ids are sum(ids_i * stride_i) — the cardinality-product scheme
   of DictionaryBasedGroupKeyGenerator.java:119-130 — with the group count
   rounded up to a multiple of 256 as the reference rounds it.

Query shapes whose lowering needs a module that is not ported yet (the host
executor, transforms, sketches, null handling, multi-value columns, the sparse
group path, selection) raise NotImplementedError; `DeviceFallback`, which the
reference answers with its host executor (e.g. DISTINCTCOUNT of a raw column,
or a grouped presence matrix over MAX_PRESENCE_CELLS), is one such error here.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from pinot_tpu_torch.common.types import DataType
from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.ast import CompareOp, Expr, FilterExpr
from pinot_tpu_torch.query.context import AggregationInfo, QueryContext, QueryType, null_handling_enabled
from pinot_tpu_torch.segment.segment import ImmutableSegment

MAX_DENSE_GROUPS = 1 << 20

# Virtual columns provided at query time (VirtualColumnProvider parity).
VIRTUAL_COLUMNS = ("$docId", "$segmentName", "$hostName")

_STRING_TYPES = (DataType.STRING, DataType.BYTES, DataType.JSON)

#: aggregations with a device lowering in this package
PORTED_AGGS = ("count", "sum", "min", "max", "avg", "minmaxrange", "distinctcount", "distinctcountbitmap")

#: largest grouped DISTINCTCOUNT presence matrix (ng * pad cells) lowered to
#: the device; the reference answers larger ones with its host executor
MAX_PRESENCE_CELLS = 1 << 24


class DeviceFallback(NotImplementedError):
    """Query shape has no device lowering; the reference runs it on its host
    executor, which is not ported yet."""


class PlanError(ValueError):
    """Query is invalid against this segment/schema."""


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


def group_strides(cards: list, dtype=np.int64) -> np.ndarray:
    """Row-major strides over group-key cardinalities: ids dot strides gives
    the dense group id (DictionaryBasedGroupKeyGenerator.java:119-130)."""
    strides = np.ones(len(cards), dtype=dtype)
    for i in range(len(cards) - 2, -1, -1):
        strides[i] = strides[i + 1] * max(cards[i + 1], 1)
    return strides


@dataclass
class SegmentPlan:
    spec: tuple  # static, hashable program shape
    operands: tuple  # numpy arrays/scalars fed as dynamic inputs
    columns: tuple[str, ...]  # device arrays the program reads, in order
    # host-side decode info
    group_cols: list[tuple[str, Any]] = field(default_factory=list)  # (col, ColumnIndex)


class _Lowering:
    def __init__(self, seg: ImmutableSegment, ctx: QueryContext):
        self.seg = seg
        self.ctx = ctx
        self.operands: list[Any] = []
        self.columns: list[str] = []
        self._group_ng = 1  # set by group_spec; the presence budget reads it

    # -- operand / column registration --------------------------------------

    def op_idx(self, value) -> int:
        self.operands.append(value)
        return len(self.operands) - 1

    def use_col(self, col: str) -> str:
        if col not in self.seg.columns:
            raise PlanError(f"unknown column {col!r} in table {self.ctx.table}")
        if col not in self.columns:
            self.columns.append(col)
        return col

    # -- value expressions ---------------------------------------------------

    def value_spec(self, expr: Expr) -> tuple:
        """Lower a value expression to a spec computing per-doc float64/int
        values on device."""
        if isinstance(expr, ast.Identifier):
            if expr.name == "$docId":
                return ("docid",)
            if expr.name in VIRTUAL_COLUMNS:
                raise DeviceFallback(f"virtual column {expr.name} in value context runs host-side")
            ci = self.seg.columns.get(expr.name)
            if ci is None:
                raise PlanError(f"unknown column {expr.name!r}")
            if ci.data_type in _STRING_TYPES:
                raise PlanError(f"column {expr.name!r} is not numeric")
            self.use_col(expr.name)
            if ci.is_dict_encoded:
                # operand: dictionary values padded to pow2 (repeat last value)
                dv = np.asarray(ci.dictionary.values)
                pad = _pow2(max(len(dv), 1))
                if len(dv) == 0:
                    dv = np.zeros(1, dtype=ci.data_type.np_dtype)
                if len(dv) < pad:
                    dv = np.concatenate([dv, np.full(pad - len(dv), dv[-1], dtype=dv.dtype)])
                return ("dictval", expr.name, self.op_idx(dv))
            return ("raw", expr.name)
        if isinstance(expr, ast.Literal):
            if not isinstance(expr.value, (int, float, bool)):
                raise PlanError(f"non-numeric literal in value expression: {expr}")
            return ("lit", self.op_idx(np.float64(expr.value)))
        if isinstance(expr, ast.BinaryOp):
            return ("bin", expr.op, self.value_spec(expr.left), self.value_spec(expr.right))
        if isinstance(expr, ast.FunctionCall):
            return self._function_value(expr)
        if isinstance(expr, ast.CaseWhen):
            # CASE lowers as in the reference; the program evaluator has no
            # "case" tag yet and raises when it meets one
            branch_vals = [v for _, v in expr.whens] + ([expr.else_] if expr.else_ is not None else [])
            for val in branch_vals:
                if isinstance(val, ast.Literal) and not isinstance(val.value, (int, float, bool)):
                    raise DeviceFallback("non-numeric CASE branches run host-side")
                if isinstance(val, ast.Identifier):
                    ci = self.seg.columns.get(val.name)
                    if ci is not None and ci.data_type in _STRING_TYPES:
                        raise DeviceFallback("string-typed CASE branches run host-side")
            whens = tuple((self.filter_spec(cond), self.value_spec(val)) for cond, val in expr.whens)
            else_spec = (
                self.value_spec(expr.else_) if expr.else_ is not None else ("lit", self.op_idx(np.float64(0.0)))
            )
            return ("case", whens, else_spec)
        raise PlanError(f"unsupported value expression: {expr}")

    def _function_value(self, expr: ast.FunctionCall) -> tuple:
        name = expr.name
        if name == "cast":
            if len(expr.args) != 2 or not isinstance(expr.args[1], ast.Literal):
                raise PlanError("CAST requires CAST(expr AS type)")
            target = str(expr.args[1].value).upper()
            if target in ("INT", "LONG", "TIMESTAMP", "BOOLEAN"):
                return ("cast_int", self.value_spec(expr.args[0]))
            if target in ("FLOAT", "DOUBLE"):
                return ("cast_float", self.value_spec(expr.args[0]))
            raise DeviceFallback(f"CAST to {target} runs host-side")
        raise NotImplementedError(f"transform function {name}(...) is not ported to pinot_tpu_torch yet")

    # -- filters -------------------------------------------------------------

    def filter_spec(self, f: FilterExpr | None) -> tuple:
        if f is None:
            return ("const", True)
        if isinstance(f, ast.And):
            kids = [self.filter_spec(c) for c in f.children]
            if any(k == ("const", False) for k in kids):
                return ("const", False)
            kids = [k for k in kids if k != ("const", True)]
            if not kids:
                return ("const", True)
            return kids[0] if len(kids) == 1 else ("and", tuple(kids))
        if isinstance(f, ast.Or):
            kids = [self.filter_spec(c) for c in f.children]
            if any(k == ("const", True) for k in kids):
                return ("const", True)
            kids = [k for k in kids if k != ("const", False)]
            if not kids:
                return ("const", False)
            return kids[0] if len(kids) == 1 else ("or", tuple(kids))
        if isinstance(f, ast.Not):
            k = self.filter_spec(f.child)
            if k[0] == "const":
                return ("const", not k[1])
            return ("not", k)
        if isinstance(f, ast.Compare):
            return self._compare(f)
        if isinstance(f, ast.Between):
            spec = self._range(f.expr, f.low, f.high, True, True)
            return ("not", spec) if f.negated else spec
        if isinstance(f, ast.In):
            return self._in(f)
        if isinstance(f, ast.Like):
            spec = self._regex_lut(f.expr, _like_to_regex(f.pattern), full=True)
            return ("not", spec) if f.negated else spec
        if isinstance(f, ast.RegexpLike):
            return self._regex_lut(f.expr, f.pattern, full=False)
        if isinstance(f, ast.IsNull):
            # segments of this package carry no null vector (Pinot default
            # null handling): IS NULL matches nothing
            return ("const", bool(f.negated))
        if isinstance(f, ast.DistinctFrom):
            raise NotImplementedError("IS [NOT] DISTINCT FROM is not ported to pinot_tpu_torch yet")
        if isinstance(f, ast.PredicateFunction):
            raise NotImplementedError(f"predicate function {f.name} is not ported to pinot_tpu_torch yet")
        if isinstance(f, ast.BoolAssert):
            raise DeviceFallback("IS [NOT] TRUE/FALSE runs host-side")
        raise PlanError(f"unsupported filter: {f}")

    def _compare(self, f: ast.Compare) -> tuple:
        left, op, right = f.left, f.op, f.right
        if isinstance(left, ast.Literal) and not isinstance(right, ast.Literal):
            left, right = right, left
            op = _FLIP[op]
        if isinstance(left, ast.Literal) and isinstance(right, ast.Literal):
            return ("const", _const_compare(op, left.value, right.value))
        if not isinstance(right, ast.Literal):
            # column-vs-column / expr-vs-expr compare: numeric expr compare
            lv, rv = self.value_spec(left), self.value_spec(right)
            return ("cmp2", op.name, lv, rv)
        value = right.value
        if isinstance(left, ast.Identifier) and left.name not in VIRTUAL_COLUMNS:
            ci = self.seg.columns.get(left.name)
            if ci is None:
                raise PlanError(f"unknown column {left.name!r}")
            if ci.is_dict_encoded:
                return self._dict_compare(left.name, ci, op, value)
            return self._raw_compare(left.name, ci, op, value)
        # predicate over computed expression, e.g. a+b > 5
        vs = self.value_spec(left)
        return ("cmp_lit", op.name, vs, self.op_idx(np.float64(value)))

    def _dict_compare(self, col: str, ci, op: CompareOp, value) -> tuple:
        d = ci.dictionary
        if op == CompareOp.EQ:
            i = d.index_of(value)
            if i < 0:
                return ("const", False)
            return self._id_range_filter(col, ci, i, i)
        if op == CompareOp.NEQ:
            i = d.index_of(value)
            if i < 0:
                return ("const", True)
            return ("not", self._id_range_filter(col, ci, i, i))
        if op == CompareOp.LT:
            lo, hi = d.id_range_for(None, value, True, False)
        elif op == CompareOp.LTE:
            lo, hi = d.id_range_for(None, value, True, True)
        elif op == CompareOp.GT:
            lo, hi = d.id_range_for(value, None, False, True)
        else:  # GTE
            lo, hi = d.id_range_for(value, None, True, True)
        if lo > hi:
            return ("const", False)
        if lo == 0 and hi == d.cardinality - 1:
            return ("const", True)
        return self._id_range_filter(col, ci, lo, hi)

    def _id_range_filter(self, col: str, ci, lo: int, hi: int) -> tuple:
        """Dict-id interval filter. On a sorted column (SortedIndexReader
        parity: the forward index IS the index) the id interval maps to one
        contiguous doc range via two binary searches — the program then tests
        iota bounds and never reads the column."""
        if ci.stats.is_sorted:
            start = int(np.searchsorted(ci.forward, lo, side="left"))
            end = int(np.searchsorted(ci.forward, hi, side="right"))
            return ("doc_range", self.op_idx(np.int32(start)), self.op_idx(np.int32(end)))
        self.use_col(col)
        return ("range_ids", col, self.op_idx(np.int32(lo)), self.op_idx(np.int32(hi)))

    def _raw_compare(self, col: str, ci, op: CompareOp, value) -> tuple:
        if ci.stats.is_sorted and op != CompareOp.NEQ:
            n = len(ci.forward)
            left = int(np.searchsorted(ci.forward, value, side="left"))
            right = int(np.searchsorted(ci.forward, value, side="right"))
            start, end = {
                CompareOp.EQ: (left, right),
                CompareOp.LT: (0, left),
                CompareOp.LTE: (0, right),
                CompareOp.GT: (right, n),
                CompareOp.GTE: (left, n),
            }[op]
            if start >= end:
                return ("const", False)
            return ("doc_range", self.op_idx(np.int32(start)), self.op_idx(np.int32(end)))
        self.use_col(col)
        # integer columns compare natively: rewrite fractional literals into
        # equivalent integer bounds first
        fwd_dtype = ci.forward.dtype
        if np.issubdtype(fwd_dtype, np.integer) and isinstance(value, (int, float)) and not isinstance(value, bool):
            iop, ival = _int_compare(op, float(value))
            if iop is None:
                return ("const", ival)
            info = np.iinfo(fwd_dtype)
            if info.min <= ival <= info.max:
                return ("cmp_raw", iop.name, col, self.op_idx(np.asarray(ival, dtype=fwd_dtype)))
            # literal out of the column dtype's range: statically decidable
            if iop in (CompareOp.LT, CompareOp.LTE):
                return ("const", ival > info.max)
            if iop in (CompareOp.GT, CompareOp.GTE):
                return ("const", ival < info.min)
            return ("const", op == CompareOp.NEQ)
        v = self.op_idx(np.asarray(value, dtype=np.float64))
        return ("cmp_raw", op.name, col, v)

    def _range(self, expr: Expr, low: Expr, high: Expr, lo_incl: bool, hi_incl: bool) -> tuple:
        if isinstance(expr, ast.Identifier) and isinstance(low, ast.Literal) and isinstance(high, ast.Literal):
            ci0 = self.seg.columns.get(expr.name)
            if ci0 is not None and not ci0.is_dict_encoded and np.issubdtype(ci0.forward.dtype, np.integer):
                # raw integer column: two native integer compares
                return (
                    "and",
                    (
                        self._raw_compare(expr.name, ci0, CompareOp.GTE if lo_incl else CompareOp.GT, low.value),
                        self._raw_compare(expr.name, ci0, CompareOp.LTE if hi_incl else CompareOp.LT, high.value),
                    ),
                )
        if not isinstance(low, ast.Literal) or not isinstance(high, ast.Literal):
            raise PlanError("BETWEEN bounds must be literals")
        if isinstance(expr, ast.Identifier):
            ci = self.seg.columns.get(expr.name)
            if ci is None:
                raise PlanError(f"unknown column {expr.name!r}")
            if ci.is_dict_encoded:
                lo, hi = ci.dictionary.id_range_for(low.value, high.value, lo_incl, hi_incl)
                if lo > hi:
                    return ("const", False)
                if lo == 0 and hi == ci.dictionary.cardinality - 1:
                    return ("const", True)
                return self._id_range_filter(expr.name, ci, lo, hi)
        vs = self.value_spec(expr)
        return (
            "and",
            (
                ("cmp_lit", "GTE" if lo_incl else "GT", vs, self.op_idx(np.float64(low.value))),
                ("cmp_lit", "LTE" if hi_incl else "LT", vs, self.op_idx(np.float64(high.value))),
            ),
        )

    def _in(self, f: ast.In) -> tuple:
        values = []
        for v in f.values:
            if not isinstance(v, ast.Literal):
                raise PlanError("IN values must be literals")
            values.append(v.value)
        if isinstance(f.expr, ast.Identifier):
            ci = self.seg.columns.get(f.expr.name)
            if ci is None:
                raise PlanError(f"unknown column {f.expr.name!r}")
            if ci.is_dict_encoded:
                self.use_col(f.expr.name)
                ids = ci.dictionary.ids_for_values(values)
                if len(ids) == 0:
                    spec = ("const", False)
                else:
                    lut = np.zeros(_pow2(max(ci.dictionary.cardinality, 1)), dtype=bool)
                    lut[ids] = True
                    spec = ("in_lut", f.expr.name, self.op_idx(lut))
                if f.negated:
                    return ("const", not spec[1]) if spec[0] == "const" else ("not", spec)
                return spec
        # raw numeric IN: sorted-membership probe (the program evaluator has
        # no "in_sorted" tag yet and raises when it meets one)
        vs = self.value_spec(f.expr)
        int_ok = all(isinstance(v, (int, bool)) or (isinstance(v, float) and v == int(v)) for v in values)
        col_dt = None
        if vs[0] == "raw":
            ci_in = self.seg.columns[vs[1]]
            col_dt = ci_in.forward.dtype
            # match to_device's lossless int64->int32 narrowing
            if col_dt == np.int64 and (
                np.iinfo(np.int32).min <= ci_in.stats.min_value and ci_in.stats.max_value <= np.iinfo(np.int32).max
            ):
                col_dt = np.dtype(np.int32)
        if int_ok and col_dt is not None and np.issubdtype(col_dt, np.integer):
            info = np.iinfo(col_dt)
            in_range = [int(v) for v in values if info.min <= int(v) <= info.max]
            if not in_range:
                return ("const", bool(f.negated))
            vals = np.unique(np.asarray(in_range, dtype=col_dt))
        else:
            vals = np.unique(np.asarray([np.float64(v) for v in values], dtype=np.float64))
        pad = _pow2(len(vals))
        if len(vals) < pad:
            vals = np.concatenate([vals, np.full(pad - len(vals), vals[-1])])
        spec = ("in_sorted", vs, self.op_idx(vals))
        return ("not", spec) if f.negated else spec

    def _regex_lut(self, expr: Expr, pattern: str, full: bool) -> tuple:
        if isinstance(expr, ast.FunctionCall):
            raise NotImplementedError(f"LIKE/REGEXP_LIKE over {expr.name}(...) is not ported to pinot_tpu_torch yet")
        if not isinstance(expr, ast.Identifier):
            raise PlanError("LIKE/REGEXP_LIKE requires a column")
        ci = self.seg.columns.get(expr.name)
        if ci is None:
            raise PlanError(f"unknown column {expr.name!r}")
        if not ci.is_dict_encoded:
            raise PlanError("LIKE/REGEXP_LIKE requires a dictionary-encoded column")
        self.use_col(expr.name)
        rx = re.compile(pattern)
        match = rx.fullmatch if full else rx.search
        lut = np.zeros(_pow2(max(ci.dictionary.cardinality, 1)), dtype=bool)
        for i, v in enumerate(ci.dictionary.values):
            if match(str(v)):
                lut[i] = True
        if not lut.any():
            return ("const", False)
        return ("in_lut", expr.name, self.op_idx(lut))

    # -- aggregations --------------------------------------------------------

    def agg_spec(self, info: AggregationInfo, grouped: bool) -> tuple:
        if info.filter is not None:
            # FILTER (WHERE ...): the reference's wrapper spec; the program
            # evaluator has no "masked" tag yet and raises when it meets one
            import dataclasses

            inner = dataclasses.replace(info, filter=None)
            return ("masked", self.filter_spec(info.filter), self.agg_spec(inner, grouped))
        if info.func not in PORTED_AGGS:
            raise NotImplementedError(f"aggregation {info.func} is not ported to pinot_tpu_torch yet")
        if info.func == "count":
            return ("count",)
        if info.func in ("distinctcount", "distinctcountbitmap"):
            # presence over the dict-id space of a dictionary-encoded column
            if isinstance(info.arg, ast.Identifier):
                ci = self.seg.columns.get(info.arg.name)
                if ci is not None and ci.is_dict_encoded and not ci.is_mv:
                    pad = _pow2(max(ci.cardinality, 1))
                    if grouped and self._group_ng * pad > MAX_PRESENCE_CELLS:
                        raise DeviceFallback("grouped DISTINCTCOUNT presence matrix exceeds device budget")
                    self.use_col(info.arg.name)
                    return ("distinct_ids", info.arg.name, pad)
            raise DeviceFallback("DISTINCTCOUNT on raw/expression args runs host-side")
        if info.arg is None:
            raise PlanError(f"{info.func} requires an argument")
        return (info.func, self.value_spec(info.arg))

    # -- group-by ------------------------------------------------------------

    def group_spec(self) -> tuple:
        cols = []
        cards = []
        for g in self.ctx.group_by:
            if not isinstance(g, ast.Identifier):
                raise DeviceFallback("expression GROUP BY keys run host-side for now")
            if g.name in VIRTUAL_COLUMNS:
                raise DeviceFallback(f"GROUP BY virtual column {g.name} runs host-side")
            ci = self.seg.columns.get(g.name)
            if ci is None:
                raise PlanError(f"unknown column {g.name!r}")
            if not ci.is_dict_encoded:
                raise DeviceFallback(f"GROUP BY on raw column {g.name} runs host-side for now")
            self.use_col(g.name)
            cols.append(g.name)
            cards.append(ci.cardinality)
        num_groups = 1
        for c in cards:
            num_groups *= max(c, 1)
        if num_groups > MAX_DENSE_GROUPS:
            raise NotImplementedError(
                f"group-key cardinality product {num_groups} needs the sparse group path, "
                "which is not ported to pinot_tpu_torch yet"
            )
        strides = group_strides(cards, np.int32)
        # round ng to 256 steps, as the reference does (its Pallas group-tile
        # edge), so both packages size every grouped output identically
        ng = ((max(num_groups, 1) + 255) // 256) * 256
        self._group_ng = ng
        return ("groups", tuple(cols), ng, self.op_idx(strides))


_FLIP = {
    CompareOp.EQ: CompareOp.EQ,
    CompareOp.NEQ: CompareOp.NEQ,
    CompareOp.LT: CompareOp.GT,
    CompareOp.LTE: CompareOp.GTE,
    CompareOp.GT: CompareOp.LT,
    CompareOp.GTE: CompareOp.LTE,
}


def _int_compare(op: CompareOp, x: float):
    """Rewrite `int_col <op> x` into an equivalent integer-literal compare.
    Returns (op, int literal), or (None, bool) when statically decided
    (fractional EQ/NEQ)."""
    import math

    if x == int(x):
        return op, int(x)
    if op == CompareOp.EQ:
        return None, False
    if op == CompareOp.NEQ:
        return None, True
    if op == CompareOp.GT:  # v > 5.5  <=>  v > 5
        return CompareOp.GT, math.floor(x)
    if op == CompareOp.GTE:  # v >= 5.5 <=>  v >= 6
        return CompareOp.GTE, math.ceil(x)
    if op == CompareOp.LT:  # v < 5.5  <=>  v < 6
        return CompareOp.LT, math.ceil(x)
    return CompareOp.LTE, math.floor(x)  # v <= 5.5 <=> v <= 5


def _const_compare(op: CompareOp, a, b) -> bool:
    return {
        CompareOp.EQ: a == b,
        CompareOp.NEQ: a != b,
        CompareOp.LT: a < b,
        CompareOp.LTE: a <= b,
        CompareOp.GT: a > b,
        CompareOp.GTE: a >= b,
    }[op]


def _like_to_regex(pattern: str) -> str:
    out = []
    for ch in pattern:
        if ch == "%":
            out.append(".*")
        elif ch == "_":
            out.append(".")
        else:
            out.append(re.escape(ch))
    return "".join(out)


def plan_segment(seg: ImmutableSegment, ctx: QueryContext) -> SegmentPlan:
    """Lower an aggregation or group-by query against one segment."""
    if null_handling_enabled(ctx.options):
        raise NotImplementedError("enableNullHandling is not ported to pinot_tpu_torch yet")
    if ctx.query_type not in (QueryType.AGGREGATION, QueryType.GROUP_BY):
        raise NotImplementedError(f"{ctx.query_type.value} queries are not ported to pinot_tpu_torch yet")
    lo = _Lowering(seg, ctx)
    fspec = lo.filter_spec(ctx.filter)
    grouped = ctx.query_type == QueryType.GROUP_BY
    gspec = lo.group_spec() if grouped else None
    aggs = tuple(lo.agg_spec(a, grouped) for a in ctx.aggregations)
    return SegmentPlan(
        spec=("agg", fspec, gspec, aggs),
        operands=tuple(lo.operands),
        columns=tuple(lo.columns),
        group_cols=[(c, seg.columns[c]) for c in (gspec[1] if gspec else ())],
    )
