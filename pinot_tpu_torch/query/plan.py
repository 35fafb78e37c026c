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
   rounded up to a multiple of 256 as the reference rounds it. Past
   MAX_DENSE_GROUPS (read when a query is planned) the product goes to the
   sparse spec `groups_sparse`, whose U slots hold the present groups.

 * SELECTION lowers to a `select` program (the first LIMIT + OFFSET matching
   docs), SELECTION ORDER BY to `select_ob` (the top LIMIT + OFFSET docs by
   one key: a dict id, a value, or for several keys one int32 composite rank
   from `multi_ob_spec`), and DISTINCT to a group-by with no aggregates.

Query shapes with no device lowering raise `DeviceFallback` where the
reference raises it, and the engine answers such a segment with the host
executor (`host_exec.py`), as the reference's does: GROUP BY on a raw column
or an expression, DISTINCTCOUNT of a raw column, a grouped presence matrix
over MAX_PRESENCE_CELLS, PERCENTILE / MODE / the EXT_AGGS family, funnels
inside a GROUP BY, string-valued transforms, and under enableNullHandling a
nullable GROUP BY key or selection.

 * enableNullHandling lowers as the reference's: a WHERE over a column with
   a null vector becomes the Kleene (true, unknown) tree (`k3root`), every
   leaf carrying its columns' null mask as a `docmask` operand; an
   aggregation over such a column is wrapped in a mask of its non-null docs
   (`masked`; a SUM in `masked_nan_empty`, NaN where no doc survives). The
   masks come from the segment's memo (`ImmutableSegment.null_docmask`), one
   array a column set, staged once a device.

 * A multi-value column's predicate is its flat per-value predicate wrapped
   in `mv_any` (any value matches; a top-level NOT stays outside, so NEQ and
   NOT IN exclude the docs where a value matches); COUNTMV / SUMMV / MINMV /
   MAXMV / AVGMV lower to `mv_*` over the flat values, DISTINCTCOUNTMV to
   `mv_distinct_ids`; a GROUP BY over one MV key to `groups_mv` (value-space
   group ids) and over two to `groups_mv2` (a dense pair space of at most
   MAX_MV2_PAIRS). An MV column in a value context, a selection or an ORDER
   BY, three MV keys, a high-cardinality MV key and *MV aggregations under an
   MV key fall back to the host, as in the reference.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

import numpy as np

from pinot_tpu_torch.common.types import DataType
from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.ast import CompareOp, Expr, FilterExpr
from pinot_tpu_torch.query.context import (
    AggregationInfo,
    QueryContext,
    QueryType,
    _collect_filter_identifiers,
    _collect_identifiers,
    null_handling_enabled,
)
from pinot_tpu_torch.query.sketches import EST_BINS, HLL_LOG2M, HLL_M
from pinot_tpu_torch.query.transforms import DEVICE_FUNCS, STRING_FUNCS, apply_string_func, rewrite_time_convert
from pinot_tpu_torch.segment.segment import ImmutableSegment, padded_len

MAX_DENSE_GROUPS = 1 << 20

# Virtual columns provided at query time (VirtualColumnProvider parity).
VIRTUAL_COLUMNS = ("$docId", "$segmentName", "$hostName")

_STRING_TYPES = (DataType.STRING, DataType.BYTES, DataType.JSON)

#: largest grouped DISTINCTCOUNT presence matrix (ng * pad cells) lowered to
#: the device; a larger one sends the segment to the host executor
MAX_PRESENCE_CELLS = 1 << 24

#: largest grouped DISTINCTCOUNTHLL register matrix (ng * 2^log2m cells),
#: and grouped PERCENTILEEST histogram matrix (ng * EST_BINS cells), lowered
#: to the device
MAX_HLL_CELLS = 1 << 22


class DeviceFallback(Exception):
    """Query shape has no device lowering: the segment runs on the host
    executor. Not a NotImplementedError, so no handler of those swallows it."""


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
    # per projection of a selection: ("dict", col) | ("rawcol", col) |
    # ("virt", name) | ("expr", None)
    select_decode: list[tuple] = field(default_factory=list)
    # multi-key ORDER BY composite: [(col, card, desc, kind, offset)], most
    # significant key first; the host decomposes the composite rank back
    # into per-key sort values
    ob_decomp: list[tuple] | None = None


class _Lowering:
    def __init__(self, seg: ImmutableSegment, ctx: QueryContext):
        self.seg = seg
        self.ctx = ctx
        self.operands: list[Any] = []
        self.columns: list[str] = []
        self._group_ng = 1  # set by group_spec; the presence budget reads it
        # null docmask operand index per column set: one operand however many
        # Kleene leaves read it
        self._null_mask_ops: dict[frozenset, int] = {}

    # -- operand / column registration --------------------------------------

    def op_idx(self, value) -> int:
        self.operands.append(value)
        return len(self.operands) - 1

    def use_col(self, col: str) -> str:
        if col not in self.seg.columns:
            raise PlanError(f"unknown column {col!r} in table {self.ctx.table}")
        if col not in self.columns:
            self.columns.append(col)
            if self.seg.columns[col].is_mv:
                # a flattened MV column: the program also reads its owning docs
                self.columns.append(f"{col}!docs")
        return col

    def _mv_wrap(self, col: str, spec: tuple) -> tuple:
        """A flat (per-value) predicate spec as MV any-match doc semantics. A
        top-level NOT stays outside the wrap: Pinot's MV exclusions (NEQ, NOT
        IN) match the docs where no value satisfies the positive form
        (NotEqualsPredicateEvaluator applyMV)."""
        if spec[0] == "const":
            return spec
        if spec[0] == "not":
            return ("not", self._mv_wrap(col, spec[1]))
        nv = self.op_idx(np.int32(len(self.seg.columns[col].forward)))
        return ("mv_any", col, spec, nv)

    # -- null handling ------------------------------------------------------

    def null_wrap(self, info: AggregationInfo, spec: tuple) -> tuple:
        """enableNullHandling: AND the mask of the docs where no argument
        column of the aggregation is null over it (NullableSingleInput-
        AggregationFunction parity); no null vector, the spec unchanged. A SUM
        is wrapped even without one: a FILTER or WHERE that leaves no doc
        must give NULL too, so its program gives NaN for an empty mask."""
        cols = {a.name for a in (info.arg, info.arg2) if isinstance(a, ast.Identifier)}
        nulls = self.seg.null_mask(cols)
        inner = spec
        while inner[0] == "masked":
            inner = inner[2]
        has_nulls = nulls is not None and nulls.any()
        if inner[0] == "sum":
            return ("masked_nan_empty", self.null_docmask_spec(cols, True) if has_nulls else ("const", True), spec)
        if not has_nulls:
            return spec
        return ("masked", self.null_docmask_spec(cols, True), spec)

    def null_docmask_spec(self, cols, negate: bool) -> tuple:
        """The segment's memoized mask of the docs where any of `cols` is null
        (or, negated, where none is), as a `docmask` operand."""
        return ("docmask", self.op_idx(self.seg.null_docmask(cols, negate)))

    def docmask_spec(self, mask: np.ndarray) -> tuple:
        """A doc mask computed on the host, padded to the segment's padded
        length, as a `docmask` operand."""
        m = np.zeros(padded_len(self.seg.n_docs), dtype=bool)
        m[: len(mask)] = mask
        return ("docmask", self.op_idx(m))

    def _expr_null_spec(self, expr: Expr) -> tuple | None:
        """`docmask` of the docs where `expr` is null (host_exec.expr_null_mask),
        or None when it never is."""
        from pinot_tpu_torch.query.host_exec import expr_null_mask

        if isinstance(expr, ast.FunctionCall) and expr.name == "coalesce":
            nulls = expr_null_mask(self.seg, expr)
            return None if nulls is None else self.docmask_spec(nulls)
        cols: set[str] = set()
        _collect_identifiers(expr, cols)
        return None if self.seg.null_mask(cols) is None else self.null_docmask_spec(cols, False)

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
            if ci.is_mv:
                raise DeviceFallback(
                    f"MV column {expr.name!r} in value context runs host-side (use the *MV aggregations)"
                )
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
            # CASE -> a fold of wheres over the WHEN masks. A missing ELSE is
            # the numeric default 0 (Pinot without null handling); string
            # results run on the host
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
        if name in ("timeconvert", "datetimeconvert"):
            rw = rewrite_time_convert(expr)
            if rw is not None:
                return self.value_spec(rw)
        if name == "map_value":
            raise DeviceFallback("map_value runs host-side (map index probe)")
        if name == "cast":
            if len(expr.args) != 2 or not isinstance(expr.args[1], ast.Literal):
                raise PlanError("CAST requires CAST(expr AS type)")
            target = str(expr.args[1].value).upper()
            if target in ("INT", "LONG", "TIMESTAMP", "BOOLEAN"):
                return ("cast_int", self.value_spec(expr.args[0]))
            if target in ("FLOAT", "DOUBLE"):
                return ("cast_float", self.value_spec(expr.args[0]))
            raise DeviceFallback(f"CAST to {target} runs host-side")
        if name in DEVICE_FUNCS:
            arity, _ = DEVICE_FUNCS[name]
            if len(expr.args) != arity:
                raise PlanError(f"{name} expects {arity} args, got {len(expr.args)}")
            return ("fn", name, tuple(self.value_spec(a) for a in expr.args))
        if name in STRING_FUNCS:
            # numeric-returning string functions (strlen, startswith, ...) over
            # a dict column become a derived value table gathered by ids —
            # cardinality-sized host work, doc-sized device gather
            derived, is_str, col = self._derived_string_values(expr)
            if is_str:
                raise DeviceFallback(f"string-valued {name}(...) runs host-side")
            self.use_col(col)
            pad = _pow2(max(len(derived), 1))
            dv = derived
            if len(dv) == 0:
                dv = np.zeros(1, dtype=np.float64)
            if len(dv) < pad:
                dv = np.concatenate([dv, np.full(pad - len(dv), dv[-1])])
            return ("dictval", col, self.op_idx(dv))
        raise DeviceFallback(f"transform function {name} has no device lowering yet")

    def _derived_string_values(self, expr: ast.FunctionCall):
        """Evaluate a string function over a dict column's VALUES on the host.
        Returns (derived value array, returns_string, column name)."""
        if not expr.args or not isinstance(expr.args[0], ast.Identifier):
            raise DeviceFallback(f"{expr.name} over non-column args runs host-side")
        col = expr.args[0].name
        ci = self.seg.columns.get(col)
        if ci is None:
            raise PlanError(f"unknown column {col!r}")
        if not ci.is_dict_encoded:
            raise DeviceFallback(f"{expr.name} over raw column runs host-side")
        lit_args = []
        for a in expr.args[1:]:
            if not isinstance(a, ast.Literal):
                raise DeviceFallback(f"{expr.name} with non-literal args runs host-side")
            lit_args.append(a.value)
        derived, is_str = apply_string_func(expr.name, ci.dictionary.values, tuple(lit_args))
        return derived, is_str, col

    def _string_fn_lut(self, expr: ast.FunctionCall, pred) -> tuple:
        """A predicate over a string function of a dict column lowers to a LUT
        over dict ids (evaluated once per distinct value on the host)."""
        derived, is_str, col = self._derived_string_values(expr)
        if not is_str:
            raise PlanError(f"{expr.name} is not string-valued")
        self.use_col(col)
        lut = np.zeros(_pow2(max(len(derived), 1)), dtype=bool)
        for i, v in enumerate(derived):
            if pred(str(v)):
                lut[i] = True
        if not lut.any():
            return ("const", False)
        if lut[: max(len(derived), 1)].all():
            return ("const", True)
        return ("in_lut", col, self.op_idx(lut))

    @staticmethod
    def _is_string_fn(expr) -> bool:
        if not (isinstance(expr, ast.FunctionCall) and expr.name in STRING_FUNCS):
            return False
        is_str = STRING_FUNCS[expr.name][2]
        if callable(is_str):  # arg-dependent result type (jsonextractscalar)
            return is_str(tuple(a.value for a in expr.args[1:] if isinstance(a, ast.Literal)))
        return is_str

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
            if isinstance(f.expr, ast.Identifier) and self.seg.extras.get("null", {}).get(f.expr.name) is not None:
                return self.null_docmask_spec({f.expr.name}, bool(f.negated))
            # no null vector (Pinot default null handling): IS NULL matches nothing
            return ("const", bool(f.negated))
        if isinstance(f, ast.DistinctFrom):
            return self._distinct_from(f)
        if isinstance(f, ast.PredicateFunction):
            return self._predicate_function(f)
        if isinstance(f, ast.BoolAssert):
            raise DeviceFallback("IS [NOT] TRUE/FALSE runs host-side")
        raise PlanError(f"unsupported filter: {f}")

    def where_spec(self, f: FilterExpr | None) -> tuple:
        """The WHERE lowering: under enableNullHandling, a filter that reads a
        column with a null vector becomes the three-valued tree (`k3root`);
        otherwise filter_spec's."""
        if f is not None and null_handling_enabled(self.ctx.options):
            refs: set[str] = set()
            _collect_filter_identifiers(f, refs)
            if any(self.seg.extras.get("null", {}).get(c) is not None for c in refs):
                return ("k3root", self.filter3_spec(f))
        return self.filter_spec(f)

    def filter3_spec(self, f: FilterExpr) -> tuple:
        """The three-valued lowering, node for node host_exec._filter3's: each
        leaf predicate carries the union of its columns' null masks as a
        `docmask` operand (`k3_leaf`); IS NULL and IS DISTINCT FROM are never
        unknown (`k3_exact`)."""
        if isinstance(f, ast.And):
            return ("k3_and", tuple(self.filter3_spec(c) for c in f.children))
        if isinstance(f, ast.Or):
            return ("k3_or", tuple(self.filter3_spec(c) for c in f.children))
        if isinstance(f, ast.Not):
            return ("k3_not", self.filter3_spec(f.child))
        if isinstance(f, (ast.IsNull, ast.DistinctFrom)):
            return ("k3_exact", self.filter_spec(f))
        spec = self.filter_spec(f)
        refs: set[str] = set()
        _collect_filter_identifiers(f, refs)
        nullable = frozenset(c for c in refs if self.seg.extras.get("null", {}).get(c) is not None)
        if not nullable:
            return ("k3_exact", spec)
        idx = self._null_mask_ops.get(nullable)
        if idx is None:
            if not self.seg.null_mask(nullable).any():
                return ("k3_exact", spec)
            idx = self.null_docmask_spec(nullable, False)[1]
            self._null_mask_ops[nullable] = idx
        return ("k3_leaf", spec, idx)

    def _distinct_from(self, f: ast.DistinctFrom) -> tuple:
        """IS [NOT] DISTINCT FROM: (l != r and both non-null) or exactly one
        null, from the NEQ compare and the two sides' null masks."""
        neq = self._compare(ast.Compare(CompareOp.NEQ, f.left, f.right))
        nl, nr = self._expr_null_spec(f.left), self._expr_null_spec(f.right)
        if nl is None and nr is None:
            spec = neq
        else:
            nl = nl or ("const", False)
            nr = nr or ("const", False)
            xor = ("or", (("and", (nl, ("not", nr))), ("and", (nr, ("not", nl)))))
            spec = ("or", (("and", (neq, ("not", nl), ("not", nr))), xor))
        return ("not", spec) if f.negated else spec

    def _predicate_function(self, f: ast.PredicateFunction) -> tuple:
        from pinot_tpu_torch.query.host_exec import predicate_function_mask

        if f.name == "st_within_distance":
            # ST_WITHIN_DISTANCE(lat, lng, qlat, qlng, radius_m): a compare
            # over the haversine distance
            if len(f.args) != 5 or not isinstance(f.args[4], ast.Literal):
                raise PlanError("ST_WITHIN_DISTANCE(lat, lng, qlat, qlng, radius_m)")
            dist = ast.FunctionCall("st_distance", tuple(f.args[:4]))
            return ("cmp_lit", "LTE", self.value_spec(dist), self.op_idx(np.float64(f.args[4].value)))
        # TEXT_MATCH / JSON_MATCH / VECTOR_SIMILARITY: the segment's index is
        # probed on the host and the program gets its docs as a `docmask`
        # operand (Pinot's index filter operators handing a bitmap to the tree)
        return self.docmask_spec(predicate_function_mask(self.seg, f))

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
            inner = (
                self._dict_compare(left.name, ci, op, value)
                if ci.is_dict_encoded
                else self._raw_compare(left.name, ci, op, value)
            )
            return self._mv_wrap(left.name, inner) if ci.is_mv else inner
        if self._is_string_fn(left):
            sv = str(value)
            pred = {
                CompareOp.EQ: lambda v: v == sv,
                CompareOp.NEQ: lambda v: v != sv,
                CompareOp.LT: lambda v: v < sv,
                CompareOp.LTE: lambda v: v <= sv,
                CompareOp.GT: lambda v: v > sv,
                CompareOp.GTE: lambda v: v >= sv,
            }[op]
            return self._string_fn_lut(left, pred)
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
        # not for MV: a doc with an empty value list matches no range, even
        # the whole dictionary
        if lo == 0 and hi == d.cardinality - 1 and not ci.is_mv:
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
                # raw integer column: two native integer compares. For MV the
                # conjunction wraps as ONE flat predicate: a doc matches when
                # a single value lies in the range
                spec = (
                    "and",
                    (
                        self._raw_compare(expr.name, ci0, CompareOp.GTE if lo_incl else CompareOp.GT, low.value),
                        self._raw_compare(expr.name, ci0, CompareOp.LTE if hi_incl else CompareOp.LT, high.value),
                    ),
                )
                return self._mv_wrap(expr.name, spec) if ci0.is_mv else spec
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
                if lo == 0 and hi == ci.dictionary.cardinality - 1 and not ci.is_mv:
                    return ("const", True)
                spec = self._id_range_filter(expr.name, ci, lo, hi)
                return self._mv_wrap(expr.name, spec) if ci.is_mv else spec
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
                if ci.is_mv:
                    spec = self._mv_wrap(f.expr.name, spec)
                if f.negated:
                    return ("const", not spec[1]) if spec[0] == "const" else ("not", spec)
                return spec
        if self._is_string_fn(f.expr):
            vals = {str(v) for v in values}
            spec = self._string_fn_lut(f.expr, lambda v: v in vals)
            if f.negated:
                return ("const", not spec[1]) if spec[0] == "const" else ("not", spec)
            return spec
        # raw numeric IN: a probe of the sorted literal list
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
        if self._is_string_fn(expr):
            rx = re.compile(pattern)
            match = rx.fullmatch if full else rx.search
            return self._string_fn_lut(expr, lambda v: bool(match(v)))
        if not isinstance(expr, ast.Identifier):
            raise PlanError("LIKE/REGEXP_LIKE requires a column")
        ci = self.seg.columns.get(expr.name)
        if ci is None:
            raise PlanError(f"unknown column {expr.name!r}")
        if not ci.is_dict_encoded:
            raise PlanError("LIKE/REGEXP_LIKE requires a dictionary-encoded column")
        self.use_col(expr.name)
        lut = np.zeros(_pow2(max(ci.dictionary.cardinality, 1)), dtype=bool)
        fst = self.seg.extras.get("fst", {}).get(expr.name)
        if fst is not None:
            # FST index: a prefix pattern is two binary searches; a general
            # regex memoizes its dict-id LUT (nativefst parity)
            ids = fst.matching_ids(pattern, full)
            lut[: len(ids)] = ids
        else:
            rx = re.compile(pattern)
            match = rx.fullmatch if full else rx.search
            for i, v in enumerate(ci.dictionary.values):
                if match(str(v)):
                    lut[i] = True
        if not lut.any():
            return ("const", False)
        return ("in_lut", expr.name, self.op_idx(lut))

    # -- aggregations --------------------------------------------------------

    def agg_spec(self, info: AggregationInfo, grouped: bool) -> tuple:
        if info.filter is not None:
            # FILTER (WHERE ...): the aggregation under its own mask,
            # three-valued under null handling as the WHERE
            import dataclasses

            inner = dataclasses.replace(info, filter=None)
            return ("masked", self.where_spec(info.filter), self.agg_spec(inner, grouped))
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
        if info.func == "distinctcounthll":
            if grouped and self._group_ng * HLL_M > MAX_HLL_CELLS:
                raise DeviceFallback("grouped HLL register matrix exceeds device budget")
            return self._hll_spec(info)
        if info.func == "percentileest":
            if grouped and self._group_ng * EST_BINS > MAX_HLL_CELLS:
                raise DeviceFallback("grouped percentileest histogram matrix exceeds device budget")
            return self._hist_spec(info)
        if info.func in ("percentile", "percentiletdigest", "mode"):
            raise DeviceFallback(f"{info.func} runs host-side (full-values / counter intermediate)")
        if info.func in ("sum", "min", "max", "avg", "minmaxrange"):
            if info.arg is None:
                raise PlanError(f"{info.func} requires an argument")
            return (info.func, self.value_spec(info.arg))
        if info.func in ("countmv", "summv", "minmv", "maxmv", "avgmv", "distinctcountmv"):
            return self._mv_agg_spec(info, grouped)
        if info.func in ("funnelcount", "funnelcompletecount"):
            # per-step presence vectors over the correlation column's dict-id
            # space
            if grouped:
                raise DeviceFallback("funnel aggregations inside GROUP BY run host-side")
            if not isinstance(info.arg, ast.Identifier):
                raise DeviceFallback("FUNNELCOUNT correlation expression runs host-side")
            ci = self.seg.columns.get(info.arg.name)
            if ci is None or not ci.is_dict_encoded or ci.is_mv:
                raise DeviceFallback("FUNNELCOUNT needs a dict-encoded SV correlation column")
            stepspecs = tuple(self.filter_spec(s) for s in info.extra[-1])
            col = self.use_col(info.arg.name)
            return ("funnel_steps", col, _pow2(max(ci.cardinality, 1)), stepspecs)
        raise DeviceFallback(f"aggregation {info.func} has no device lowering yet")

    def _mv_agg_spec(self, info: AggregationInfo, grouped: bool) -> tuple:
        """The MV aggregations over the flattened layout
        (core/query/aggregation/function/*MVAggregationFunction.java): the
        doc mask gathers to value positions, and the reduction is the SV
        twin's over the flat values."""
        if not isinstance(info.arg, ast.Identifier):
            raise PlanError(f"{info.func} requires an MV column argument")
        ci = self.seg.columns.get(info.arg.name)
        if ci is None:
            raise PlanError(f"unknown column {info.arg.name!r}")
        if not ci.is_mv:
            raise PlanError(f"{info.func} requires a multi-value column, {info.arg.name!r} is single-value")
        col = self.use_col(info.arg.name)
        nv = self.op_idx(np.int32(len(ci.forward)))
        if info.func == "countmv":
            return ("mv_count", col, nv)
        if info.func == "distinctcountmv":
            if grouped:
                raise DeviceFallback("DISTINCTCOUNTMV inside GROUP BY runs host-side for now")
            if not ci.is_dict_encoded:
                raise DeviceFallback("DISTINCTCOUNTMV on raw MV columns runs host-side")
            return ("mv_distinct_ids", col, _pow2(max(ci.cardinality, 1)), nv)
        if ci.data_type in _STRING_TYPES:
            raise PlanError(f"{info.func} requires a numeric MV column")
        if ci.is_dict_encoded:
            dv = np.asarray(ci.dictionary.values)
            pad = _pow2(max(len(dv), 1))
            if len(dv) == 0:
                dv = np.zeros(1, dtype=ci.data_type.np_dtype)
            if len(dv) < pad:
                dv = np.concatenate([dv, np.full(pad - len(dv), dv[-1], dtype=dv.dtype)])
            vspec = ("dictval", col, self.op_idx(dv))
        else:
            vspec = ("raw", col)
        return (f"mv_{info.func[:-2]}", vspec, col, nv)

    def _hist_spec(self, info: AggregationInfo) -> tuple:
        """PERCENTILEEST's fixed-bin histogram over the engine's global
        bounds."""
        bounds = self.ctx.hints.get("est_bounds", {}).get(info.name)
        if bounds is None:
            raise DeviceFallback("percentileest without global bounds runs host-side")
        lo, hi = bounds
        if not (hi > lo):
            raise DeviceFallback("degenerate percentileest bounds run host-side")
        return (
            "hist",
            self.value_spec(info.arg),
            self.op_idx(np.float64(lo)),
            self.op_idx(np.float64(EST_BINS / (hi - lo))),
            EST_BINS,
        )

    def _hll_spec(self, info: AggregationInfo) -> tuple:
        if isinstance(info.arg, ast.Identifier):
            ci = self.seg.columns.get(info.arg.name)
            if ci is None:
                raise PlanError(f"unknown column {info.arg.name!r}")
            if ci.is_dict_encoded:
                # the dictionary's memoized hash table, a stable operand: its
                # staged copy survives across queries
                self.use_col(info.arg.name)
                return ("hll", ("gather", info.arg.name, self.op_idx(ci.dictionary.hll_hash_pad())), HLL_LOG2M)
        # raw numeric column / numeric expression: hashed on the device
        if info.arg is None:
            raise PlanError("distinctcounthll requires an argument")
        return ("hll", ("mix", self.value_spec(info.arg)), HLL_LOG2M)

    # -- ORDER BY ------------------------------------------------------------

    def multi_ob_spec(self, order_by) -> tuple:
        """Composite rank key for a multi-key ORDER BY (the sorting twin of
        DictionaryBasedGroupKeyGenerator's cardinality product): ascending
        composite order is the requested multi-key order. Each key maps to
        its rank (a dict id is its value's rank; a bounded int shifts by its
        minimum), DESC flips it (card - 1 - rank), and the ranks combine by
        cardinality-product strides into one int32. Returns (kspec, decomp)."""
        entries = []  # (col, card, desc, kind, offset)
        total = 1
        for ob in order_by:
            if not isinstance(ob.expr, ast.Identifier):
                raise DeviceFallback("expression ORDER BY keys run host-side")
            ci = self.seg.columns.get(ob.expr.name)
            if ci is None:
                raise PlanError(f"unknown column {ob.expr.name!r}")
            if ci.is_mv:
                raise DeviceFallback("MV ORDER BY keys run host-side")
            if ci.is_dict_encoded:
                entries.append((ob.expr.name, max(ci.cardinality, 1), ob.desc, "ids", 0))
            elif np.issubdtype(ci.forward.dtype, np.integer):
                lo_v, hi_v = int(ci.stats.min_value), int(ci.stats.max_value)
                card = hi_v - lo_v + 1
                i32 = np.iinfo(np.int32)
                # the offset and extreme literals ride as int32 operands
                if card <= 0 or card > (1 << 31) or lo_v < i32.min or hi_v > i32.max:
                    raise DeviceFallback("wide-range int ORDER BY key runs host-side")
                entries.append((ob.expr.name, card, ob.desc, "rawoff", lo_v))
            else:
                raise DeviceFallback("float/string-raw multi-key ORDER BY runs host-side")
            total *= entries[-1][1]
            if total > (1 << 31) - 1:
                raise DeviceFallback("ORDER BY key-rank product exceeds int32; host-side")
        strides = group_strides([e[1] for e in entries], np.int64).tolist()
        kspec = None
        for (col, card, desc, kind, off), stride in zip(entries, strides):
            self.use_col(col)
            base: tuple = ("ids" if kind == "ids" else "raw", col)
            if kind == "rawoff" and off != 0:
                base = ("bin", "-", base, ("lit", self.op_idx(np.int32(off))))
            if desc:
                base = ("bin", "-", ("lit", self.op_idx(np.int32(card - 1))), base)
            term = base if stride == 1 else ("bin", "*", base, ("lit", self.op_idx(np.int32(stride))))
            kspec = term if kspec is None else ("bin", "+", kspec, term)
        return kspec, entries

    # -- group-by ------------------------------------------------------------

    #: cap on the (base MV flat values x other MV max-len) pair space of a
    #: two-MV-key device group-by
    MAX_MV2_PAIRS = 1 << 23

    def group_spec(self) -> tuple:
        cols = []
        cards = []
        mv_cols: list[str] = []
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
            if ci.is_mv:
                mv_cols.append(g.name)
            self.use_col(g.name)
            cols.append(g.name)
            cards.append(ci.cardinality)
        if len(mv_cols) > 2:
            raise DeviceFallback("3+ MV GROUP BY keys run host-side (explode)")
        if len(mv_cols) == 2 and mv_cols[0] == mv_cols[1]:
            # a repeated MV key: the pair space would only hold the diagonal
            # (v, v) combinations, not the whole cartesian square
            raise DeviceFallback("repeated MV GROUP BY key runs host-side (explode)")
        num_groups = 1
        for c in cards:
            num_groups *= max(c, 1)
        if num_groups > MAX_DENSE_GROUPS:
            # high-cardinality product: the sort-compaction path. Dense 64-bit
            # gids are sorted on the device and their runs compacted into U
            # slots; the aggregation runs over the slots. U bounds the PRESENT
            # groups (<= n_docs), not the product; a segment with more present
            # groups than U raises DeviceFallback in the engine.
            if mv_cols:
                raise DeviceFallback("high-cardinality MV GROUP BY runs host-side")
            if num_groups >= (1 << 62):
                raise DeviceFallback("group cardinality product overflows int64 gids")
            strides64 = group_strides(cards, np.int64)
            u = min(_pow2(max(self.seg.n_docs, 256)), MAX_DENSE_GROUPS)
            self._group_ng = u
            return ("groups_sparse", tuple(cols), u, self.op_idx(strides64))
        strides = group_strides(cards, np.int32)
        # round ng to 256 steps, as the reference does (its Pallas group-tile
        # edge), so both packages size every grouped output identically
        ng = ((max(num_groups, 1) + 255) // 256) * 256
        self._group_ng = ng
        if len(mv_cols) == 2:
            return self._group_spec_mv2(cols, ng, strides, mv_cols)
        if mv_cols:
            # one MV key: the group ids live in value space, each doc
            # contributes once per value (Pinot's MV group-by semantics)
            nv = self.op_idx(np.int32(len(self.seg.columns[mv_cols[0]].forward)))
            return ("groups_mv", tuple(cols), ng, self.op_idx(strides), mv_cols[0], nv)
        return ("groups", tuple(cols), ng, self.op_idx(strides))

    def _group_spec_mv2(self, cols, ng, strides, mv_cols) -> tuple:
        """Two MV keys: each doc's cartesian pairs in a dense (base flat
        values x other max-len) pair space. The base's flat layout gives one
        axis; the other column gives Lb positions a base value, masked by its
        per-doc length (DictionaryBasedGroupKeyGenerator's MV cartesian
        semantics)."""

        def maxlen(name: str) -> int:
            lens = self.seg.columns[name].lens
            return int(lens.max()) if len(lens) else 0

        a, b = mv_cols
        # the base that makes the smaller pair space
        if padded_len(len(self.seg.columns[b].forward)) * maxlen(a) < padded_len(
            len(self.seg.columns[a].forward)
        ) * maxlen(b):
            a, b = b, a
        lb = maxlen(b)
        if lb == 0:
            # the other column has no value anywhere: no doc joins a group
            raise DeviceFallback("MV GROUP BY key with no values runs host-side")
        ci_b = self.seg.columns[b]
        pairs = padded_len(len(self.seg.columns[a].forward)) * lb
        if pairs > self.MAX_MV2_PAIRS:
            raise DeviceFallback(f"two-MV-key pair space {pairs} exceeds device budget {self.MAX_MV2_PAIRS}")
        # pad + 1 entries: the base's padding docids point one past the
        # padded doc range, and a zero length there makes their pairs invalid
        off_p, len_p = ci_b.doc_tables(padded_len(self.seg.n_docs))
        nv_a = self.op_idx(np.int32(len(self.seg.columns[a].forward)))
        return ("groups_mv2", tuple(cols), ng, self.op_idx(strides), a, nv_a, b, self.op_idx(off_p), self.op_idx(len_p), lb)


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


def plan_filter_mask(seg: ImmutableSegment, filt, valid_mask=None, kleene: bool = False) -> SegmentPlan:
    """Lower ONLY a filter into a `mask` program: the multistage leaf Scan's
    filter (LeafStageTransferableBlockOperator.java:87 parity: the v2 leaf
    runs the single-stage engine's filter program, not host numpy). `kleene`
    lowers nullable-column predicates to the three-valued tree, as WHERE
    under enableNullHandling. Raises DeviceFallback for host-only
    predicates."""
    from types import SimpleNamespace

    shim = SimpleNamespace(
        table=seg.schema.name,
        hints={},
        group_by=[],
        options={"enablenullhandling": "true"} if kleene else {},
    )
    lo = _Lowering(seg, shim)
    fspec = lo.where_spec(filt) if kleene else lo.filter_spec(filt)
    if valid_mask is not None:
        fspec = ("and", (lo.docmask_spec(np.asarray(valid_mask, dtype=bool)), fspec))
    return SegmentPlan(spec=("mask", fspec), operands=tuple(lo.operands), columns=tuple(lo.columns))


def plan_segment(seg: ImmutableSegment, ctx: QueryContext, valid_mask=None) -> SegmentPlan:
    """Lower a query against one segment. Raises DeviceFallback where the
    segment runs on the host executor, as in the reference. `valid_mask` is
    an upsert validity snapshot the caller already took; without one the
    segment's own `extras["valid_docs"]` is read."""
    from pinot_tpu_torch.query.host_exec import expr_null_mask

    null_on = null_handling_enabled(ctx.options)
    if null_on and any(expr_null_mask(seg, g) is not None for g in ctx.group_by):
        # null keys form a group of their own: the host executor puts None in
        # the key column
        raise DeviceFallback("null-handling group-by key runs host-side")
    lo = _Lowering(seg, ctx)
    fspec = lo.where_spec(ctx.filter)
    if valid_mask is None:
        valid = seg.extras.get("valid_docs")
        if valid is not None:
            valid_mask = valid(seg.n_docs)
    if valid_mask is not None:
        # upsert visibility: only the latest doc of each primary key counts.
        # The current validity rides as a docmask operand, copied into a
        # fresh padded array for every query and never a stable operand: the
        # caller may mutate the array it handed over in place
        fspec = ("and", (lo.docmask_spec(np.asarray(valid_mask, dtype=bool)), fspec))

    def plan(spec, **decode) -> SegmentPlan:
        return SegmentPlan(spec=spec, operands=tuple(lo.operands), columns=tuple(lo.columns), **decode)

    if ctx.query_type in (QueryType.AGGREGATION, QueryType.GROUP_BY):
        grouped = ctx.query_type == QueryType.GROUP_BY
        gspec = lo.group_spec() if grouped else None
        aggs = tuple(lo.agg_spec(a, grouped) for a in ctx.aggregations)
        if null_on:
            aggs = tuple(lo.null_wrap(a, s) for a, s in zip(ctx.aggregations, aggs))
        if gspec is not None and gspec[0] in ("groups_mv", "groups_mv2"):
            # MV group ids are value space; an *MV aggregation is value space
            # over a (maybe different) MV column: the two together run on the
            # host (explode)
            def has_mv(a):
                return a[0].startswith("mv_") or (a[0] in ("masked", "masked_nan_empty") and has_mv(a[2]))

            if any(has_mv(a) for a in aggs):
                raise DeviceFallback("MV aggregations under an MV GROUP BY run host-side")
        return plan(("agg", fspec, gspec, aggs), group_cols=[(c, seg.columns[c]) for c in (gspec[1] if gspec else ())])

    if ctx.query_type == QueryType.DISTINCT:
        # a group-by over the selected columns with no aggregates
        saved = ctx.group_by
        ctx.group_by = [it.expr for it in ctx.select_items]
        try:
            gspec = lo.group_spec()
        finally:
            ctx.group_by = saved
        return plan(("agg", fspec, gspec, ()), group_cols=[(c, seg.columns[c]) for c in gspec[1]])

    # SELECTION / SELECTION_ORDER_BY
    if null_on and any(
        expr_null_mask(seg, e) is not None for e in [it.expr for it in ctx.select_items] + [ob.expr for ob in ctx.order_by]
    ):
        # null cells come out as None (through expressions too) and sort as
        # the largest value: the host executor reads the null vectors
        raise DeviceFallback("null-handling selection runs host-side")
    proj, decode = [], []
    for item in ctx.select_items:
        e = item.expr
        if isinstance(e, ast.Star):
            raise DeviceFallback("SELECT * expansion handled by engine")
        if isinstance(e, ast.Identifier):
            if e.name in VIRTUAL_COLUMNS:
                # $docId / $segmentName / $hostName: doc ids come off the
                # device, the constants decode on the host
                proj.append(("docid",))
                decode.append(("virt", e.name))
                continue
            ci = seg.columns.get(e.name)
            if ci is None:
                raise PlanError(f"unknown column {e.name!r}")
            if ci.is_mv:
                raise DeviceFallback("MV column selection runs host-side (ragged rows)")
            lo.use_col(e.name)
            if ci.is_dict_encoded:
                proj.append(("ids", e.name))
                decode.append(("dict", e.name))
            else:
                proj.append(("raw", e.name))
                decode.append(("rawcol", e.name))
        else:
            proj.append(lo.value_spec(e))
            decode.append(("expr", None))
    k = ctx.limit + ctx.offset
    if ctx.query_type != QueryType.SELECTION_ORDER_BY:
        return plan(("select", fspec, tuple(proj), k), select_decode=decode)
    if len(ctx.order_by) != 1:
        # several keys: one int32 composite rank, one top-k for all of them
        kspec, ob_decomp = lo.multi_ob_spec(ctx.order_by)
        return plan(("select_ob", fspec, tuple(proj), kspec, False, k), select_decode=decode, ob_decomp=ob_decomp)
    ob = ctx.order_by[0]
    key = ob.expr
    if isinstance(key, ast.Identifier) and key.name in seg.columns and seg.columns[key.name].is_dict_encoded:
        lo.use_col(key.name)
        kspec = ("ids", key.name)  # dict id order is value order
    else:
        kspec = lo.value_spec(key)
    return plan(("select_ob", fspec, tuple(proj), kspec, ob.desc, k), select_decode=decode)
