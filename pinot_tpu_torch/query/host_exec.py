"""Host (numpy) executor: where a segment runs when its planning raises
DeviceFallback.

Reference parity: plays the role of Pinot's non-optimized operator paths (e.g.
NoDictionary*GroupKeyGenerator, ExpressionFilterOperator) for query shapes the
device lowering does not cover: GROUP BY on a raw column or an expression,
DISTINCTCOUNT of a raw column, the aggregations with no device lowering
(PERCENTILE, MODE, the `aggregates.EXT_AGGS` family, ...), string transforms.
This is the JAX package's `query/host_exec.py` written in numpy alone: it
produces the SAME partial formats as the device path (see reduce.py), so the
broker reduce never knows which executor ran a segment, and its group frames
keep pandas' `groupby(sort=False, dropna=False)` semantics: groups in order of
first appearance (a NaN key is a group of its own), each group's rows in row
order, NaN-skipping reducers where the reference's pandas ones skip.

Two evaluations differ in cost and not in result from the reference's: a
predicate over a dictionary column is evaluated once per dictionary value and
gathered by id, and a GROUP BY / DISTINCT key on a dictionary column groups by
its ids and decodes each group's first row (ids and values are one-to-one).

Under enableNullHandling it reads the segments' null vectors as the
reference's does: a WHERE or FILTER is three-valued (`filter_mask_null_aware`,
Kleene logic), aggregations skip the docs where their argument is null, a
null GROUP BY key forms a group of its own, and a selected null cell comes
out as None. A multi-value column filters by any-match (NEQ and NOT IN
match the docs where no value does), aggregates through the *MV functions
(each a partial of its single-value twin's format), and as a GROUP BY or
DISTINCT key explodes: each doc joins once per value (per cartesian
combination of several MV keys), a doc with no value joins no group. A
selected MV cell is a Python list. TEXT_MATCH, JSON_MATCH and
VECTOR_SIMILARITY probe the segment's index (`predicate_function_mask`, which
the planner also calls for the device program's `docmask` operand);
ST_WITHIN_DISTANCE takes the geo index's candidates where the segment has
one; map_value reads the map index where there is one.
"""

from __future__ import annotations

import json
import math
import re
import socket

import numpy as np

from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query import funnel
from pinot_tpu_torch.query.aggregates import EXT_AGGS, _hpp_p, _kll_k, _td_comp, _theta_compute, parse_theta_extra
from pinot_tpu_torch.query.context import (
    QueryContext,
    _collect_filter_identifiers,
    _collect_identifiers,
    null_handling_enabled,
)
from pinot_tpu_torch.query.distinct_sketch import hllplus_registers
from pinot_tpu_torch.query.plan import _FLIP, PlanError, _like_to_regex, group_strides
from pinot_tpu_torch.query.quantile_sketch import kll_from_values, td_from_values
from pinot_tpu_torch.query.reduce import group_index, parts_of, stable_order
from pinot_tpu_torch.query.sketches import np_est_hist, np_hll_registers
from pinot_tpu_torch.query.transforms import DEVICE_FUNCS, STRING_FUNCS, apply_string_func, rewrite_time_convert
from pinot_tpu_torch.segment.segment import ImmutableSegment

#: aggregations whose FILTER (WHERE) the group frame applies with a mask;
#: every other one NaN-masks its excluded rows and skips them
_FILTERED_OK = ("count", "sum", "min", "max", "avg", "minmaxrange")


def _column(seg: ImmutableSegment, name: str):
    ci = seg.columns.get(name)
    if ci is None:
        raise PlanError(f"unknown column {name!r}")
    return ci


def _dict_column(seg: ImmutableSegment, expr):
    """The ColumnIndex when `expr` names a single-value dictionary-encoded
    column, else None."""
    if isinstance(expr, ast.Identifier) and expr.name in seg.columns:
        ci = _column(seg, expr.name)
        if ci.is_dict_encoded and not ci.is_mv:
            return ci
    return None


def _mv_column(seg: ImmutableSegment, expr):
    """The ColumnIndex when `expr` names a multi-value column, else None."""
    if isinstance(expr, ast.Identifier):
        ci = seg.columns.get(expr.name)
        if ci is not None and ci.is_mv:
            return ci
    return None


def _mv_flat_values(ci) -> np.ndarray:
    return ci.dictionary.get_many(ci.forward) if ci.dictionary is not None else ci.forward


def _mv_flat_pred(ci, pred) -> np.ndarray:
    """pred over an MV column's flat values (per dictionary value, gathered
    by id, when it has a dictionary)."""
    if ci.dictionary is None:
        return np.asarray(pred(ci.forward), dtype=bool)
    lut = np.asarray(pred(ci.dictionary.values), dtype=bool)
    if lut.ndim == 0:
        return np.full(len(ci.forward), bool(lut))
    return lut[ci.forward]


def _mv_any_match(ci, flat_pred: np.ndarray) -> np.ndarray:
    """A flat per-value predicate as per-doc any-match (the host twin of the
    program's `mv_any`)."""
    hits = ci.flat_docids()[np.asarray(flat_pred, dtype=bool)]
    return np.bincount(hits, minlength=len(ci.lens)) > 0


# ---------------------------------------------------------------------------
# value expressions
# ---------------------------------------------------------------------------


def eval_value(seg: ImmutableSegment, expr: ast.Expr) -> np.ndarray:
    """Per-doc values of a value expression over the whole segment."""
    if isinstance(expr, ast.Identifier):
        if expr.name == "$docId":
            return np.arange(seg.n_docs, dtype=np.int64)
        if expr.name == "$segmentName":
            return np.full(seg.n_docs, seg.name, dtype=object)
        if expr.name == "$hostName":
            return np.full(seg.n_docs, socket.gethostname(), dtype=object)
        return _column(seg, expr.name).materialize()
    if isinstance(expr, ast.Literal):
        return np.full(seg.n_docs, expr.value)
    if isinstance(expr, ast.BinaryOp):
        l = eval_value(seg, expr.left)
        r = eval_value(seg, expr.right)
        if expr.op == "+":
            return l + r
        if expr.op == "-":
            return l - r
        if expr.op == "*":
            return l * r
        if expr.op == "/":
            return l.astype(np.float64) / r.astype(np.float64)
        if expr.op == "%":
            return np.mod(l, r)
    if isinstance(expr, ast.CaseWhen):
        conds = [filter_mask(seg, c) for c, _ in expr.whens]
        vals = [np.asarray(eval_value(seg, v)) for _, v in expr.whens]
        n = seg.n_docs
        vals = [np.broadcast_to(v, (n,)) if v.ndim == 0 else v for v in vals]
        if expr.else_ is not None:
            default = np.asarray(eval_value(seg, expr.else_))
            default = np.broadcast_to(default, (n,)) if default.ndim == 0 else default
        else:
            # null-handling-disabled default (CaseTransformFunction parity):
            # 0 for numeric branches, 'null' for string branches
            is_str = any(v.dtype == object or v.dtype.kind in "US" for v in vals)
            default = np.full(n, "null" if is_str else 0, dtype=object if is_str else np.float64)
        if any(v.dtype == object or v.dtype.kind in "US" for v in vals):
            vals = [v.astype(object) for v in vals]
            default = default.astype(object)
        return np.select(conds, vals, default=default)
    if isinstance(expr, ast.FunctionCall):
        return _eval_function(seg, expr)
    raise PlanError(f"unsupported value expression in host executor: {expr}")


def _eval_function(seg: ImmutableSegment, expr: ast.FunctionCall) -> np.ndarray:
    name = expr.name
    if name in ("timeconvert", "datetimeconvert"):
        rw = rewrite_time_convert(expr)
        if rw is not None:
            return eval_value(seg, rw)
    if name == "map_value":
        # map_value(col, 'key'): the dense per-key column of the map index
        # where the segment has one, else a per-row document parse
        # (StandardIndexes map entry parity)
        if len(expr.args) != 2 or not isinstance(expr.args[0], ast.Identifier) or not isinstance(expr.args[1], ast.Literal):
            raise PlanError("map_value requires (column, 'key')")
        col, key = expr.args[0].name, str(expr.args[1].value)
        mi = seg.extras.get("map", {}).get(col)
        if mi is not None:
            return mi.value_column(key)
        out = np.full(seg.n_docs, None, dtype=object)
        for i, v in enumerate(_column(seg, col).materialize()):
            if isinstance(v, dict):
                doc = v
            else:
                try:
                    doc = json.loads(v) if v else {}
                except (ValueError, TypeError):
                    continue  # non-JSON row -> None
            if isinstance(doc, dict):
                out[i] = doc.get(key)
        return out
    if name == "lookup":
        # lookUp('dimTable','destColumn','pk1',expr1[,'pk2',expr2...])
        # (LookupTransformFunction parity; host-side PK-map probes)
        from pinot_tpu_torch.cluster.dimension import get_dim_table

        if len(expr.args) < 4 or len(expr.args) % 2 != 0:
            raise PlanError("lookup requires (dimTable, destColumn, pkCol, pkExpr, ...)")
        lits = expr.args[:2]
        if not all(isinstance(a, ast.Literal) for a in lits):
            raise PlanError("lookup dimTable/destColumn must be string literals")
        dim = get_dim_table(str(lits[0].value))
        dest = str(lits[1].value)
        pk_cols = [str(a.value) for a in expr.args[2::2] if isinstance(a, ast.Literal)]
        key_arrays = [eval_value(seg, a) for a in expr.args[3::2]]
        if pk_cols != dim.pk_columns:
            raise PlanError(f"lookup join keys {pk_cols} must match dim table PK {dim.pk_columns}")
        keys = list(zip(*[a.tolist() for a in key_arrays]))
        return dim.lookup_column(dest, keys)
    if name == "cast":
        v = eval_value(seg, expr.args[0])
        target = str(expr.args[1].value).upper()
        if target in ("INT", "LONG", "TIMESTAMP", "BOOLEAN"):
            return np.trunc(v.astype(np.float64)).astype(np.int64) if np.issubdtype(v.dtype, np.floating) else v
        if target in ("FLOAT", "DOUBLE"):
            return v.astype(np.float64)
        if target == "STRING":
            return np.asarray([str(x) for x in v], dtype=object)
        raise PlanError(f"unsupported CAST target {target}")
    if name == "coalesce":
        # first non-null argument per row (CoalesceTransformFunction): null =
        # the null vector or a NaN/None cell. Accumulate in object space;
        # all-numeric results narrow back.
        out = np.full(seg.n_docs, None, dtype=object)
        filled = np.zeros(seg.n_docs, dtype=bool)
        for a in expr.args:
            v = np.asarray(eval_value(seg, a))
            v = np.broadcast_to(v, (seg.n_docs,)) if v.ndim == 0 else v
            miss = expr_null_mask(seg, a)
            miss = np.zeros(seg.n_docs, dtype=bool) if miss is None else miss.copy()
            if v.dtype == object:
                miss |= np.asarray([x is None for x in v], dtype=bool)
            elif np.issubdtype(v.dtype, np.floating):
                miss |= np.isnan(v)
            take = ~filled & ~miss
            out[take] = v[take]
            filled |= take
            if filled.all():
                break
        if filled.all() and all(
            isinstance(x, (int, float, np.integer, np.floating)) and not isinstance(x, bool) for x in out
        ):
            return out.astype(np.float64)
        return out
    if name in _ARRAY_FUNCS and len(expr.args) == 1:
        mvci = _mv_column(seg, expr.args[0])
        if mvci is not None:
            return _ARRAY_FUNCS[name](mvci)
    if name in _VECTOR_UNARY and len(expr.args) == 1:
        mvci = _mv_column(seg, expr.args[0])
        if mvci is not None:
            vecs = _vectors_of(mvci)
            if name == "vectordims":
                return np.full(len(vecs), vecs.shape[1], dtype=np.int64)
            return np.sqrt((vecs * vecs).sum(axis=-1))
    if name in _VECTOR_BINARY and len(expr.args) == 2:
        sides = []
        for a in expr.args:
            mvci = _mv_column(seg, a)
            if mvci is not None:
                sides.append(_vectors_of(mvci))
            elif isinstance(a, ast.ArrayLiteral):
                sides.append(np.asarray([float(v) for v in a.values])[None, :])
            else:
                sides = None
                break
        if sides is not None and sides[0].shape[-1] == sides[1].shape[-1]:
            res = _vector_binary(name, sides[0], sides[1])
            if res.shape[0] == 1 and seg.n_docs != 1:
                # both sides literal: one value for every doc
                res = np.full(seg.n_docs, float(res[0]))
            return res
    if name in DEVICE_FUNCS:
        _, fn = DEVICE_FUNCS[name]
        # the functions take their array namespace first: numpy here
        args = [eval_value(seg, a) for a in expr.args]
        return np.asarray(fn(np, *args))
    if name in STRING_FUNCS:
        base = eval_value(seg, expr.args[0])
        lit_args = tuple(a.value for a in expr.args[1:] if isinstance(a, ast.Literal))
        derived, _ = apply_string_func(name, base, lit_args)
        return derived
    raise PlanError(f"unsupported value expression in host executor: {expr}")


def _array_length(ci) -> np.ndarray:
    return np.asarray(ci.lens, dtype=np.int64)


def _array_numeric_reduce(ci, op: str) -> np.ndarray:
    """Per-doc reduction over an MV column's values (Array{Sum,Min,Max,
    Average}TransformFunction); an empty list reduces to NaN."""
    flat = _mv_flat_values(ci)
    if flat.dtype == object or flat.dtype.kind in ("U", "S"):
        raise PlanError(f"{op} requires a numeric multi-value column")
    flat = flat.astype(np.float64)
    docs = ci.flat_docids()
    n = len(ci.lens)
    if op in ("arraysum", "arrayaverage"):
        s = np.zeros(n, dtype=np.float64)
        np.add.at(s, docs, flat)
        if op == "arrayaverage":
            s = s / np.maximum(np.asarray(ci.lens, dtype=np.float64), 1.0)
    elif op == "arraymin":
        s = np.full(n, np.inf)
        np.minimum.at(s, docs, flat)
    else:  # arraymax
        s = np.full(n, -np.inf)
        np.maximum.at(s, docs, flat)
    return np.where(np.asarray(ci.lens) == 0, np.nan, s)


_ARRAY_FUNCS = {
    "arraylength": _array_length,
    "cardinality": _array_length,
    "arraysum": lambda ci: _array_numeric_reduce(ci, "arraysum"),
    "arrayaverage": lambda ci: _array_numeric_reduce(ci, "arrayaverage"),
    "arraymin": lambda ci: _array_numeric_reduce(ci, "arraymin"),
    "arraymax": lambda ci: _array_numeric_reduce(ci, "arraymax"),
}

#: VectorTransformFunctions parity: the binary distances / similarity of a
#: float MV column and an ARRAY[...] literal (or two MV columns), and the
#: unary VECTORDIMS / VECTORNORM
_VECTOR_BINARY = ("cosinedistance", "innerproduct", "l1distance", "l2distance")
_VECTOR_UNARY = ("vectordims", "vectornorm")


def _vectors_of(ci) -> np.ndarray:
    """(n_docs, dim) float matrix of a uniform-length numeric MV column."""
    flat = _mv_flat_values(ci)
    if flat.dtype == object or flat.dtype.kind in ("U", "S"):
        raise PlanError("vector functions require a numeric multi-value column")
    lens = np.asarray(ci.lens)
    if len(lens) == 0 or (lens != lens[0]).any() or lens[0] == 0:
        raise PlanError("vector functions require uniform non-empty vector lengths")
    return flat.astype(np.float64).reshape(len(lens), int(lens[0]))


def _vector_binary(name: str, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if name == "innerproduct":
        return (a * b).sum(axis=-1)
    if name == "l1distance":
        return np.abs(a - b).sum(axis=-1)
    if name == "l2distance":
        return np.sqrt(((a - b) ** 2).sum(axis=-1))
    # cosinedistance: 1 - cosine similarity, NaN for a zero-norm row
    na = np.sqrt((a * a).sum(axis=-1))
    nb = np.sqrt((b * b).sum(axis=-1))
    denom = na * nb
    with np.errstate(invalid="ignore", divide="ignore"):
        sim = (a * b).sum(axis=-1) / denom
    return np.where(denom == 0, np.nan, 1.0 - sim)


def eval_rows(seg: ImmutableSegment, expr: ast.Expr, rows: np.ndarray) -> np.ndarray:
    """eval_value(seg, expr)[rows], reading only `rows` where expr is a column."""
    if isinstance(expr, ast.Identifier) and expr.name in seg.columns:
        return _column(seg, expr.name).materialize(rows)
    return eval_value(seg, expr)[rows]


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------


_CMPS = {
    ast.CompareOp.EQ: lambda a, b: a == b,
    ast.CompareOp.NEQ: lambda a, b: a != b,
    ast.CompareOp.LT: lambda a, b: a < b,
    ast.CompareOp.LTE: lambda a, b: a <= b,
    ast.CompareOp.GT: lambda a, b: a > b,
    ast.CompareOp.GTE: lambda a, b: a >= b,
}


def _pred_mask(seg: ImmutableSegment, expr, pred) -> np.ndarray:
    """pred over expr's per-doc values, as a bool doc mask. pred is elementwise,
    so over a dictionary column it runs once per dictionary value and the
    result gathers by id."""
    ci = _dict_column(seg, expr)
    if ci is None:
        return np.asarray(pred(eval_value(seg, expr)), dtype=bool)
    lut = np.asarray(pred(ci.dictionary.values), dtype=bool)
    if lut.ndim == 0:  # numpy decided the comparison for every value at once
        return np.full(seg.n_docs, bool(lut))
    return lut[ci.forward]


def filter_mask(seg: ImmutableSegment, f: ast.FilterExpr | None) -> np.ndarray:
    n = seg.n_docs
    if f is None:
        return np.ones(n, dtype=bool)
    if isinstance(f, ast.And):
        m = np.ones(n, dtype=bool)
        for c in f.children:
            m &= filter_mask(seg, c)
        return m
    if isinstance(f, ast.Or):
        m = np.zeros(n, dtype=bool)
        for c in f.children:
            m |= filter_mask(seg, c)
        return m
    if isinstance(f, ast.Not):
        return ~filter_mask(seg, f.child)
    if isinstance(f, ast.Compare):
        left, op, right = f.left, f.op, f.right
        if isinstance(left, ast.Literal) and not isinstance(right, ast.Literal):
            left, right = right, left
            op = _FLIP[op]
        if not isinstance(right, ast.Literal):
            return np.asarray(_CMPS[op](eval_value(seg, left), eval_value(seg, right)), dtype=bool)
        rv = right.value
        mvci = _mv_column(seg, left)
        # an MV column: any value matches; NEQ is an exclusion, the docs where
        # no value equals (an empty list included)
        pos_op = ast.CompareOp.EQ if mvci is not None and op == ast.CompareOp.NEQ else op

        def cmp(lv):
            if isinstance(rv, str) and lv.dtype == object:
                lv = lv.astype(str)
            return _CMPS[pos_op](lv, rv)

        if mvci is not None:
            m = _mv_any_match(mvci, _mv_flat_pred(mvci, cmp))
            return ~m if op == ast.CompareOp.NEQ else m
        return _pred_mask(seg, left, cmp)
    if isinstance(f, ast.Between):
        lo = f.low.value if isinstance(f.low, ast.Literal) else None
        hi = f.high.value if isinstance(f.high, ast.Literal) else None
        if lo is None or hi is None:
            raise PlanError("BETWEEN bounds must be literals")

        def between(v):
            if v.dtype == object:
                v = v.astype(str)
            return (v >= lo) & (v <= hi)

        mvci = _mv_column(seg, f.expr)
        m = _mv_any_match(mvci, _mv_flat_pred(mvci, between)) if mvci is not None else _pred_mask(seg, f.expr, between)
        return ~m if f.negated else m
    if isinstance(f, ast.In):
        vals = [x.value for x in f.values if isinstance(x, ast.Literal)]

        def isin(v):
            want = vals
            if v.dtype == object:
                v = v.astype(str)
                want = [str(x) for x in vals]
            return np.isin(v, np.asarray(want))

        mvci = _mv_column(seg, f.expr)
        m = _mv_any_match(mvci, _mv_flat_pred(mvci, isin)) if mvci is not None else _pred_mask(seg, f.expr, isin)
        return ~m if f.negated else m
    if isinstance(f, ast.Like):
        rx = re.compile(_like_to_regex(f.pattern))
        m = _pred_mask(seg, f.expr, lambda v: [bool(rx.fullmatch(x)) for x in v.astype(str)])
        return ~m if f.negated else m
    if isinstance(f, ast.RegexpLike):
        rx = re.compile(f.pattern)
        return _pred_mask(seg, f.expr, lambda v: [bool(rx.search(x)) for x in v.astype(str)])
    if isinstance(f, ast.IsNull):
        if isinstance(f.expr, ast.Identifier):
            nulls = seg.null_mask({f.expr.name})
            if nulls is not None:
                return ~nulls if f.negated else nulls.copy()
        # no null vector (Pinot default null handling): IS NULL matches nothing
        return np.full(n, bool(f.negated))
    if isinstance(f, ast.BoolAssert):
        v = np.asarray(eval_value(seg, f.expr))
        nulls = expr_null_mask(seg, f.expr)
        if v.dtype == object or v.dtype.kind in ("U", "S"):
            truthy = np.asarray([x is not None and bool(x) and str(x).lower() not in ("false", "0") for x in v], dtype=bool)
        else:
            truthy = v.astype(np.float64) != 0
        pos = truthy if f.want_true else ~truthy
        if nulls is not None:
            pos = pos & ~nulls
        # IS NOT TRUE / IS NOT FALSE include the null rows (3-valued NOT)
        return ~pos if f.negated else pos
    if isinstance(f, ast.DistinctFrom):
        nl = expr_null_mask(seg, f.left)
        nr = expr_null_mask(seg, f.right)
        nl = np.zeros(n, dtype=bool) if nl is None else nl
        nr = np.zeros(n, dtype=bool) if nr is None else nr
        with np.errstate(invalid="ignore"):
            neq = np.asarray(eval_value(seg, f.left) != eval_value(seg, f.right), dtype=bool)
        m = (neq & ~nl & ~nr) | (nl ^ nr)
        return ~m if f.negated else m
    if isinstance(f, ast.PredicateFunction):
        return predicate_function_mask(seg, f)
    raise PlanError(f"unsupported filter in host executor: {f}")


def predicate_function_mask(seg: ImmutableSegment, f: ast.PredicateFunction) -> np.ndarray:
    """Index-probe predicates -> bool doc mask (TextMatch / JsonMatch /
    VectorSimilarity filter-operator parity; shared by the device planner and
    the host executor); ST_WITHIN_DISTANCE through the geo index's candidates
    where the segment has one, else a haversine over the columns."""
    n = seg.n_docs

    def _col(i: int) -> str:
        if len(f.args) <= i or not isinstance(f.args[i], ast.Identifier):
            raise PlanError(f"{f.name} argument {i} must be a column")
        return f.args[i].name

    def _lit(i: int):
        if len(f.args) <= i or not isinstance(f.args[i], ast.Literal):
            raise PlanError(f"{f.name} argument {i} must be a literal")
        return f.args[i].value

    if f.name == "text_match":
        col = _col(0)
        ti = seg.extras.get("text", {}).get(col)
        if ti is None:
            raise PlanError(f"TEXT_MATCH requires a text index on column {col!r}")
        return ti.search(str(_lit(1)))
    if f.name == "json_match":
        col = _col(0)
        ji = seg.extras.get("json", {}).get(col)
        if ji is None:
            raise PlanError(f"JSON_MATCH requires a json index on column {col!r}")
        return ji.match(str(_lit(1)))
    if f.name == "vector_similarity":
        col = _col(0)
        vi = seg.extras.get("vector", {}).get(col)
        if vi is None:
            raise PlanError(f"VECTOR_SIMILARITY requires a vector index on column {col!r}")
        if len(f.args) < 2 or not isinstance(f.args[1], ast.ArrayLiteral):
            raise PlanError("VECTOR_SIMILARITY(col, ARRAY[...], topK)")
        k = int(_lit(2)) if len(f.args) > 2 else 10
        mask = np.zeros(n, dtype=bool)
        mask[vi.top_k(np.asarray(f.args[1].values, dtype=np.float32), k)] = True
        return mask
    if f.name == "st_within_distance":
        from pinot_tpu_torch.segment.indexes import haversine_m

        qlat, qlng, radius = float(_lit(2)), float(_lit(3)), float(_lit(4))
        if isinstance(f.args[0], ast.Identifier) and isinstance(f.args[1], ast.Identifier):
            gi = seg.extras.get("geo", {}).get(f"{f.args[0].name},{f.args[1].name}")
            if gi is not None:
                # the grid cells' candidates first, the exact haversine over
                # the (usually few) candidates only
                cand = gi.candidate_docs(qlat, qlng, radius)
                mask = np.zeros(n, dtype=bool)
                if len(cand):
                    lat_c = seg.columns[f.args[0].name].materialize(cand).astype(np.float64)
                    lng_c = seg.columns[f.args[1].name].materialize(cand).astype(np.float64)
                    mask[cand[haversine_m(lat_c, lng_c, qlat, qlng) <= radius]] = True
                return mask
        lat = eval_value(seg, f.args[0]).astype(np.float64)
        lng = eval_value(seg, f.args[1]).astype(np.float64)
        return haversine_m(lat, lng, qlat, qlng) <= radius
    raise PlanError(f"unknown predicate function {f.name}")


# ---------------------------------------------------------------------------
# null handling
# ---------------------------------------------------------------------------


def expr_null_mask(seg: ImmutableSegment, expr) -> np.ndarray | None:
    """Docs where `expr` is null, or None when it never is: where any column
    it reads is null (nulls propagate through expressions), except that
    COALESCE is null only where every argument is."""
    if isinstance(expr, ast.FunctionCall) and expr.name == "coalesce":
        m = None
        for a in expr.args:
            am = expr_null_mask(seg, a)
            if am is None:
                return None  # an argument that is never null
            m = am if m is None else (m & am)
        return m
    idents: set[str] = set()
    _collect_identifiers(expr, idents)
    return seg.null_mask(idents)


def _null_doc_mask(seg: ImmutableSegment, a) -> np.ndarray | None:
    """Docs where an argument column of aggregation `a` is null, or None when
    no argument column has a null vector (the segment memoizes the mask)."""
    return seg.null_mask({x.name for x in (a.arg, a.arg2) if isinstance(x, ast.Identifier)})


def filter_mask_null_aware(seg: ImmutableSegment, f: ast.FilterExpr | None) -> np.ndarray:
    """Three-valued filter evaluation under enableNullHandling: a predicate
    over a null input is UNKNOWN, AND / OR / NOT combine by Kleene logic, and
    only definitely-true docs survive."""
    return _filter3(seg, f)[0]


def _filter3(seg: ImmutableSegment, f: ast.FilterExpr | None) -> tuple[np.ndarray, np.ndarray]:
    """(true mask, unknown mask) of one filter node."""
    n = seg.n_docs
    if f is None:
        return np.ones(n, dtype=bool), np.zeros(n, dtype=bool)
    if isinstance(f, ast.And):
        t, u, any_false = np.ones(n, dtype=bool), np.zeros(n, dtype=bool), np.zeros(n, dtype=bool)
        for c in f.children:
            ct, cu = _filter3(seg, c)
            t &= ct
            u |= cu
            any_false |= ~ct & ~cu
        return t, u & ~any_false  # FALSE dominates UNKNOWN
    if isinstance(f, ast.Or):
        t, u = np.zeros(n, dtype=bool), np.zeros(n, dtype=bool)
        for c in f.children:
            ct, cu = _filter3(seg, c)
            t |= ct
            u |= cu
        return t, u & ~t  # TRUE dominates UNKNOWN
    if isinstance(f, ast.Not):
        ct, cu = _filter3(seg, f.child)
        return ~ct & ~cu, cu  # NOT(unknown) = unknown
    if isinstance(f, (ast.IsNull, ast.DistinctFrom, ast.BoolAssert)):
        # never unknown: these read the null vectors themselves
        return filter_mask(seg, f), np.zeros(n, dtype=bool)
    # a leaf predicate: unknown wherever a column it reads is null
    t = filter_mask(seg, f)
    refs: set[str] = set()
    _collect_filter_identifiers(f, refs)
    nulls = seg.null_mask(refs)
    if nulls is None or not nulls.any():
        return t, np.zeros(n, dtype=bool)
    return t & ~nulls, nulls


def _selection_nulls(seg: ImmutableSegment, ctx: QueryContext, expr) -> np.ndarray | None:
    """A selected expression's null mask under enableNullHandling (its null
    cells then come out as None, not as the stored placeholder), else None."""
    return expr_null_mask(seg, expr) if null_handling_enabled(ctx.options) else None


def _null_subst(v: np.ndarray, nm: np.ndarray) -> np.ndarray:
    out = v.astype(object)
    out[nm] = None
    return out


# ---------------------------------------------------------------------------
# missing values (FILTER (WHERE) exclusions), as pandas treats them
# ---------------------------------------------------------------------------


def _isna(v: np.ndarray) -> np.ndarray:
    """pandas' isna over a column: NaN in float columns; None or NaN in
    object columns."""
    if v.dtype.kind == "f":
        return np.isnan(v)
    if v.dtype == object:
        return np.fromiter((x is None or (isinstance(x, float) and x != x) for x in v), bool, len(v))
    return np.zeros(len(v), dtype=bool)


def _dropna(v: np.ndarray) -> np.ndarray:
    return v[~_isna(v)]


def _dropna_typed(v: np.ndarray) -> np.ndarray:
    """dropna() that restores int64 dtype for object cells holding ints —
    hash-based sketches must see the original integer bit patterns."""
    v2 = _dropna(v)
    if v2.dtype == object and len(v2):
        first = v2[0]
        if isinstance(first, (int, np.integer)) and not isinstance(first, bool):
            return v2.astype(np.int64)
    return v2


def _nan_mask_values(v: np.ndarray, excluded: np.ndarray, func: str) -> np.ndarray:
    """Substitute excluded rows with NaN/None so the reducers skip them.
    Strings and identity-sensitive functions keep object/None cells: a
    float64 cast would collapse int values above 2^53 AND change the hash
    bit-pattern HLL/theta sketches use."""
    identity = v.dtype.kind in "iu" and (func.startswith("distinct") or func in ("idset", "mode", "sumprecision"))
    if v.dtype == object or v.dtype.kind in "US" or identity:
        v = v.astype(object)
        v[excluded] = None
        return v
    return np.where(excluded, np.nan, v.astype(np.float64))


# ---------------------------------------------------------------------------
# partial producers (formats documented in reduce.py)
# ---------------------------------------------------------------------------


def _theta_filter_masks(seg: ImmutableSegment, extra: tuple) -> list[np.ndarray]:
    """Doc masks for a filtered DISTINCTCOUNTTHETASKETCH's filter predicates
    (one per clause)."""
    from pinot_tpu_torch.query.sql import parse_sql

    _params, filters, _postagg = parse_theta_extra(extra)
    return [filter_mask(seg, parse_sql(f"SELECT * FROM _t WHERE {f}").where) for f in filters]


def _theta_filtered_partial(seg: ImmutableSegment, a, mask: np.ndarray):
    """DISTINCTCOUNTTHETASKETCH with filter expressions: one KMV sketch per
    filter predicate, combined at reduce by the SET_* post-aggregation."""
    fmasks = _theta_filter_masks(seg, a.extra)
    v = eval_value(seg, a.arg)
    if not fmasks:
        return _theta_compute(v[mask], None, ())
    return ("multi", [_theta_compute(v[mask & fm], None, ()) for fm in fmasks])


# -- MV aggregations: partials in their single-value twin's format --------

_MV_AGGS = (
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
    "percentileestmv",
    "percentiletdigestmv",
    "percentilekllmv",
    "percentilerawestmv",
    "percentilerawtdigestmv",
    "percentilerawkllmv",
    "distinctcounthllplusmv",
    "distinctcountrawhllmv",
    "distinctcountrawhllplusmv",
)
#: set partials (the twins merge by union)
_MV_SET_AGGS = ("distinctcountmv", "distinctsummv", "distinctavgmv", "distinctcountbitmapmv", "distinctcounthllmv")
#: the matched flat values (or a quantile sketch of them) as the partial
_MV_VALUES_AGGS = (
    "percentilemv",
    "percentileestmv",
    "percentiletdigestmv",
    "percentilekllmv",
    "percentilerawestmv",
    "percentilerawtdigestmv",
    "percentilerawkllmv",
)
#: HLL-register partials (the twins merge by elementwise max)
_MV_REG_AGGS = ("distinctcounthllplusmv", "distinctcountrawhllmv", "distinctcountrawhllplusmv")


def _mv_agg_column(seg: ImmutableSegment, a):
    if not isinstance(a.arg, ast.Identifier):
        raise PlanError(f"{a.func} requires an MV column argument")
    ci = seg.columns.get(a.arg.name)
    if ci is None or not ci.is_mv:
        raise PlanError(f"{a.func} requires a multi-value column")
    return ci


def _mv_values_to_twin(func: str, arr: np.ndarray, extra: tuple):
    """Matched flat values -> the twin's partial: a t-digest or a KLL sketch
    for the sketch twins, else the float64 values."""
    arr = np.asarray(arr, dtype=np.float64)
    if func in ("percentiletdigestmv", "percentilerawtdigestmv", "percentilerawestmv"):
        return td_from_values(arr, _td_comp(extra))
    if func in ("percentilekllmv", "percentilerawkllmv"):
        return kll_from_values(arr, _kll_k(extra))
    return arr


def _mv_registers(func: str, values: np.ndarray, extra: tuple) -> np.ndarray:
    if func in ("distinctcounthllplusmv", "distinctcountrawhllplusmv"):
        return hllplus_registers(values, _hpp_p(extra))
    return np_hll_registers(values)


def _mv_scalar_partial(func: str, flat: np.ndarray, extra: tuple = ()):
    """The partial of an MV aggregation over the matched flat values."""
    if func == "countmv":
        return int(len(flat))
    if func in _MV_SET_AGGS:
        return set(flat.tolist())
    if func in _MV_VALUES_AGGS:
        return _mv_values_to_twin(func, flat, extra)
    if func in _MV_REG_AGGS:
        return _mv_registers(func, flat, extra)
    v = flat.astype(np.float64)
    if func == "summv":
        return float(v.sum())
    if func == "minmv":
        return float(v.min()) if len(v) else float("inf")
    if func == "maxmv":
        return float(v.max()) if len(v) else float("-inf")
    if func == "minmaxrangemv":
        return (float(v.min()) if len(v) else float("inf"), float(v.max()) if len(v) else float("-inf"))
    # avgmv
    return (float(v.sum()), int(len(v)))


def _mv_doc_partials(func: str, ci, rows: np.ndarray, keep: np.ndarray | None) -> list[np.ndarray]:
    """Per-doc pre-aggregates of a numeric MV aggregation at the frame's
    `rows` (doc ids, repeated where an MV key explodes a doc), so the group
    merge needs only the twin's sum / min / max. `keep` (a FILTER (WHERE), at
    `rows`): an excluded row keeps its place with a neutral partial."""
    if func == "countmv":
        lens = ci.lens[rows].astype(np.int64)
        return [lens if keep is None else np.where(keep, lens, 0)]
    v = _mv_flat_values(ci).astype(np.float64)
    docids = ci.flat_docids()
    n = len(ci.lens)

    def doc_reduce(ufunc, start):
        if ufunc is np.add:
            out = np.bincount(docids, weights=v, minlength=n)  # in flat order, as add.at
        else:
            out = np.full(n, start)
            ufunc.at(out, docids, v)
        out = out[rows]
        return out if keep is None else np.where(keep, out, start)

    if func == "summv":
        return [doc_reduce(np.add, 0.0)]
    if func == "minmv":
        return [doc_reduce(np.minimum, np.inf)]
    if func == "maxmv":
        return [doc_reduce(np.maximum, -np.inf)]
    if func == "minmaxrangemv":
        return [doc_reduce(np.minimum, np.inf), doc_reduce(np.maximum, -np.inf)]
    # avgmv
    lens = ci.lens[rows].astype(np.int64)
    return [doc_reduce(np.add, 0.0), lens if keep is None else np.where(keep, lens, 0)]


def _mv_group_values(ci, rows, keep, grp: "_Groups") -> tuple[np.ndarray, np.ndarray]:
    """(group, flat position) of each value of an MV column the frame's rows
    hold, in row order and within a row in value order (the reference
    concatenates its rows' value arrays so); a row `keep` excludes holds
    none."""
    group = grp.group
    if keep is not None:
        rows, group = rows[keep], group[keep]
    lens = ci.lens[rows].astype(np.int64)
    take = np.repeat(np.arange(len(rows)), lens)
    pos = ci.offsets()[:-1][rows][take] + (np.arange(len(take)) - np.repeat(np.cumsum(lens) - lens, lens))
    return group[take], pos


#: largest (groups x dictionary) presence count of a host MV set aggregation
MV_PRESENCE_CELLS = 1 << 24


def _mv_group_sets(ci, group: np.ndarray, pos: np.ndarray, n_groups: int) -> list[set]:
    """Each group's set of an MV column's values at flat positions `pos`; of
    a dictionary column from a (group, id) presence count, no sort."""
    if ci.dictionary is not None and n_groups * max(ci.cardinality, 1) <= MV_PRESENCE_CELLS:
        card = max(ci.cardinality, 1)
        seen = np.bincount(group * card + ci.forward[pos], minlength=n_groups * card).reshape(n_groups, card) > 0
        return [set(ci.dictionary.values[np.flatnonzero(row)].tolist()) for row in seen]
    flat = _mv_flat_values(ci)
    order = stable_order(group, n_groups)
    bounds = np.searchsorted(group[order], np.arange(n_groups + 1))
    return [set(flat[pos[order[bounds[g] : bounds[g + 1]]]].tolist()) for g in range(n_groups)]


def _mv_group_partials(a, ci, rows, fmask, grp: "_Groups") -> list[np.ndarray]:
    """An MV aggregation's partial columns over a group frame's groups."""
    n_groups = len(grp.size)
    out = np.empty(n_groups, dtype=object)
    if a.func in _MV_VALUES_AGGS:
        group, pos = _mv_group_values(ci, rows, fmask, grp)
        order = stable_order(group, n_groups)
        bounds = np.searchsorted(group[order], np.arange(n_groups + 1))
        flat = _mv_flat_values(ci)[pos[order]].astype(np.float64)
        for g in range(n_groups):
            out[g] = _mv_values_to_twin(a.func, flat[bounds[g] : bounds[g + 1]], a.extra)
        return [out]
    if a.func in _MV_SET_AGGS or a.func in _MV_REG_AGGS:
        for g, vals in enumerate(_mv_group_sets(ci, *_mv_group_values(ci, rows, fmask, grp), n_groups)):
            # a register partial is made once from the group's merged set
            out[g] = _mv_registers(a.func, np.asarray(list(vals)), a.extra) if a.func in _MV_REG_AGGS else vals
        return [out]
    docp = _mv_doc_partials(a.func, ci, rows, fmask)
    if a.func in ("countmv", "summv"):
        return [grp.sum(docp[0])]
    if a.func in ("minmv", "maxmv"):
        return [grp.extreme(docp[0], a.func == "minmv")]
    if a.func == "minmaxrangemv":
        return [grp.extreme(docp[0], True), grp.extreme(docp[1], False)]
    # avgmv
    return [grp.sum(docp[0]), grp.sum(docp[1])]


def _mode_counter(v: np.ndarray) -> dict:
    vals, counts = np.unique(v, return_counts=True)
    return {float(k): int(c) for k, c in zip(vals, counts)}


def _agg_filter(seg: ImmutableSegment, f, null_on: bool) -> np.ndarray:
    """An aggregation's FILTER (WHERE ...) mask: three-valued under null
    handling, as the WHERE."""
    return filter_mask_null_aware(seg, f) if null_on else filter_mask(seg, f)


def agg_partials(seg: ImmutableSegment, ctx: QueryContext, query_mask: np.ndarray) -> list:
    null_on = null_handling_enabled(ctx.options)
    out = []
    for a in ctx.aggregations:
        # FILTER (WHERE ...) intersects into the query mask per aggregation;
        # under null handling the docs where the argument is null drop out
        mask = query_mask if a.filter is None else query_mask & _agg_filter(seg, a.filter, null_on)
        if null_on:
            nulls = _null_doc_mask(seg, a)
            if nulls is not None:
                mask = mask & ~nulls
        if a.func == "count":
            out.append(int(mask.sum()))
            continue
        if a.func in _MV_AGGS:
            ci = _mv_agg_column(seg, a)
            flat = _mv_flat_values(ci)[mask[ci.flat_docids()]]
            out.append(_mv_scalar_partial(a.func, flat, a.extra))
            continue
        if a.func in funnel.FUNNEL_AGGS:
            out.append(funnel.segment_partial(seg, a, mask))
            continue
        if a.func == "distinctcounttheta" and a.extra:
            out.append(_theta_filtered_partial(seg, a, mask))
            continue
        if a.func in EXT_AGGS:
            v = eval_value(seg, a.arg)[mask] if a.arg is not None else None
            v2 = eval_value(seg, a.arg2)[mask] if a.arg2 is not None else None
            out.append(EXT_AGGS[a.func].compute(v, v2, a.extra))
            continue
        rows = np.flatnonzero(mask)
        if a.func in ("distinctcount", "distinctcountbitmap"):
            out.append(set(eval_rows(seg, a.arg, rows).tolist()))
            continue
        if a.func == "distinctcounthll":
            out.append(np_hll_registers(eval_rows(seg, a.arg, rows)))
            continue
        if a.func == "mode":
            out.append(_mode_counter(eval_rows(seg, a.arg, rows)))
            continue
        v = eval_rows(seg, a.arg, rows).astype(np.float64)
        if a.func == "percentileest":
            bounds = ctx.hints.get("est_bounds", {}).get(a.name)
            if bounds is None:
                out.append(v)  # exact-values mode (merged by concatenation)
            else:
                lo, hi = bounds
                out.append((np_est_hist(v, lo, hi), lo, hi))
        elif a.func == "percentiletdigest":
            out.append(td_from_values(v, _td_comp(a.extra)))
        elif a.func == "percentile":
            out.append(v)
        elif a.func == "sum":
            # None: no non-null doc under null handling (NULL at the reduce)
            out.append(float(v.sum()) if len(v) else (None if null_on else 0.0))
        elif a.func == "min":
            out.append(float(v.min()) if len(v) else float("inf"))
        elif a.func == "max":
            out.append(float(v.max()) if len(v) else float("-inf"))
        elif a.func == "avg":
            out.append((float(v.sum()), int(len(v))))
        elif a.func == "minmaxrange":
            out.append((float(v.min()) if len(v) else float("inf"), float(v.max()) if len(v) else float("-inf")))
        else:
            raise PlanError(f"unsupported aggregation in host executor: {a.func}")
    return out


class _Groups:
    """Rows grouped in order of first appearance: `group[r]` is row r's
    group, and `pieces(v)` gives each group's values in row order (what a
    pandas groupby hands each group's reducer)."""

    def __init__(self, group: np.ndarray, n_groups: int):
        self.group = group
        self.size = np.bincount(group, minlength=n_groups).astype(np.int64)
        self.order = stable_order(group, n_groups)
        self.ends = np.cumsum(self.size)
        self.starts = self.ends - self.size

    def pieces(self, v: np.ndarray) -> list[np.ndarray]:
        sv = v[self.order]
        return [sv[s:e] for s, e in zip(self.starts.tolist(), self.ends.tolist())]

    def cells(self, fn, *cols) -> np.ndarray:
        """fn over each group's pieces of `cols`, one object cell a group."""
        parts = [self.pieces(c) for c in cols]
        out = np.empty(len(self.size), dtype=object)
        for g in range(len(self.size)):
            out[g] = fn(*(p[g] for p in parts))
        return out

    def sum(self, v: np.ndarray) -> np.ndarray:
        """Per-group sum skipping NaN (pandas' sum): exact int64 for integer
        and bool columns, float64 otherwise."""
        if v.dtype.kind in "iub":
            return np.add.reduceat(v.astype(np.int64)[self.order], self.starts)
        v = v.astype(np.float64)
        return np.add.reduceat(np.where(np.isnan(v), 0.0, v)[self.order], self.starts)

    def sum_or_nan(self, v: np.ndarray) -> np.ndarray:
        """Per-group float64 sum skipping NaN, NaN where a group has no other
        value (pandas' sum(min_count=1))."""
        s = self.sum(v).astype(np.float64)
        if v.dtype.kind != "f":
            return s
        return np.where(self.sum(~np.isnan(v)) == 0, np.nan, s)

    def extreme(self, v: np.ndarray, is_min: bool) -> np.ndarray:
        """Per-group min / max skipping NaN (NaN where a group has only NaN)."""
        if v.dtype.kind in "iub":
            ufunc = np.minimum if is_min else np.maximum
            return ufunc.reduceat(v[self.order], self.starts).astype(np.float64)
        ufunc = np.fmin if is_min else np.fmax
        return ufunc.reduceat(v.astype(np.float64)[self.order], self.starts)


def _explode(seg: ImmutableSegment, exprs: list, rows: np.ndarray) -> tuple[np.ndarray, dict[int, np.ndarray]]:
    """The frame's rows with every MV key exploded (pandas' explode, one key
    after the other): each doc repeats once per value of its first MV key,
    each of those once per value of the next, ... A doc with no value of an
    MV key (and a NaN value of a float one, which the reference's dropna
    drops) leaves no row. Returns (the doc of each row, {key index: the flat
    value position of each row})."""
    pos: dict[int, np.ndarray] = {}
    for i, e in enumerate(exprs):
        ci = _mv_column(seg, e)
        if ci is None:
            continue
        if not pos and len(rows) == len(ci.lens):
            # every doc, no key exploded yet: the rows are the flat values
            rows, pos[i] = ci.flat_docids().astype(np.int64), np.arange(len(ci.forward))
        else:
            lens = ci.lens[rows].astype(np.int64)
            take = np.repeat(np.arange(len(rows)), lens)
            within = np.arange(len(take)) - np.repeat(np.cumsum(lens) - lens, lens)
            rows = rows[take]
            pos = {k: p[take] for k, p in pos.items()}
            pos[i] = ci.offsets()[:-1][rows] + within
        flat = ci.dictionary.values if ci.dictionary is not None else ci.forward
        if flat.dtype.kind == "f":
            keep = ~np.isnan(flat[ci.forward[pos[i]]] if ci.dictionary is not None else flat[pos[i]])
            rows = rows[keep]
            pos = {k: p[keep] for k, p in pos.items()}
    return rows, pos


def _mv_key(v: np.ndarray) -> np.ndarray:
    """An MV key column's values as the reference's exploded column holds
    them: text as str, integers as int64, floats as float64."""
    if v.dtype == object or v.dtype.kind in "US":
        return v.astype(str)
    if v.dtype.kind in "iu":
        return v.astype(np.int64)
    return v.astype(np.float64) if v.dtype.kind == "f" else v


def _key_columns(seg: ImmutableSegment, exprs: list, rows: np.ndarray, null_keys: bool = False):
    """(grouping arrays, decode(first rows) -> key columns, the frame's
    rows): a dictionary column groups by its ids; any other key by its
    values, strings as fixed-width text (the reference's `astype(str)`). Keys
    that are all dictionary columns group by one combined id. MV keys explode
    (`_explode`), so the frame's rows are docs, repeated. With `null_keys`
    (null handling), the docs where a key is null group apart, by a null flag
    beside the key, and decode as missing (`_null_key`)."""
    rows, pos = _explode(seg, exprs, rows)
    keys, decoders, cards, flags = [], [], [], []
    for i, e in enumerate(exprs):
        mvci = _mv_column(seg, e)
        ci = _dict_column(seg, e)
        if mvci is not None and mvci.is_dict_encoded:
            ids = mvci.forward[pos[i]]
            keys.append(ids)
            cards.append(max(mvci.cardinality, 1))
            dec = lambda first, ci=mvci, ids=ids: _mv_key(ci.dictionary.get_many(ids[first]))  # noqa: E731
        elif mvci is not None:
            v = _mv_key(mvci.forward[pos[i]])
            keys.append(v)
            dec = lambda first, v=v: v[first]  # noqa: E731
        elif ci is not None:
            ids = ci.forward[rows]
            keys.append(ids)
            cards.append(max(ci.cardinality, 1))
            dec = lambda first, ci=ci, ids=ids: _as_key(ci.dictionary.get_many(ids[first]))  # noqa: E731
        else:
            v = _as_key(eval_rows(seg, e, rows))
            keys.append(v)
            dec = lambda first, v=v: v[first]  # noqa: E731
        nulls = expr_null_mask(seg, e) if null_keys else None
        if nulls is not None and nulls[rows].any():
            null = nulls[rows]
            flags.append(null)
            dec = lambda first, dec=dec, null=null: _null_key(dec(first), null[first])  # noqa: E731
        decoders.append(dec)
    if len(keys) > 1 and len(cards) == len(keys) and math.prod(cards) < (1 << 62):
        keys = [sum(k.astype(np.int64) * s for k, s in zip(keys, group_strides(cards).tolist()))]
    return keys + flags, decoders, rows


def _null_key(v: np.ndarray, null: np.ndarray) -> np.ndarray:
    """A key column with its null groups' cells missing, as pandas groups a
    column holding None: numbers become float64 with NaN, text keeps None."""
    if v.dtype.kind in "iufb":
        return np.where(null, np.nan, v.astype(np.float64))
    return _null_subst(v, null)


def _as_key(v: np.ndarray) -> np.ndarray:
    return v.astype(str) if v.dtype == object else v


def _frame_column(v: np.ndarray) -> np.ndarray:
    """A value column as a group's reducer sees it: text as Python strings
    (the reference's reducers get a DataFrame column's to_numpy())."""
    return v.astype(object) if v.dtype.kind in "US" else v


def _empty_group_frame(ctx: QueryContext) -> dict[str, np.ndarray]:
    cols = {f"k{i}": np.empty(0, dtype=object) for i in range(len(ctx.group_by))}
    for i, a in enumerate(ctx.aggregations):
        for j in range(parts_of(a.func)):
            cols[f"a{i}p{j}"] = np.empty(0, dtype=object)
    return cols


def group_frame(seg: ImmutableSegment, ctx: QueryContext, mask: np.ndarray) -> dict[str, np.ndarray]:
    """The segment's group frame: keys k0.., partials a{i}p{j}, one row a
    group in order of first appearance."""
    null_on = null_handling_enabled(ctx.options)
    keys, decoders, rows = _key_columns(seg, ctx.group_by, np.flatnonzero(mask), null_keys=null_on)
    if len(rows) == 0:
        return _empty_group_frame(ctx)
    group, first = group_index(keys)
    grp = _Groups(group, len(first))
    frame: dict[str, np.ndarray] = {f"k{i}": dec(first) for i, dec in enumerate(decoders)}
    for i, a in enumerate(ctx.aggregations):
        fmask = _agg_filter(seg, a.filter, null_on)[rows] if a.filter is not None else None
        nulls = _null_doc_mask(seg, a) if null_on else None
        nulls = nulls[rows] if nulls is not None and nulls.any() else None
        for j, part in enumerate(_group_partials(seg, ctx, a, rows, fmask, nulls, grp)):
            frame[f"a{i}p{j}"] = part
    return frame


def _group_partials(seg, ctx, a, rows, fmask, nulls, grp: _Groups) -> list[np.ndarray]:
    """One aggregation's partial columns over a group frame's groups. `nulls`:
    under null handling, the rows where its argument is null (else None)."""
    filtered = fmask is not None
    null_on = null_handling_enabled(ctx.options)
    if a.func in _MV_AGGS:
        return _mv_group_partials(a, _mv_agg_column(seg, a), rows, fmask, grp)
    if a.func == "count":
        if nulls is not None and a.arg is not None:
            # COUNT(col) under null handling counts the non-null rows
            return [grp.sum(~nulls & fmask if filtered else ~nulls)]
        return [grp.sum(fmask) if filtered else grp.size]
    if a.func in funnel.FUNNEL_AGGS:
        return [_funnel_cells(seg, a, rows, fmask, grp)]
    v = _frame_column(eval_rows(seg, a.arg, rows))
    if a.func == "distinctcounttheta" and a.extra:
        fms = _theta_filter_masks(seg, a.extra)
        fms = [fm[rows] & fmask if filtered else fm[rows] for fm in fms]
        if not fms:
            return [grp.cells(lambda x: _theta_compute(x, None, ()), v)]
        return [
            grp.cells(
                lambda x, *ms: ("multi", [_theta_compute(x[m], None, ()) for m in ms]), v, *fms
            )
        ]
    na = False  # the reducers skip missing values
    if filtered:
        v = _nan_mask_values(v, ~fmask, a.func)
        na = a.func not in _FILTERED_OK
    if nulls is not None:
        v = _nan_mask_values(v, nulls, a.func)
        na = True
    keep = _dropna if na else (lambda x: x)
    if a.func == "sum":
        # under null handling a group with no non-null value sums to NaN
        return [grp.sum_or_nan(v) if null_on else np.nan_to_num(grp.sum(v).astype(np.float64))]
    if a.func in ("min", "max"):
        out = grp.extreme(v, a.func == "min")
        if filtered or nulls is not None:
            out = np.where(np.isnan(out), np.inf if a.func == "min" else -np.inf, out)
        return [out]
    if a.func == "avg":
        s = grp.sum_or_nan(v) if null_on else np.nan_to_num(grp.sum(v).astype(np.float64))
        if nulls is not None:
            # the rows both FILTER-passing and non-null: v's non-NaN cells
            return [s, grp.sum(~np.isnan(v))]
        return [s, grp.sum(fmask) if filtered else grp.size]
    if a.func == "minmaxrange":
        lo, hi = grp.extreme(v, True), grp.extreme(v, False)
        if filtered:
            lo = np.where(np.isnan(lo), np.inf, lo)
            hi = np.where(np.isnan(hi), -np.inf, hi)
        return [lo, hi]
    if a.func in ("distinctcount", "distinctcountbitmap"):
        return [grp.cells(lambda x: set(keep(x).tolist()), v)]
    if a.func == "distinctcounthll":
        return [grp.cells(lambda x: np_hll_registers(_dropna_typed(x) if na else x), v)]
    bounds = ctx.hints.get("est_bounds", {}).get(a.name)
    if a.func == "percentileest" and bounds:
        lo_b, hi_b = bounds
        return [grp.cells(lambda x: (np_est_hist(np.asarray(keep(x)), lo_b, hi_b), lo_b, hi_b), v)]
    if a.func == "percentiletdigest":
        comp = _td_comp(a.extra)
        return [grp.cells(lambda x: td_from_values(np.asarray(keep(x), dtype=np.float64), comp), v)]
    if a.func in ("percentile", "percentileest"):
        return [grp.cells(lambda x: np.asarray(keep(x), dtype=np.float64), v)]
    if a.func == "mode":
        return [grp.cells(lambda x: _mode_counter(np.asarray(keep(x))), v)]
    if a.func in EXT_AGGS:
        spec = EXT_AGGS[a.func]
        if a.arg2 is not None:
            w = _frame_column(eval_rows(seg, a.arg2, rows))

            def two(x, y):
                if na:
                    ok = ~_isna(x)
                    x, y = x[ok], y[ok]
                return spec.compute(x, y, a.extra)

            return [grp.cells(two, v, w)]
        return [grp.cells(lambda x: spec.compute(_dropna_typed(x) if na else x, None, a.extra), v)]
    raise PlanError(f"unsupported aggregation in host executor: {a.func}")


def _funnel_cells(seg, a, rows, fmask, grp: _Groups) -> np.ndarray:
    """Per-group funnel partials: each row's step bits, then the count
    variants' per-step id sets or the windowed variants' event lists."""
    bits = np.zeros(len(rows), dtype=np.int64)
    for k, s in enumerate(a.extra[-1]):
        sm = filter_mask(seg, s)[rows]
        if fmask is not None:
            sm = sm & fmask  # FILTER(WHERE): excluded docs join no step
        bits |= sm.astype(np.int64) << k
    if funnel.is_windowed(a.func):
        corr = _frame_column(eval_rows(seg, a.arg2, rows))
        ts = np.asarray(eval_rows(seg, a.arg, rows), dtype=np.float64)

        def windowed(b, c, t):
            keep = b != 0
            return funnel.events_partial(c[keep], t[keep], b[keep])

        return grp.cells(windowed, bits, corr, ts)
    corr = _frame_column(eval_rows(seg, a.arg, rows))
    n = len(a.extra[-1])
    return grp.cells(lambda b, c: [set(c[(b & (1 << k)) != 0].tolist()) for k in range(n)], bits, corr)


def distinct_frame(seg: ImmutableSegment, ctx: QueryContext, mask: np.ndarray) -> dict[str, np.ndarray]:
    """The distinct key rows of the segment, first occurrences in row order
    (pandas' drop_duplicates)."""
    keys, decoders, rows = _key_columns(seg, [it.expr for it in ctx.select_items], np.flatnonzero(mask))
    if len(rows) == 0:
        return {f"k{i}": k for i, k in enumerate(keys)}
    _, first = group_index(keys)
    return {f"k{i}": dec(first) for i, dec in enumerate(decoders)}


def _selected(seg: ImmutableSegment, ctx: QueryContext, expr, rows: np.ndarray) -> np.ndarray:
    """A selected expression's values at `rows`, null cells None under null
    handling, an MV column's cells Python lists."""
    v = eval_rows(seg, expr, rows)
    if _mv_column(seg, expr) is not None:
        cells = np.empty(len(v), dtype=object)
        for j, c in enumerate(v):
            cells[j] = c.tolist()
        return cells
    nm = _selection_nulls(seg, ctx, expr)
    return v if nm is None else _null_subst(v, nm[rows])


def selection_frame(seg: ImmutableSegment, ctx: QueryContext, mask: np.ndarray, k: int) -> dict[str, np.ndarray]:
    idx = np.flatnonzero(mask)[:k]
    return {f"c{i}": _selected(seg, ctx, it.expr, idx) for i, it in enumerate(ctx.select_items)}


def selection_ob_frame(seg: ImmutableSegment, ctx: QueryContext, mask: np.ndarray, k: int) -> dict[str, np.ndarray]:
    """The segment's top k rows by the ORDER BY keys (stable, nulls largest),
    with the sort values as __key columns."""
    from pinot_tpu_torch.common.sorting import sort_nulls_largest

    rows = np.flatnonzero(mask)
    keys = []
    for ob in ctx.order_by:
        v = eval_rows(seg, ob.expr, rows)
        nm = _selection_nulls(seg, ctx, ob.expr)
        if nm is None:
            keys.append(_as_key(v))
        elif v.dtype == object or v.dtype.kind in "US":
            keys.append(_null_subst(v, nm[rows]))  # None ranks as the largest value
        else:
            keys.append(np.where(nm[rows], np.nan, v.astype(np.float64)))
    perm = sort_nulls_largest(keys, [not ob.desc for ob in ctx.order_by])[:k]
    frame = {f"__key{j}": v[perm] for j, v in enumerate(keys)}
    for i, it in enumerate(ctx.select_items):
        frame[f"c{i}"] = _selected(seg, ctx, it.expr, rows[perm])
    return frame


def execute_segment(seg: ImmutableSegment, ctx: QueryContext, extra_mask=None) -> tuple:
    """(partial, matched docs) of one segment on the host; `extra_mask` (the
    upsert validity) is ANDed into the WHERE's mask."""
    from pinot_tpu_torch.query.context import QueryType

    mask = filter_mask_null_aware(seg, ctx.filter) if null_handling_enabled(ctx.options) else filter_mask(seg, ctx.filter)
    if extra_mask is not None:
        mask = mask & extra_mask
    matched = int(mask.sum())
    qt = ctx.query_type
    k = ctx.limit + ctx.offset
    if qt == QueryType.AGGREGATION:
        return agg_partials(seg, ctx, mask), matched
    if qt == QueryType.GROUP_BY:
        return group_frame(seg, ctx, mask), matched
    if qt == QueryType.DISTINCT:
        return distinct_frame(seg, ctx, mask), matched
    if qt == QueryType.SELECTION_ORDER_BY:
        return selection_ob_frame(seg, ctx, mask, k), matched
    return selection_frame(seg, ctx, mask, k), matched
