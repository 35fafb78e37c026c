"""Broker-side reduce: merge per-segment partials into a final ResultTable.

Reference parity: BrokerReduceService.reduceOnDataTable (pinot-core/.../query/
reduce/BrokerReduceService.java:54,61) and the per-type reducers
(GroupByDataTableReducer, AggregationDataTableReducer, SelectionDataTableReducer,
DistinctDataTableReducer) plus HavingFilterHandler / PostAggregationHandler.
This is the JAX package's `query/reduce.py` written in numpy alone: it keeps
the reference's merge order, so ties under ORDER BY come out in the
reference's row order, and the reference's row values (see `frame_rows`).
Partials from the device path and from the host executor (host_exec.py) have
one format and merge in one pass, so one query may mix both.

Partial formats:
  AGGREGATION: list aligned with ctx.aggregations; entries by func:
      count -> int, sum/min/max -> float, avg -> (sum, count),
      minmaxrange -> (min, max), distinctcount -> set of values,
      distinctcounthll -> int32 register vector (or a set of values),
      percentile -> float64 values, percentileest -> (histogram, lo, hi) or
      float64 values, percentiletdigest -> a t-digest, mode -> {value: count},
      funnels -> funnel.py's, the EXT_AGGS family -> aggregates.py's;
      an *MV aggregation -> its single-value twin's (MV_TWIN)
  GROUP_BY / DISTINCT: a "group frame", a dict of equal-length numpy arrays
      with key columns k0..k{n-1} and partial columns a{i}p{j} (agg i, part
      j); an object-valued partial (a set, registers, values, a sketch, a
      counter) is one cell of an object column
  SELECTION: a frame with positional columns c0..c{n-1}
  SELECTION_ORDER_BY: the same plus sort columns __key0..__key{m-1}
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from pinot_tpu_torch.common.sorting import sort_nulls_largest
from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query import funnel
from pinot_tpu_torch.query.aggregates import EXT_AGGS, exact_percentile
from pinot_tpu_torch.query.context import QueryContext, canonical, null_handling_enabled
from pinot_tpu_torch.query.quantile_sketch import td_create, td_merge, td_quantile
from pinot_tpu_torch.query.result import ResultTable
from pinot_tpu_torch.query.sketches import hist_estimate, hll_estimate


def frame_len(frame: dict[str, np.ndarray]) -> int:
    return len(next(iter(frame.values()))) if frame else 0


def concat_frames(frames: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """The non-empty frames' rows, in order (pd.concat's)."""
    frames = [f for f in frames if frame_len(f)]
    if not frames:
        return {}
    return {c: np.concatenate([f[c] for f in frames]) for c in frames[0]}


def frame_rows(columns: list[np.ndarray]) -> list[list]:
    """Rows of Python values, as the reference's `DataFrame.values.tolist()`
    gives them: the columns share one dtype first (numeric columns promote,
    so an INT column beside a DOUBLE one comes out as floats; any string or
    object column makes every value its own Python object)."""
    if not columns:
        return []
    if all(c.dtype.kind in "iuf" for c in columns):
        dt = np.result_type(*columns)
        return np.column_stack([c.astype(dt) for c in columns]).tolist()
    return [list(r) for r in zip(*(c.astype(object).tolist() for c in columns))]


# ---------------------------------------------------------------------------
# scalar expression evaluation over an environment (post-aggregation, having,
# order-by on merged results)
# ---------------------------------------------------------------------------


def eval_scalar(expr: ast.Expr, env: dict[str, Any], aliases: dict[str, ast.Expr] | None = None):
    if isinstance(expr, ast.Literal):
        return expr.value
    # a whole expression may itself be a group key (e.g. GROUP BY year-1990)
    if not isinstance(expr, ast.Identifier):
        cn = canonical(expr)
        if cn in env:
            return env[cn]
    if isinstance(expr, ast.Identifier):
        if expr.name in env:
            return env[expr.name]
        if aliases and expr.name in aliases:
            return eval_scalar(aliases[expr.name], env, aliases)
        raise KeyError(f"unknown reference {expr.name!r} in post-aggregation context")
    if isinstance(expr, ast.FunctionCall):
        name = canonical(expr)
        if name in env:
            return env[name]
        # COUNT(DISTINCT x) was canonicalized to distinctcount(x)
        if expr.name == "count" and expr.distinct:
            alt = canonical(ast.FunctionCall("distinctcount", expr.args))
            if alt in env:
                return env[alt]
        raise KeyError(f"aggregation {name!r} not computed")
    if isinstance(expr, ast.BinaryOp):
        l = eval_scalar(expr.left, env, aliases)
        r = eval_scalar(expr.right, env, aliases)
        if l is None or r is None:
            return None  # null propagates through post-aggregation arithmetic
        if expr.op == "+":
            return l + r
        if expr.op == "-":
            return l - r
        if expr.op == "*":
            return l * r
        if expr.op == "/":
            return float(l) / float(r) if r != 0 else float("inf") if l > 0 else float("-inf") if l < 0 else float("nan")
        if expr.op == "%":
            return math.fmod(l, r)
    raise ValueError(f"cannot evaluate {expr} at reduce stage")


def eval_having(f: ast.FilterExpr, env: dict[str, Any], aliases: dict[str, ast.Expr] | None = None) -> "bool | None":
    """Three-valued HAVING evaluation: returns None for unknown (a NULL
    aggregate compared to anything). The filtering caller treats None as
    falsy, but NOT(unknown) stays unknown (Kleene)."""
    if isinstance(f, ast.And):
        vals = [eval_having(c, env, aliases) for c in f.children]
        if any(v is False for v in vals):
            return False
        return None if any(v is None for v in vals) else True
    if isinstance(f, ast.Or):
        vals = [eval_having(c, env, aliases) for c in f.children]
        if any(v is True for v in vals):
            return True
        return None if any(v is None for v in vals) else False
    if isinstance(f, ast.Not):
        v = eval_having(f.child, env, aliases)
        return None if v is None else not v
    if isinstance(f, ast.Compare):
        l = eval_scalar(f.left, env, aliases)
        r = eval_scalar(f.right, env, aliases)
        if l is None or r is None:
            return None  # NULL comparison is unknown
        return {
            ast.CompareOp.EQ: lambda: l == r,
            ast.CompareOp.NEQ: lambda: l != r,
            ast.CompareOp.LT: lambda: l < r,
            ast.CompareOp.LTE: lambda: l <= r,
            ast.CompareOp.GT: lambda: l > r,
            ast.CompareOp.GTE: lambda: l >= r,
        }[f.op]()
    if isinstance(f, ast.Between):
        v = eval_scalar(f.expr, env, aliases)
        if v is None:
            return None  # unknown
        ok = eval_scalar(f.low, env, aliases) <= v <= eval_scalar(f.high, env, aliases)
        return not ok if f.negated else ok
    if isinstance(f, ast.In):
        v = eval_scalar(f.expr, env, aliases)
        if v is None:
            return None  # unknown
        vals = {eval_scalar(x, env, aliases) for x in f.values}
        return (v not in vals) if f.negated else (v in vals)
    if isinstance(f, ast.DistinctFrom):
        l = eval_scalar(f.left, env, aliases)
        r = eval_scalar(f.right, env, aliases)
        ln = _is_null_partial(l)
        rn = _is_null_partial(r)
        m = (ln != rn) or (not ln and not rn and l != r)
        return not m if f.negated else m
    if isinstance(f, ast.BoolAssert):
        v = eval_scalar(f.expr, env, aliases)
        # SQL assertion: never unknown — null fails IS TRUE/FALSE, passes NOT
        truthy = not _is_null_partial(v) and bool(v) and str(v).lower() not in ("false", "0")
        pos = truthy if f.want_true else (not _is_null_partial(v) and not truthy)
        return not pos if f.negated else pos
    raise ValueError(f"unsupported HAVING predicate: {f}")


# ---------------------------------------------------------------------------
# merge functions
# ---------------------------------------------------------------------------


#: aggregations whose partial is a set of values (merged by union)
DISTINCT_AGGS = ("distinctcount", "distinctcountbitmap")

#: MV aggregations give partials shaped exactly as their single-value twins'
#: (CountMVAggregationFunction et al. reuse the SV merge logic in Pinot too),
#: so the reduce merges and finalizes each as its twin
MV_TWIN = {
    "countmv": "count",
    "summv": "sum",
    "minmv": "min",
    "maxmv": "max",
    "avgmv": "avg",
    "distinctcountmv": "distinctcount",
    "minmaxrangemv": "minmaxrange",
    "distinctsummv": "distinctsum",
    "distinctavgmv": "distinctavg",
    "distinctcountbitmapmv": "distinctcountbitmap",
    "distinctcounthllmv": "distinctcounthll",
    "percentilemv": "percentile",
    "percentileestmv": "percentileest",
    "percentiletdigestmv": "percentiletdigest",
    "percentilekllmv": "percentilekll",
    "percentilerawestmv": "percentilerawest",
    "percentilerawtdigestmv": "percentilerawtdigest",
    "percentilerawkllmv": "percentilerawkll",
    "distinctcounthllplusmv": "distinctcounthllplus",
    "distinctcountrawhllmv": "distinctcountrawhll",
    "distinctcountrawhllplusmv": "distinctcountrawhllplus",
}


def twin(func: str) -> str:
    """The aggregation whose partial format, merge and finalize `func` shares:
    an MV aggregation's single-value twin, else `func` itself."""
    return MV_TWIN.get(func, func)


def _is_null_partial(x) -> bool:
    """True for None or NaN, the reference's null sentinels."""
    return x is None or (isinstance(x, float) and x != x)


def _merge_agg_partials(func: str, a, b, null_on: bool = False):
    if func in funnel.FUNNEL_AGGS:
        return funnel.merge(func, a, b)
    func = twin(func)
    if func in EXT_AGGS:
        return EXT_AGGS[func].merge(a, b)
    if func == "sum":
        # a null partial ("no non-null doc seen") is the merge's identity:
        # None always, NaN only under null handling (without it a stored NaN
        # DOUBLE keeps IEEE propagation)
        if a is None or (null_on and _is_null_partial(a)):
            return b
        if b is None or (null_on and _is_null_partial(b)):
            return a
        return a + b
    if func == "count":
        return a + b
    if func == "min":
        return min(a, b)
    if func == "max":
        return max(a, b)
    if func == "avg":
        return (a[0] + b[0], a[1] + b[1])
    if func == "minmaxrange":
        return (min(a[0], b[0]), max(a[1], b[1]))
    if func in DISTINCT_AGGS:
        return a | b
    if func == "distinctcounthll":
        # registers merge by elementwise max; exact sets by union
        if isinstance(a, (set, frozenset)):
            return a | b
        return np.maximum(a, b)
    if func == "percentileest":
        if isinstance(a, tuple) and len(a) == 3:  # (hist counts, lo, hi)
            return (a[0] + b[0], a[1], a[2])
        return np.concatenate([a, b])  # exact-values mode
    if func == "percentiletdigest":
        return td_merge(a, b)
    if func == "percentile":
        return np.concatenate([a, b])
    if func == "mode":
        out = dict(a)
        for k, v in b.items():
            out[k] = out.get(k, 0) + v
        return out
    raise AssertionError(func)


def _hll_count(p) -> int:
    """DISTINCTCOUNTHLL of a merged partial: an exact set counts its values,
    registers give the HLL estimate."""
    return len(p) if isinstance(p, (set, frozenset)) else hll_estimate(np.asarray(p))


def _finalize(a, p, null_on: bool = False):
    """Finalize a merged partial. `a` is the AggregationInfo. Under null
    handling (`null_on`) an aggregation that saw no non-null value gives NULL
    (None), not its neutral default (SumAggregationFunction with
    nullHandlingEnabled keeps a null holder)."""
    func = a.func
    if func in funnel.FUNNEL_AGGS:
        return funnel.finalize(func, p, a.extra)
    func = twin(func)
    if func in EXT_AGGS:
        return EXT_AGGS[func].finalize(p, a.extra)
    if func == "count":
        return int(p)
    if func == "sum":
        return None if null_on and _is_null_partial(p) else float(p)
    if func in ("min", "max"):
        v = float(p)
        if null_on and (_is_null_partial(v) or v == (math.inf if func == "min" else -math.inf)):
            return None
        return v
    if func == "avg":
        if not p[1]:
            return None if null_on else float("-inf")  # Pinot: avg of 0 docs -> default
        if null_on and _is_null_partial(p[0]):
            return None
        return float(p[0]) / p[1]
    if func == "minmaxrange":
        lo, hi = float(p[0]), float(p[1])
        if null_on and (_is_null_partial(lo) or _is_null_partial(hi) or (lo == math.inf and hi == -math.inf)):
            return None
        return hi - lo
    if func in DISTINCT_AGGS:
        return len(p)
    if func == "distinctcounthll":
        return _hll_count(p)
    if func == "percentileest":
        if isinstance(p, tuple):
            return hist_estimate(np.asarray(p[0]), p[1], p[2], a.extra[0])
        if null_on and len(p) == 0:
            return None
        return exact_percentile(p, a.extra[0])
    if func == "percentiletdigest":
        if null_on and p[1] == 0:
            return None  # an empty digest
        return td_quantile(p, a.extra[0])
    if func == "percentile":
        if null_on and len(p) == 0:
            return None
        return exact_percentile(p, a.extra[0])
    if func == "mode":
        if not p:
            return None if null_on else float("-inf")
        best = max(p.values())
        return float(min(k for k, v in p.items() if v == best))  # Pinot MODE ties -> MIN
    raise AssertionError(func)


def _finalize_column(a, parts, null_on: bool = False) -> list:
    """Finalize one aggregation over ALL merged groups at once: the numeric
    reducers in one numpy pass + tolist (identical values to per-row
    _finalize), every object-valued partial through _finalize."""
    func = twin(a.func)
    if func == "count":
        return np.asarray(parts, dtype=np.int64).tolist()
    if func in ("sum", "min", "max"):
        arr = np.asarray(parts, dtype=np.float64)
        out = arr.tolist()
        if null_on:
            bad = np.isnan(arr)
            if func != "sum":
                bad |= arr == (np.inf if func == "min" else -np.inf)
            for j in np.flatnonzero(bad):
                out[j] = None
        return out
    if func == "avg":
        s = np.asarray(parts[0], dtype=np.float64)
        c = np.asarray(parts[1], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (s / c).tolist()
        for j in np.flatnonzero((c == 0) | (np.isnan(s) if null_on else False)):
            out[j] = None if null_on else float("-inf")  # Pinot: avg of 0 docs -> default
        return out
    if func == "minmaxrange":
        lo = np.asarray(parts[0], dtype=np.float64)
        hi = np.asarray(parts[1], dtype=np.float64)
        out = (hi - lo).tolist()
        if null_on:
            for j in np.flatnonzero(np.isnan(lo) | np.isnan(hi) | ((lo == np.inf) & (hi == -np.inf))):
                out[j] = None
        return out
    if func in DISTINCT_AGGS:
        return [len(s) for s in parts]
    return [_finalize(a, p, null_on) for p in parts]


def _alias_map(ctx: QueryContext) -> dict[str, ast.Expr]:
    return {it.alias: it.expr for it in ctx.select_items if it.alias}


def reduce_aggregation(ctx: QueryContext, partials: list[list]) -> list[list]:
    """Merge AGGREGATION partials -> single result row per the select list."""
    null_on = null_handling_enabled(ctx.options)
    if not partials:
        # no segment contributed: under null handling a SUM saw no value
        merged = [None if null_on and twin(a.func) == "sum" else _empty_partial(a.func, a.extra) for a in ctx.aggregations]
    else:
        merged = list(partials[0])
        for p in partials[1:]:
            merged = [_merge_agg_partials(a.func, m, x, null_on) for a, m, x in zip(ctx.aggregations, merged, p)]
    env: dict[str, Any] = {a.name: _finalize(a, p, null_on) for a, p in zip(ctx.aggregations, merged)}
    aliases = _alias_map(ctx)
    return [[eval_scalar(it.expr, env, aliases) for it in ctx.select_items]]


def _empty_partial(func: str, extra: tuple = ()):
    if func in funnel.FUNNEL_AGGS:
        return funnel.empty_partial(func, extra)
    func = twin(func)
    if func in EXT_AGGS:
        return EXT_AGGS[func].empty(extra)
    if func == "percentiletdigest":
        return td_create()
    if func in ("percentile", "percentileest"):
        return np.zeros(0)
    if func == "mode":
        return {}
    return {
        "count": 0,
        "sum": 0.0,
        "min": float("inf"),
        "max": float("-inf"),
        "avg": (0.0, 0),
        "minmaxrange": (float("inf"), float("-inf")),
        "distinctcount": set(),
        "distinctcountbitmap": set(),
        "distinctcounthll": set(),
    }[func]


def _split_none(keys: list[np.ndarray]) -> list[np.ndarray]:
    """Each object key column holding None as its None flag beside it, with
    the None cells filled by another of its values (np.unique cannot order
    None): None keys form a group of their own."""
    out = []
    for k in keys:
        if k.dtype == object:
            null = np.fromiter((x is None for x in k), bool, len(k))
            if null.any():
                k = k.copy()
                k[null] = k[~null][0] if not null.all() else 0
                out.append(null)
        out.append(k)
    return out


def group_index(keys: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """(group of each row, first row of each group), with groups numbered in
    order of first appearance — pandas groupby(sort=False, dropna=False)
    order, which the reference's merge uses."""
    n = len(keys[0])
    if n == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    dense = max(1 << 20, 4 * n)
    code, card = np.zeros(n, dtype=np.int64), 1
    for k in _split_none(keys):
        k_code, k_card = _factorize(k, dense)
        if card * k_card > dense:
            # re-densify so the combined code stays below n * k_card
            _, code = np.unique(code, return_inverse=True)
            code, card = code.reshape(-1), int(code.max()) + 1
        code, card = code * k_card + k_code, card * k_card
    if card <= dense:
        return _dense_group_index(code, card)
    _, first, inv = np.unique(code, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], first[order]


def _factorize(k: np.ndarray, dense: int) -> tuple[np.ndarray, int]:
    """(int64 code of each row, number of codes): one code per distinct value
    of the key, in any order (group_index numbers the groups afterwards).
    Integers of a small range are their offset from the minimum; text takes a
    dict; anything else np.unique's inverse (NaN one value, as pandas)."""
    if k.dtype.kind in "biu":
        lo, hi = int(k.min()), int(k.max())
        if hi - lo < dense and -(1 << 62) < lo and hi < 1 << 62:
            return k.astype(np.int64) - lo, hi - lo + 1
    if k.dtype.kind in "US":
        ids: dict = {}
        return np.fromiter((ids.setdefault(x, len(ids)) for x in k.tolist()), np.int64, len(k)), max(len(ids), 1)
    uniq, inv = np.unique(k, return_inverse=True)
    return inv.reshape(-1).astype(np.int64), max(len(uniq), 1)


def _dense_group_index(code: np.ndarray, n_codes: int) -> tuple[np.ndarray, np.ndarray]:
    """group_index of one key of small non-negative integers (dictionary ids,
    their combined code): each code's first row by a scatter-min, no sort of
    the rows."""
    n = len(code)
    first = np.full(n_codes, n, dtype=np.int64)
    np.minimum.at(first, code, np.arange(n, dtype=np.int64))
    present = np.flatnonzero(first < n)
    present = present[np.argsort(first[present], kind="stable")]
    rank = np.empty(n_codes, dtype=np.int64)
    rank[present] = np.arange(len(present))
    return rank[code], first[present]


def stable_order(group: np.ndarray, n_groups: int) -> np.ndarray:
    """argsort(group, kind="stable") of group ids in [0, n_groups); below
    2^16 groups as 16-bit ids, which numpy sorts by radix."""
    return np.argsort(group.astype(np.uint16) if n_groups <= 1 << 16 else group, kind="stable")


def _merge_column(func: str, how: str, vals: np.ndarray, group: np.ndarray, n_groups: int) -> np.ndarray:
    """Per-group merge of one partial column of aggregation `func`, with
    pandas' missing-value semantics: sum skips NaN ("sum_or_nan": NaN where a
    group has only NaN, pandas' min_count=1), min/max skip NaN unless a group
    has only NaN; union merges a column of sets; fold merges any other object
    partial with _merge_agg_partials, in row order (the reference's reduce
    over each group's series)."""
    if how == "union":
        out = np.empty(n_groups, dtype=object)
        for g in range(n_groups):
            out[g] = set()
        for g, s in zip(group.tolist(), vals):
            out[g] |= s
        return out
    if how == "fold":
        out = np.full(n_groups, None, dtype=object)
        for g, r in zip(group.tolist(), vals):
            out[g] = r if out[g] is None else _merge_agg_partials(func, out[g], r)
        return out
    if how in ("sum", "sum_or_nan"):
        if vals.dtype.kind == "f":
            out = np.zeros(n_groups, dtype=np.float64)
            np.add.at(out, group, np.where(np.isnan(vals), 0.0, vals))
            if how == "sum_or_nan":
                out[np.bincount(group, weights=~np.isnan(vals), minlength=n_groups) == 0] = np.nan
        else:
            out = np.zeros(n_groups, dtype=np.int64)
            np.add.at(out, group, vals.astype(np.int64))
        return out
    out = np.full(n_groups, np.nan)
    (np.fmin if how == "min" else np.fmax).at(out, group, vals.astype(np.float64))
    return out


#: per-part merge of each aggregation's partial columns; every aggregation
#: not listed has one object partial, merged by "fold"
_PART_MERGE = {
    "count": ("sum",),
    "sum": ("sum",),
    "avg": ("sum", "sum"),
    "min": ("min",),
    "max": ("max",),
    "minmaxrange": ("min", "max"),
    "distinctcount": ("union",),
    "distinctcountbitmap": ("union",),
}


def parts_of(func: str) -> int:
    """Partial columns of an aggregation in a group frame."""
    return len(_PART_MERGE.get(twin(func), ("fold",)))


def reduce_group_by(ctx: QueryContext, frames: list[dict[str, np.ndarray]]) -> list[list]:
    nkeys = len(ctx.group_by)
    cols = concat_frames(frames)
    if not cols:
        return []
    null_on = null_handling_enabled(ctx.options)
    group, first = group_index([cols[f"k{i}"] for i in range(nkeys)])
    n_rows = len(first)
    key_vals = [cols[f"k{i}"][first].tolist() for i in range(nkeys)]
    if null_on:
        # a NaN key is the null group too
        key_vals = [[None if _is_null_partial(k) else k for k in col] for col in key_vals]
    fin_cols = []
    for i, a in enumerate(ctx.aggregations):
        func = twin(a.func)
        hows = _PART_MERGE.get(func, ("fold",))
        if null_on and func in ("sum", "avg"):
            # a group whose partials are all NaN (no non-null value) stays
            # NaN, and finalizes to NULL
            hows = ("sum_or_nan",) + hows[1:]
        parts = [_merge_column(func, how, cols[f"a{i}p{j}"], group, n_rows).tolist() for j, how in enumerate(hows)]
        fin_cols.append(_finalize_column(a, parts[0] if len(parts) == 1 else tuple(parts), null_on))

    aliases = _alias_map(ctx)
    group_names = [canonical(g) for g in ctx.group_by]
    rows = []
    for ri in range(n_rows):
        env: dict[str, Any] = {name: key_vals[i][ri] for i, name in enumerate(group_names)}
        for i, a in enumerate(ctx.aggregations):
            env[a.name] = fin_cols[i][ri]
        rows.append(env)

    if ctx.having is not None:
        rows = [e for e in rows if eval_having(ctx.having, e, aliases)]

    if ctx.order_by:
        rows = _order_rows(rows, ctx.order_by, aliases)

    rows = rows[ctx.offset : ctx.offset + ctx.limit]
    return [[eval_scalar(it.expr, env, aliases) for it in ctx.select_items] for env in rows]


def _ob_column(ob, rows: list[dict], aliases) -> list:
    """Evaluate one ORDER BY expression over every row env. The canonical
    env key is row-independent, so it is resolved ONCE and the per-row work
    collapses to a dict lookup; only expressions not materialized in the env
    (post-agg arithmetic, alias chains) pay full eval_scalar per row."""
    expr = ob.expr
    if rows:
        if isinstance(expr, ast.Identifier):
            if expr.name in rows[0]:
                return [e[expr.name] for e in rows]
        elif not isinstance(expr, ast.Literal):
            cn = canonical(expr)
            if cn in rows[0]:
                return [e[cn] for e in rows]
    return [eval_scalar(expr, e, aliases) for e in rows]


def _order_rows(rows: list[dict], order_by, aliases) -> list[dict]:
    """ORDER BY over merged group rows. Numeric keys, and text keys as their
    ranks, ride one stable np.lexsort (nulls-as-largest, DESC via negation —
    same ordering as _OrderKey); any other or precision-risky key (mixed
    types, |int|>2^53) falls back to the general Python sort over the SAME
    pre-evaluated columns, so eval_scalar never runs per-comparison either
    way."""
    cols = [_ob_column(ob, rows, aliases) for ob in order_by]
    descs = [ob.desc for ob in order_by]
    n = len(rows)
    lex: list[np.ndarray] = []
    numeric = True
    for vals, desc in zip(cols, descs):
        ranked = _text_ranks(vals, desc)
        if ranked is not None:
            lex.extend(ranked)
            continue
        arr = np.empty(n, np.float64)
        mask = np.empty(n, np.float64)
        for i, v in enumerate(vals):
            if v is None or (isinstance(v, float) and math.isnan(v)):
                # nulls rank as the largest value: first under DESC, last ASC
                mask[i] = 0.0 if desc else 1.0
                arr[i] = 0.0
            elif isinstance(v, bool) or not isinstance(v, (int, float, np.integer, np.floating)):
                numeric = False
                break
            elif isinstance(v, (int, np.integer)) and abs(int(v)) > (1 << 53):
                numeric = False  # float64 would collapse distinct keys
                break
            else:
                mask[i] = 1.0 if desc else 0.0
                arr[i] = -float(v) if desc else float(v)
        if not numeric:
            break
        lex.append(mask)
        lex.append(arr)
    if numeric:
        if not lex:
            return rows
        # np.lexsort: LAST key is primary -> reversed, ob_1's null-group mask
        # dominates, then its values, then ob_2's mask/values, ...
        order = np.lexsort(lex[::-1])
        return [rows[i] for i in order]
    idx = sorted(
        range(n),
        key=lambda i: tuple(_OrderKey(c[i], d) for c, d in zip(cols, descs)),
    )
    return [rows[i] for i in idx]


def _text_ranks(vals: list, desc: bool) -> list[np.ndarray] | None:
    """(null mask, rank) lexsort keys of a column of str values and nulls,
    ranked in code-point order (Python's str order), or None for any other
    column (and for text numpy cannot hold as it is: a trailing NUL)."""
    null = [v is None or (isinstance(v, float) and v != v) for v in vals]
    text = [v for v, nl in zip(vals, null) if not nl]
    if not text or not all(type(v) is str and not v.endswith("\x00") for v in text):
        return None
    null = np.asarray(null, dtype=bool)
    rank = np.zeros(len(vals), dtype=np.float64)
    rank[~null] = np.unique(np.asarray(text), return_inverse=True)[1].reshape(-1)
    mask = np.where(null, 0.0 if desc else 1.0, 1.0 if desc else 0.0)
    return [mask, -rank if desc else rank]


class _OrderKey:
    """Comparable wrapper implementing DESC via reversed comparison."""

    __slots__ = ("v", "desc")

    def __init__(self, v, desc):
        self.v = v
        self.desc = desc

    def __lt__(self, other):
        a, b = (other.v, self.v) if self.desc else (self.v, other.v)
        # nulls rank as the largest value (OrderByExpressionContext default)
        if _is_null_partial(a):
            return False
        if _is_null_partial(b):
            return True
        return a < b

    def __eq__(self, other):
        if _is_null_partial(self.v) or _is_null_partial(other.v):
            return _is_null_partial(self.v) and _is_null_partial(other.v)
        return self.v == other.v


def reduce_distinct(ctx: QueryContext, frames: list[dict[str, np.ndarray]]) -> list[list]:
    """Distinct key rows: the first occurrence of each across the frames
    (drop_duplicates' order), then the ORDER BY, OFFSET and LIMIT."""
    cols = concat_frames(frames)
    if not cols:
        return []
    keys = [cols[f"k{i}"] for i in range(len(ctx.select_items))]
    _, first = group_index(keys)
    keys = [k[first] for k in keys]
    if ctx.order_by:
        aliases = _alias_map(ctx)
        name_of = {canonical(it.expr): i for i, it in enumerate(ctx.select_items)}
        by, asc = [], []
        for ob in ctx.order_by:
            cn = canonical(ob.expr)
            if cn not in name_of and aliases and cn in aliases:
                cn = canonical(aliases[cn])
            if cn not in name_of:
                raise ValueError(f"DISTINCT ORDER BY must reference selected columns: {cn}")
            by.append(keys[name_of[cn]])
            asc.append(not ob.desc)
        perm = sort_nulls_largest(by, asc)
        keys = [k[perm] for k in keys]
    return frame_rows([k[ctx.offset : ctx.offset + ctx.limit] for k in keys])


def reduce_selection(ctx: QueryContext, frames: list[dict[str, np.ndarray]]) -> list[list]:
    """The frames' rows in segment order, then OFFSET and LIMIT."""
    cols = concat_frames(frames)
    return frame_rows([v[ctx.offset : ctx.offset + ctx.limit] for v in cols.values()])


def reduce_selection_order_by(ctx: QueryContext, frames: list[dict[str, np.ndarray]]) -> list[list]:
    """Every segment's top rows sorted by the __key columns (stable: ties keep
    segment order, then each segment's order), then OFFSET and LIMIT."""
    cols = concat_frames(frames)
    if not cols:
        return []
    key_cols = [c for c in cols if c.startswith("__key")]
    asc = [not ob.desc for ob in ctx.order_by[: len(key_cols)]]
    perm = sort_nulls_largest([cols[c] for c in key_cols], asc)[ctx.offset : ctx.offset + ctx.limit]
    return frame_rows([v[perm] for c, v in cols.items() if c not in key_cols])


def apply_gapfill(ctx: QueryContext, rows: list[list]) -> list[list]:
    """Broker-side gap filling (reference: GapfillProcessor,
    pinot-core/.../query/reduce/GapfillProcessor.java). Emits exactly one pass
    over the [start, end) bucket range in step increments: rows whose time
    value lands on a bucket are kept (rows outside the range are dropped);
    missing buckets are synthesized with per-column FILL modes —
    FILL_PREVIOUS_VALUE carries the last emitted value forward,
    FILL_DEFAULT_VALUE emits 0, otherwise None."""
    gf = ctx.gapfill
    assert gf is not None
    n = len(ctx.select_items)
    integral = all(float(v).is_integer() for v in (gf.start, gf.step))
    nbuckets = max(0, int(math.ceil((gf.end - gf.start) / gf.step)))
    # bucket-index matching (not exact float equality) so fractional steps
    # don't miss rows to rounding
    by_bucket: dict[int, list[list]] = {}
    for r in rows:
        try:
            idx = (float(r[gf.col_index]) - gf.start) / gf.step
        except (TypeError, ValueError):
            continue
        b = int(round(idx))
        if 0 <= b < nbuckets and abs(idx - b) < 1e-9:
            by_bucket.setdefault(b, []).append(r)
    out: list[list] = []
    prev: list | None = None
    for b in range(nbuckets):
        t = gf.start + b * gf.step
        hit = by_bucket.get(b)
        if hit:
            out.extend(hit)
            prev = hit[-1]
            continue
        row: list = [None] * n
        row[gf.col_index] = int(t) if integral else t
        for j in range(n):
            if j == gf.col_index:
                continue
            mode = gf.fills.get(j)
            if mode == "FILL_PREVIOUS_VALUE" and prev is not None:
                row[j] = prev[j]
            elif mode == "FILL_DEFAULT_VALUE":
                row[j] = 0
        out.append(row)
    return out


def build_result(ctx: QueryContext, rows: list[list], **stats) -> ResultTable:
    if ctx.gapfill is not None:
        rows = apply_gapfill(ctx, rows)
    cols = [ctx.output_name(it) for it in ctx.select_items]
    return ResultTable(columns=cols, rows=rows, **stats)
