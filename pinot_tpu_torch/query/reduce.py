"""Broker-side reduce: merge per-segment partials into a final ResultTable.

Reference parity: BrokerReduceService.reduceOnDataTable (pinot-core/.../query/
reduce/BrokerReduceService.java:54,61) and the per-type reducers
(GroupByDataTableReducer, AggregationDataTableReducer) plus HavingFilterHandler
/ PostAggregationHandler. This is the JAX package's `query/reduce.py` for the
aggregations this package lowers (COUNT, SUM, MIN, MAX, AVG, MINMAXRANGE,
DISTINCTCOUNT), written in numpy alone: it keeps the reference's merge order,
so ties under ORDER BY come out in the reference's row order.

Partial formats:
  AGGREGATION: list aligned with ctx.aggregations; entries by func:
      count -> int, sum/min/max -> float, avg -> (sum, count),
      minmaxrange -> (min, max), distinctcount -> set of values
  GROUP_BY: a "group frame", a dict of equal-length numpy arrays with key
      columns k0..k{n-1} and partial columns a{i}p{j} (agg i, part j);
      DISTINCTCOUNT's column holds a set per group (dtype object)
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.context import QueryContext, canonical
from pinot_tpu_torch.query.result import ResultTable


def frame_len(frame: dict[str, np.ndarray]) -> int:
    return len(next(iter(frame.values()))) if frame else 0


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


def _is_null_partial(x) -> bool:
    """True for None or NaN, the reference's null sentinels."""
    return x is None or (isinstance(x, float) and x != x)


def _merge_agg_partials(func: str, a, b):
    if func in ("sum", "count"):
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
    raise AssertionError(func)


def _finalize(a, p):
    """Finalize a merged partial. `a` is the AggregationInfo."""
    func = a.func
    if func == "count":
        return int(p)
    if func in ("sum", "min", "max"):
        return float(p)
    if func == "avg":
        if not p[1]:
            return float("-inf")  # Pinot: avg of 0 docs -> default
        return float(p[0]) / p[1]
    if func == "minmaxrange":
        return float(p[1]) - float(p[0])
    if func in DISTINCT_AGGS:
        return len(p)
    raise AssertionError(func)


def _finalize_column(a, parts) -> list:
    """Finalize one aggregation over ALL merged groups at once (one numpy
    pass + tolist, identical values to per-row _finalize)."""
    func = a.func
    if func == "count":
        return np.asarray(parts, dtype=np.int64).tolist()
    if func in ("sum", "min", "max"):
        return np.asarray(parts, dtype=np.float64).tolist()
    if func == "avg":
        s = np.asarray(parts[0], dtype=np.float64)
        c = np.asarray(parts[1], dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = (s / c).tolist()
        for j in np.flatnonzero(c == 0):
            out[j] = float("-inf")  # Pinot: avg of 0 docs -> default
        return out
    if func == "minmaxrange":
        lo = np.asarray(parts[0], dtype=np.float64)
        hi = np.asarray(parts[1], dtype=np.float64)
        return (hi - lo).tolist()
    if func in DISTINCT_AGGS:
        return [len(s) for s in parts]
    raise AssertionError(func)


def _alias_map(ctx: QueryContext) -> dict[str, ast.Expr]:
    return {it.alias: it.expr for it in ctx.select_items if it.alias}


def reduce_aggregation(ctx: QueryContext, partials: list[list]) -> list[list]:
    """Merge AGGREGATION partials -> single result row per the select list."""
    if not partials:
        merged = [_empty_partial(a.func) for a in ctx.aggregations]
    else:
        merged = list(partials[0])
        for p in partials[1:]:
            merged = [_merge_agg_partials(a.func, m, x) for a, m, x in zip(ctx.aggregations, merged, p)]
    env: dict[str, Any] = {a.name: _finalize(a, p) for a, p in zip(ctx.aggregations, merged)}
    aliases = _alias_map(ctx)
    return [[eval_scalar(it.expr, env, aliases) for it in ctx.select_items]]


def _empty_partial(func: str):
    return {
        "count": 0,
        "sum": 0.0,
        "min": float("inf"),
        "max": float("-inf"),
        "avg": (0.0, 0),
        "minmaxrange": (float("inf"), float("-inf")),
        "distinctcount": set(),
        "distinctcountbitmap": set(),
    }[func]


def group_index(keys: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """(group of each row, first row of each group), with groups numbered in
    order of first appearance — pandas groupby(sort=False, dropna=False)
    order, which the reference's merge uses."""
    n = len(keys[0])
    code = np.zeros(n, dtype=np.int64)
    for k in keys:
        uniq, inv = np.unique(k, return_inverse=True)
        # re-densify after every key so the combined code stays below n*card
        _, code = np.unique(code * len(uniq) + inv.reshape(-1), return_inverse=True)
    _, first, inv = np.unique(code, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return rank[inv.reshape(-1)], first[order]


def _merge_column(func: str, vals: np.ndarray, group: np.ndarray, n_groups: int) -> np.ndarray:
    """Per-group merge of one partial column, with pandas' missing-value
    semantics: sum skips NaN, min/max skip NaN unless a group has only NaN;
    union merges a column of sets."""
    if func == "union":
        out = np.empty(n_groups, dtype=object)
        for g in range(n_groups):
            out[g] = set()
        for g, s in zip(group.tolist(), vals):
            out[g] |= s
        return out
    if func == "sum":
        if vals.dtype.kind == "f":
            out = np.zeros(n_groups, dtype=np.float64)
            np.add.at(out, group, np.where(np.isnan(vals), 0.0, vals))
        else:
            out = np.zeros(n_groups, dtype=np.int64)
            np.add.at(out, group, vals.astype(np.int64))
        return out
    out = np.full(n_groups, np.nan)
    (np.fmin if func == "min" else np.fmax).at(out, group, vals.astype(np.float64))
    return out


#: per-part merge of each aggregation's partial columns
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


def reduce_group_by(ctx: QueryContext, frames: list[dict[str, np.ndarray]]) -> list[list]:
    nkeys = len(ctx.group_by)
    frames = [f for f in frames if frame_len(f)]
    if not frames:
        return []
    cols = {c: np.concatenate([f[c] for f in frames]) for c in frames[0]}
    group, first = group_index([cols[f"k{i}"] for i in range(nkeys)])
    n_rows = len(first)
    key_vals = [cols[f"k{i}"][first].tolist() for i in range(nkeys)]
    fin_cols = []
    for i, a in enumerate(ctx.aggregations):
        parts = [
            _merge_column(how, cols[f"a{i}p{j}"], group, n_rows).tolist()
            for j, how in enumerate(_PART_MERGE[a.func])
        ]
        fin_cols.append(_finalize_column(a, parts[0] if len(parts) == 1 else tuple(parts)))

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
    """ORDER BY over merged group rows. Numeric keys ride one stable
    np.lexsort (nulls-as-largest, DESC via negation — same ordering as
    _OrderKey); any non-numeric or precision-risky key (strings, |int|>2^53)
    falls back to the general Python sort over the SAME pre-evaluated
    columns, so eval_scalar never runs per-comparison either way."""
    cols = [_ob_column(ob, rows, aliases) for ob in order_by]
    descs = [ob.desc for ob in order_by]
    n = len(rows)
    lex: list[np.ndarray] = []
    numeric = True
    for vals, desc in zip(cols, descs):
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


def build_result(ctx: QueryContext, rows: list[list], **stats) -> ResultTable:
    if ctx.gapfill is not None:
        raise NotImplementedError("GAPFILL is not ported to pinot_tpu_torch yet")
    cols = [ctx.output_name(it) for it in ctx.select_items]
    return ResultTable(columns=cols, rows=rows, **stats)
