"""Query-side star-tree swap: rewrite matching queries onto pre-agg tables.

Reference parity: StarTreeUtils.extractAggregationFunctionPairs + the
executor swap in AggregationPlanNode/GroupByPlanNode (pinot-core/.../startree/
executor/StarTreeAggregationExecutor.java:36, StarTreeGroupByExecutor.java:45).
This is the JAX package's `query/startree_exec.py`. A query matches when its
filter and group keys touch only split dimensions and every aggregation
derives from the stored pairs; it then executes as an ordinary query over the
star table segment (shared dictionaries keep all dict-id predicate lowering
intact), and the partials map back into the original aggregation layout, so
the reduce never knows.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np

from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.context import AggregationInfo, QueryContext, QueryType, _collect_filter_identifiers
from pinot_tpu_torch.segment.startree import StarTable, star_table_as_segment

_NOT_A_COLUMN = "\x00not-a-column"  # never matches a column


def _agg_arg_col(a: AggregationInfo) -> str | None:
    if a.arg is None:
        return None
    if isinstance(a.arg, ast.Identifier):
        return a.arg.name
    return _NOT_A_COLUMN


def _null_dependent(f) -> bool:
    """Predicates whose truth depends on the null vector (IS NULL / IS
    DISTINCT FROM / IS TRUE): the star table bakes nulls into placeholder
    values, so these must run the per-doc path."""
    if f is None:
        return False
    if isinstance(f, (ast.IsNull, ast.DistinctFrom, ast.BoolAssert)):
        return True
    if isinstance(f, (ast.And, ast.Or)):
        return any(_null_dependent(c) for c in f.children)
    if isinstance(f, ast.Not):
        return _null_dependent(f.child)
    return False


def matches(ctx: QueryContext, st: StarTable) -> bool:
    if ctx.query_type not in (QueryType.AGGREGATION, QueryType.GROUP_BY):
        return False
    if not ctx.aggregations:
        return False
    if _null_dependent(ctx.filter):
        return False
    dims = set(st.dimensions)
    fcols: set[str] = set()
    _collect_filter_identifiers(ctx.filter, fcols)
    if not fcols.issubset(dims):
        return False
    for g in ctx.group_by:
        if not isinstance(g, ast.Identifier) or g.name not in dims:
            return False
    for a in ctx.aggregations:
        if a.filter is not None:
            # FILTER(WHERE ...) cannot be applied to pre-aggregated rows
            return False
        col = _agg_arg_col(a)
        if col == _NOT_A_COLUMN or not st.supports_agg(a.func, col):
            return False
    return True


def _rewrite(ctx: QueryContext) -> tuple[QueryContext, list[tuple]]:
    """The star-side context, and for each original aggregation how to
    rebuild its partial from the star partials: (kind, star indices...)."""
    star_aggs: list[AggregationInfo] = []
    mapping: list[tuple] = []

    def add(func: str, col: str) -> int:
        star_aggs.append(AggregationInfo(func, ast.Identifier(col), f"{func}({col})#star{len(star_aggs)}"))
        return len(star_aggs) - 1

    for a in ctx.aggregations:
        col = _agg_arg_col(a)
        if a.func == "count":
            mapping.append(("count", add("sum", "__count")))
        elif a.func in ("sum", "min", "max"):
            mapping.append(("copy", add(a.func, f"{a.func.upper()}__{col}")))
        elif a.func == "avg":
            mapping.append(("avg", add("sum", f"SUM__{col}"), add("sum", "__count")))
        elif a.func == "minmaxrange":
            mapping.append(("pair", add("min", f"MIN__{col}"), add("max", f"MAX__{col}")))
        elif a.func in ("distinctcount", "distinctcountbitmap", "distinctcounthll"):
            mapping.append(("copy", add(a.func, col)))
        else:
            raise AssertionError(a.func)
    return replace(ctx, aggregations=star_aggs, hints=dict(ctx.hints)), mapping


def _convert_scalar(mapping, star_partial) -> list:
    out = []
    for m in mapping:
        kind = m[0]
        if kind == "count":
            out.append(int(star_partial[m[1]]))
        elif kind == "copy":
            out.append(star_partial[m[1]])
        elif kind == "avg":
            out.append((float(star_partial[m[1]]), int(star_partial[m[2]])))
        elif kind == "pair":
            out.append((float(star_partial[m[1]]), float(star_partial[m[2]])))
    return out


def _convert_frame(ctx: QueryContext, mapping, frame: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """The star group frame in the original aggregations' columns."""
    data = {f"k{i}": frame[f"k{i}"] for i in range(len(ctx.group_by))}
    for i, m in enumerate(mapping):
        kind = m[0]
        if kind == "count":
            data[f"a{i}p0"] = frame[f"a{m[1]}p0"].astype(np.int64)
        elif kind == "copy":
            data[f"a{i}p0"] = frame[f"a{m[1]}p0"]
        elif kind == "avg":
            data[f"a{i}p0"] = frame[f"a{m[1]}p0"].astype(np.float64)
            data[f"a{i}p1"] = frame[f"a{m[2]}p0"].astype(np.int64)
        elif kind == "pair":
            data[f"a{i}p0"] = frame[f"a{m[1]}p0"].astype(np.float64)
            data[f"a{i}p1"] = frame[f"a{m[2]}p0"].astype(np.float64)
    return data


def try_execute(engine, seg, ctx: QueryContext):
    """Star-tree execution of one segment: (partial, matched star rows) in
    the original context's format, or None when no star table matches. The
    star segment is built once and kept in `seg.extras`; the engine stages
    it like any segment."""
    for idx, st in enumerate(seg.extras.get("startree") or []):
        if not matches(ctx, st):
            continue
        cache_key = f"startree_seg:{idx}"
        star_seg = seg.extras.get(cache_key)
        if star_seg is None:
            star_seg = seg.extras[cache_key] = star_table_as_segment(seg, st)
        star_ctx, mapping = _rewrite(ctx)
        partial, matched = engine._execute_segment(star_seg, star_ctx)
        if ctx.query_type == QueryType.AGGREGATION:
            return _convert_scalar(mapping, partial), matched
        return _convert_frame(ctx, mapping, partial), matched
    return None
