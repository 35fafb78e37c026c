"""Timeseries runtime: execute a plan tree against the SQL engine.

Reference parity: the physical side of pinot-timeseries —
PhysicalTimeSeriesServerPlanVisitor (pinot-query-runtime/.../runtime/
timeseries/) compiles the leaf node into the single-stage engine (filter +
time-bucket group-by), and the transform stages run over TimeSeriesBlocks.
The leaf SQL shape is

    SELECT <tags...>, FLOOR((time - start) / step) AS bucket, AGG(value)
    FROM table WHERE time >= start AND time < end [AND filter]
    GROUP BY <tags...>, bucket

This is the JAX package's `timeseries/engine.py`: the same leaf SQL (LIMIT
1000000 included), the same literals and the same numpy transforms. Its
bucket key is an expression, and the planner sends an expression GROUP BY
key to the host executor (`DeviceFallback` in `query/plan.py`), as the
reference's does, so the leaf runs on the host: no kernel launches for it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pinot_tpu_torch.timeseries.plan import (
    LeafTimeSeriesPlanNode,
    TimeSeriesBlock,
    TransformNode,
)


@dataclass
class RangeTimeSeriesRequest:
    """RangeTimeSeriesRequest parity: query + [start, end) + step, all in the
    time column's native unit. `language` selects the registered planner
    (the reference's language query-param; m3ql is the built-in plugin)."""

    query: str
    start: float
    end: float
    step: float
    language: str = "m3ql"

    @property
    def num_buckets(self) -> int:
        return max(1, int(np.ceil((self.end - self.start) / self.step)))


class TimeSeriesEngine:
    """Executes timeseries requests over any SQL executor exposing
    `execute(sql) -> ResultTable` (QueryEngine or Broker)."""

    def __init__(self, sql_executor):
        self._sql = sql_executor

    def execute(self, request: RangeTimeSeriesRequest) -> TimeSeriesBlock:
        from pinot_tpu_torch.timeseries.language import get_timeseries_planner

        root = get_timeseries_planner(request.language)(request.query)
        return self._run(root, request)

    def execute_dict(self, request: RangeTimeSeriesRequest) -> dict:
        """JSON surface (the /timeseries/api/v1/query_range analog)."""
        return self.execute(request).to_dict()

    # ------------------------------------------------------------------

    def _run(self, node, request: RangeTimeSeriesRequest) -> TimeSeriesBlock:
        if isinstance(node, LeafTimeSeriesPlanNode):
            return self._run_leaf(node, request)
        assert isinstance(node, TransformNode)
        child = self._run(node.child, request)
        return _apply_transform(node, child, request)

    def _run_leaf(self, leaf: LeafTimeSeriesPlanNode, request: RangeTimeSeriesRequest) -> TimeSeriesBlock:
        n = request.num_buckets
        tags = list(leaf.group_by)
        sel_tags = (", ".join(tags) + ", ") if tags else ""
        bucket_expr = f"FLOOR(({leaf.time_column} - {_lit(request.start)}) / {_lit(request.step)})"
        agg_expr = "COUNT(*)" if leaf.agg == "count" else f"{leaf.agg.upper()}({leaf.value_expr})"
        where = f"{leaf.time_column} >= {_lit(request.start)} AND {leaf.time_column} < {_lit(request.end)}"
        if leaf.filter_sql:
            where += f" AND ({leaf.filter_sql})"
        group = ", ".join(tags + [bucket_expr])
        sql = (
            f"SELECT {sel_tags}{bucket_expr} AS bucket, {agg_expr} FROM {leaf.table} "
            f"WHERE {where} GROUP BY {group} LIMIT 1000000"
        )
        res = self._sql.execute(sql)
        buckets = request.start + request.step * np.arange(n, dtype=np.float64)
        block = TimeSeriesBlock(buckets=buckets, tag_names=tags)
        for row in res.rows:
            key = tuple(row[: len(tags)])
            b = int(row[len(tags)])
            if not 0 <= b < n:
                continue
            arr = block.series.get(key)
            if arr is None:
                arr = np.full(n, np.nan)
                block.series[key] = arr
            arr[b] = row[len(tags) + 1]
        return block


def _lit(v: float) -> str:
    return repr(int(v)) if float(v).is_integer() else repr(float(v))


# -- series transforms -------------------------------------------------------


def _apply_transform(node: TransformNode, block: TimeSeriesBlock, request) -> TimeSeriesBlock:
    kind = node.kind
    if kind == "groupby":
        return _regroup(block, node.args)
    if kind in ("sum", "min", "max", "avg"):
        return _cross_series(block, kind)
    if kind == "rate":
        return _map_series(block, lambda v: np.concatenate(([np.nan], np.diff(v) / request.step)))
    if kind == "shift":
        k = int(node.args[0]) if node.args else 1
        return _map_series(block, lambda v: _shift(v, k))
    if kind == "movingavg":
        k = max(1, int(node.args[0]) if node.args else 1)
        return _map_series(block, lambda v: _moving_avg(v, k))
    if kind == "scale":
        # "__step__" resolves to the request's bucket width (promql delta)
        f = float(request.step) if node.args[0] == "__step__" else float(node.args[0])
        return _map_series(block, lambda v: v * f)
    if kind == "topk":
        from pinot_tpu_torch.timeseries.language import ranked_k

        return ranked_k(block, int(node.args[0]) if node.args else 1, largest=True)
    if kind == "keeplastvalue":
        return _map_series(block, _ffill)
    # pluggable pipeline ops (timeseries/language.py registry)
    from pinot_tpu_torch.timeseries.language import get_series_op, has_series_op

    if has_series_op(kind):
        return get_series_op(kind)(block, node.args, request)
    raise AssertionError(kind)


def _map_series(block: TimeSeriesBlock, fn) -> TimeSeriesBlock:
    return TimeSeriesBlock(
        block.buckets, block.tag_names, {k: fn(v) for k, v in block.series.items()}
    )


def _regroup(block: TimeSeriesBlock, keep_tags: list[str]) -> TimeSeriesBlock:
    """Re-aggregate (sum) series down to a subset of tags
    (m3ql groupBy/aggregate-tags)."""
    idx = []
    for t in keep_tags:
        if t not in block.tag_names:
            raise ValueError(f"groupBy tag {t!r} not in series tags {block.tag_names}")
        idx.append(block.tag_names.index(t))
    out = TimeSeriesBlock(block.buckets, list(keep_tags))
    for key, vals in block.series.items():
        nk = tuple(key[i] for i in idx)
        cur = out.series.get(nk)
        out.series[nk] = vals.copy() if cur is None else _nansum_pair(cur, vals)
    return out


def _cross_series(block: TimeSeriesBlock, agg: str) -> TimeSeriesBlock:
    """Collapse all series into one (pipe sum/min/max/avg with no args)."""
    out = TimeSeriesBlock(block.buckets, [])
    if not block.series:
        return out
    stack = np.vstack(list(block.series.values()))
    with np.errstate(all="ignore"):
        if agg == "sum":
            v = np.nansum(stack, axis=0)
            v[np.isnan(stack).all(axis=0)] = np.nan
        elif agg == "min":
            v = np.nanmin(stack, axis=0) if len(stack) else stack
        elif agg == "max":
            v = np.nanmax(stack, axis=0)
        else:
            v = np.nanmean(stack, axis=0)
    out.series[()] = v
    return out


def _nansum_pair(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    out = np.where(np.isnan(a), b, np.where(np.isnan(b), a, a + b))
    return out


def _shift(v: np.ndarray, k: int) -> np.ndarray:
    out = np.full_like(v, np.nan)
    if k >= 0:
        out[k:] = v[: len(v) - k] if k else v
    else:
        out[:k] = v[-k:]
    return out


def _moving_avg(v: np.ndarray, k: int) -> np.ndarray:
    out = np.full_like(v, np.nan)
    for i in range(len(v)):
        w = v[max(0, i - k + 1) : i + 1]
        if not np.isnan(w).all():
            out[i] = np.nanmean(w)
    return out


def _ffill(v: np.ndarray) -> np.ndarray:
    out = v.copy()
    last = np.nan
    for i in range(len(out)):
        if np.isnan(out[i]):
            out[i] = last
        else:
            last = out[i]
    return out
