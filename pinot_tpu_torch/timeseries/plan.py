"""Timeseries logical planning: M3QL-style pipe language -> plan tree.

Reference parity: pinot-timeseries/pinot-timeseries-spi
(TimeSeriesLogicalPlanner SPI, LeafTimeSeriesPlanNode, BaseTimeSeriesPlanNode
tree) with the pinot-timeseries-m3ql language plugin's pipe syntax. The
language here:

    fetch table=events value=value time=ts filter="kind = 'a'" agg=sum
      | groupBy kind
      | sum
      | rate
      | movingAvg 3

Each `|` stage is a TransformNode over the leaf fetch. Series data flows as
TimeSeriesBlock: a shared time-bucket axis + per-tag-tuple value arrays
(the SPI's TimeSeriesBlock {timeBuckets, Map<tags, Double[]>} shape).

This is the JAX package's `timeseries/plan.py`, unchanged: numpy only, with
its error messages word for word.
"""

from __future__ import annotations

import re
import shlex
from dataclasses import dataclass, field

import numpy as np

_LEAF_AGGS = {"sum", "min", "max", "avg", "count"}
_SERIES_TRANSFORMS = {
    "groupby",
    "sum",
    "min",
    "max",
    "avg",
    "rate",
    "shift",
    "movingavg",
    "scale",
    "topk",
    "keeplastvalue",
}


@dataclass
class TimeSeriesBlock:
    """Bucketed series: `buckets` holds bucket START times (epoch units of the
    table's time column); `series` maps tag tuples -> float array aligned to
    buckets (NaN = empty bucket)."""

    buckets: np.ndarray
    tag_names: list[str]
    series: dict[tuple, np.ndarray] = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "timeBuckets": self.buckets.tolist(),
            "tagNames": self.tag_names,
            "series": [
                {
                    "tags": dict(zip(self.tag_names, k)),
                    "values": [None if np.isnan(v) else float(v) for v in vals],
                }
                for k, vals in sorted(self.series.items(), key=lambda kv: kv[0])
            ],
        }


@dataclass
class LeafTimeSeriesPlanNode:
    """Pushed-down fetch (LeafTimeSeriesPlanNode parity): everything the SQL
    engine evaluates per bucket — table, time/value columns, filter, agg."""

    table: str
    value_expr: str
    time_column: str = "ts"
    filter_sql: str = ""
    agg: str = "sum"
    group_by: list[str] = field(default_factory=list)


@dataclass
class TransformNode:
    kind: str
    args: list[str]
    child: object = None


def parse_timeseries(query: str):
    """Parse the pipe language into a plan tree (language-plugin parse step).
    Returns the root node (a TransformNode chain ending at the leaf)."""
    stages = [s.strip() for s in query.split("|")]
    if not stages or not stages[0].startswith("fetch"):
        raise ValueError("timeseries query must start with 'fetch'")
    leaf = _parse_fetch(stages[0])
    node: object = leaf
    for stage in stages[1:]:
        if not stage:
            continue
        parts = stage.split(None, 1)
        kind = parts[0].lower()
        raw_args = parts[1] if len(parts) > 1 else ""
        args = [a.strip() for a in re.split(r"[,\s]+", raw_args) if a.strip()]
        if kind not in _SERIES_TRANSFORMS:
            # registered pipeline-op plugins extend the language
            from pinot_tpu_torch.timeseries.language import has_series_op, registered_series_ops

            if not has_series_op(kind):
                raise ValueError(
                    f"unknown timeseries transform {kind!r} "
                    f"(core: {sorted(_SERIES_TRANSFORMS)}; ops: {registered_series_ops()})"
                )
        if kind == "groupby" and not args:
            raise ValueError("groupBy requires at least one tag")
        node = TransformNode(kind, args, node)
    return node


# m3ql-flavored pipe syntax is the first language plugin
# (pinot-timeseries-m3ql analog)
from pinot_tpu_torch.timeseries.language import register_timeseries_language  # noqa: E402

register_timeseries_language("m3ql", parse_timeseries)


def _parse_fetch(stage: str) -> LeafTimeSeriesPlanNode:
    # shlex handles filter="quoted string"
    toks = shlex.split(stage)
    if toks[0] != "fetch":
        raise ValueError("expected fetch")
    kv = {}
    for t in toks[1:]:
        if "=" not in t:
            raise ValueError(f"fetch args are key=value, got {t!r}")
        k, v = t.split("=", 1)
        kv[k.lower()] = v
    if "table" not in kv:
        raise ValueError("fetch requires table=")
    agg = kv.get("agg", "sum").lower()
    if agg not in _LEAF_AGGS:
        raise ValueError(f"fetch agg must be one of {sorted(_LEAF_AGGS)}")
    value = kv.get("value", "*")
    if value == "*" and agg != "count":
        raise ValueError("fetch without value= requires agg=count")
    return LeafTimeSeriesPlanNode(
        table=kv["table"],
        value_expr=value,
        time_column=kv.get("time", "ts"),
        filter_sql=kv.get("filter", ""),
        agg=agg,
        group_by=[g for g in kv.get("groupby", "").split(",") if g],
    )
