"""Server-side segment pruning before any program is planned or staged.

Reference parity: SegmentPrunerService (pinot-core/.../query/pruner/):
ColumnValueSegmentPruner (min/max interval tests) + BloomFilterSegmentPruner
(EQ/IN probes against per-segment bloom filters). The JAX package's
`query/pruner.py`: it runs on the host per segment; a pruned segment
contributes a canonical empty partial (the port's numpy frames) so the
reduce and the segment accounting see every segment.

The min/max test (`segment_can_match`, `_interval`, `_cmp_overlap`) is the
port's own copy of the JAX package's `cluster/routing.py` helpers. Bloom and
geo rejects read `seg.extras["bloom"]` / `seg.extras["geo"]`: the bloom
filters and geo indexes of a built or a loaded segment (segment/indexes.py,
h3.py).
"""

from __future__ import annotations

import numpy as np

from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.ast import CompareOp
from pinot_tpu_torch.query.context import QueryContext, QueryType, null_handling_enabled
from pinot_tpu_torch.query.reduce import MV_TWIN, _empty_partial, parts_of
from pinot_tpu_torch.segment.segment import ImmutableSegment


def _interval(stats: dict, col: str):
    s = stats.get(col)
    if s is None:
        return None
    mn, mx = s.get("min"), s.get("max")
    if mn is None or mx is None:
        return None
    if isinstance(mn, dict) or isinstance(mx, dict):  # bytes columns: skip
        return None
    return mn, mx


def _cmp_overlap(op: CompareOp, lo, hi, v) -> bool:
    try:
        if op == CompareOp.EQ:
            return lo <= v <= hi
        if op == CompareOp.NEQ:
            return True  # only prunable when lo == hi == v; keep conservative
        if op == CompareOp.LT:
            return lo < v
        if op == CompareOp.LTE:
            return lo <= v
        if op == CompareOp.GT:
            return hi > v
        if op == CompareOp.GTE:
            return hi >= v
    except TypeError:
        return True
    return True


def segment_can_match(f: ast.FilterExpr | None, stats: dict) -> bool:
    """Conservative test: False only when the filter PROVABLY matches no doc
    of the segment given column [min, max] stats."""
    if f is None:
        return True
    if isinstance(f, ast.And):
        return all(segment_can_match(c, stats) for c in f.children)
    if isinstance(f, ast.Or):
        return any(segment_can_match(c, stats) for c in f.children)
    if isinstance(f, ast.Compare):
        left, op, right = f.left, f.op, f.right
        if isinstance(left, ast.Literal) and isinstance(right, ast.Identifier):
            from pinot_tpu_torch.query.plan import _FLIP

            left, right, op = right, left, _FLIP[op]
        if isinstance(left, ast.Identifier) and isinstance(right, ast.Literal):
            iv = _interval(stats, left.name)
            if iv is not None:
                v = right.value
                if isinstance(v, str) != isinstance(iv[0], str):
                    return True
                return _cmp_overlap(op, iv[0], iv[1], v)
        return True
    if isinstance(f, ast.Between) and isinstance(f.expr, ast.Identifier) and not f.negated:
        if isinstance(f.low, ast.Literal) and isinstance(f.high, ast.Literal):
            iv = _interval(stats, f.expr.name)
            if iv is not None:
                try:
                    return not (f.high.value < iv[0] or f.low.value > iv[1])
                except TypeError:
                    return True
        return True
    if isinstance(f, ast.In) and isinstance(f.expr, ast.Identifier) and not f.negated:
        iv = _interval(stats, f.expr.name)
        if iv is not None:
            try:
                return any(iv[0] <= v.value <= iv[1] for v in f.values if isinstance(v, ast.Literal))
            except TypeError:
                return True
        return True
    # NOT / LIKE / REGEXP / IsNull: never prune
    return True


def _stats_map(seg: ImmutableSegment) -> dict:
    return {col: {"min": ci.stats.min_value, "max": ci.stats.max_value} for col, ci in seg.columns.items()}


def _bloom_rejects(seg: ImmutableSegment, f: ast.FilterExpr | None) -> bool:
    """True when a bloom filter PROVES a conjunctive EQ/IN predicate matches
    nothing in this segment."""
    blooms = seg.extras.get("bloom")
    if not blooms or f is None:
        return False
    if isinstance(f, ast.And):
        return any(_bloom_rejects(seg, c) for c in f.children)
    if isinstance(f, ast.Compare) and f.op == CompareOp.EQ:
        left, right = f.left, f.right
        if isinstance(left, ast.Literal) and isinstance(right, ast.Identifier):
            left, right = right, left
        if isinstance(left, ast.Identifier) and isinstance(right, ast.Literal) and left.name in blooms:
            return not blooms[left.name].might_contain(right.value)
    if isinstance(f, ast.In) and not f.negated and isinstance(f.expr, ast.Identifier):
        if f.expr.name in blooms:
            bf = blooms[f.expr.name]
            return not any(bf.might_contain(v.value) for v in f.values if isinstance(v, ast.Literal))
    return False


def _geo_rejects(seg: ImmutableSegment, f: ast.FilterExpr | None) -> bool:
    """True when a geo grid index's bbox PROVES a conjunctive
    ST_WITHIN_DISTANCE probe matches nothing."""
    geos = seg.extras.get("geo")
    if not geos or f is None:
        return False
    if isinstance(f, ast.And):
        return any(_geo_rejects(seg, c) for c in f.children)
    if isinstance(f, ast.PredicateFunction) and f.name == "st_within_distance" and len(f.args) == 5:
        if not (isinstance(f.args[0], ast.Identifier) and isinstance(f.args[1], ast.Identifier)):
            return False
        gi = geos.get(f"{f.args[0].name},{f.args[1].name}")
        if gi is None or not all(isinstance(a, ast.Literal) for a in f.args[2:]):
            return False
        qlat, qlng, radius = (float(a.value) for a in f.args[2:])
        return gi.min_distance_m(qlat, qlng) > radius
    return False


def filter_prune_reason(seg: ImmutableSegment, f: "ast.FilterExpr | None") -> str | None:
    """Why this segment is pruned for a bare filter tree, or None when it
    must execute: "value" (empty segment / min-max interval miss), "bloom"
    (a bloom filter proves no EQ/IN match), "geo" (the grid bbox is farther
    than the probe radius). They feed the per-reason pruning funnel
    (numSegmentsPrunedByValue / ByBloom / ByGeo)."""
    if seg.n_docs == 0:
        return "value"
    if not segment_can_match(f, _stats_map(seg)):
        return "value"
    if _bloom_rejects(seg, f):
        return "bloom"
    if _geo_rejects(seg, f):
        return "geo"
    return None


def filter_can_match(seg: ImmutableSegment, f: "ast.FilterExpr | None") -> bool:
    """Segment-level pruning for a bare filter tree (min-max stats, bloom,
    geo bbox)."""
    return filter_prune_reason(seg, f) is None


def prune_reason(seg: ImmutableSegment, ctx: QueryContext) -> str | None:
    return filter_prune_reason(seg, ctx.filter)


def can_match(seg: ImmutableSegment, ctx: QueryContext) -> bool:
    return filter_can_match(seg, ctx.filter)


def _empty_frame(names: list[str]) -> dict[str, np.ndarray]:
    return {c: np.empty(0, dtype=object) for c in names}


def empty_partial(ctx: QueryContext):
    """Canonical zero-result partial per query type, in the formats of
    `reduce.py` (an aggregation's list; a frame of no rows with the
    reference's column names)."""
    qt = ctx.query_type
    if qt == QueryType.AGGREGATION:
        out = []
        for a in ctx.aggregations:
            if a.func == "distinctcounthll":
                from pinot_tpu_torch.query.sketches import HLL_M

                out.append(np.zeros(HLL_M, dtype=np.int32))  # registers merge by max
            elif a.func == "percentileest" and a.name in ctx.hints.get("est_bounds", {}):
                from pinot_tpu_torch.query.sketches import EST_BINS

                lo, hi = ctx.hints["est_bounds"][a.name]
                out.append((np.zeros(EST_BINS, dtype=np.int64), lo, hi))
            elif null_handling_enabled(ctx.options) and MV_TWIN.get(a.func, a.func) == "sum":
                # the null-handling SUM identity: a pruned segment adds no
                # value, so an all-pruned SUM finalizes to NULL
                out.append(None)
            else:
                out.append(_empty_partial(a.func, a.extra))
        return out
    if qt == QueryType.GROUP_BY:
        cols = [f"k{i}" for i in range(len(ctx.group_by))]
        for i, a in enumerate(ctx.aggregations):
            cols += [f"a{i}p{j}" for j in range(parts_of(a.func))]
        return _empty_frame(cols)
    if qt == QueryType.DISTINCT:
        return _empty_frame([f"k{i}" for i in range(len(ctx.select_items))])
    if qt == QueryType.SELECTION_ORDER_BY:
        return _empty_frame([f"__key{j}" for j in range(len(ctx.order_by))] + [f"c{i}" for i in range(len(ctx.select_items))])
    return _empty_frame([f"c{i}" for i in range(len(ctx.select_items))])
