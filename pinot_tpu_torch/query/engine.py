"""QueryEngine: end-to-end SQL execution over a set of segments on one device.

Reference parity: this composes, in-process, what Pinot splits across
ServerQueryExecutorV1Impl (pinot-core/.../query/executor/
ServerQueryExecutorV1Impl.java:141, per-segment plan + execute) and
BrokerReduceService (core/query/reduce/BrokerReduceService.java:61, merge).
It is the JAX package's `query/engine.py` single-stage path: per segment,
plan -> one device program -> one device->host copy -> partial, then one
reduce over the partials.

The engine runs on `device`, "cuda" unless the caller asks for another; on a
machine without a card the default raises rather than running elsewhere.
Each segment takes one of three executors, chosen at dispatch as the
reference chooses: the star-tree swap, when a star table of the segment
matches, unless null handling is on and the segment has null vectors
(`startree_exec`); the host executor (`host_exec`, numpy), when planning raises DeviceFallback or a
sparse group-by segment holds more present groups than its slots; else the
device program. Only DeviceFallback reroutes a segment: a
NotImplementedError (a spec tag not ported yet), a CUDA error or a failed
kernel build reaches the caller. `segment_modes`
counts the executor of every segment resolved ("startree", "host",
"device"). Segment pruning, upsert validity and the scan-stats / heat /
accounting / trace hooks of the reference are not ported yet.
"""

from __future__ import annotations

import socket
import time
from collections import Counter

import numpy as np
import torch

from pinot_tpu_torch.query import ast, host_exec, startree_exec
from pinot_tpu_torch.query import reduce as reduce_mod
from pinot_tpu_torch.query.context import QueryContext, QueryType, expand_star, null_handling_enabled
from pinot_tpu_torch.query.kernels import dispatch_plan_packed
from pinot_tpu_torch.query.optimizer import optimize_filter
from pinot_tpu_torch.query.plan import DeviceFallback, SegmentPlan, group_strides, plan_segment
from pinot_tpu_torch.query.result import ResultTable
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.segment.segment import ImmutableSegment


class QueryEngine:
    def __init__(self, segments: list[ImmutableSegment], device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("QueryEngine(device='cuda'): no CUDA device is available; pass device='cpu' to run on the CPU")
        self.segments = list(segments)
        #: executor of every segment resolved so far, by mode
        self.segment_modes: Counter = Counter()

    def mv_columns(self) -> set[str]:
        """The multi-value columns of the engine's segments, those appended
        to `segments` since it was made included."""
        return {name for seg in self.segments for name, ci in seg.columns.items() if ci.is_mv}

    # ------------------------------------------------------------------

    def make_context(self, sql: str) -> QueryContext:
        """Parse + resolve a query against this engine's segments."""
        stmt = parse_sql(sql)
        expand_star(stmt, self.segments[0].schema if self.segments else None)
        # filter rewrites (QueryOptimizer parity) run here, where the schema
        # is known: range merging skips MV columns (any-match semantics)
        stmt.where = optimize_filter(stmt.where, mv_cols=self.mv_columns())
        ctx = QueryContext.from_statement(stmt)
        if stmt.explain or stmt.explain_analyze:
            raise NotImplementedError("EXPLAIN is not ported to pinot_tpu_torch yet")
        self._compute_hints(ctx)
        return ctx

    def _compute_hints(self, ctx: QueryContext) -> None:
        """Cross-segment planning hints: global [min, max] bounds per
        PERCENTILEEST aggregation, so every segment builds its histogram over
        the same bin edges."""
        for a in ctx.aggregations:
            if a.func != "percentileest" or not isinstance(a.arg, ast.Identifier):
                continue
            los, his = [], []
            for seg in self.segments:
                ci = seg.columns.get(a.arg.name)
                if ci is None or not isinstance(ci.stats.min_value, (int, float)):
                    break
                los.append(float(ci.stats.min_value))
                his.append(float(ci.stats.max_value))
            else:
                if los:
                    ctx.hints.setdefault("est_bounds", {})[a.name] = (min(los), max(his))

    @staticmethod
    def reduce(ctx: QueryContext, partials: list) -> list[list]:
        """Broker-side half: merge partials into final rows."""
        if ctx.query_type == QueryType.AGGREGATION:
            return reduce_mod.reduce_aggregation(ctx, partials)
        if ctx.query_type == QueryType.GROUP_BY:
            return reduce_mod.reduce_group_by(ctx, partials)
        if ctx.query_type == QueryType.DISTINCT:
            return reduce_mod.reduce_distinct(ctx, partials)
        if ctx.query_type == QueryType.SELECTION_ORDER_BY:
            return reduce_mod.reduce_selection_order_by(ctx, partials)
        return reduce_mod.reduce_selection(ctx, partials)

    def execute(self, sql: str) -> ResultTable:
        """Synchronous execute = submit + immediate resolve."""
        return self.submit(sql)()

    def submit(self, sql: str):
        """Plan the query and ENQUEUE every per-segment device program without
        a device->host sync, returning a zero-argument resolve() that makes the
        syncs, the reduce and the ResultTable. Submitting several queries
        before resolving any keeps the device busy across them."""
        t0 = time.perf_counter()
        ctx = self.make_context(sql)
        pend = [(seg, self._dispatch_segment(seg, ctx)) for seg in self.segments]

        def resolve() -> ResultTable:
            partials = []
            scanned = 0
            for seg, disp in pend:
                partial, matched, mode = self._finish_segment(seg, ctx, disp)
                partials.append(partial)
                scanned += int(matched)
                self.segment_modes[mode] += 1
            rows = self.reduce(ctx, partials)
            return reduce_mod.build_result(
                ctx,
                rows,
                num_docs_scanned=scanned,
                total_docs=sum(s.n_docs for s in self.segments),
                num_segments_queried=len(self.segments),
                time_used_ms=(time.perf_counter() - t0) * 1e3,
            )

        return resolve

    # ------------------------------------------------------------------

    def _execute_segment(self, seg: ImmutableSegment, ctx: QueryContext):
        """(partial, matched docs) of one segment, synchronously."""
        return self._finish_segment(seg, ctx, self._dispatch_segment(seg, ctx))[:2]

    def _dispatch_segment(self, seg: ImmutableSegment, ctx: QueryContext):
        """Async half of segment execution. Returns ("ready", partial,
        matched, mode) when the segment resolved on the host (the star-tree
        swap, which runs its small program over the star table at once, or
        the host executor), else ("dev", plan, unpack) with the device
        program still in flight."""
        # the star tables pre-aggregate the null placeholders in: under null
        # handling a segment with null vectors takes the per-doc path
        if seg.extras.get("startree") and not (null_handling_enabled(ctx.options) and seg.extras.get("null")):
            res = startree_exec.try_execute(self, seg, ctx)
            if res is not None:
                return ("ready",) + res + ("startree",)
        try:
            plan = plan_segment(seg, ctx)
        except DeviceFallback:
            return ("ready",) + host_exec.execute_segment(seg, ctx) + ("host",)
        return ("dev", plan, dispatch_plan_packed(plan, seg.to_device_cached(self.device)))

    def _finish_segment(self, seg: ImmutableSegment, ctx: QueryContext, disp):
        """Sync half: convert a dispatch to (partial, matched, mode)."""
        if disp[0] == "ready":
            return disp[1:]
        _, plan, unpack = disp
        out = unpack()  # the one device->host copy for this segment
        qt = ctx.query_type
        if qt == QueryType.AGGREGATION:
            matched, parts = out
            return self._convert_agg(seg, ctx, plan, parts), int(matched), "device"
        if qt == QueryType.SELECTION:
            matched, outs = out
            return self._convert_selection(seg, plan, int(matched), outs), int(matched), "device"
        if qt == QueryType.SELECTION_ORDER_BY:
            matched, keys, outs = out
            return self._convert_selection_ob(seg, plan, int(matched), keys, outs), int(matched), "device"
        # GROUP_BY and DISTINCT
        if plan.spec[2][0] == "groups_sparse":
            matched, counts, parts, uniq, n_unique = out
            if int(n_unique) > plan.spec[2][2]:
                # more present groups than compact slots: the clipped slots
                # collided and the partial is unusable; rerun on the host
                return host_exec.execute_segment(seg, ctx) + ("host",)
            partial = self._convert_groups(seg, ctx, plan, np.asarray(counts), parts, dense_gids=uniq)
            return partial, int(matched), "device"
        matched, counts, parts = out
        return self._convert_groups(seg, ctx, plan, np.asarray(counts), parts), int(matched), "device"

    # -- device output -> host partial conversions ----------------------

    @staticmethod
    def _convert_agg(seg: ImmutableSegment, ctx: QueryContext, plan: SegmentPlan, parts) -> list:
        out = []
        for a, spec_entry, p in zip(ctx.aggregations, plan.spec[3], parts):
            spec_entry = _unwrapped(spec_entry)
            func = reduce_mod.twin(a.func)  # an MV partial is its SV twin's
            if func == "count":
                out.append(int(p))
            elif func in reduce_mod.DISTINCT_AGGS:
                # presence over dict ids -> the set of present values
                out.append(_present_values(seg, spec_entry[1], np.asarray(p)))
            elif a.func in ("funnelcount", "funnelcompletecount"):
                # (K, pad) presence rows -> each step's set of values
                pres = np.asarray(p)
                out.append([_present_values(seg, spec_entry[1], pres[k]) for k in range(pres.shape[0])])
            elif a.func == "distinctcounthll":
                out.append(np.asarray(p))  # the register vector
            elif a.func == "percentileest":
                lo, hi = ctx.hints["est_bounds"][a.name]
                out.append((np.asarray(p), lo, hi))
            elif func in ("avg", "minmaxrange"):
                out.append((float(p[0]), int(p[1]) if func == "avg" else float(p[1])))
            else:
                out.append(float(p))
        return out

    @staticmethod
    def _convert_groups(
        seg: ImmutableSegment, ctx: QueryContext, plan: SegmentPlan, counts: np.ndarray, parts, dense_gids=None
    ) -> dict[str, np.ndarray]:
        """Present groups (count > 0) -> a group frame: key columns decoded
        through the dictionaries, one column per partial (DISTINCTCOUNT: an
        object column of value sets; DISTINCTCOUNTHLL: of register vectors).
        DISTINCT's frame has the keys alone. `dense_gids` maps the sparse
        path's slots to their dense gids; on the dense path a slot IS its
        gid."""
        pg = np.nonzero(counts)[0]
        gids = pg if dense_gids is None else np.asarray(dense_gids)[pg]
        cards = [ci.cardinality for _, ci in plan.group_cols]
        strides = group_strides(cards, np.int64)
        frame: dict[str, np.ndarray] = {}
        for i, (_, ci) in enumerate(plan.group_cols):
            ids = (gids // strides[i]) % max(cards[i], 1)
            vals = ci.dictionary.get_many(ids)
            frame[f"k{i}"] = vals.astype(str) if vals.dtype == object else vals
        for i, (a, spec_entry, p) in enumerate(zip(ctx.aggregations, plan.spec[3], parts)):
            spec_entry = _unwrapped(spec_entry)
            if reduce_mod.twin(a.func) in ("avg", "minmaxrange"):
                frame[f"a{i}p0"] = np.asarray(p[0])[pg]
                frame[f"a{i}p1"] = np.asarray(p[1])[pg]
            elif a.func in reduce_mod.DISTINCT_AGGS:
                pres = np.asarray(p)[pg]
                cells = np.empty(len(pg), dtype=object)
                for j in range(len(pg)):
                    cells[j] = _present_values(seg, spec_entry[1], pres[j])
                frame[f"a{i}p0"] = cells
            elif a.func == "distinctcounthll":
                regs = np.asarray(p)[pg]
                cells = np.empty(len(pg), dtype=object)
                for j in range(len(pg)):
                    cells[j] = regs[j]
                frame[f"a{i}p0"] = cells
            elif a.func == "percentileest":
                lo, hi = ctx.hints["est_bounds"][a.name]
                hists = np.asarray(p)[pg]
                cells = np.empty(len(pg), dtype=object)
                for j in range(len(pg)):
                    cells[j] = (hists[j], lo, hi)
                frame[f"a{i}p0"] = cells
            else:
                frame[f"a{i}p0"] = np.asarray(p)[pg]
        return frame

    @staticmethod
    def _convert_selection(seg: ImmutableSegment, plan: SegmentPlan, matched: int, outs) -> dict[str, np.ndarray]:
        n = min(matched, plan.spec[3])
        return {f"c{i}": _decode(seg, d, np.asarray(o)[:n]) for i, (d, o) in enumerate(zip(plan.select_decode, outs))}

    @staticmethod
    def _convert_selection_ob(
        seg: ImmutableSegment, plan: SegmentPlan, matched: int, keys_out, outs
    ) -> dict[str, np.ndarray]:
        """The segment's top rows with their sort values as __key columns:
        one per ORDER BY key (a composite rank decomposes back into each
        key's value), dictionary keys decoded."""
        n = min(matched, plan.spec[5])
        frame: dict[str, np.ndarray] = {}
        keys = np.asarray(keys_out)[:n]
        if plan.ob_decomp:
            comp = keys.astype(np.int64)
            strides = group_strides([card for _, card, _, _, _ in plan.ob_decomp], np.int64)
            for i, (col, card, desc, kind, off) in enumerate(plan.ob_decomp):
                rank = (comp // strides[i]) % card
                if desc:
                    rank = card - 1 - rank
                frame[f"__key{i}"] = _dict_values(seg, col, rank) if kind == "ids" else rank + off
        elif plan.spec[3][0] == "ids":
            frame["__key0"] = _dict_values(seg, plan.spec[3][1], keys.astype(np.int64))
        else:
            frame["__key0"] = keys
        for i, (dec, o) in enumerate(zip(plan.select_decode, outs)):
            frame[f"c{i}"] = _decode(seg, dec, np.asarray(o)[:n])
        return frame


def _unwrapped(spec_entry: tuple) -> tuple:
    """An aggregate's spec inside its FILTER (WHERE) / null-handling masks."""
    while spec_entry[0] in ("masked", "masked_nan_empty"):
        spec_entry = spec_entry[2]
    return spec_entry


def _dict_values(seg: ImmutableSegment, col: str, ids: np.ndarray) -> np.ndarray:
    vals = seg.columns[col].dictionary.get_many(ids)
    return vals.astype(str) if vals.dtype == object else vals


def _decode(seg: ImmutableSegment, dec: tuple, v: np.ndarray) -> np.ndarray:
    """A selection projection's device values -> its column values."""
    kind = dec[0]
    if kind == "dict":
        return _dict_values(seg, dec[1], v.astype(np.int64))
    if kind == "virt":
        # virtual columns: v carries the selected doc ids
        if dec[1] == "$docId":
            return v.astype(np.int64)
        if dec[1] == "$segmentName":
            return np.full(len(v), seg.name, dtype=object)
        return np.full(len(v), socket.gethostname(), dtype=object)
    return v


def _present_values(seg: ImmutableSegment, col: str, presence: np.ndarray) -> set:
    """The dictionary values of `col` whose ids a presence vector marks (the
    reference's mergeable DISTINCTCOUNT partial)."""
    ci = seg.columns[col]
    return set(ci.dictionary.values[np.nonzero(presence[: ci.cardinality])[0]].tolist())
