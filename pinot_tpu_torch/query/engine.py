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
Star-tree swaps, the host executor, segment pruning, upsert validity and the
scan-stats / heat / accounting / trace hooks of the reference are not ported
yet; query shapes that need them raise NotImplementedError.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pinot_tpu_torch.query import reduce as reduce_mod
from pinot_tpu_torch.query.context import QueryContext, QueryType, expand_star
from pinot_tpu_torch.query.kernels import dispatch_plan_packed
from pinot_tpu_torch.query.optimizer import optimize_filter
from pinot_tpu_torch.query.plan import SegmentPlan, group_strides, plan_segment
from pinot_tpu_torch.query.result import ResultTable
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.segment.segment import ImmutableSegment


class QueryEngine:
    def __init__(self, segments: list[ImmutableSegment], device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("QueryEngine(device='cuda'): no CUDA device is available; pass device='cpu' to run on the CPU")
        self.segments = list(segments)

    # ------------------------------------------------------------------

    def make_context(self, sql: str) -> QueryContext:
        """Parse + resolve a query against this engine's segments."""
        stmt = parse_sql(sql)
        expand_star(stmt, self.segments[0].schema if self.segments else None)
        # filter rewrites (QueryOptimizer parity) run here, where the schema
        # is known; this package builds no MV columns
        stmt.where = optimize_filter(stmt.where, mv_cols=set())
        ctx = QueryContext.from_statement(stmt)
        if stmt.explain or stmt.explain_analyze:
            raise NotImplementedError("EXPLAIN is not ported to pinot_tpu_torch yet")
        return ctx

    @staticmethod
    def reduce(ctx: QueryContext, partials: list) -> list[list]:
        """Broker-side half: merge partials into final rows."""
        if ctx.query_type == QueryType.AGGREGATION:
            return reduce_mod.reduce_aggregation(ctx, partials)
        if ctx.query_type == QueryType.GROUP_BY:
            return reduce_mod.reduce_group_by(ctx, partials)
        raise NotImplementedError(f"{ctx.query_type.value} queries are not ported to pinot_tpu_torch yet")

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
                partial, matched = self._finish_segment(seg, ctx, disp)
                partials.append(partial)
                scanned += int(matched)
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

    def _dispatch_segment(self, seg: ImmutableSegment, ctx: QueryContext):
        """Async half of segment execution: plan + ENQUEUE the device program.
        Returns (plan, unpack) with the program still in flight."""
        plan = plan_segment(seg, ctx)
        return plan, dispatch_plan_packed(plan, seg.to_device_cached(self.device))

    def _finish_segment(self, seg: ImmutableSegment, ctx: QueryContext, disp):
        """Sync half: convert an in-flight dispatch to (partial, matched)."""
        plan, unpack = disp
        out = unpack()  # the one device->host copy for this segment
        if ctx.query_type == QueryType.AGGREGATION:
            matched, parts = out
            return self._convert_agg(seg, ctx, plan, parts), int(matched)
        matched, counts, parts = out
        return self._convert_groups(seg, ctx, plan, np.asarray(counts), parts), int(matched)

    # -- device output -> host partial conversions ----------------------

    @staticmethod
    def _convert_agg(seg: ImmutableSegment, ctx: QueryContext, plan: SegmentPlan, parts) -> list:
        out = []
        for a, spec_entry, p in zip(ctx.aggregations, plan.spec[3], parts):
            if a.func == "count":
                out.append(int(p))
            elif a.func in reduce_mod.DISTINCT_AGGS:
                # presence over dict ids -> the set of present values
                out.append(_present_values(seg, spec_entry[1], np.asarray(p)))
            elif a.func in ("avg", "minmaxrange"):
                out.append((float(p[0]), int(p[1]) if a.func == "avg" else float(p[1])))
            else:
                out.append(float(p))
        return out

    @staticmethod
    def _convert_groups(
        seg: ImmutableSegment, ctx: QueryContext, plan: SegmentPlan, counts: np.ndarray, parts
    ) -> dict[str, np.ndarray]:
        """Present groups (count > 0) -> a group frame: key columns decoded
        through the dictionaries, one column per partial (DISTINCTCOUNT: an
        object column of value sets)."""
        pg = np.nonzero(counts)[0]
        cards = [ci.cardinality for _, ci in plan.group_cols]
        strides = group_strides(cards, np.int64)
        frame: dict[str, np.ndarray] = {}
        for i, (_, ci) in enumerate(plan.group_cols):
            ids = (pg // strides[i]) % max(cards[i], 1)
            vals = ci.dictionary.get_many(ids)
            frame[f"k{i}"] = vals.astype(str) if vals.dtype == object else vals
        for i, (a, spec_entry, p) in enumerate(zip(ctx.aggregations, plan.spec[3], parts)):
            if a.func in ("avg", "minmaxrange"):
                frame[f"a{i}p0"] = np.asarray(p[0])[pg]
                frame[f"a{i}p1"] = np.asarray(p[1])[pg]
            elif a.func in reduce_mod.DISTINCT_AGGS:
                pres = np.asarray(p)[pg]
                cells = np.empty(len(pg), dtype=object)
                for j in range(len(pg)):
                    cells[j] = _present_values(seg, spec_entry[1], pres[j])
                frame[f"a{i}p0"] = cells
            else:
                frame[f"a{i}p0"] = np.asarray(p)[pg]
        return frame


def _present_values(seg: ImmutableSegment, col: str, presence: np.ndarray) -> set:
    """The dictionary values of `col` whose ids a presence vector marks (the
    reference's mergeable DISTINCTCOUNT partial)."""
    ci = seg.columns[col]
    return set(ci.dictionary.values[np.nonzero(presence[: ci.cardinality])[0]].tolist())
