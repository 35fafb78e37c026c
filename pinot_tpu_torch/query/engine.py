"""QueryEngine: end-to-end SQL execution over a set of segments on one device.

Reference parity: this composes, in-process, what Pinot splits across
ServerQueryExecutorV1Impl (pinot-core/.../query/executor/
ServerQueryExecutorV1Impl.java:141, per-segment plan + execute) and
BrokerReduceService (core/query/reduce/BrokerReduceService.java:61, merge).
It is the JAX package's `query/engine.py` single-stage path: per segment,
prune, plan -> one device program -> one device->host copy -> partial, then
one reduce over the partials.

The engine runs on `device`, "cuda" unless the caller asks for another; on a
machine without a card the default raises rather than running elsewhere.
`_dispatch_all` is the one dispatch loop (submit, execute, partials and
EXPLAIN ANALYZE share it): per segment the accountant checkpoint, the
deadline, the `segment.execute` fault point, then the pruner. A segment whose
min/max proves the filter empty is pruned: never planned, never staged; it
contributes the canonical empty partial. Every other segment takes one of
three executors, chosen at dispatch as the reference chooses: the star-tree
swap, when a star table of the segment matches, unless the segment has an
upsert validity (`extras["valid_docs"]`) or null handling is on and the
segment has null vectors (`startree_exec`); the host executor (`host_exec`,
numpy), when planning raises DeviceFallback or a sparse group-by segment
holds more present groups than its slots; else the device program. The
validity reaches the program as a docmask operand and the host executor as
an extra mask. Only DeviceFallback reroutes a segment: a NotImplementedError,
a CUDA error or a failed kernel build reaches the caller.

`_resolve_partials` is the one resolve loop: per segment the checkpoint and
the deadline again, the device->host copy inside a `segment:<name>` trace
span, the accountant's sample, the scan-path stats and the segment heat;
after the last segment, the kernel launches' CUDA events, read once every
copy has synchronized the stream (`common/kernel_obs.py`). `segment_modes`
counts the executor
of every segment resolved ("startree", "host", "device", "pruned").
EXPLAIN PLAN FOR returns the operator tree of the first segment's plan;
EXPLAIN ANALYZE runs the query under a private trace and annotates it.
"""

from __future__ import annotations

import contextlib
import socket
import time
from collections import Counter

import numpy as np
import torch

from pinot_tpu_torch.common.accounting import default_accountant
from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
from pinot_tpu_torch.common.kernel_obs import KERNELS
from pinot_tpu_torch.common.metrics import ScanMeter, ServerMeter, server_metrics
from pinot_tpu_torch.common.segment_heat import HEAT
from pinot_tpu_torch.common.trace import InvocationScope, start_trace, trace_event
from pinot_tpu_torch.query import ast, host_exec, pruner, scan_stats, startree_exec
from pinot_tpu_torch.query import reduce as reduce_mod
from pinot_tpu_torch.query.context import QueryContext, QueryType, expand_star, null_handling_enabled
from pinot_tpu_torch.query.kernels import dispatch_plan_packed
from pinot_tpu_torch.query.optimizer import optimize_filter
from pinot_tpu_torch.query.plan import DeviceFallback, SegmentPlan, group_strides, plan_segment
from pinot_tpu_torch.query.result import ResultTable
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.segment.segment import ImmutableSegment

EXPLAIN_COLUMNS = ["Operator", "Operator_Id", "Parent_Id"]


def _describe_spec(spec: tuple, next_id: int, parent: int) -> list[list]:
    """Flatten a compiled plan spec into [operator, id, parent] rows."""
    rows: list[list] = []
    counter = [next_id]

    def emit(label: str, par: int) -> int:
        oid = counter[0]
        counter[0] += 1
        rows.append([label, oid, par])
        return oid

    def walk_filter(f, par: int) -> None:
        kind = f[0]
        if kind in ("and", "or"):
            oid = emit(f"FILTER_{kind.upper()}", par)
            for c in f[1]:
                walk_filter(c, oid)
        elif kind == "not":
            oid = emit("FILTER_NOT", par)
            walk_filter(f[1], oid)
        elif kind == "const":
            emit(f"FILTER_CONST({f[1]})", par)
        else:
            emit(f"FILTER_{kind.upper()}", par)

    def walk_agg(a, par: int) -> None:
        if a[0] in ("masked", "masked_nan_empty"):
            oid = emit("AGG_FILTERED", par)
            walk_filter(a[1], oid)
            walk_agg(a[2], oid)
        else:
            emit(f"AGGREGATE_{a[0].upper()}", par)

    kind = spec[0]
    if kind == "agg":
        _, fspec, gspec, aggs = spec
        walk_filter(fspec, parent)
        if gspec is not None:
            gid = emit(f"GROUP_BY(keys={list(gspec[1])}, ng={gspec[2]})", parent)
            for a in aggs:
                walk_agg(a, gid)
        else:
            for a in aggs:
                walk_agg(a, parent)
    elif kind == "select":
        emit(f"SELECT(columns={len(spec[2])}, limit={spec[3]})", parent)
        walk_filter(spec[1], parent)
    elif kind == "select_ob":
        emit(f"SELECT_ORDER_BY(columns={len(spec[2])}, limit={spec[5]})", parent)
        walk_filter(spec[1], parent)
    return rows


class QueryEngine:
    def __init__(self, segments: list[ImmutableSegment], device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("QueryEngine(device='cuda'): no CUDA device is available; pass device='cpu' to run on the CPU")
        self.segments = list(segments)
        #: executor of every segment resolved so far, by mode
        self.segment_modes: Counter = Counter()
        #: scan-path stats and segment heat for this engine's queries (also
        #: off while `scan_stats.configure(False)` holds)
        self.scan_obs_enabled = True

    def add_segment(self, seg: ImmutableSegment) -> None:
        self.segments.append(seg)

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

    def _obs(self) -> bool:
        return scan_stats.enabled() and self.scan_obs_enabled

    # -- the server half --------------------------------------------------

    def partials(self, ctx: QueryContext, segments: list[ImmutableSegment] | None = None):
        """Server-side half: (per-segment partials, matched doc count,
        scan-path summary). The broker reduce consumes these."""
        probes = self._new_probe_sink()
        pend, pruned = self._dispatch_all(ctx, segments, probe_sink=probes)
        out, scanned, summary = self._resolve_partials(ctx, pend, pruned)
        scan_stats.merge_probe_sink(summary, probes)
        return out, scanned, summary

    def _new_probe_sink(self):
        """A dict for index-probe entries recorded during dispatch-time
        pruning (bloom membership, geo grid rejects), or None when scan
        observability is off."""
        return {} if self._obs() else None

    def _dispatch_all(self, ctx: QueryContext, segments=None, probe_sink=None):
        """Prune + enqueue every segment's program, with no device->host sync
        (host executors run inline). Returns ([(seg, dispatch, launches)],
        pruned count); `launches` are the segment's kernel launches, resolved
        with it."""
        pend: list = []
        pruned = 0
        cm = scan_stats.collect_probes(probe_sink) if probe_sink is not None else contextlib.nullcontext()
        with cm:
            for seg in self.segments if segments is None else segments:
                default_accountant.checkpoint()
                if ctx.deadline is not None:
                    ctx.deadline.check(f"segment {seg.name}")
                try:
                    FAULTS.maybe_fail("segment.execute")
                except InjectedFault:
                    trace_event("fault.injected", point="segment.execute", segment=seg.name)
                    raise
                reason = pruner.prune_reason(seg, ctx)
                if reason is not None:
                    # the canonical empty partial; the reason feeds the
                    # pruning funnel (numSegmentsPrunedByValue / ByBloom / ByGeo)
                    pend.append((seg, ("pruned", pruner.empty_partial(ctx), reason), []))
                    pruned += 1
                    continue
                with KERNELS.collect() as launches:
                    disp = self._dispatch_segment(seg, ctx)
                pend.append((seg, disp, launches))
        return pend, pruned

    def _resolve_partials(self, ctx: QueryContext, pend: list, pruned: int):
        """Sync + convert every pending dispatch, with the per-segment
        checkpoint (where a killed query stops), deadline, trace span,
        accountant sample, segment meters and scan-path and heat folds, then
        the kernel records. Returns (partials, matched docs, scan summary)."""
        obs = self._obs()
        summary = scan_stats.new_scan_summary()
        n_post = len(ctx.post_filter_columns) if obs else 0
        out = []
        scanned = 0
        launched: list = []
        for seg, disp, launches in pend:
            if disp[0] == "pruned":
                out.append(disp[1])  # no scan, no sample
                self.segment_modes["pruned"] += 1
                if obs:
                    scan_stats.fold_prune(summary, disp[2])
                continue
            default_accountant.checkpoint()
            if ctx.deadline is not None:
                ctx.deadline.check(f"segment {seg.name}")
            # per-segment CPU attribution: thread_time_ns deltas exclude time
            # this thread spent descheduled or blocked
            t_cpu = time.thread_time_ns()
            t_wall = time.perf_counter()
            with InvocationScope(f"segment:{seg.name}") as scope:
                if obs:
                    with scan_stats.collect_probes(summary["indexProbeEntries"]):
                        partial, matched, mode = self._finish_segment(seg, ctx, disp)
                else:
                    partial, matched, mode = self._finish_segment(seg, ctx, disp)
                scope.set_attr("numDocsMatched", int(matched))
            launched += launches
            self.segment_modes[mode] += 1
            default_accountant.sample(segments=1, allocated_bytes=seg.size_bytes, cpu_ns=time.thread_time_ns() - t_cpu)
            if obs:
                seg_stats = scan_stats.segment_scan_stats(ctx, seg, _scan_mode(disp), int(matched), n_post)
                scan_stats.fold_segment_stats(summary, seg_stats)
                HEAT.record(
                    ctx.table,
                    seg.name,
                    docs_scanned=int(matched),
                    bytes_touched=seg.size_bytes,
                    device_ms=(time.perf_counter() - t_wall) * 1e3,
                )
                if seg_stats["fullScanFallbacks"]:
                    trace_event(
                        "scan.fullScan",
                        segment=seg.name,
                        columns=",".join(sorted({f["column"] for f in seg_stats["fullScanFallbacks"]})),
                    )
            out.append(partial)
            scanned += int(matched)
        # every segment's copy has synchronized the stream: the launches'
        # events are complete; their times and mask counts are read at once
        KERNELS.resolve(launched)
        m = server_metrics()
        m.meter(ServerMeter.NUM_SEGMENTS_QUERIED).mark(len(pend) - pruned)
        if pruned:
            m.meter(ServerMeter.NUM_SEGMENTS_PRUNED).mark(pruned)
        if obs:
            tbl = ctx.table
            if summary["entriesInFilter"]:
                m.meter(ScanMeter.ENTRIES_IN_FILTER, table=tbl).mark(summary["entriesInFilter"])
            if summary["entriesPostFilter"]:
                m.meter(ScanMeter.ENTRIES_POST_FILTER, table=tbl).mark(summary["entriesPostFilter"])
            by_path: dict[str, int] = {}
            for key, cnt in summary["predicates"].items():
                path = key.rsplit(":", 1)[1]
                by_path[path] = by_path.get(path, 0) + cnt
            for path, cnt in by_path.items():
                m.meter(ScanMeter.PREDICATES, table=tbl, index=path).mark(cnt)
            n_fallback = sum(summary["fullScanFallbacks"].values())
            if n_fallback:
                m.meter(ScanMeter.FULL_SCAN_FALLBACK, table=tbl).mark(n_fallback)
        return out, scanned, summary

    def partials_iter(self, ctx: QueryContext, segments: list[ImmutableSegment] | None = None):
        """Per-segment streaming variant of partials(): yields (seg, partial,
        matched, scan stats or None) as each segment finishes, so a caller can
        frame results out one by one and stop early (GrpcQueryServer.submit
        streaming parity). Pruned segments yield nothing."""
        obs = self._obs()
        n_post = len(ctx.post_filter_columns) if obs else 0
        for seg in self.segments if segments is None else segments:
            if ctx.deadline is not None:
                ctx.deadline.check(f"segment {seg.name}")
            try:
                FAULTS.maybe_fail("segment.execute")
            except InjectedFault:
                trace_event("fault.injected", point="segment.execute", segment=seg.name)
                raise
            if not pruner.can_match(seg, ctx):
                continue
            with KERNELS.collect() as launches:
                disp = self._dispatch_segment(seg, ctx)
            t_wall = time.perf_counter()
            partial, matched, mode = self._finish_segment(seg, ctx, disp)
            KERNELS.resolve(launches)
            self.segment_modes[mode] += 1
            seg_stats = None
            if obs:
                seg_stats = scan_stats.segment_scan_stats(ctx, seg, _scan_mode(disp), int(matched), n_post)
                HEAT.record(
                    ctx.table,
                    seg.name,
                    docs_scanned=int(matched),
                    bytes_touched=seg.size_bytes,
                    device_ms=(time.perf_counter() - t_wall) * 1e3,
                )
            yield seg, partial, int(matched), seg_stats

    # -- the broker half --------------------------------------------------

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

    # -- EXPLAIN ------------------------------------------------------------

    def explain(self, ctx: QueryContext) -> ResultTable:
        """EXPLAIN PLAN FOR: the operator tree the query would execute
        (ExplainPlanQueryExecutor parity) as [Operator, Operator_Id,
        Parent_Id] rows, from the first segment's lowering."""
        rows: list[list] = [["BROKER_REDUCE(" + ctx.query_type.value + ")", 0, -1]]
        if not self.segments:
            return ResultTable(columns=EXPLAIN_COLUMNS, rows=rows)
        seg = self.segments[0]
        st = seg.extras.get("startree")
        if (
            st is not None
            and seg.extras.get("valid_docs") is None
            and not (null_handling_enabled(ctx.options) and seg.extras.get("null"))
        ):
            if any(startree_exec.matches(ctx, t) for t in st):
                rows.append(["STARTREE_SWAP(pre-aggregated table scan)", 1, 0])
                rows.extend(self._filter_attribution_rows(ctx, seg, "startree", rows))
                return ResultTable(columns=EXPLAIN_COLUMNS, rows=rows)
        try:
            plan = plan_segment(seg, ctx)
            rows.append(["DEVICE_FUSED_PROGRAM(segment=" + seg.name + ")", 1, 0])
            rows.extend(_describe_spec(plan.spec, next_id=2, parent=1))
            rows.extend(self._filter_attribution_rows(ctx, seg, "device", rows))
        except DeviceFallback as e:
            rows.append([f"HOST_EXECUTOR(reason={e})", 1, 0])
            rows.extend(self._filter_attribution_rows(ctx, seg, "host", rows))
        return ResultTable(columns=EXPLAIN_COLUMNS, rows=rows)

    @staticmethod
    def _filter_attribution_rows(ctx: QueryContext, seg, mode: str, rows: list[list]) -> list[list]:
        """One FILTER_<PATH>(col) row per filter predicate, parented at the
        execution node (id 1): which index class (or FULL_SCAN) serves each
        predicate under the mode the first segment would execute in."""
        out = []
        nid = max(r[1] for r in rows) + 1
        for leaf in scan_stats.filter_leaves(ctx.filter):
            col, path, _entries = scan_stats.classify_leaf(leaf, seg, mode)
            out.append([f"FILTER_{path}({col})", nid, 1])
            nid += 1
        return out

    def _explain_analyze(self, ctx: QueryContext) -> ResultTable:
        """EXPLAIN ANALYZE: run the query under a private trace and annotate
        the EXPLAIN tree with the runtime stats and one SEGMENT_SCAN row per
        segment span."""
        base = self.explain(ctx)
        t0 = time.perf_counter()
        with start_trace("explain-analyze") as tr:
            pend, pruned = self._dispatch_all(ctx)
            partials, scanned, scan = self._resolve_partials(ctx, pend, pruned)
            out_rows = self.reduce(ctx, partials)
        wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [list(r) for r in base.rows]
        rows[0][0] += (
            f" (rows={len(out_rows)}, docsScanned={int(scanned)},"
            f" segmentsPruned={pruned},"
            f" entriesInFilter={scan['entriesInFilter']},"
            f" entriesPostFilter={scan['entriesPostFilter']}, timeMs={wall_ms:.2f})"
        )
        # the filter attribution rows gain the measured entry counts
        for r in rows:
            label = r[0]
            if label.startswith("FILTER_") and label.endswith(")") and "(" in label:
                path, _, col = label[len("FILTER_") : -1].partition("(")
                if path in scan_stats.ALL_PATHS:
                    entries = scan.get("predicateEntries", {}).get(f"{col}:{path}", 0)
                    r[0] = f"{label} (entries={entries})"
        # per-segment spans become children of the execution root
        exec_parent = rows[1][1] if len(rows) > 1 else rows[0][1]
        nid = max(r[1] for r in rows) + 1
        for span in tr.to_dict()["spans"]:
            if not span["name"].startswith("segment:"):
                continue
            matched = span.get("attrs", {}).get("numDocsMatched", 0)
            rows.append(
                [
                    f"SEGMENT_SCAN({span['name'][len('segment:'):]}, docsMatched={matched}, wallMs={span['durationMs']})",
                    nid,
                    exec_parent,
                ]
            )
            nid += 1
        return ResultTable(columns=EXPLAIN_COLUMNS, rows=rows)

    # -- execute / submit ---------------------------------------------------

    def execute(self, sql: str) -> ResultTable:
        """Synchronous execute = submit + immediate resolve (one code path)."""
        return self.submit(sql)()

    def submit(self, sql: str):
        """Plan the query and ENQUEUE every per-segment device program without
        a device->host sync, returning a zero-argument resolve() that makes the
        syncs, the reduce and the ResultTable. Submitting several queries
        before resolving any keeps the device busy across them."""
        t0 = time.perf_counter()
        ctx = self.make_context(sql)
        if ctx.statement.explain:
            return lambda: self.explain(ctx)
        if ctx.statement.explain_analyze:
            return lambda: self._explain_analyze(ctx)
        probes = self._new_probe_sink()
        pend, pruned = self._dispatch_all(ctx, probe_sink=probes)

        def resolve() -> ResultTable:
            partials, scanned, scan = self._resolve_partials(ctx, pend, pruned)
            scan_stats.merge_probe_sink(scan, probes)
            rows = self.reduce(ctx, partials)
            by_reason = scan["prunedByReason"]
            return reduce_mod.build_result(
                ctx,
                rows,
                num_docs_scanned=int(scanned),
                total_docs=sum(s.n_docs for s in self.segments),
                num_segments_queried=len(self.segments),
                num_segments_pruned=pruned,
                num_segments_pruned_by_value=by_reason.get("value", 0),
                num_segments_pruned_by_bloom=by_reason.get("bloom", 0),
                num_segments_pruned_by_geo=by_reason.get("geo", 0),
                num_entries_scanned_in_filter=scan["entriesInFilter"],
                num_entries_scanned_post_filter=scan["entriesPostFilter"],
                scan_profile=scan,
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
        the host executor), else ("dev", plan, unpack, valid mask) with the
        device program still in flight."""
        valid = seg.extras.get("valid_docs")
        # the star tables pre-aggregate every doc: unusable under an upsert
        # validity, and under null handling over a segment with null vectors
        # (they bake the null placeholders in)
        if (
            seg.extras.get("startree")
            and valid is None
            and not (null_handling_enabled(ctx.options) and seg.extras.get("null"))
        ):
            res = startree_exec.try_execute(self, seg, ctx)
            if res is not None:
                return ("ready",) + res + ("startree",)
        vmask = valid(seg.n_docs) if valid is not None else None
        try:
            plan = plan_segment(seg, ctx, valid_mask=vmask)
        except DeviceFallback:
            return ("ready",) + host_exec.execute_segment(seg, ctx, extra_mask=vmask) + ("host",)
        return ("dev", plan, dispatch_plan_packed(plan, seg.to_device_cached(self.device)), vmask)

    def _finish_segment(self, seg: ImmutableSegment, ctx: QueryContext, disp):
        """Sync half: convert a dispatch to (partial, matched, mode)."""
        if disp[0] == "ready":
            return disp[1:]
        _, plan, unpack, vmask = disp
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
                return host_exec.execute_segment(seg, ctx, extra_mask=vmask) + ("host",)
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


def _scan_mode(disp) -> str:
    """The executor a dispatch planned, as scan-path attribution names it (a
    sparse segment rerun on the host still planned "device")."""
    return "device" if disp[0] == "dev" else disp[3]


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
