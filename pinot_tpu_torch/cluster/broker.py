"""Broker role: route, scatter, gather, reduce.

Reference parity: BaseSingleStageBrokerRequestHandler.handleRequest
(pinot-broker/.../requesthandler/BaseSingleStageBrokerRequestHandler.java:286)
-> routing table -> QueryRouter.submitQuery scatter (pinot-core/.../transport/
QueryRouter.java:89) -> gather DataTables -> BrokerReduceService. Here the
scatter fans out over a thread pool to server handles (in-process objects or
HTTP clients over DCN), partials are the host-format DataTable analog, and
the reduce is the shared reduce module.

The broker never picks a device: the servers hold the segments and run the
kernels, and the in-process multistage route runs its engine on the device
of the servers it takes the segments from. Access control and the
distributed multistage dispatcher are ROADMAP A9b, as is the continuous
profiler.
"""

from __future__ import annotations

import itertools
import threading
import time
from concurrent.futures import ThreadPoolExecutor

from pinot_tpu_torch.common.errors import QueryErrorCode
from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.context import QueryContext, QueryType
from pinot_tpu_torch.query.engine import QueryEngine
from pinot_tpu_torch.query.reduce import build_result, frame_len, frame_rows
from pinot_tpu_torch.query.result import ResultTable
from pinot_tpu_torch.query.scheduler import SchedulerRejectedError
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.cluster.controller import Controller
from pinot_tpu_torch.cluster.routing import BalancedInstanceSelector, segment_can_match


def _collect_tables(stmt) -> list[str]:
    """All physical table names referenced by a (possibly nested) statement."""
    out: list[str] = []

    def rel(r):
        if isinstance(r, ast.TableRef):
            if r.name not in out:
                out.append(r.name)
        elif isinstance(r, ast.SubqueryRef):
            walk(r.stmt)
        elif isinstance(r, ast.JoinRel):
            rel(r.left)
            rel(r.right)

    def walk(s):
        if isinstance(s, ast.SetOpStatement):
            walk(s.left)
            walk(s.right)
        else:
            rel(s.relation)

    walk(stmt)
    return out


_request_seq = itertools.count()


class _PartialState:
    """Per-query degradation collector. Counts scattered/answered servers and,
    when `allow` (allowPartialResults), records server failures as structured
    exceptions instead of letting the query die — the broker then returns the
    merged rows it has with partialResult=true (BrokerResponseNative
    partial-response parity)."""

    def __init__(self, allow: bool):
        self.allow = allow
        self.partial = False
        #: set by the admission controller: projected overload + allowPartial
        #: -> trim scatter fan-out instead of shedding (see _degrade_plan)
        self.degrade = False
        self.exceptions: list[dict] = []
        self.servers_queried = 0
        self.servers_responded = 0

    def record(self, message: str, error_code: int = QueryErrorCode.QUERY_EXECUTION) -> None:
        self.partial = True
        self.exceptions.append({"errorCode": error_code, "message": message})


class Broker:
    def __init__(
        self,
        controller: Controller,
        max_scatter_threads: int = 8,
        selector=None,
        failure_detector=None,
        enable_quota: bool = True,
        query_logger=None,
        tenant_tags: list[str] | None = None,
        access_control=None,
        obs_config=None,
        resilience=None,
        scheduler_config=None,
        cache_config=None,
    ):
        """selector: instance selector (Balanced default; ReplicaGroup /
        Adaptive from cluster.routing). failure_detector: optional
        cluster.failure.FailureDetector enabling routing exclusion + one-round
        connection-failure failover. Per-table QPS quotas come from
        TableConfig.extra['queryQuotaQps']; query_logger is an optional
        cluster.quota.QueryLogger. obs_config: common.config.ObservabilityConfig
        controlling the structured slow-query log. resilience:
        common.config.ResilienceConfig — default query timeout, partial-result
        policy, and fault-injection rules (applied to the process-global
        injector when non-empty). scheduler_config:
        common.config.SchedulerConfig — the admission tier: which
        QueryScheduler the request path runs on (priority default), queue
        bounds, shed/degrade policy, and per-tenant QPS quotas
        (SchedulerConfig(enabled=False) restores inline execution).
        cache_config: common.config.CacheConfig — the query-cache plane
        (result + parse + plan tiers, cluster/result_cache.py); default ON,
        CacheConfig(enabled=False) restores uncached execution."""
        import collections

        from pinot_tpu_torch.cluster.admission import AdmissionController
        from pinot_tpu_torch.cluster.quota import QueryQuotaManager
        from pinot_tpu_torch.common.config import (
            CacheConfig,
            ObservabilityConfig,
            ResilienceConfig,
            SchedulerConfig,
        )

        if access_control is not None:
            raise NotImplementedError("Broker(access_control=...): the AccessControl SPI is ROADMAP A9b")
        self.controller = controller
        self.scheduler_config = (
            scheduler_config if scheduler_config is not None else SchedulerConfig()
        )
        #: admission tier (None when SchedulerConfig.enabled is False): every
        #: query passes decide() before any work is enqueued, then runs on
        #: the scheduler's bounded runner pool instead of the caller thread
        self.admission = (
            AdmissionController(self.scheduler_config, role="broker")
            if self.scheduler_config.enabled
            else None
        )
        #: broker-tenant membership; None = serve every table (untagged
        #: brokers belong to the DefaultTenant, TagNameUtils parity)
        self.tenant_tags = list(tenant_tags) if tenant_tags is not None else None
        #: AccessControl SPI (None = allow all); execute(sql, identity=...)
        #: gates READ on the queried table (BaseBrokerRequestHandler parity)
        self.access_control = access_control
        self.selector = selector if selector is not None else BalancedInstanceSelector()
        self.failure_detector = failure_detector
        self.quota = (
            QueryQuotaManager(controller, tenant_qps=self.scheduler_config.tenant_qps)
            if enable_quota
            else None
        )
        self.cache_config = cache_config if cache_config is not None else CacheConfig()
        #: QueryCaches (result/parse/plan tiers + single-flight), or None
        #: when CacheConfig.enabled is False — every cache branch in the
        #: request path keys off this being non-None
        self.caches = self.cache_config.make()
        self.query_logger = query_logger
        self.obs_config = obs_config if obs_config is not None else ObservabilityConfig()
        # kernel_obs is process-global (kernels register at import time);
        # the broker is where ObservabilityConfig enters the process, so it
        # applies the deployment's knobs here
        from pinot_tpu_torch.common.kernel_obs import KERNELS

        KERNELS.configure(
            enabled=self.obs_config.kernel_obs_enabled,
            hbm_peak_gbps=self.obs_config.hbm_peak_gbps,
        )
        # scan-path attribution shares the same deployment entry point
        from pinot_tpu_torch.query import scan_stats

        scan_stats.configure(self.obs_config.scan_obs_enabled)
        if self.obs_config.profiler_enabled:
            raise NotImplementedError("ObservabilityConfig(profiler_enabled=True): the sampling profiler is ROADMAP A9b")
        #: structured slow-query ring buffer (newest last); entries also go
        #: to the pinot_tpu_torch.slowquery logger as one JSON line each
        self.slow_queries = collections.deque(maxlen=self.obs_config.slow_query_log_max_entries)
        #: assembled distributed traces, newest last (GET /debug/traces);
        #: populated for trace=true queries and trace_sample_rate samples
        self.traces = collections.deque(maxlen=self.obs_config.trace_buffer_max_entries)
        self._traces_lock = threading.Lock()
        self.resilience = resilience if resilience is not None else ResilienceConfig()
        if self.resilience.faults:
            from pinot_tpu_torch.common.faults import FAULTS

            FAULTS.configure(self.resilience.faults, seed=self.resilience.fault_seed)
        # query id -> {"sql", "deadline", "startMs"} for every in-flight query
        # (ServerQueryLogger running-query registry parity; DELETE /query/{id})
        self._running: dict[str, dict] = {}
        self._running_lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=max_scatter_threads)
        # hedged-scatter state (tail-at-scale): per-(server,table) latency
        # EWMA drives the hedge delay; cumulative primary/issued counts
        # enforce the fan-out budget
        self._hedge_lock = threading.Lock()
        self._hedge_ewma: dict[tuple[str, str], float] = {}
        self._hedge_primary = 0
        self._hedge_issued = 0

    # -- hedged scatter (tail-at-scale) ---------------------------------------

    def _hedge_record(self, sid: str, table: str, ms: float) -> None:
        """Fold one successful scatter latency into the (server, table) EWMA
        the hedge delay derives from. Always on (one lock + dict op) so the
        model is warm the moment hedging is enabled."""
        key = (sid, table)
        with self._hedge_lock:
            prev = self._hedge_ewma.get(key)
            self._hedge_ewma[key] = ms if prev is None else prev * 0.8 + ms * 0.2

    def _hedge_delay_s(self, sid: str, table: str) -> float:
        """Hedge delay for this (server, table): factor × EWMA, clamped to
        [min, max]; no observation yet → max (hedge only when clearly hung)."""
        r = self.resilience
        with self._hedge_lock:
            ewma = self._hedge_ewma.get((sid, table))
        ms = r.hedge_delay_max_ms if ewma is None else ewma * r.hedge_delay_factor
        return min(max(ms, r.hedge_delay_min_ms), r.hedge_delay_max_ms) / 1e3

    def _hedge_admit(self) -> bool:
        """Claim one unit of hedge budget: cumulative hedges stay within
        hedge_budget_fraction of cumulative primary scatter calls (with a
        floor of one so a cold broker can still hedge its first straggler)."""
        with self._hedge_lock:
            allowed = max(1.0, self._hedge_primary * self.resilience.hedge_budget_fraction)
            if self._hedge_issued + 1 > allowed:
                return False
            self._hedge_issued += 1
            return True

    def _hedge_target(self, sid: str, segs, ideal, table: str) -> str | None:
        """A single surviving ONLINE replica hosting the WHOLE segment group
        (lowest EWMA wins) — hedging never splits a group, so the hedge is
        one extra request, not a re-scatter."""
        cands: set[str] | None = None
        for seg in segs:
            reps = {s for s, st in ideal.get(seg, {}).items() if st == "ONLINE" and s != sid}
            cands = reps if cands is None else cands & reps
            if not cands:
                return None
        if not cands:
            return None
        if self.failure_detector is not None:
            cands -= set(self.failure_detector.unhealthy_servers())
            if not cands:
                return None
        with self._hedge_lock:
            return min(cands, key=lambda s: (self._hedge_ewma.get((s, table), float("inf")), s))

    @staticmethod
    def _is_failed_marker(r) -> bool:
        return isinstance(r, tuple) and bool(r) and r[0] == "__failed__"

    def _scatter_plan(self, scatter, plan: dict, ideal, table: str) -> list:
        """Fan the scatter closure over the plan. With hedging disabled this
        is exactly the old pool.map. Enabled, each primary that outlives its
        EWMA-derived hedge delay is re-issued (budget permitting) to one
        surviving replica hosting the same group; the first non-failed result
        wins and the loser is cancelled (or its result ignored — a thread
        already executing cannot be interrupted, which is why the fan-out
        budget, not cancellation, bounds hedge cost)."""
        items = list(plan.items())
        if not items:
            return []
        if not self.resilience.hedge_enabled:
            return list(self._pool.map(scatter, items))
        from concurrent.futures import FIRST_COMPLETED
        from concurrent.futures import TimeoutError as _FutTimeout  # builtin alias only on 3.11+
        from concurrent.futures import wait as _fut_wait

        from pinot_tpu_torch.common.metrics import BrokerMeter, broker_metrics

        bm = broker_metrics()
        t_submit = time.perf_counter()
        entries = []
        for sid, segs in items:
            entries.append(
                (
                    sid,
                    segs,
                    self._pool.submit(scatter, (sid, segs)),
                    t_submit + self._hedge_delay_s(sid, table),
                )
            )
        with self._hedge_lock:
            self._hedge_primary += len(entries)

        results = []
        for sid, segs, fut, hedge_ts in entries:
            try:
                results.append(fut.result(timeout=max(0.0, hedge_ts - time.perf_counter())))
                continue
            except (TimeoutError, _FutTimeout):
                pass
            target = self._hedge_target(sid, segs, ideal, table)
            if target is None or not self._hedge_admit():
                results.append(fut.result())  # nothing to hedge with / over budget
                continue
            bm.meter(BrokerMeter.HEDGE_ISSUED, table=table).mark()
            hfut = self._pool.submit(scatter, (target, segs))
            _fut_wait({fut, hfut}, return_when=FIRST_COMPLETED)
            first, other = (fut, hfut) if fut.done() else (hfut, fut)

            def outcome(f):
                try:
                    return f.result(), None
                except Exception as e:  # pinotlint: disable=deadline-swallow — re-raised below when the other leg also fails
                    return None, e

            r1, e1 = outcome(first)
            if e1 is None and not self._is_failed_marker(r1):
                other.cancel()
                bm.meter(
                    BrokerMeter.HEDGE_WON if first is hfut else BrokerMeter.HEDGE_WASTED,
                    table=table,
                ).mark()
                results.append(r1)
                continue
            r2, e2 = outcome(other)  # first leg failed: wait out the other
            if e2 is None and not self._is_failed_marker(r2):
                bm.meter(
                    BrokerMeter.HEDGE_WON if other is hfut else BrokerMeter.HEDGE_WASTED,
                    table=table,
                ).mark()
                results.append(r2)
                continue
            # both legs failed: surface the PRIMARY's outcome so the normal
            # failover/degradation path sees the unhedged shape
            bm.meter(BrokerMeter.HEDGE_WASTED, table=table).mark()
            pr, pe = (r1, e1) if first is fut else (r2, e2)
            if pe is not None:
                raise pe
            results.append(pr)
        return results

    def hedge_snapshot(self) -> dict:
        """Cumulative hedge counters + budget state (for /debug/cluster)."""
        with self._hedge_lock:
            return {
                "enabled": self.resilience.hedge_enabled,
                "primaryScatters": self._hedge_primary,
                "hedgesIssued": self._hedge_issued,
                "budgetFraction": self.resilience.hedge_budget_fraction,
            }

    # -- cancellation / running-query registry --------------------------------

    def running_queries(self) -> list[dict]:
        """[{queryId, sql, startMs}] for queries currently executing here."""
        with self._running_lock:
            return [
                {"queryId": qid, "sql": ent["sql"], "startMs": ent["startMs"]}
                for qid, ent in sorted(self._running.items())
            ]

    def cancel_query(self, qid: str) -> bool:
        """Cancel an in-flight query: flip its cancel flag (observed by the
        broker's own gather/reduce loops), fan out to every server (v1
        partials and v2 stage workers check the same flag), and tombstone the
        query's mailboxes so straggler blocks are dropped. Returns whether
        any participant knew the id."""
        with self._running_lock:
            ent = self._running.get(qid)
        found = ent is not None
        if ent is not None:
            ent["deadline"].cancel()
        for srv in self.controller.servers().values():
            cancel = getattr(srv, "cancel_query", None)
            if cancel is None:
                continue
            try:
                found = bool(cancel(qid)) or found
            except Exception:  # pinotlint: disable=deadline-swallow — best-effort cancel fan-out; an unreachable server is already failing the query
                pass
        return found

    def execute(self, sql: str, identity: str | None = None) -> ResultTable:
        import random

        from pinot_tpu_torch.common.metrics import BrokerMeter, BrokerTimer, broker_metrics
        from pinot_tpu_torch.common.trace import TraceContext, start_trace
        from pinot_tpu_torch.query.context import (
            Deadline,
            QueryCancelledError,
            QueryTimeoutError,
            query_option,
        )

        bm = broker_metrics()
        bm.meter(BrokerMeter.QUERIES).mark()
        table = ""
        t_entry = time.perf_counter()
        qid = f"q{next(_request_seq)}"
        deadline: Deadline | None = None
        timeout_ms: float | None = None
        tctx = None
        try:
            # bind-only attribution scope: broker-side samples (parse, plan,
            # scatter wait, reduce) show up under this query id in
            # /debug/pprof; no tracker is registered here (see bind_scope)
            from pinot_tpu_torch.common.accounting import default_accountant

            with bm.timer(BrokerTimer.QUERY_TOTAL).time(), default_accountant.bind_scope(qid):
                stmt, normalized = self._compile(sql)
                raw_timeout = query_option(
                    stmt.options, "timeoutMs", self.resilience.default_timeout_ms
                )
                timeout_ms = float(raw_timeout) if raw_timeout is not None else None
                deadline = Deadline.from_timeout_ms(timeout_ms)
                allow_partial = (
                    str(
                        query_option(
                            stmt.options,
                            "allowPartialResults",
                            self.resilience.allow_partial_results,
                        )
                    ).lower()
                    == "true"
                )
                partial = _PartialState(allow_partial)
                with self._running_lock:
                    self._running[qid] = {
                        "sql": sql,
                        "deadline": deadline,
                        "startMs": time.time() * 1e3,
                    }
                table = getattr(stmt, "from_table", None) or ""
                if self.quota is not None and table:
                    self.quota.acquire(table)
                # admission decision BEFORE any work is enqueued: shed
                # (SchedulerRejectedError -> HTTP 503 + Retry-After) when the
                # projected completion cannot fit the remaining deadline
                # budget, or degrade fan-out when the client allows partials
                from pinot_tpu_torch.common.frontend_obs import active_timeline

                wire_tl = active_timeline()  # HTTP wire timeline, if any
                if self.admission is not None:
                    from pinot_tpu_torch.cluster.admission import DEGRADE

                    t_adm = time.perf_counter()
                    decision = self.admission.decide(
                        table or "_default", deadline=deadline, allow_partial=allow_partial
                    )
                    if wire_tl is not None:
                        wire_tl.record_sub(
                            "admission", (time.perf_counter() - t_adm) * 1e3
                        )
                    if decision == DEGRADE:
                        partial.degrade = True

                t_submit = time.perf_counter()

                def run_query():
                    # dequeue-start minus submit = scheduler queue wait: the
                    # slice of `execute` spent waiting for an admission slot
                    if wire_tl is not None:
                        wire_tl.record_sub(
                            "queueWait", (time.perf_counter() - t_submit) * 1e3
                        )
                    return self._execute(
                        stmt, sql, deadline=deadline, qid=qid, partial=partial,
                        normalized=normalized,
                    )

                def run_admitted():
                    if self.admission is None:
                        return run_query()
                    return self.admission.execute(run_query, table or "_default")

                # result-cache tier, AFTER quota + admission by design: hits
                # still count against quotas and shed/degrade verdicts, but a
                # hit bypasses the scheduler enqueue and the whole scatter
                cache_state = self._cache_key(stmt, table, normalized)
                hit_box = {"hit": False}

                def run_cached():
                    if cache_state is None:
                        return run_admitted()
                    return self._run_cached(cache_state, run_admitted, partial, deadline, hit_box)

                # per-query tracing (Tracing.java + `trace=true` query option):
                # always sampled on trace=true, else probabilistically per
                # ObservabilityConfig.trace_sample_rate (head-based sampling)
                trace_requested = stmt.options.get("trace", "").lower() == "true"
                rate = self.obs_config.trace_sample_rate
                sampled = trace_requested or (rate > 0.0 and random.random() < rate)
                if sampled:
                    tctx = TraceContext.mint()
                    t_start = time.perf_counter()
                    with start_trace(request_id=qid, context=tctx, service="broker") as tr:
                        if wire_tl is not None:
                            # the timeline finishes after the response write:
                            # attaching the trace here lets finish() fold the
                            # COMPLETE wire-phase set (incl. serialize/write/
                            # drain) into phaseTimesMs under http.* keys
                            wire_tl.trace = tr
                        # expose the live trace to attach_alert(): a firing
                        # SLO alert attributable to this request id lands as
                        # a span event while the query is still in flight
                        with self._running_lock:
                            if qid in self._running:
                                self._running[qid]["trace"] = tr
                                self._running[qid]["traceId"] = tctx.trace_id
                        try:
                            result = run_cached()
                        finally:
                            tr.root.duration_ms = (time.perf_counter() - t_start) * 1e3
                            self._store_trace(tr)
                    result.trace_id = tctx.trace_id
                    if trace_requested:
                        result.trace = tr.to_dict()
                else:
                    result = run_cached()
                # a cancel acknowledged mid-flight must not turn into a
                # success: the execution may have raced past every check
                deadline.check("post-execute")
                result.cache_hit = hit_box["hit"]
                if hit_box["hit"]:
                    # a hit's latency is this request's dict lookup, not the
                    # original scatter's wall time
                    result.time_used_ms = (time.perf_counter() - t_entry) * 1e3
            if partial.partial:
                bm.meter(BrokerMeter.PARTIAL_RESPONSES).mark()
                result.partial_result = True
                result.exceptions = list(partial.exceptions)
            if partial.servers_queried:
                result.num_servers_queried = partial.servers_queried
                result.num_servers_responded = partial.servers_responded
            if self.query_logger is not None:
                self.query_logger.log(sql, table, result.time_used_ms, result.num_docs_scanned)
            if table:
                # labelled per-table latency family: the federated scrape
                # merges these into per-table p99 series so SLO objectives
                # can carry per-table overrides
                bm.timer("broker.tableLatencyMs", table=table).update_ms(result.time_used_ms)
            self._log_slow_query(sql, table, result, qid)
            return result
        except Exception as e:
            bm.meter(BrokerMeter.REQUEST_FAILURES).mark()
            if table:
                bm.meter("broker.tableErrors", table=table).mark()
            if isinstance(e, SchedulerRejectedError) or getattr(e, "error_code", None) == QueryErrorCode.QUOTA_EXCEEDED:
                # rejection latency from request entry to the typed raise:
                # the overload bench gates this at <100ms (sheds must be
                # instant verdicts, never queued work that failed late)
                bm.histogram("broker.admission.shedDecisionMs").update_ms(
                    (time.perf_counter() - t_entry) * 1e3
                )
            if tctx is not None and not getattr(e, "trace_id", None):
                e.trace_id = tctx.trace_id  # exemplar id for the error payload
            kill_reason = getattr(e, "kill_reason", None)
            if kill_reason:
                # accountant kills surface structured, not just as message text
                self._log_killed_query(sql, table, qid, kill_reason, getattr(e, "trace_id", None))
            if self.query_logger is not None:
                self.query_logger.log(sql, table, 0.0, 0, exception=type(e).__name__)
            # central outcome mapping: whatever low-level error the deadline or
            # cancel flag surfaced as (mailbox RuntimeError, connection reset,
            # worker error tuple), the caller sees the distinct error class
            if deadline is not None and deadline.cancelled:
                bm.meter(BrokerMeter.QUERIES_CANCELLED).mark()
                if isinstance(e, QueryCancelledError):
                    raise
                raise QueryCancelledError(f"query {qid} cancelled: {e}") from e
            if deadline is not None and deadline.expired:
                bm.meter(BrokerMeter.QUERIES_TIMED_OUT).mark()
                if isinstance(e, QueryTimeoutError):
                    raise
                raise QueryTimeoutError(
                    f"query {qid} timed out after {timeout_ms:.0f}ms: {e}"
                ) from e
            raise
        finally:
            with self._running_lock:
                self._running.pop(qid, None)

    # -- query-cache plane (cluster/result_cache.py) --------------------------

    def _compile(self, sql: str, *, stmt=None, schema=None, table: str | None = None,
                 normalized: str | None = None, epoch=None):
        """The single broker compile choke point — the two formerly duplicated
        `phase_timer(REQUEST_COMPILATION)` sites both route here, so the parse
        and plan caches have exactly one fill path and the phase counter ticks
        only on real compile work (cache hits skip it entirely).

        Parse mode (stmt=None): sql -> (statement, normalized text | None).
        The statement may come from the shared parse cache: treat it as
        immutable (plan mode deep-copies before star expansion).

        Plan mode (stmt given): -> (expanded statement, QueryContext), cached
        per (normalized sql, table, routing epoch); the cached prototype is
        cloned per query with fresh hints/options dicts so per-request state
        (deadline, tenant, trace context) never leaks between queries."""
        import copy

        from pinot_tpu_torch.common.trace import ServerQueryPhase, phase_timer

        def timer():
            return phase_timer(ServerQueryPhase.REQUEST_COMPILATION, role="broker")

        if stmt is None:
            if self.caches is None:
                with timer():
                    return parse_sql(sql), None
            return self.caches.get_or_parse(sql, on_compile=timer)

        if self.caches is None or normalized is None or epoch is None:
            # epoch None with caches on = routing versions unavailable
            # (controller failover): plan uncached rather than risk keying
            # a plan to an unknown routing state
            with timer():
                self._expand_star(stmt, schema)
                return stmt, QueryContext.from_statement(stmt)
        key = (normalized, table, epoch)
        ent = self.caches.get_plan(key)
        if ent is None:
            with timer():
                # the parse-tier statement is shared across requests; star
                # expansion and context building both mutate, so plan on a copy
                pristine = copy.deepcopy(stmt)
                self._expand_star(pristine, schema)
                proto = QueryContext.from_statement(pristine)
            ent = (pristine, proto)
            self.caches.put_plan(key, ent)
        cached_stmt, proto = ent
        ctx = copy.copy(proto)
        ctx.options = dict(proto.options)
        ctx.hints = dict(proto.hints)
        ctx.deadline = None
        return cached_stmt, ctx

    def _cache_key(self, stmt, table: str, normalized: str | None):
        """Result-tier key material: ((normalized sql, option fingerprint),
        version vector, twin table list) or None when caching is off. The
        vector covers every referenced table AND its `_REALTIME` twin — hybrid
        queries route through both halves, so a mutation on either must change
        the key."""
        if self.caches is None or normalized is None:
            return None
        from pinot_tpu_torch.cluster.result_cache import options_fingerprint

        tables = _collect_tables(stmt) or ([table] if table else [])
        if not tables:
            return None
        twins: list[str] = []
        for t in tables:
            twins.append(t)
            if not t.endswith("_REALTIME"):
                twins.append(f"{t}_REALTIME")
        try:
            vv = self.controller.routing_versions(twins)
        except ConnectionError:
            # every controller candidate down (HA failover in progress):
            # degrade to uncached execution — routing state can't be keyed
            # safely, but the query itself only needs servers, not metadata
            return None
        versions = tuple(sorted((t, int(v)) for t, v in vv.items()))
        return (normalized, options_fingerprint(stmt.options)), versions, twins

    def _run_cached(self, cache_state, run_admitted, partial, deadline, hit_box):
        """Result-tier lookup around the admitted execution. Hit: clone the
        cached response (bypassing the scheduler enqueue — quota and admission
        already ruled). Miss: single-flight identical concurrent queries so
        one scatter fills the cache for all, then cache the response only when
        it is complete (partial/degraded/error responses are never cached)."""
        from pinot_tpu_torch.common.trace import trace_event

        key, versions, twins = cache_state
        caches = self.caches

        def hit(value):
            hit_box["hit"] = True
            trace_event("resultCacheHit", entries=len(caches.result))
            return self._clone_result(value)

        cached = caches.result_get(key, versions)
        if cached is not None:
            return hit(cached)

        def fill():
            result = run_admitted()
            if not partial.partial and not result.exceptions:
                caches.result_put(
                    key,
                    self._clone_result(result),
                    versions,
                    realtime=self._has_consuming(twins),
                )
            return result

        if not caches.config.single_flight:
            return fill()
        leader, ev = caches.result_flight.begin((key, versions))
        if not leader:
            budget = deadline.remaining() if deadline is not None else None
            caches.result_flight.wait(ev, timeout=budget if budget is not None else 30.0)
            cached = caches.result_get(key, versions)
            if cached is not None:
                return hit(cached)
            # leader failed, returned partial, or we timed out: run our own
            return run_admitted()
        try:
            return fill()
        finally:
            caches.result_flight.done((key, versions))

    @staticmethod
    def _clone_result(result: ResultTable) -> ResultTable:
        """Detached copy for cache put/get: per-request fields (trace ids,
        exceptions) must not flow between the filling query and later hits.
        Row payloads are shared read-only — nothing mutates rows post-reduce."""
        import copy

        out = copy.copy(result)
        out.exceptions = list(result.exceptions)
        out.trace = None
        out.trace_id = ""
        return out

    def _has_consuming(self, tables) -> bool:
        """Any listed table with an ideal-state segment lacking committed
        metadata (= actively consuming). Those rows advance with no metadata
        write, so cached entries get the realtimeTtlMs freshness cap instead
        of living until the next version bump."""
        for t in tables:
            ideal = self.controller.ideal_state(t)
            if not ideal:
                continue
            meta = self.controller.all_segment_metadata(t)
            if any(s not in meta for s in ideal):
                return True
        return False

    def cache_snapshot(self) -> dict:
        """The GET /debug/cache document."""
        if self.caches is None:
            return {"enabled": False, "config": self.cache_config.to_dict()}
        return self.caches.snapshot()

    def _log_slow_query(self, sql: str, table: str, result: ResultTable, qid: str = "") -> None:
        """Structured slow-query log (the reference's broker query-log WARN
        path for above-threshold queries): one JSON line + ring-buffer entry
        when wall time crosses ObservabilityConfig.slow_query_threshold_ms."""
        if result.time_used_ms < self.obs_config.slow_query_threshold_ms:
            return
        import json
        import logging

        from pinot_tpu_torch.common.accounting import default_accountant

        entry = {
            "sql": sql,
            "table": table,
            "timeMs": round(result.time_used_ms, 3),
            "numDocsScanned": result.num_docs_scanned,
            "numRows": len(result.rows),
            "numSegmentsQueried": result.num_segments_queried,
            "cacheHit": bool(getattr(result, "cache_hit", False)),
            "ts": time.time(),
        }
        if qid:
            # SLO exemplars carry the request id so a firing alert can be
            # attributed back to the query while it is still in flight
            entry["queryId"] = qid
            # device-vs-host split (kernel_obs): the servers re-publish their
            # per-request device ms / peak HBM under the broker's query id
            st = default_accountant.recent_query_stats(qid)
            if st is not None:
                entry["deviceMs"] = st.get("deviceMs", 0.0)
                entry["peakHbmBytes"] = st.get("peakHbmBytes", 0)
        if getattr(result, "scan_profile", None):
            # scan-path attribution: which index class served each predicate,
            # entries examined, and any full-scan fallbacks — "was the slow
            # query slow because it scanned?"
            entry["scanProfile"] = result.scan_profile
        if result.trace_id:
            # exemplar: join the slow-query log entry to /debug/traces/{id}
            entry["traceId"] = result.trace_id
        from pinot_tpu_torch.common.frontend_obs import active_timeline

        wire_tl = active_timeline()
        if wire_tl is not None:
            # wire-phase breakdown gathered so far (bodyRead/parse + the
            # execute sub-phases; serialize/write happen after logging):
            # "was the slow query slow on the engine or on the socket?"
            snap = wire_tl.snapshot()
            entry["wirePhasesMs"] = snap["phasesMs"]
            if snap["subPhasesMs"]:
                entry["wireSubPhasesMs"] = snap["subPhasesMs"]
        self.slow_queries.append(entry)
        logging.getLogger("pinot_tpu_torch.slowquery").warning(json.dumps(entry, sort_keys=True))

    def attach_alert(self, alert: dict) -> dict:
        """Cross-link a controller SLO alert into this broker's observability
        planes (the alert -> trace -> slow-query join, both directions):
        slow-query entries matching the alert's exemplar trace — or, lacking
        one, the alert's table — gain an `alertId` field, and when the
        exemplar's request id or trace id is still in flight with a sampled
        trace, the firing lands as a `slo.alert` span event on the live
        trace. Called in-process by the ClusterMetricsAggregator or via
        POST /debug/alerts/attach."""
        aid = alert.get("id")
        out = {"alertId": aid, "slowQueries": 0, "spanEvents": 0}
        if not aid:
            return out
        ex = alert.get("exemplar") or {}
        tid, rid, table = ex.get("traceId"), ex.get("queryId"), alert.get("table")
        # deque iteration races with concurrent appends; a list copy is
        # stable and the entry dicts are shared so stamping still lands
        for entry in list(self.slow_queries):
            if (tid and entry.get("traceId") == tid) or (
                not tid and table and entry.get("table") == table
            ):
                entry["alertId"] = aid
                out["slowQueries"] += 1
        with self._running_lock:
            running = list(self._running.items())
        for qid, ent in running:
            tr = ent.get("trace")
            if tr is None:
                continue
            if qid == rid or (tid and ent.get("traceId") == tid):
                tr.add_event(
                    "slo.alert",
                    alertId=aid,
                    slo=str(alert.get("slo")),
                    state=str(alert.get("state")),
                    table=str(table or ""),
                )
                out["spanEvents"] += 1
        return out

    def _log_killed_query(self, sql: str, table: str, qid: str, reason: str, trace_id: str | None) -> None:
        """Accountant kills get a structured log entry of their own — the
        killReason would otherwise survive only inside the exception text."""
        import json
        import logging

        entry = {
            "sql": sql,
            "table": table,
            "queryId": qid,
            "killReason": reason,
            "ts": time.time(),
        }
        if trace_id:
            entry["traceId"] = trace_id
        self.slow_queries.append(entry)
        logging.getLogger("pinot_tpu_torch.slowquery").warning(json.dumps(entry, sort_keys=True))

    # -- distributed-trace ring buffer (GET /debug/traces) --------------------

    def _store_trace(self, tr) -> None:
        try:
            doc = tr.assemble()
        except Exception:  # pinotlint: disable=deadline-swallow — trace assembly must never fail the query it observed
            return
        doc["ts"] = time.time()
        with self._traces_lock:
            self.traces.append(doc)

    def recent_traces(self) -> list[dict]:
        """Summaries of the buffered traces, newest last."""
        with self._traces_lock:
            return [
                {
                    "traceId": d.get("traceId", ""),
                    "requestId": d.get("requestId", ""),
                    "numProcesses": len(d.get("resourceSpans", [])),
                    "numSpans": sum(len(rs.get("spans", [])) for rs in d.get("resourceSpans", [])),
                    "ts": d.get("ts"),
                }
                for d in self.traces
            ]

    def get_trace(self, request_id: str) -> dict | None:
        """Full assembled trace by request id or trace id (newest match)."""
        with self._traces_lock:
            for d in reversed(self.traces):
                if d.get("requestId") == request_id or d.get("traceId") == request_id:
                    return d
        return None

    def readiness(self) -> tuple[bool, dict]:
        """(ready, per-component detail) for GET /health/ready. A broker is
        live as soon as its HTTP service binds, but not *ready* until the
        controller answers and at least one server is registered to route to
        (BrokerResourceManager convergence analog)."""
        try:
            servers = self.controller.servers()
            controller_ok, n_servers, err = True, len(servers), ""
        except Exception as e:  # pinotlint: disable=deadline-swallow — readiness probe: an unreachable controller IS the not-ready answer, reported in detail
            controller_ok, n_servers, err = False, 0, f"{type(e).__name__}: {e}"
        components = {
            "controller": {"ok": controller_ok, **({"error": err} if err else {})},
            "servers": {"ok": n_servers > 0, "registered": n_servers},
        }
        return all(c["ok"] for c in components.values()), components

    def shutdown(self) -> None:
        """Stop the admission scheduler's runner threads (idempotent)."""
        if self.admission is not None:
            self.admission.stop()

    def admission_snapshot(self) -> dict:
        """Live admission-plane state for GET /debug/admission."""
        if self.admission is not None:
            snap = self.admission.snapshot()
        else:
            snap = {"role": "broker", "enabled": False, "scheduler": None, "counters": {}}
        snap.setdefault("counters", {})["quotaRejected"] = (
            self.quota.rejected if self.quota is not None else 0
        )
        if self.scheduler_config.tenant_qps:
            snap["tenantQps"] = dict(self.scheduler_config.tenant_qps)
        return snap

    def _degrade_plan(self, plan: dict, partial, table: str) -> dict:
        """Admission degrade: keep the busiest `degrade_keep_fraction` of the
        planned servers and record the skipped segments as a partial-result
        loss — reduced fan-out under overload beats queueing the full plan
        into deadline death. Only active when the admission controller set
        partial.degrade (which requires allowPartialResults)."""
        if partial is None or not partial.degrade or len(plan) <= 1:
            return plan
        import math

        keep_n = max(1, math.ceil(len(plan) * self.scheduler_config.degrade_keep_fraction))
        if keep_n >= len(plan):
            return plan
        ranked = sorted(plan.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        kept = dict(ranked[:keep_n])
        skipped = sum(len(segs) for _, segs in ranked[keep_n:])
        partial.record(
            f"admission degrade under overload: serving {keep_n}/{len(plan)} "
            f"servers for {table}, skipped {skipped} segments",
            error_code=QueryErrorCode.SERVER_OUT_OF_CAPACITY,
        )
        return kept

    def _execute(self, stmt, sql: str, deadline=None, qid=None, partial=None, normalized=None) -> ResultTable:
        t0 = time.perf_counter()
        if getattr(stmt, "explain", False) or getattr(stmt, "explain_analyze", False):
            # failing loudly beats silently executing the query and returning
            # its rows as if they were a plan
            raise ValueError(
                "EXPLAIN PLAN FOR / EXPLAIN ANALYZE are supported on the "
                "embedded engines (QueryEngine / MultistageEngine), not "
                "through the broker yet"
            )
        # v2 engine selection (MultiStageBrokerRequestHandler.java:88 parity):
        # joins/subqueries/set-ops/windows, or explicit SET useMultistageEngine
        use_v2 = stmt.needs_multistage or stmt.options.get("useMultistageEngine", "").lower() == "true"
        if use_v2:
            if self.caches is not None and normalized is not None:
                # the v2 planner mutates the statement; never hand it the
                # shared parse-tier copy
                import copy

                stmt = copy.deepcopy(stmt)
            return self._execute_multistage(stmt, sql, deadline=deadline, qid=qid)
        table = stmt.from_table
        offline_cfg = self.controller.get_table(table)
        rt_name = f"{table}_REALTIME"
        rt_cfg = self.controller.get_table(rt_name) if not table.endswith("_REALTIME") else None
        if offline_cfg is None and rt_cfg is None:
            raise KeyError(f"no such table: {table}")  # BrokerResponse TableDoesNotExist parity
        # broker-tenant gate: a tagged broker serves only tables whose broker
        # tenant it belongs to (BrokerResourceManager routing-table parity)
        if self.tenant_tags is not None:
            from pinot_tpu_torch.cluster.tenancy import broker_tag, table_tenants

            for cfg in (offline_cfg, rt_cfg):  # BOTH halves of a hybrid table
                if cfg is None:
                    continue
                want = broker_tag(table_tenants(cfg)[0])
                if want not in self.tenant_tags:
                    raise PermissionError(
                        f"table {cfg.table_name!r} belongs to broker tenant tag {want!r}; "
                        f"this broker serves {self.tenant_tags}"
                    )
        from pinot_tpu_torch.common.trace import ServerQueryPhase, phase_timer

        schema = self.controller.get_schema(table) or self.controller.get_schema(rt_name)
        # plan epoch: the (offline, realtime) routing versions — schema and
        # segment-set changes both land as bumps, re-keying the cached plan
        epoch = None
        if self.caches is not None and normalized is not None:
            try:
                epoch = tuple(sorted(self.controller.routing_versions([table, rt_name]).items()))
            except ConnectionError:
                # controller failover in progress: plan uncached this round
                epoch = None
        stmt, ctx = self._compile(
            sql, stmt=stmt, schema=schema, table=table, normalized=normalized, epoch=epoch
        )
        ctx.deadline = deadline
        # workload attribution: the table's server tenant rides the hints to
        # every server (accountant rollups) and labels the broker-side meter
        from pinot_tpu_torch.cluster.tenancy import table_tenants
        from pinot_tpu_torch.common.metrics import broker_metrics

        tenant = table_tenants(offline_cfg or rt_cfg)[1]
        ctx.hints["__tenant__"] = tenant
        broker_metrics().meter("broker.tableQueries", table=table, tenant=tenant).mark()
        # the deadline and query id ride the hints dict to every server (so
        # any server-handle shape carries them); servers pop the markers,
        # rebuild a local Deadline, and register it for cancel fan-out
        if deadline is not None and deadline.deadline_ts is not None:
            ctx.hints["__deadlineTs__"] = deadline.deadline_ts
        if qid is not None:
            ctx.hints["__queryId__"] = qid
        from pinot_tpu_torch.common.trace import active_trace

        tr = active_trace()
        if tr is not None and tr.context is not None:
            # rides hints to in-process handles; the HTTP client pops it and
            # sends a real `traceparent` header instead
            ctx.hints["__traceCtx__"] = tr.context.to_dict()

        # legs: (physical table, sql text). Hybrid tables split on the time
        # boundary (TimeBoundaryManager parity): offline <= boundary < realtime
        if offline_cfg is not None and rt_cfg is not None and offline_cfg.time_column:
            from pinot_tpu_torch.cluster.routing import TimeBoundary

            offline_meta = self.controller.all_segment_metadata(table)
            tb = TimeBoundary.compute(offline_meta, offline_cfg.time_column)
            if tb is None:
                legs = [(rt_name, sql)]
            else:
                legs = [(table, tb.offline_sql(sql)), (rt_name, tb.realtime_sql(sql))]
        elif offline_cfg is not None:
            legs = [(table, sql)]
        else:
            legs = [(rt_name, sql)]

        all_meta: dict[str, dict] = {}
        for leg_table, _ in legs:
            all_meta.update(self.controller.all_segment_metadata(leg_table))
        self._compute_hints(ctx, all_meta)

        if ctx.query_type == QueryType.SELECTION and ctx.gapfill is None:
            # plain SELECT: framed streaming with incremental reduce — broker
            # memory stays bounded by (needed rows + one frame), and servers
            # stop producing once the LIMIT is satisfied
            # (StreamingReduceService parity)
            return self._execute_streaming(ctx, legs, all_meta, t0, partial=partial)

        from pinot_tpu_torch.query import scan_stats

        partials, scanned, queried, pruned = [], 0, 0, 0
        scan = scan_stats.new_scan_summary()
        for leg_table, leg_sql in legs:
            if deadline is not None:
                deadline.check(f"scatter {leg_table}")
            p, s, q, pr, leg_scan = self._scatter_leg(ctx, leg_table, leg_sql, partial=partial)
            partials.extend(p)
            scanned += s
            queried += q
            pruned += pr
            scan_stats.merge_scan_summaries(scan, leg_scan)
        if pruned:
            # broker-side routing prunes (min-max metadata / partition) are
            # value-based; server-side reasons arrive via the scan summary
            scan["prunedByReason"]["value"] = scan["prunedByReason"].get("value", 0) + pruned
        by_reason = scan["prunedByReason"]

        with phase_timer(ServerQueryPhase.BROKER_REDUCE, role="broker"):
            rows = QueryEngine.reduce(ctx, partials)
        return build_result(
            ctx,
            rows,
            num_docs_scanned=int(scanned),
            total_docs=sum(m.get("numDocs", 0) for m in all_meta.values()),
            num_segments_queried=queried,
            num_segments_pruned=sum(by_reason.values()),
            num_segments_pruned_by_value=by_reason.get("value", 0),
            num_segments_pruned_by_bloom=by_reason.get("bloom", 0),
            num_segments_pruned_by_geo=by_reason.get("geo", 0),
            num_entries_scanned_in_filter=scan["entriesInFilter"],
            num_entries_scanned_post_filter=scan["entriesPostFilter"],
            scan_profile=scan,
            time_used_ms=(time.perf_counter() - t0) * 1e3,
        )

    def _execute_streaming(self, ctx: QueryContext, legs, all_meta, t0, partial=None) -> ResultTable:
        """Selection-only streaming scatter/gather: all servers stream in
        parallel into one bounded frame queue (memory stays bounded by
        queue depth x frame size); the incremental reduce appends rows and
        signals every stream to stop the moment offset+limit rows are
        gathered. Connection failures fail over to a surviving replica once,
        like the non-streaming scatter; under allowPartialResults a failed
        failover degrades to the rows gathered so far instead of raising."""
        from pinot_tpu_torch.query import scan_stats

        need = ctx.offset + ctx.limit
        rows: list[list] = []
        state = {"scanned": 0, "frames": 0, "scan": scan_stats.new_scan_summary()}
        queried = 0
        pruned = 0
        for leg_table, leg_sql in legs:
            if ctx.deadline is not None:
                ctx.deadline.check(f"stream scatter {leg_table}")
            plan, servers, ideal, n_candidates, leg_pruned = self._route_leg(ctx, leg_table)
            plan = self._degrade_plan(plan, partial, leg_table)
            queried += n_candidates
            pruned += leg_pruned
            hints = dict(ctx.hints)
            failed = self._drain_streams(
                plan, servers, leg_table, leg_sql, hints, need, rows, state,
                deadline=ctx.deadline,
            )
            if partial is not None:
                partial.servers_queried += len(plan)
                partial.servers_responded += len(plan) - len(failed)
            if failed and len(rows) < need:
                # one failover round on surviving replicas (connection-failure
                # parity with _scatter_leg)
                bad = {sid for sid, _, _ in failed}
                retry_segs = [s for _, segs, _ in failed for s in segs]
                retry_ideal = {
                    seg: {s: st for s, st in ideal.get(seg, {}).items() if s not in bad}
                    for seg in retry_segs
                }
                plan2, unroutable = self.selector.select(retry_ideal, retry_segs)
                if unroutable:
                    if partial is None or not partial.allow:
                        raise RuntimeError(
                            f"servers {sorted(bad)} unreachable and no surviving replica for {unroutable}"
                        ) from failed[0][2]
                    partial.record(
                        f"servers {sorted(bad)} unreachable and no surviving "
                        f"replica for {sorted(unroutable)}: {failed[0][2]}"
                    )
                still = self._drain_streams(
                    plan2, servers, leg_table, leg_sql, hints, need, rows, state,
                    deadline=ctx.deadline,
                ) if plan2 else []
                if partial is not None:
                    partial.servers_queried += len(plan2)
                    partial.servers_responded += len(plan2) - len(still)
                if still:
                    if partial is None or not partial.allow:
                        raise RuntimeError(
                            f"streaming retry failed for servers {[sid for sid, _, _ in still]}"
                        ) from still[0][2]
                    for sid, _segs, exc in still:
                        partial.record(f"streaming retry failed for server {sid}: {exc}")
            if len(rows) >= need:
                break
        rows = rows[ctx.offset : need]
        scan = state["scan"]
        if pruned:
            # broker-side routing prunes are value-based (min-max/partition
            # metadata); streamed servers skip pruned segments silently, so
            # only the broker's own count contributes here
            scan["prunedByReason"]["value"] = scan["prunedByReason"].get("value", 0) + pruned
        by_reason = scan["prunedByReason"]
        return build_result(
            ctx,
            rows,
            num_docs_scanned=int(state["scanned"]),
            total_docs=sum(m.get("numDocs", 0) for m in all_meta.values()),
            num_segments_queried=queried,
            num_segments_pruned=sum(by_reason.values()),
            num_segments_pruned_by_value=by_reason.get("value", 0),
            num_segments_pruned_by_bloom=by_reason.get("bloom", 0),
            num_segments_pruned_by_geo=by_reason.get("geo", 0),
            num_entries_scanned_in_filter=scan["entriesInFilter"],
            num_entries_scanned_post_filter=scan["entriesPostFilter"],
            scan_profile=scan,
            num_stream_frames=state["frames"],
            time_used_ms=(time.perf_counter() - t0) * 1e3,
        )

    def _drain_streams(self, plan, servers, table, sql, hints, need, rows, state, deadline=None):
        """Pump every server's stream concurrently into a bounded queue and
        append rows until `need` is reached. Returns [(sid, segs, exc)] for
        servers that failed with a connection-class error; other exceptions
        propagate. The gather loop polls the query deadline so a hung server
        stream cannot wedge the broker thread past expiry."""
        import queue as _queue

        from pinot_tpu_torch.cluster.routing import AdaptiveServerSelector

        if not plan:
            return []
        adaptive = self.selector if isinstance(self.selector, AdaptiveServerSelector) else None
        stop = threading.Event()
        out_q: _queue.Queue = _queue.Queue(maxsize=8)

        def pump(sid, segs):
            srv = servers[sid]
            t0 = time.perf_counter()
            try:
                stream = srv.execute_partials_stream(table, sql, segs, hints, max_rows=need)
                try:
                    for item in stream:
                        if stop.is_set():
                            break
                        while not stop.is_set():
                            try:
                                out_q.put(("frame", item), timeout=0.05)
                                break
                            except _queue.Full:
                                continue
                finally:
                    stream.close()
                if self.failure_detector is not None:
                    self.failure_detector.mark_success(sid)
                if adaptive is not None:
                    adaptive.record(sid, (time.perf_counter() - t0) * 1e3)
                out_q.put(("done", sid))
            except Exception as e:  # pinotlint: disable=deadline-swallow — every branch enqueues e to out_q; the gather loop re-raises it
                if isinstance(e, (RuntimeError, OSError)) and (
                    "unreachable" in str(e) or "truncated" in str(e) or isinstance(e, OSError)
                ):
                    if self.failure_detector is not None:
                        self.failure_detector.mark_failure(sid)
                    out_q.put(("failed", sid, segs, e))
                else:
                    out_q.put(("error", e))

        futures = [self._pool.submit(pump, sid, segs) for sid, segs in plan.items()]
        pending = len(futures)
        failed = []
        error = None
        while pending:
            if deadline is not None:
                try:
                    deadline.check("stream gather")
                except Exception:
                    stop.set()  # release the pumps before surfacing the expiry
                    raise
                try:
                    msg = out_q.get(timeout=0.2)
                except _queue.Empty:
                    continue
            else:
                msg = out_q.get()
            kind = msg[0]
            if kind == "frame":
                item = msg[1]
                frame, matched = item[0], item[1]
                state["frames"] += 1
                state["scanned"] += int(matched)
                # a segment's scan record rides only its first frame (4th
                # element), so chunked segments never double-count
                if len(item) > 3 and item[3] and "scan" in state:
                    from pinot_tpu_torch.query import scan_stats

                    scan_stats.fold_segment_stats(state["scan"], item[3])
                if error is None and isinstance(frame, dict) and frame_len(frame):
                    rows.extend(frame_rows(list(frame.values())))
                if len(rows) >= need:
                    stop.set()
            elif kind == "done":
                pending -= 1
            elif kind == "failed":
                pending -= 1
                failed.append((msg[1], msg[2], msg[3]))
            else:  # hard error: stop the fleet, then raise
                pending -= 1
                stop.set()
                error = msg[1]
        if error is not None:
            raise error
        return failed

    def _route_leg(self, ctx: QueryContext, table: str):
        """Prune on stats/partitions and pick replicas. Returns
        (plan {server: [segments]}, servers, ideal, n_candidates, pruned)."""
        from pinot_tpu_torch.cluster.routing import segment_partitions_match

        meta = self.controller.all_segment_metadata(table)
        ideal = self.controller.ideal_state(table)

        candidates, pruned = [], 0
        for seg_name, m in meta.items():
            if seg_name not in ideal:
                continue
            if segment_can_match(ctx.filter, m.get("stats", {})) and segment_partitions_match(
                ctx.filter, m.get("partitions", {})
            ):
                candidates.append(seg_name)
            else:
                pruned += 1
        # consuming segments have no committed metadata yet: always routed
        candidates.extend(s for s in ideal if s not in meta)

        routable_ideal = (
            self.failure_detector.filter_ideal_state(ideal) if self.failure_detector else ideal
        )
        plan, unroutable = self.selector.select(routable_ideal, candidates)
        if unroutable:
            raise RuntimeError(f"no ONLINE replica for segments: {unroutable}")
        return plan, self.controller.servers(), ideal, len(candidates), pruned

    def _scatter_leg(self, ctx: QueryContext, table: str, sql: str, partial=None):
        """Route + scatter one physical table, re-routing briefly when a
        query lands exactly in a segment-rollover commit window (the routed
        CONSUMING name is transiently unresolvable on a single replica —
        SegmentCompletionManager's commit interval). Connection failures
        fail over to other replicas inside the single attempt."""
        last: RuntimeError | None = None
        for attempt in range(4):
            if ctx.deadline is not None:
                ctx.deadline.check(f"scatter {table}")
            try:
                return self._scatter_leg_once(ctx, table, sql, partial=partial)
            except RuntimeError as e:
                if "does not host segments" not in str(e):
                    raise
                last = e
                time.sleep(0.05 * (attempt + 1))  # commit windows are short
        raise last

    def _scatter_leg_once(self, ctx: QueryContext, table: str, sql: str, partial=None):
        """One route + scatter pass: prune on stats/partitions, select
        replicas (excluding failure-detected servers), fan out, retry
        connection failures on other replicas once. Returns
        (partials, scanned, num_segments_queried, num_segments_pruned,
        scan_summary).
        When `partial` allows it, a failed failover records the loss and the
        reduce proceeds over the partials that did arrive."""
        from pinot_tpu_torch.cluster.routing import AdaptiveServerSelector

        plan, servers, ideal, n_candidates, pruned = self._route_leg(ctx, table)
        plan = self._degrade_plan(plan, partial, table)
        hints = dict(ctx.hints)
        if partial is not None:
            partial.servers_queried += len(plan)

        from pinot_tpu_torch.common.trace import active_trace, run_traced

        trace = active_trace()
        adaptive = self.selector if isinstance(self.selector, AdaptiveServerSelector) else None

        def scatter(item):
            sid, segs = item
            t0 = time.perf_counter()
            try:
                out = run_traced(trace, servers[sid].execute_partials, table, sql, segs, hints)
            except RuntimeError as e:
                # connection-class failures enter the failover/degradation
                # path when a failure detector is watching OR the query opted
                # into partial results; otherwise they stay hard errors
                degradable = self.failure_detector is not None or (
                    partial is not None and partial.allow
                )
                if degradable and "unreachable" in str(e):
                    if self.failure_detector is not None:
                        self.failure_detector.mark_failure(sid)
                    return ("__failed__", sid, segs, e)
                raise
            if self.failure_detector is not None:
                self.failure_detector.mark_success(sid)
            elapsed_ms = (time.perf_counter() - t0) * 1e3
            if adaptive is not None:
                adaptive.record(sid, elapsed_ms)
            self._hedge_record(sid, table, elapsed_ms)
            if len(out[0]) != len(segs):
                # a server silently skipping unhosted segments would mean
                # missing rows; fail loudly instead (partial-response guard)
                raise RuntimeError(
                    f"server {sid} executed {len(out[0])}/{len(segs)} requested segments"
                )
            return out

        results = self._scatter_plan(scatter, plan, ideal, table)
        failed = [r for r in results if isinstance(r, tuple) and r and r[0] == "__failed__"]
        results = [r for r in results if not (isinstance(r, tuple) and r and r[0] == "__failed__")]
        if partial is not None:
            partial.servers_responded += len(plan) - len(failed)
        if failed:
            # one retry round on surviving replicas (connection-failure
            # failover; a second failure is a hard error — or, under
            # allowPartialResults, a recorded loss)
            bad_servers = {f[1] for f in failed}
            retry_segs = [s for f in failed for s in f[2]]
            retry_ideal = {
                seg: {s: st for s, st in ideal.get(seg, {}).items() if s not in bad_servers}
                for seg in retry_segs
            }
            plan2, unroutable2 = self.selector.select(retry_ideal, retry_segs)
            if unroutable2:
                if partial is None or not partial.allow:
                    raise RuntimeError(
                        f"servers {sorted(bad_servers)} unreachable and no surviving replica for {unroutable2}"
                    ) from failed[0][3]
                partial.record(
                    f"servers {sorted(bad_servers)} unreachable and no surviving "
                    f"replica for {sorted(unroutable2)}: {failed[0][3]}"
                )
            retry_results = list(self._pool.map(scatter, plan2.items())) if plan2 else []
            still = [r for r in retry_results if isinstance(r, tuple) and r and r[0] == "__failed__"]
            retry_results = [
                r for r in retry_results if not (isinstance(r, tuple) and r and r[0] == "__failed__")
            ]
            if partial is not None:
                partial.servers_queried += len(plan2)
                partial.servers_responded += len(plan2) - len(still)
            if still:
                if partial is None or not partial.allow:
                    raise RuntimeError(
                        f"retry failed for servers {[f[1] for f in still]}"
                    ) from still[0][3]
                for f in still:
                    partial.record(f"retry failed for server {f[1]}: {f[3]}")
            results.extend(retry_results)

        from pinot_tpu_torch.query import scan_stats

        partials, scanned = [], 0
        scan = scan_stats.new_scan_summary()
        for out in results:
            partials.extend(out[0])
            scanned += out[1]
            # remote servers append their span subtree as a 4th element;
            # in-process handles share our trace and return the bare triple
            if len(out) > 3 and out[3] and trace is not None:
                trace.add_remote(out[3])
            # 5th element: the server's scan-path summary. The hedged path
            # returns only the winning leg's tuple, so stats never double-count.
            if len(out) > 4:
                scan_stats.merge_scan_summaries(scan, out[4])
        return partials, scanned, n_candidates, pruned, scan

    def _execute_multistage(self, stmt, sql: str, deadline=None, qid=None) -> ResultTable:
        """Run the v2 engine over one replica of each segment.

        Reference parity: QueryDispatcher.submitAndReduce
        (pinot-query-runtime/.../QueryDispatcher.java:128). With in-process
        servers the local engine runs over their segment objects, on their
        device. When every participating server is remote (HTTP), the
        reference dispatches the stages to the server processes
        (multistage/distributed.py): that route is ROADMAP A9b."""
        from pinot_tpu_torch.common.trace import InvocationScope

        import zlib

        servers = self.controller.servers()
        schemas: dict[str, list[str]] = {}
        seg_info: dict[str, list] = {}  # table -> [(name, online sids, location)]
        participating: set[str] = set()
        for table in _collect_tables(stmt):
            if self.controller.get_table(table) is None:
                raise KeyError(f"no such table: {table}")
            schema = self.controller.get_schema(table)
            if schema is not None:
                schemas[table] = list(schema.columns)
            info: list = []
            for seg_name, replicas in sorted(self.controller.ideal_state(table).items()):
                online = sorted(
                    sid for sid, st in replicas.items() if st == "ONLINE" and sid in servers
                )
                if not online:
                    continue
                meta = self.controller.segment_metadata(table, seg_name)
                info.append((seg_name, online, (meta or {}).get("location")))
                # the reference's replica spread (crc32, stable across
                # processes): which servers the dispatch would reach
                participating.add(online[zlib.crc32(seg_name.encode()) % len(online)])
            seg_info[table] = info
        if participating and all(getattr(servers[sid], "base_url", None) for sid in participating):
            raise NotImplementedError(
                "distributed multistage dispatch over remote servers (DistributedDispatcher) is ROADMAP A9b"
            )

        from pinot_tpu_torch.multistage import MultistageEngine

        catalog: dict[str, list] = {}
        devices: list = []
        for table, info in seg_info.items():
            segs = []
            for seg_name, online, location in info:
                got = None
                # try EVERY online replica's object, then the deep store —
                # one stale replica must not silently drop the segment
                for sid in online:
                    got = servers[sid].get_segment_object(table, seg_name)
                    if got is not None:
                        devices.append(servers[sid].device)
                        break
                if got is None and location:
                    from pinot_tpu_torch.segment.loader import load_segment

                    got = load_segment(location)
                if got is None:
                    raise RuntimeError(
                        f"segment {table}/{seg_name} unavailable on all replicas "
                        f"{online} and has no deep-store copy"
                    )
                segs.append(got)
            catalog[table] = segs
        # the servers own the device: the engine runs where the segments'
        # servers run theirs
        devices += [h.device for h in servers.values() if hasattr(h, "device")]
        if not devices:
            raise RuntimeError("the in-process multistage route needs an in-process server")
        engine = MultistageEngine(catalog, n_workers=4, schemas=schemas, device=devices[0])
        # per-operator runtime stats surface via result.stage_stats when
        # trace=true; the dispatch-level span bounds the whole v2 execution
        with InvocationScope("multistage:dispatch", tables=list(catalog)) as scope:
            result = engine.execute(sql, stmt=stmt, deadline=deadline)
            scope.set_attr("numRows", len(result.rows))
        return result

    @staticmethod
    def _expand_star(stmt, schema) -> None:
        from pinot_tpu_torch.query.context import expand_star

        expand_star(stmt, schema)

    @staticmethod
    def _compute_hints(ctx: QueryContext, meta: dict[str, dict]) -> None:
        """Global percentile-histogram bounds from controller-stored per-
        segment stats (the broker-side analog of QueryEngine._compute_hints)."""
        for a in ctx.aggregations:
            if a.func != "percentileest" or not isinstance(a.arg, ast.Identifier):
                continue
            los, his = [], []
            ok = bool(meta)
            for m in meta.values():
                s = m.get("stats", {}).get(a.arg.name)
                if s is None or not isinstance(s.get("min"), (int, float)):
                    ok = False
                    break
                los.append(float(s["min"]))
                his.append(float(s["max"]))
            if ok and los:
                ctx.hints.setdefault("est_bounds", {})[a.name] = (min(los), max(his))
