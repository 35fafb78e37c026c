"""Per-query resource accounting with watermark-based query killing.

Reference parity: pinot-spi/.../accounting/ThreadResourceUsageAccountant +
PerQueryCPUMemAccountantFactory (pinot-core/.../accounting/): worker threads
sample their CPU time and allocated bytes against the query they serve; an
accountant aggregates per query and, when the process crosses a critical
memory watermark, kills the most expensive query (the reference raises
QueryCancelledException inside operator checkpoints — here operators call
`checkpoint()` between segment blocks). The same trackers back the REST debug
endpoints (ThreadResourceTracker/QueryResourceTracker).

The JAX package's `common/accounting.py`. The port's engine checkpoints each
segment at dispatch and at resolve and samples its CPU time and bytes after
it resolves; `kernel_obs` samples the device ms of each kernel launch.
"""

from __future__ import annotations

import contextvars
import threading
import time
from dataclasses import dataclass, field


class QueryKilledError(RuntimeError):
    """Raised inside operator checkpoints when the accountant cancels the
    query (QueryCancelledException parity). Carries the structured
    `kill_reason` so the broker can surface it in error payloads and the
    slow-query log instead of parsing it back out of the message."""

    def __init__(self, message: str, kill_reason: str = ""):
        super().__init__(message)
        self.kill_reason = kill_reason or message


@dataclass
class QueryResourceTracker:
    query_id: str
    start_ts: float = field(default_factory=time.time)
    cpu_ns: int = 0
    allocated_bytes: int = 0
    segments_executed: int = 0
    killed: bool = False
    kill_reason: str = ""
    #: workload-attribution dimensions (reference: table-suffixed metric
    #: names + the tenant tag of PerQueryCPUMemAccountant); "" = unattributed
    table: str = ""
    tenant: str = ""
    #: device-side split (kernel_obs): accelerator ms spent on this query's
    #: kernels and the largest modeled HBM footprint any of them touched
    device_ms: float = 0.0
    peak_hbm_bytes: int = 0

    def to_dict(self) -> dict:
        d = {
            "queryId": self.query_id,
            "cpuTimeNs": self.cpu_ns,
            "allocatedBytes": self.allocated_bytes,
            "segmentsExecuted": self.segments_executed,
            "deviceMs": round(self.device_ms, 3),
            "peakHbmBytes": self.peak_hbm_bytes,
            "ageSec": round(time.time() - self.start_ts, 3),
            "killed": self.killed,
        }
        if self.table:
            d["table"] = self.table
        if self.tenant:
            d["tenant"] = self.tenant
        return d


@dataclass
class WorkloadRollup:
    """Lifetime per-(tenant, table) aggregate, folded in when each query's
    tracker unregisters — the measurement substrate for quota tuning and
    load shedding (ROADMAP item 2)."""

    tenant: str
    table: str
    queries: int = 0
    cpu_ns: int = 0
    allocated_bytes: int = 0
    segments_executed: int = 0
    queries_killed: int = 0
    #: device split: summed accelerator ms; max single-query HBM footprint
    device_ms: float = 0.0
    peak_hbm_bytes: int = 0

    def to_dict(self) -> dict:
        return {
            "tenant": self.tenant,
            "table": self.table,
            "queries": self.queries,
            "cpuTimeNs": self.cpu_ns,
            "allocatedBytes": self.allocated_bytes,
            "segmentsExecuted": self.segments_executed,
            "queriesKilled": self.queries_killed,
            "deviceMs": round(self.device_ms, 3),
            "peakHbmBytes": self.peak_hbm_bytes,
        }


_current_query: contextvars.ContextVar[str | None] = contextvars.ContextVar("pinot_query_id", default=None)


class ResourceAccountant:
    """Aggregates per-query usage; enforces a byte budget across in-flight
    queries. `heap_limit_bytes` is the critical watermark: when total tracked
    allocation exceeds it, the largest query is killed (the reference's
    "kill most expensive query on critical heap usage" policy)."""

    def __init__(self, heap_limit_bytes: int | None = None, per_query_limit_bytes: int | None = None):
        self.heap_limit_bytes = heap_limit_bytes
        self.per_query_limit_bytes = per_query_limit_bytes
        self._queries: dict[str, QueryResourceTracker] = {}
        #: thread ident -> in-flight query id, maintained by bind_thread/
        #: _Scope so an *external* observer (the sampling profiler walking
        #: sys._current_frames()) can attribute any thread's stack to its
        #: query — the contextvar below is only readable from inside the
        #: thread itself
        self._threads: dict[int, str] = {}
        #: (tenant, table) -> lifetime rollup; survives unregister
        self._rollups: dict[tuple[str, str], WorkloadRollup] = {}
        #: query id -> {"deviceMs", "peakHbmBytes"} for recently finished
        #: queries (bounded, insertion-ordered) so the broker can stamp the
        #: device split into slow-query log entries after the tracker is gone
        self._recent: dict[str, dict] = {}
        self._lock = threading.Lock()

    # -- query lifecycle ----------------------------------------------------

    def register(self, query_id: str, table: str = "", tenant: str = "") -> QueryResourceTracker:
        with self._lock:
            tr = self._queries.get(query_id)
            if tr is None:
                tr = QueryResourceTracker(query_id)
                self._queries[query_id] = tr
            if table and not tr.table:
                tr.table = table
            if tenant and not tr.tenant:
                tr.tenant = tenant
            return tr

    def unregister(self, query_id: str) -> None:
        with self._lock:
            tr = self._queries.pop(query_id, None)
            if tr is not None:
                key = (tr.tenant, tr.table)
                r = self._rollups.get(key)
                if r is None:
                    r = self._rollups[key] = WorkloadRollup(tr.tenant, tr.table)
                r.queries += 1
                r.cpu_ns += tr.cpu_ns
                r.allocated_bytes += tr.allocated_bytes
                r.segments_executed += tr.segments_executed
                r.queries_killed += 1 if tr.killed else 0
                r.device_ms += tr.device_ms
                r.peak_hbm_bytes = max(r.peak_hbm_bytes, tr.peak_hbm_bytes)
                self._note_recent_locked(
                    query_id,
                    {"deviceMs": round(tr.device_ms, 3), "peakHbmBytes": tr.peak_hbm_bytes},
                )

    _RECENT_MAX = 256

    def _note_recent_locked(self, query_id: str, stats: dict) -> None:
        self._recent[query_id] = stats
        while len(self._recent) > self._RECENT_MAX:
            self._recent.pop(next(iter(self._recent)))

    def merge_recent(self, query_id: str, stats: dict) -> None:
        """Alias a finished query's device stats under another id (the server
        re-publishes its per-request totals under the broker's query id so
        the broker-side slow-query log can find them; scatter fan-out merges
        by summing ms and maxing HBM)."""
        with self._lock:
            cur = self._recent.get(query_id)
            if cur is None:
                self._note_recent_locked(query_id, dict(stats))
            else:
                cur["deviceMs"] = round(cur.get("deviceMs", 0.0) + stats.get("deviceMs", 0.0), 3)
                cur["peakHbmBytes"] = max(
                    cur.get("peakHbmBytes", 0), stats.get("peakHbmBytes", 0)
                )

    def recent_query_stats(self, query_id: str) -> dict | None:
        """Device split for an in-flight or recently finished query id."""
        with self._lock:
            tr = self._queries.get(query_id)
            if tr is not None:
                return {"deviceMs": round(tr.device_ms, 3), "peakHbmBytes": tr.peak_hbm_bytes}
            st = self._recent.get(query_id)
            return dict(st) if st is not None else None

    # -- thread attribution (read by common/profiler.py) --------------------

    def bind_thread(self, query_id: str, ident: int | None = None) -> None:
        with self._lock:
            self._threads[ident if ident is not None else threading.get_ident()] = query_id

    def unbind_thread(self, ident: int | None = None) -> None:
        with self._lock:
            self._threads.pop(ident if ident is not None else threading.get_ident(), None)

    def thread_bindings(self) -> dict[int, str]:
        """Snapshot of thread ident -> query id (profiler attribution map)."""
        with self._lock:
            return dict(self._threads)

    class _Scope:
        def __init__(self, acct, query_id, table, tenant):
            self._acct = acct
            self._qid = query_id
            self._table = table
            self._tenant = tenant

        def __enter__(self):
            self._token = _current_query.set(self._qid)
            # nesting: remember any outer binding on this thread so exit
            # restores it instead of leaving the thread unattributed
            self._prev = self._acct.thread_bindings().get(threading.get_ident())
            self._acct.bind_thread(self._qid)
            return self._acct.register(self._qid, table=self._table, tenant=self._tenant)

        def __exit__(self, *exc):
            _current_query.reset(self._token)
            if self._prev is not None:
                self._acct.bind_thread(self._prev)
            else:
                self._acct.unbind_thread()
            self._acct.unregister(self._qid)
            return False

    def scope(self, query_id: str, table: str = "", tenant: str = "") -> "_Scope":
        """Context manager: register + bind the query to this thread."""
        return ResourceAccountant._Scope(self, query_id, table, tenant)

    # -- sampling (called by worker threads) --------------------------------

    def sample(self, query_id: str | None = None, cpu_ns: int = 0, allocated_bytes: int = 0, segments: int = 0, device_ms: float = 0.0, hbm_bytes: int = 0) -> None:
        qid = query_id or _current_query.get()
        if qid is None:
            return
        with self._lock:
            tr = self._queries.get(qid)
            if tr is None:
                return
            tr.cpu_ns += cpu_ns
            tr.allocated_bytes += allocated_bytes
            tr.segments_executed += segments
            tr.device_ms += device_ms
            tr.peak_hbm_bytes = max(tr.peak_hbm_bytes, hbm_bytes)
        self._enforce()

    def checkpoint(self, query_id: str | None = None) -> None:
        """Operator checkpoint: raise if this query has been killed
        (Tracing.ThreadAccountantOps.sampleAndCheckInterruption parity)."""
        qid = query_id or _current_query.get()
        if qid is None:
            return
        with self._lock:
            tr = self._queries.get(qid)
            killed = tr is not None and tr.killed
            reason = tr.kill_reason if killed else ""
        if killed:
            from pinot_tpu_torch.common.trace import trace_event

            trace_event("accountant.kill", queryId=qid, reason=reason)
            raise QueryKilledError(f"query {qid} killed: {reason}", kill_reason=reason)

    # -- enforcement --------------------------------------------------------

    def kill(self, query_id: str, reason: str) -> bool:
        with self._lock:
            tr = self._queries.get(query_id)
            if tr is None or tr.killed:
                return False
            tr.killed = True
            tr.kill_reason = reason
            return True

    def _enforce(self) -> None:
        with self._lock:
            live = [t for t in self._queries.values() if not t.killed]
            victims = []
            if self.per_query_limit_bytes is not None:
                for t in live:
                    if t.allocated_bytes > self.per_query_limit_bytes:
                        victims.append((t, f"per-query memory {t.allocated_bytes}B > limit {self.per_query_limit_bytes}B"))
            if self.heap_limit_bytes is not None:
                total = sum(t.allocated_bytes for t in live)
                if total > self.heap_limit_bytes and live:
                    worst = max(live, key=lambda t: t.allocated_bytes)
                    victims.append((worst, f"total memory {total}B > watermark {self.heap_limit_bytes}B; killing most expensive"))
            for t, reason in victims:
                if not t.killed:
                    t.killed = True
                    t.kill_reason = reason
        if victims:
            from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics

            server_metrics().meter(ServerMeter.QUERIES_KILLED).mark(len({id(t) for t, _ in victims}))

    # -- debug endpoints (REST /debug/query/resourceUsage parity) -----------

    def query_trackers(self) -> list[dict]:
        with self._lock:
            return [t.to_dict() for t in self._queries.values()]

    def workload_rollups(self, include_inflight: bool = True) -> list[dict]:
        """Per-(tenant, table) lifetime rollups for GET /debug/workload,
        sorted by cpu_ns descending. With `include_inflight` (the default)
        still-registered queries are folded into a merged view so the
        endpoint answers "who is eating the box *right now*" too."""
        with self._lock:
            merged: dict[tuple[str, str], WorkloadRollup] = {
                k: WorkloadRollup(r.tenant, r.table, r.queries, r.cpu_ns,
                                  r.allocated_bytes, r.segments_executed, r.queries_killed,
                                  r.device_ms, r.peak_hbm_bytes)
                for k, r in self._rollups.items()
            }
            if include_inflight:
                for tr in self._queries.values():
                    key = (tr.tenant, tr.table)
                    r = merged.get(key)
                    if r is None:
                        r = merged[key] = WorkloadRollup(tr.tenant, tr.table)
                    r.queries += 1
                    r.cpu_ns += tr.cpu_ns
                    r.allocated_bytes += tr.allocated_bytes
                    r.segments_executed += tr.segments_executed
                    r.queries_killed += 1 if tr.killed else 0
                    r.device_ms += tr.device_ms
                    r.peak_hbm_bytes = max(r.peak_hbm_bytes, tr.peak_hbm_bytes)
        return [r.to_dict() for r in sorted(merged.values(), key=lambda r: -r.cpu_ns)]

    def reset_rollups(self) -> None:
        """Test hook."""
        with self._lock:
            self._rollups.clear()
            self._recent.clear()


# default process-wide accountant (no limits => tracking only)
default_accountant = ResourceAccountant()
