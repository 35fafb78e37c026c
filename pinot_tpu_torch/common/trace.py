"""Request tracing: distributed context propagation, spans, span events,
per-phase timers, and cluster-wide assembly.

Reference parity: pinot-spi/.../trace/Tracing.java (atomic global Tracer
registration, default no-op), InvocationScope spans around operators,
TraceRunnable-style context propagation across combine threads
(pinot-core/.../util/trace/TraceRunnable.java — here via contextvars; the
query scheduler copies the submitting context so segment spans land under
the right parent), and per-phase timers TimerContext/ServerQueryPhase
(ServerQueryExecutorV1Impl.java:161-166).

This is the JAX package's `common/trace.py` as the v1 cluster path uses
it: the broker mints a W3C-traceparent-shaped `TraceContext` (always under
the `trace=true` query option, else by ObservabilityConfig.trace_sample_rate)
and sends it on every scatter request as the `traceparent` header. Each
process records its own span subtree in a local `RequestTrace`; span starts
are perf_counter offsets from the trace's epoch, and `anchor_wall_ms` (the
wall clock at that epoch) lets the broker shift a remote subtree onto its
own timeline. Server subtrees ride back on the data-path response, and
`RequestTrace.assemble()` flattens them into the one document served at the
broker's `GET /debug/traces/{requestId}`. `trace_event()` adds an event to
the active span (fault-injector hits, deadline checks) and is a no-op with
no trace. The distributed multistage dispatcher carries the context in the
v2 stage-plan envelope, and each server's stage workers send their subtrees
back on the trailing end-of-stream stats relay (multistage/distributed.py).

`InvocationScope` is the one span. It has two sinks:

- the active `RequestTrace` (flat under its root, or under an explicit
  `parent` Span), as above, for `/debug/traces` and EXPLAIN ANALYZE;
- while a torch profiler records, the process-wide span log `SPANS`: name,
  start and end as `time.perf_counter()` seconds (the clock of the
  benchmark's slices, onto which it maps the profiler's device rows), the
  thread, the query's id, the enclosing span's id and the attributes. The
  log is bounded and counts what it drops. While the profiler records, each
  span also opens a `torch.profiler.record_function` range of its name, so
  an exported Chrome trace shows the spans over the device's rows (threads
  other than the profiler's own appear there only under the profiler's
  `profile_all_threads` option).

The gate is the profiler's process-wide flag
(`torch.autograd.profiler._is_profiler_enabled`, set while a profiler
records): `torch.autograd._profiler_enabled()` is the starting thread's
alone and reads False on a query's runner thread. A span that overlaps a
recording interval is logged whole, one that began before the profiler
started or ended after it stopped included: each span reads the clock as
it opens, and one that closes with the profiler off is logged when a span
site saw the profiler recording after it opened (`SpanLog.seen_on`).
Attributes set while a span neither traces nor logs are dropped; a span
logged at its close keeps those given as it opened and those set after
its close (a segment's card time, read once its events have completed).
Off (no request trace, no profiler), a span costs one ContextVar read, one
read of the profiler's flag and one perf_counter read as it opens, two
reads as it closes, and the scope object itself: no Span, no log record,
no lock, no ContextVar set, no record_function (which costs microseconds
even with the profiler off).

Every span of one query carries one query id: the query scheduler mints it
for each job, in the job's copied context (`new_query`), and
`QueryEngine.submit` mints one where no scheduler did (`query_scope`).
"""

from __future__ import annotations

import contextvars
import itertools
import sys
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from enum import Enum


class ServerQueryPhase(Enum):
    REQUEST_DESERIALIZATION = "requestDeserialization"
    TOTAL_QUERY_TIME = "totalQueryTime"
    SEGMENT_PRUNING = "segmentPruning"
    BUILD_QUERY_PLAN = "buildQueryPlan"
    QUERY_PLAN_EXECUTION = "queryPlanExecution"
    RESPONSE_SERIALIZATION = "responseSerialization"
    SCHEDULER_WAIT = "schedulerWait"
    #: device time attributed by kernel_obs (CUDA events around each kernel
    #: launch) — the device-side slice of queryPlanExecution
    DEVICE_EXECUTION = "deviceExecution"
    # broker/transport phases (BrokerQueryPhase parity) — one enum keeps the
    # phaseTimesMs namespace flat across roles
    REQUEST_COMPILATION = "requestCompilation"
    BROKER_REDUCE = "brokerReduce"
    MAILBOX_RECEIVE_WAIT = "mailboxReceiveWait"


@dataclass
class TraceContext:
    """W3C traceparent-shaped propagation context: 32-hex trace id, 16-hex
    parent span id, sampled flag. Immutable per hop; the receiving process
    starts its subtree under `parent_span_id`."""

    trace_id: str
    parent_span_id: str
    sampled: bool = True

    @staticmethod
    def mint() -> "TraceContext":
        return TraceContext(uuid.uuid4().hex, uuid.uuid4().hex[:16], True)

    def to_header(self) -> str:
        # version 00, per https://www.w3.org/TR/trace-context/
        return f"00-{self.trace_id}-{self.parent_span_id}-{'01' if self.sampled else '00'}"

    @staticmethod
    def from_header(header: str) -> "TraceContext | None":
        parts = header.strip().split("-")
        if len(parts) != 4 or len(parts[1]) != 32 or len(parts[2]) != 16:
            return None
        return TraceContext(parts[1], parts[2], parts[3] == "01")

    def to_dict(self) -> dict:
        return {"traceId": self.trace_id, "parentSpanId": self.parent_span_id, "sampled": self.sampled}

    @staticmethod
    def from_dict(d: dict) -> "TraceContext":
        return TraceContext(d["traceId"], d["parentSpanId"], bool(d.get("sampled", True)))


@dataclass
class Span:
    name: str
    start_ms: float
    duration_ms: float = 0.0
    children: list = field(default_factory=list)
    attrs: dict = field(default_factory=dict)
    events: list = field(default_factory=list)

    def add_event(self, name: str, ts_ms: float, attrs: dict | None = None) -> None:
        ev = {"name": name, "tsMs": round(ts_ms, 3)}
        if attrs:
            ev["attrs"] = dict(attrs)
        self.events.append(ev)

    def to_dict(self) -> dict:
        d = {"name": self.name, "startMs": round(self.start_ms, 3), "durationMs": round(self.duration_ms, 3)}
        if self.attrs:
            d["attrs"] = dict(self.attrs)
        if self.events:
            d["events"] = [dict(e) for e in self.events]
        if self.children:
            d["children"] = [c.to_dict() for c in self.children]
        return d


class RequestTrace:
    """Per-request span tree. Thread-safe: combine workers append concurrently.

    One instance per process per traced request: the broker's carries the
    root, each server builds its own and ships `subtree()` back for the
    broker to `add_remote()` and finally `assemble()`.
    """

    def __init__(self, request_id: str = "", context: TraceContext | None = None, service: str = "broker"):
        self.request_id = request_id
        self.context = context
        self.service = service
        self.root = Span("request" if service == "broker" else service, 0.0)
        self._t0 = time.perf_counter()
        # wall clock captured at the same instant as the perf_counter epoch:
        # lets the assembling broker align remote offsets despite clock skew
        self.anchor_wall_ms = time.time() * 1e3
        self._lock = threading.Lock()
        self.phase_ms: dict[str, float] = {}
        self.remote: list[dict] = []

    def now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def add_span(self, span: Span, parent: Span | None = None) -> None:
        with self._lock:
            (parent or self.root).children.append(span)

    def add_event(self, name: str, **attrs) -> None:
        """Record a point-in-time event on the root span (resilience-plane
        moments: retries, deadline hits, fault injections, kills)."""
        with self._lock:
            self.root.add_event(name, self.now_ms(), attrs or None)

    def add_remote(self, subtree: dict) -> None:
        """Attach a span subtree shipped back from another process."""
        if not isinstance(subtree, dict):
            return
        with self._lock:
            self.remote.append(subtree)

    def record_phase(self, phase: ServerQueryPhase, ms: float) -> None:
        with self._lock:
            self.phase_ms[phase.value] = self.phase_ms.get(phase.value, 0.0) + ms

    def record_phase_ms(self, name: str, ms: float) -> None:
        """String-keyed phase recording for phases outside ServerQueryPhase —
        the HTTP wire timeline folds its socket-level phases in here under
        `http.<name>` keys so /debug/traces/{id} shows transport time next
        to engine time."""
        with self._lock:
            self.phase_ms[name] = self.phase_ms.get(name, 0.0) + ms

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "requestId": self.request_id,
                "phaseTimesMs": {k: round(v, 3) for k, v in self.phase_ms.items()},
                "spans": [c.to_dict() for c in self.root.children],
            }
            if self.context is not None:
                d["traceId"] = self.context.trace_id
            if self.root.events:
                d["events"] = [dict(e) for e in self.root.events]
            if self.remote:
                d["processes"] = [dict(r) for r in self.remote]
            return d

    def subtree(self) -> dict:
        """Serializable span subtree for shipping back to the assembler."""
        d = self.to_dict()
        d["service"] = self.service
        d["anchorWallMs"] = round(self.anchor_wall_ms, 3)
        if self.context is not None:
            d["parentSpanId"] = self.context.parent_span_id
        return d

    def assemble(self) -> dict:
        """Flatten local + remote subtrees into one OTLP-flavored document.

        Remote span offsets are shifted by (remote anchor − local anchor) so
        all startMs share the broker's timeline. Span ids are synthetic and
        sequential — stable for a given trace, unique within it.
        """
        seq = [0]

        def next_id() -> str:
            seq[0] += 1
            return f"{seq[0]:016x}"

        def flatten(span_dict: dict, parent_id: str, shift_ms: float, out: list) -> None:
            sid = next_id()
            rec = {
                "spanId": sid,
                "parentSpanId": parent_id,
                "name": span_dict.get("name", ""),
                "startMs": round(span_dict.get("startMs", 0.0) + shift_ms, 3),
                "durationMs": span_dict.get("durationMs", 0.0),
            }
            if span_dict.get("attrs"):
                rec["attrs"] = span_dict["attrs"]
            if span_dict.get("events"):
                rec["events"] = [
                    {**e, "tsMs": round(e.get("tsMs", 0.0) + shift_ms, 3)} for e in span_dict["events"]
                ]
            out.append(rec)
            for child in span_dict.get("children", ()):
                flatten(child, sid, shift_ms, out)

        with self._lock:
            root_id = self.context.parent_span_id if self.context is not None else next_id()
            local_spans: list[dict] = [
                {
                    "spanId": root_id,
                    "parentSpanId": "",
                    "name": self.root.name,
                    "startMs": 0.0,
                    "durationMs": round(self.root.duration_ms, 3),
                }
            ]
            if self.root.events:
                local_spans[0]["events"] = [dict(e) for e in self.root.events]
            for child in self.root.children:
                flatten(child.to_dict(), root_id, 0.0, local_spans)
            resource_spans = [
                {
                    "resource": {"service.name": self.service},
                    "phaseTimesMs": {k: round(v, 3) for k, v in self.phase_ms.items()},
                    "spans": local_spans,
                }
            ]
            remote = [dict(r) for r in self.remote]

        for sub in remote:
            shift = float(sub.get("anchorWallMs", self.anchor_wall_ms)) - self.anchor_wall_ms
            parent = sub.get("parentSpanId") or root_id
            spans: list[dict] = []
            sub_root_id = next_id()
            rec = {
                "spanId": sub_root_id,
                "parentSpanId": parent,
                "name": sub.get("service", "remote"),
                "startMs": round(shift, 3),
                "durationMs": 0.0,
            }
            if sub.get("events"):
                rec["events"] = [
                    {**e, "tsMs": round(e.get("tsMs", 0.0) + shift, 3)} for e in sub["events"]
                ]
            spans.append(rec)
            for child in sub.get("spans", ()):
                flatten(child, sub_root_id, shift, spans)
            resource_spans.append(
                {
                    "resource": {"service.name": sub.get("service", "remote")},
                    "phaseTimesMs": sub.get("phaseTimesMs", {}),
                    "spans": spans,
                }
            )

        return {
            "traceId": self.context.trace_id if self.context is not None else "",
            "requestId": self.request_id,
            "resourceSpans": resource_spans,
        }


# active trace for the current execution context (None = tracing disabled,
# the no-op default). contextvars gives TraceRunnable-style propagation into
# threads when callers copy_context() (the query scheduler snapshots the
# submitting context per job; ad-hoc worker threads use run_traced).
_active: contextvars.ContextVar[RequestTrace | None] = contextvars.ContextVar("pinot_trace", default=None)

# the query this context's spans belong to, and the innermost span of this
# context that records (a trace's or the log's)
_query: contextvars.ContextVar[int | None] = contextvars.ContextVar("pinot_query", default=None)
_current: contextvars.ContextVar["InvocationScope | None"] = contextvars.ContextVar("pinot_span", default=None)
_query_ids = itertools.count(1)
_span_ids = itertools.count(1)


def active_trace() -> RequestTrace | None:
    return _active.get()


def profiling() -> bool:
    """Whether a torch profiler records now, in any thread (its own flag,
    set from its start to its stop; False where torch was never imported)."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and getattr(prof, "_is_profiler_enabled", False)


@dataclass(slots=True)
class SpanRecord:
    """One span of the log: `start` and `end` are time.perf_counter()
    seconds, `thread` the recording thread's ident, `query` the query's id,
    `parent` the enclosing span's id (None where none recorded as it
    opened)."""

    name: str
    start: float
    end: float
    thread: int
    query: int | None
    id: int
    parent: int | None
    attrs: dict


class SpanLog:
    """The spans recorded while a torch profiler records, process-wide: the
    last CAPACITY kept, the older ones dropped and counted in `dropped`."""

    CAPACITY = 1 << 16

    def __init__(self):
        self.dropped = 0
        #: the latest perf_counter time a span site saw the profiler recording
        self.seen_on = float("-inf")
        self._lock = threading.Lock()
        self._records: deque = deque(maxlen=self.CAPACITY)

    def add(self, rec: SpanRecord) -> None:
        with self._lock:
            if len(self._records) == self.CAPACITY:
                self.dropped += 1
            self._records.append(rec)

    def records(self) -> list[SpanRecord]:
        with self._lock:
            return list(self._records)


#: the process's span log
SPANS = SpanLog()


def _log(name: str, start: float, end: float, span_id: int, parent: int | None, attrs: dict) -> SpanRecord:
    if end > SPANS.seen_on and profiling():
        SPANS.seen_on = end
    rec = SpanRecord(name, start, end, threading.get_ident(), _query.get(), span_id, parent, attrs)
    SPANS.add(rec)
    return rec


def new_query() -> None:
    """Give this context a new query id (the scheduler runs it in a job's
    own copied context)."""
    _query.set(next(_query_ids))


class query_scope:
    """The block runs under query id `qid`, or under this context's, or
    under a new one; `as` gives the id."""

    __slots__ = ("id", "_token")

    def __init__(self, qid: int | None = None):
        self.id = qid
        self._token = None

    def __enter__(self) -> int:
        current = _query.get()
        if self.id is None:
            self.id = current if current is not None else next(_query_ids)
        if current != self.id:
            self._token = _query.set(self.id)
        return self.id

    def __exit__(self, *exc):
        if self._token is not None:
            _query.reset(self._token)
            self._token = None
        return False


def trace_event(name: str, **attrs) -> None:
    """Record a point-in-time event on the active trace's root span.
    No-op (one ContextVar read) when tracing is off — safe on hot paths."""
    tr = _active.get()
    if tr is not None:
        tr.add_event(name, **attrs)


class start_trace:
    """Context manager enabling tracing for the dynamic extent of a request."""

    def __init__(self, request_id: str = "", context: TraceContext | None = None, service: str = "broker"):
        self.trace = RequestTrace(request_id, context=context, service=service)

    def __enter__(self) -> RequestTrace:
        self._token = _active.set(self.trace)
        return self.trace

    def __exit__(self, *exc):
        _active.reset(self._token)
        return False


class InvocationScope:
    """A span around an operator, a layer's step or a kernel invocation,
    recorded into the active trace and, while a profiler records, into
    SPANS (module docstring). No-op when tracing is off (Tracing.java
    default NoOpTracer parity)."""

    __slots__ = ("name", "attrs", "_parent", "_trace", "_span", "_t0", "_token", "_rf", "_id", "_up", "_rec")

    def __init__(self, name: str, parent: Span | None = None, **attrs):
        self.name = name
        self.attrs = attrs
        self._parent = parent
        self._trace = _active.get()

    def __enter__(self) -> "InvocationScope":
        on = profiling()
        self._token = self._rec = None
        if on or self._trace is not None:
            self._open(on)
        else:
            self._t0 = time.perf_counter()
        return self

    def _open(self, on: bool) -> None:
        up = _current.get()
        self._id = next(_span_ids)
        self._up = up._id if up is not None else None
        self._token = _current.set(self)
        self._rf = None
        if on:
            self._rf = sys.modules["torch.autograd.profiler"].record_function(self.name)
            self._rf.__enter__()
        # read next to the range's own start (and, closing, its end)
        self._t0 = time.perf_counter()
        if on and self._t0 > SPANS.seen_on:
            SPANS.seen_on = self._t0
        if self._trace is not None:
            self._span = Span(self.name, (self._t0 - self._trace._t0) * 1e3, attrs=self.attrs)

    def set_attr(self, key: str, value) -> None:
        """Set an attribute (dropped where the span neither traces nor logs;
        after its close it still reaches its trace span and log record)."""
        if self._token is not None or self._rec is not None:
            self.attrs[key] = value

    def __exit__(self, *exc):
        if self._token is None:
            if not profiling() and SPANS.seen_on < self._t0:
                return False
            # the profiler recorded during the span: logged whole
            self._rec = _log(self.name, self._t0, time.perf_counter(), next(_span_ids), None, self.attrs)
            return False
        end = time.perf_counter()
        if self._rf is not None:
            self._rf.__exit__(None, None, None)
        _current.reset(self._token)
        if self._trace is not None:
            self._span.duration_ms = (end - self._t0) * 1e3
            self._trace.add_span(self._span, self._parent)
        if self._rf is not None or profiling() or SPANS.seen_on >= self._t0:
            self._rec = _log(self.name, self._t0, end, self._id, self._up, self.attrs)
        return False


def span_attr(key: str, value) -> None:
    """Set an attribute of this context's innermost recording span (no-op,
    one ContextVar read, where none records)."""
    scope = _current.get()
    if scope is not None:
        scope.attrs[key] = value


def record_span(name: str, start: float, end: float, **attrs) -> None:
    """Record a span whose start the recording code did not see (a job's
    wait for its runner, from its enqueue), into the active trace and, where
    a profiler recorded during it, the log; it has no record_function
    range. Off it reads one ContextVar, the profiler's flag and
    `SpanLog.seen_on`."""
    tr = _active.get()
    logged = profiling() or SPANS.seen_on >= start
    if tr is not None:
        tr.add_span(Span(name, (start - tr._t0) * 1e3, (end - start) * 1e3, attrs=attrs))
    if logged:
        up = _current.get()
        _log(name, start, end, next(_span_ids), up._id if up is not None else None, attrs)


def record_phase(phase: ServerQueryPhase, ms: float, role: str | None = None) -> None:
    """Fold `ms` of `phase` into the active trace's phaseTimesMs, the active
    HTTP wire timeline's sub-phases (a no-op outside an instrumented HTTP
    request) and, with `role`, that role's `<role>.phase.<phase>Ms` Timer,
    which /metrics exports for untraced queries too."""
    tr = _active.get()
    if tr is not None:
        tr.record_phase(phase, ms)
    if role is not None:
        from pinot_tpu_torch.common.metrics import get_registry

        get_registry(role).timer(f"{role}.phase.{phase.value}Ms").update_ms(ms)
    from pinot_tpu_torch.common.frontend_obs import record_timeline_sub

    record_timeline_sub(phase.value, ms)


class phase_timer:
    """Times one ServerQueryPhase (TimerContext parity) into
    `record_phase`: the active trace's phaseTimesMs when tracing is on, and
    — when `role` is given — unconditionally that role's metrics registry,
    so `/metrics` answers "which phase ate the budget" in aggregate even for
    untraced queries while `/debug/traces` answers it per request."""

    def __init__(self, phase: ServerQueryPhase, role: str | None = None):
        self.phase = phase
        self.role = role

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        record_phase(self.phase, (time.perf_counter() - self._t0) * 1e3, self.role)
        return False


def run_traced(trace: RequestTrace | None, fn, *args, **kwargs):
    """Run fn with `trace` active — the TraceRunnable analog for worker
    threads that did not inherit the submitting context."""
    if trace is None:
        return fn(*args, **kwargs)
    ctx = contextvars.copy_context()

    def _inner():
        _active.set(trace)
        return fn(*args, **kwargs)

    return ctx.run(_inner)
