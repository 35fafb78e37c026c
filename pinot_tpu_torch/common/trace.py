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
"""

from __future__ import annotations

import contextvars
import threading
import time
import uuid
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


def active_trace() -> RequestTrace | None:
    return _active.get()


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
    """Span around an operator/kernel invocation. No-op when tracing is off
    (Tracing.java default NoOpTracer parity: near-zero overhead)."""

    __slots__ = ("name", "attrs", "_trace", "_span", "_t0", "_parent")

    def __init__(self, name: str, parent: Span | None = None, **attrs):
        self.name = name
        self.attrs = attrs
        self._parent = parent
        self._trace = _active.get()

    def __enter__(self) -> "InvocationScope":
        if self._trace is not None:
            self._t0 = time.perf_counter()
            self._span = Span(self.name, self._trace.now_ms(), attrs=self.attrs)
        return self

    def set_attr(self, key: str, value) -> None:
        if self._trace is not None:
            self._span.attrs[key] = value

    def __exit__(self, *exc):
        if self._trace is not None:
            self._span.duration_ms = (time.perf_counter() - self._t0) * 1e3
            self._trace.add_span(self._span, self._parent)
        return False


class phase_timer:
    """Times one ServerQueryPhase (TimerContext parity). Records into the
    active trace's phaseTimesMs when tracing is on, and — when `role` is
    given — unconditionally into that role's metrics registry as a
    `<role>.phase.<phase>Ms` Timer, so `/metrics` answers "which phase ate
    the budget" in aggregate even for untraced queries while `/debug/traces`
    answers it per request."""

    def __init__(self, phase: ServerQueryPhase, role: str | None = None):
        self.phase = phase
        self.role = role

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        ms = (time.perf_counter() - self._t0) * 1e3
        tr = _active.get()
        if tr is not None:
            tr.record_phase(self.phase, ms)
        if self.role is not None:
            from pinot_tpu_torch.common.metrics import get_registry

            get_registry(self.role).timer(f"{self.role}.phase.{self.phase.value}Ms").update_ms(ms)
        # fold into the active HTTP wire timeline's sub-phase decomposition
        # (no-op outside an instrumented HTTP request)
        from pinot_tpu_torch.common.frontend_obs import record_timeline_sub

        record_timeline_sub(self.phase.value, ms)
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
