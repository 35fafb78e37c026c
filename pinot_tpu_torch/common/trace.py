"""Request tracing: spans, span events and per-phase timers.

Reference parity: pinot-spi/.../trace/Tracing.java (default no-op tracer),
InvocationScope spans around operators, TraceRunnable-style context
propagation across worker threads (here contextvars: the query scheduler
copies the submitting context, so segment spans land under the right
request) and the per-phase timers TimerContext / ServerQueryPhase
(ServerQueryExecutorV1Impl.java:161-166).

This is the JAX package's `common/trace.py` for one process: a
`RequestTrace` holds the span tree of one request, `start_trace` makes it
the active trace, `InvocationScope` adds a span, `trace_event` a
point-in-time event on the root span, and `phase_timer` a phase time. The
W3C traceparent context, the cross-process assembly and the HTTP wire
timeline come with the server and broker processes.
"""

from __future__ import annotations

import contextvars
import threading
import time
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
    REQUEST_COMPILATION = "requestCompilation"
    BROKER_REDUCE = "brokerReduce"
    MAILBOX_RECEIVE_WAIT = "mailboxReceiveWait"


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
    """Per-request span tree. Thread-safe: workers append concurrently."""

    def __init__(self, request_id: str = "", service: str = "broker"):
        self.request_id = request_id
        self.service = service
        self.root = Span("request" if service == "broker" else service, 0.0)
        self._t0 = time.perf_counter()
        self._lock = threading.Lock()
        self.phase_ms: dict[str, float] = {}

    def now_ms(self) -> float:
        return (time.perf_counter() - self._t0) * 1e3

    def add_span(self, span: Span, parent: Span | None = None) -> None:
        with self._lock:
            (parent or self.root).children.append(span)

    def add_event(self, name: str, **attrs) -> None:
        """Record a point-in-time event on the root span (retries, deadline
        hits, fault injections, kills, kernel launches)."""
        with self._lock:
            self.root.add_event(name, self.now_ms(), attrs or None)

    def record_phase(self, phase: ServerQueryPhase, ms: float) -> None:
        with self._lock:
            self.phase_ms[phase.value] = self.phase_ms.get(phase.value, 0.0) + ms

    def to_dict(self) -> dict:
        with self._lock:
            d = {
                "requestId": self.request_id,
                "phaseTimesMs": {k: round(v, 3) for k, v in self.phase_ms.items()},
                "spans": [c.to_dict() for c in self.root.children],
            }
            if self.root.events:
                d["events"] = [dict(e) for e in self.root.events]
            return d


# active trace of the current execution context (None = tracing off, the
# no-op default); contextvars carry it into scheduler runner threads, which
# run each job in a copy of the submitting context
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

    def __init__(self, request_id: str = "", service: str = "broker"):
        self.trace = RequestTrace(request_id, service=service)

    def __enter__(self) -> RequestTrace:
        self._token = _active.set(self.trace)
        return self.trace

    def __exit__(self, *exc):
        _active.reset(self._token)
        return False


class InvocationScope:
    """Span around an operator invocation. No-op when tracing is off."""

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
    """Times one ServerQueryPhase (TimerContext parity): into the active
    trace's phaseTimesMs when tracing is on, and, when `role` is given,
    always into that role's registry as a `<role>.phase.<phase>Ms` Timer."""

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
        return False
