"""Frontend & transport request-lifecycle observability.

The cluster is instrumented down to per-kernel device time (kernel_obs),
yet at high client counts much of a request's latency can sit *outside*
all of it, in the HTTP tier. This module instruments that tier — the
socket-level request lifecycle — so "client minus broker" decomposes into
named milliseconds:

* **PhaseTimeline** — per-request wire-phase breakdown (accept →
  headersRead → bodyRead → parse → execute → serialize → write → drain)
  recorded by the instrumented HTTP handlers in cluster/http.py. Phases
  are *disjoint by construction* (each `mark()` closes the interval since
  the previous mark), so they sum to the request wall time. Broker/server
  internal phases (admission, queueWait, requestCompilation, scatter,
  brokerReduce, schedulerWait, ...) fold in as **sub-phases**: a nested
  decomposition of `execute`, recorded automatically by every
  `phase_timer` that fires while a timeline is active. On finish, phases
  land in the role registry as `<role>.http.phase.<name>Ms` timers and —
  when a trace is attached — in the trace's `phaseTimesMs` under
  `http.<name>` keys.

* **ConnTracker** — connection-plane accounting per HTTP service:
  open/active/idle counts, accepted/refused/reset counters, bytes in/out,
  per-connection requests-served and lifetime (keep-alive efficiency).
  Counts live as plain ints (reset-immune, like ConnectionPool.stats)
  and mirror into the role registry for /metrics exposition.

* **SchedLagProbe** — a heartbeat thread measuring wakeup delay
  (`runtime.schedLagMs`): the direct GIL/thread-starvation signal the
  r15 flamegraph only implied. One probe per process, recording into
  every role registry that registered interest.

* **frontend_snapshot()** — the `GET /debug/frontend` document: live
  connection gauges, per-phase latency histograms, status-code rates and
  scheduling lag, merged per-node into `/debug/cluster` by the
  ClusterMetricsAggregator.

* **attribute_client_gap()** — the bench-side cross-check math: given
  per-request client phase splits (connect/send/TTFB/read) and the
  broker-reported time, attribute the client-minus-broker gap to named
  phases.
"""

from __future__ import annotations

import contextvars
import threading
import time

from pinot_tpu_torch.common.metrics import get_registry

#: canonical top-level wire phases, in lifecycle order. `accept` is the
#: accept()-to-handler-thread delay (first request on a connection only);
#: the rest partition the handler wall from first request byte to flush.
WIRE_PHASES = (
    "accept",
    "headersRead",
    "bodyRead",
    "parse",
    "execute",
    "serialize",
    "write",
    "drain",
    "handler",  # unmarked remainder on non-instrumented endpoints
)

_active_tl: contextvars.ContextVar["PhaseTimeline | None"] = contextvars.ContextVar(
    "pinot_frontend_timeline", default=None
)


def active_timeline() -> "PhaseTimeline | None":
    return _active_tl.get()


def record_timeline_sub(name: str, ms: float) -> None:
    """Fold a nested phase sample into the active request timeline's
    sub-phase decomposition. No-op (one ContextVar read) when no HTTP
    timeline is active — safe on hot paths; called by trace.phase_timer."""
    tl = _active_tl.get()
    if tl is not None:
        tl.record_sub(name, ms)


class PhaseTimeline:
    """Socket-level phase breakdown of one HTTP request.

    `mark(name)` closes the interval since the previous mark and charges it
    to `name` — top-level phases are therefore disjoint and sum to the
    wall time between the timeline epoch and the last mark (the
    completeness invariant tests assert). `record_pre()` charges time that
    happened *before* the epoch (the accept->thread delay); `record_sub()`
    holds the nested decomposition of `execute` (admission, queueWait,
    scatter, reduce, ...) which overlaps top-level phases by design and is
    excluded from the sum-to-wall contract."""

    __slots__ = ("role", "t0", "_last", "_pre_ms", "phases", "sub", "_lock", "_token", "trace")

    def __init__(self, role: str, t0: float | None = None):
        now = time.perf_counter() if t0 is None else t0
        self.role = role
        self.t0 = now
        self._last = now
        self._pre_ms = 0.0
        self.phases: dict[str, float] = {}
        self.sub: dict[str, float] = {}
        # scatter legs / scheduler workers record sub-phases concurrently
        self._lock = threading.Lock()
        self._token = None
        self.trace = None

    # -- recording -----------------------------------------------------------

    def mark(self, name: str, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        ms = (now - self._last) * 1e3
        self._last = now
        if ms < 0.0:
            return
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + ms

    def record_pre(self, name: str, ms: float) -> None:
        """Charge time spent before the timeline epoch (accept delay)."""
        ms = max(0.0, float(ms))
        with self._lock:
            self.phases[name] = self.phases.get(name, 0.0) + ms
            self._pre_ms += ms

    def record_sub(self, name: str, ms: float) -> None:
        with self._lock:
            self.sub[name] = self.sub.get(name, 0.0) + ms

    # -- context activation ---------------------------------------------------

    def activate(self) -> None:
        self._token = _active_tl.set(self)

    def deactivate(self) -> None:
        if self._token is not None:
            _active_tl.reset(self._token)
            self._token = None

    # -- read / finish ---------------------------------------------------------

    def wall_ms(self, now: float | None = None) -> float:
        now = time.perf_counter() if now is None else now
        return (now - self.t0) * 1e3 + self._pre_ms

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "phasesMs": {k: round(v, 3) for k, v in self.phases.items()},
                "subPhasesMs": {k: round(v, 3) for k, v in self.sub.items()},
            }

    def fold_into_trace(self, trace) -> None:
        """Record the wire phases gathered so far into a RequestTrace's
        phaseTimesMs under `http.<name>` keys (the per-request join between
        the transport plane and /debug/traces/{id})."""
        with self._lock:
            phases = dict(self.phases)
        for name, ms in phases.items():
            trace.record_phase_ms(f"http.{name}", ms)

    def finish(self, registry=None) -> dict:
        """Fold every phase (top-level and sub) into labelled
        `<role>.http.phase.<name>Ms` timers plus the whole-request
        `<role>.http.requestMs` timer; returns the snapshot dict."""
        wall = self.wall_ms()
        reg = registry if registry is not None else get_registry(self.role)
        with self._lock:
            phases = dict(self.phases)
            sub = dict(self.sub)
        covered = sum(phases.values())
        if wall - covered > 0.0:
            # unmarked remainder (endpoints without fine-grained marks):
            # keep the sum-to-wall contract by charging it explicitly
            leftover = wall - covered
            phases["handler"] = phases.get("handler", 0.0) + leftover
            with self._lock:
                self.phases["handler"] = phases["handler"]
        prefix = f"{self.role}.http.phase."
        for name, ms in phases.items():
            reg.timer(f"{prefix}{name}Ms").update_ms(ms)
        for name, ms in sub.items():
            reg.timer(f"{prefix}{name}Ms").update_ms(ms)
        reg.timer(f"{self.role}.http.requestMs").update_ms(wall)
        if self.trace is not None:
            self.fold_into_trace(self.trace)
        out = self.snapshot()
        out["wallMs"] = round(wall, 3)
        return out


# ---------------------------------------------------------------------------
# connection-plane accounting
# ---------------------------------------------------------------------------


class ConnTracker:
    """Per-service connection accounting (netty channel-group gauges parity).

    Plain-int counters under one lock (reset-immune, `stats()` like
    ConnectionPool) mirrored into the role registry so /metrics carries the
    same series. `idle` is derived: open connections minus those currently
    inside a request handler."""

    def __init__(self, role: str):
        self.role = role
        self._lock = threading.Lock()
        self.open_conns = 0
        self.active_requests = 0
        self.accepted = 0
        self.refused = 0
        self.resets = 0
        self.closed = 0
        self.requests = 0
        self.bytes_in = 0
        self.bytes_out = 0

    def _reg(self):
        return get_registry(self.role)

    def _mirror_gauges(self) -> None:
        r = self._reg()
        r.gauge(f"{self.role}.http.conn.open").set(self.open_conns)
        r.gauge(f"{self.role}.http.conn.active").set(self.active_requests)
        r.gauge(f"{self.role}.http.conn.idle").set(
            max(0, self.open_conns - self.active_requests)
        )

    def conn_opened(self) -> None:
        with self._lock:
            self.accepted += 1
            self.open_conns += 1
            self._mirror_gauges()
        self._reg().meter(f"{self.role}.http.conn.accepted").mark()

    def conn_closed(self, lifetime_ms: float, requests_served: int) -> None:
        with self._lock:
            self.closed += 1
            self.open_conns = max(0, self.open_conns - 1)
            self._mirror_gauges()
        r = self._reg()
        r.meter(f"{self.role}.http.conn.closed").mark()
        r.histogram(f"{self.role}.http.conn.lifetimeMs").update_ms(lifetime_ms)
        # keep-alive efficiency: requests served per TCP connection (1 =
        # no reuse; the pooled clients should push this well above 1)
        r.histogram(f"{self.role}.http.conn.requestsServed").update_ms(float(requests_served))

    def conn_refused(self) -> None:
        with self._lock:
            self.refused += 1
        self._reg().meter(f"{self.role}.http.conn.refused").mark()

    def conn_reset(self) -> None:
        with self._lock:
            self.resets += 1
        self._reg().meter(f"{self.role}.http.conn.reset").mark()

    def request_started(self) -> None:
        with self._lock:
            self.requests += 1
            self.active_requests += 1
            self._mirror_gauges()

    def request_finished(self, bytes_in: int, bytes_out: int) -> None:
        with self._lock:
            self.active_requests = max(0, self.active_requests - 1)
            self.bytes_in += bytes_in
            self.bytes_out += bytes_out
            self._mirror_gauges()
        r = self._reg()
        if bytes_in:
            r.meter(f"{self.role}.http.bytesIn").mark(bytes_in)
        if bytes_out:
            r.meter(f"{self.role}.http.bytesOut").mark(bytes_out)

    def stats(self) -> dict:
        with self._lock:
            return {
                "open": self.open_conns,
                "active": self.active_requests,
                "idle": max(0, self.open_conns - self.active_requests),
                "accepted": self.accepted,
                "refused": self.refused,
                "reset": self.resets,
                "closed": self.closed,
                "requests": self.requests,
                "bytesIn": self.bytes_in,
                "bytesOut": self.bytes_out,
            }


# ---------------------------------------------------------------------------
# byte-counting stream observers (rfile/wfile wrappers)
# ---------------------------------------------------------------------------


class CountingReader:
    """rfile wrapper: counts bytes and stamps the first-byte arrival per
    request (distinguishes keep-alive idle wait from headersRead time)."""

    __slots__ = ("raw", "total", "_mark", "first_byte_t")

    def __init__(self, raw):
        self.raw = raw
        self.total = 0
        self._mark = 0
        self.first_byte_t = None

    def begin_request(self) -> None:
        self._mark = self.total
        self.first_byte_t = None

    def taken(self) -> int:
        return self.total - self._mark

    def _note(self, n: int) -> None:
        if n:
            if self.first_byte_t is None:
                self.first_byte_t = time.perf_counter()
            self.total += n

    def read(self, *a):
        data = self.raw.read(*a)
        self._note(len(data))
        return data

    def readline(self, *a):
        data = self.raw.readline(*a)
        self._note(len(data))
        return data

    def readinto(self, b):
        n = self.raw.readinto(b)
        self._note(n or 0)
        return n

    def __getattr__(self, name):
        return getattr(self.raw, name)


class CountingWriter:
    """wfile wrapper counting bytes written (response-plane byte meter)."""

    __slots__ = ("raw", "total", "_mark")

    def __init__(self, raw):
        self.raw = raw
        self.total = 0
        self._mark = 0

    def begin_request(self) -> None:
        self._mark = self.total

    def taken(self) -> int:
        return self.total - self._mark

    def write(self, data):
        n = self.raw.write(data)
        self.total += n if n is not None else len(data)
        return n

    def writelines(self, seq):
        seq = list(seq)
        self.raw.writelines(seq)
        self.total += sum(len(s) for s in seq)

    def __getattr__(self, name):
        return getattr(self.raw, name)


# ---------------------------------------------------------------------------
# scheduling-lag probe
# ---------------------------------------------------------------------------


class SchedLagProbe:
    """Heartbeat thread measuring wakeup delay: sleep(interval), compare the
    actual wakeup time against the target, record the overshoot as
    `runtime.schedLagMs`. Under GIL/thread starvation (the r15 frontend
    ceiling) wakeups slip by whole scheduler quanta — this is the direct,
    always-on signal the flamegraph only implied."""

    _instance: "SchedLagProbe | None" = None
    _instance_lock = threading.Lock()

    def __init__(self, interval_s: float = 0.05):
        self.interval_s = interval_s
        self._roles: set[str] = set()
        self._roles_lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def add_role(self, role: str) -> None:
        with self._roles_lock:
            self._roles.add(role)

    def _tick(self, lag_ms: float) -> None:
        """Record one wakeup-delay sample into every registered role's
        registry (separated from the loop for deterministic tests)."""
        lag_ms = max(0.0, lag_ms)
        with self._roles_lock:
            roles = list(self._roles)
        for role in roles:
            r = get_registry(role)
            r.histogram("runtime.schedLagMs").update_ms(lag_ms)
            r.gauge("runtime.schedLagLastMs").set(round(lag_ms, 3))

    def _run(self) -> None:
        while not self._stop.is_set():
            t0 = time.perf_counter()
            if self._stop.wait(self.interval_s):
                break
            self._tick((time.perf_counter() - t0 - self.interval_s) * 1e3)

    def start(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="sched-lag-probe", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    @classmethod
    def ensure(cls, role: str, interval_s: float = 0.05) -> "SchedLagProbe":
        """Process-wide singleton: one heartbeat thread no matter how many
        HTTP services start, recording into every interested role."""
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = SchedLagProbe(interval_s)
        cls._instance.add_role(role)
        cls._instance.start()
        return cls._instance


# ---------------------------------------------------------------------------
# /debug/frontend snapshot
# ---------------------------------------------------------------------------


def _timer_summary(entry: dict) -> dict:
    return {
        "count": entry.get("count", 0),
        "totalMs": round(float(entry.get("totalMs") or 0.0), 3),
        "meanMs": round(float(entry.get("meanMs") or 0.0), 3),
        "p50Ms": round(float(entry.get("p50Ms") or 0.0), 3),
        "p95Ms": round(float(entry.get("p95Ms") or 0.0), 3),
        "p99Ms": round(float(entry.get("p99Ms") or 0.0), 3),
        "maxMs": round(float(entry.get("maxMs") or 0.0), 3),
        "buckets": entry.get("buckets") or [],
    }


def frontend_snapshot(role: str, tracker: ConnTracker | None = None) -> dict:
    """The `GET /debug/frontend` document for one service: connection-plane
    gauges (from the tracker's reset-immune counts when available), the
    per-phase wire timeline histograms, status-code rates, and the
    scheduling-lag probe series."""
    snap = get_registry(role).snapshot()
    prefix = f"{role}.http.phase."
    phases = {}
    for key, entry in snap.items():
        if key.startswith(prefix) and entry.get("type") == "timer":
            name = key[len(prefix):]
            if name.endswith("Ms"):
                name = name[:-2]
            phases[name] = _timer_summary(entry)
    status = {}
    sprefix = f"{role}.http.status{{"
    for key, entry in snap.items():
        if key.startswith(sprefix) and entry.get("type") == "meter":
            code = (entry.get("labels") or {}).get("code", "?")
            status[code] = status.get(code, 0) + int(entry.get("count") or 0)
    if tracker is not None:
        connections = tracker.stats()
    else:
        connections = {
            "open": snap.get(f"{role}.http.conn.open", {}).get("value", 0),
            "active": snap.get(f"{role}.http.conn.active", {}).get("value", 0),
            "idle": snap.get(f"{role}.http.conn.idle", {}).get("value", 0),
            "accepted": snap.get(f"{role}.http.conn.accepted", {}).get("count", 0),
            "refused": snap.get(f"{role}.http.conn.refused", {}).get("count", 0),
            "reset": snap.get(f"{role}.http.conn.reset", {}).get("count", 0),
            "closed": snap.get(f"{role}.http.conn.closed", {}).get("count", 0),
            "requests": snap.get(f"{role}.http.requestMs", {}).get("count", 0),
            "bytesIn": snap.get(f"{role}.http.bytesIn", {}).get("count", 0),
            "bytesOut": snap.get(f"{role}.http.bytesOut", {}).get("count", 0),
        }
    lifetime = snap.get(f"{role}.http.conn.lifetimeMs")
    per_conn = snap.get(f"{role}.http.conn.requestsServed")
    sched = snap.get("runtime.schedLagMs")
    doc = {
        "role": role,
        "connections": connections,
        "keepAlive": {
            "lifetimeMs": _timer_summary(lifetime) if lifetime else None,
            "requestsServed": _timer_summary(per_conn) if per_conn else None,
        },
        "request": _timer_summary(snap.get(f"{role}.http.requestMs") or {}),
        "phases": phases,
        "status": status,
        "schedLag": {
            "count": sched.get("count", 0) if sched else 0,
            "p50Ms": round(float(sched.get("p50Ms") or 0.0), 3) if sched else 0.0,
            "p99Ms": round(float(sched.get("p99Ms") or 0.0), 3) if sched else 0.0,
            "maxMs": round(float(sched.get("maxMs") or 0.0), 3) if sched else 0.0,
            "lastMs": snap.get("runtime.schedLagLastMs", {}).get("value", 0.0),
        },
    }
    return doc


# ---------------------------------------------------------------------------
# client-tail attribution (bench cross-check math)
# ---------------------------------------------------------------------------


def attribute_client_gap(samples: list[dict]) -> dict:
    """Attribute the client-minus-broker latency gap to named phases.

    Each sample carries the client-side split of one request —
    `connectMs` (TCP dial; 0 on a reused keep-alive socket), `sendMs`
    (request write), `ttfbMs` (request sent -> first response byte),
    `readMs` (rest of the body), `wallMs` — plus `brokerMs`, the
    broker-reported server-side time for the same request (timeUsedMs).

    The broker's time is a slice of TTFB, so the client-only share of
    TTFB is `max(0, ttfb - broker)` (accept queue, handler-thread sched,
    wire). Named attribution of the gap `wall - broker`:

        connect + send + (ttfb - broker) + read

    anything left (client-side bookkeeping between the stamps) is
    `otherMs`. `coverage` is the named share of the total gap across all
    samples. `tail` runs the same math over the top 1% of requests by wall
    time."""

    def fold(rows: list[dict]) -> dict:
        gap = conn = send = ttfb_net = read = broker = wall = 0.0
        for s in rows:
            b = min(float(s.get("brokerMs") or 0.0), float(s["ttfbMs"]))
            g = max(0.0, float(s["wallMs"]) - b)
            gap += g
            conn += float(s.get("connectMs") or 0.0)
            send += float(s.get("sendMs") or 0.0)
            ttfb_net += max(0.0, float(s["ttfbMs"]) - b)
            read += float(s.get("readMs") or 0.0)
            broker += b
            wall += float(s["wallMs"])
        named = conn + send + ttfb_net + read
        n = max(1, len(rows))
        return {
            "requests": len(rows),
            "meanWallMs": round(wall / n, 3),
            "meanBrokerMs": round(broker / n, 3),
            "meanGapMs": round(gap / n, 3),
            "attributionMs": {
                "connect": round(conn / n, 3),
                "send": round(send / n, 3),
                "ttfbMinusBroker": round(ttfb_net / n, 3),
                "read": round(read / n, 3),
                "other": round(max(0.0, gap - named) / n, 3),
            },
            "coverage": round(min(1.0, named / gap), 4) if gap > 0 else 1.0,
        }

    if not samples:
        return {"requests": 0, "coverage": 1.0, "overall": fold([]), "tail": fold([])}
    by_wall = sorted(samples, key=lambda s: -float(s["wallMs"]))
    tail_n = max(1, len(samples) // 100)
    overall = fold(samples)
    return {
        "requests": len(samples),
        "coverage": overall["coverage"],
        "overall": overall,
        "tail": fold(by_wall[:tail_n]),
    }
