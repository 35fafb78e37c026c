"""HTTP data/control plane for multi-process clusters (the DCN tier).

Reference parity: Pinot's network split — broker REST SQL endpoint
(POST /query/sql), controller REST (pinot-controller/.../api/resources/),
and the broker<->server data plane (Netty/thrift InstanceRequest,
pinot-core/.../transport/InstanceRequestHandler.java:69). Here each role
exposes a ThreadingHTTPServer; the broker->server hop carries
{table, sql, segments, hints} JSON and returns DataTable-encoded partials
(the DataTableImplV4 bytes analog — a versioned pure-data wire format,
never pickle). All client roles (scatter, mailbox sender, controller
proxy) share the keep-alive connection pool in common/wire.py, and
handlers speak HTTP/1.1 so one TCP connection carries many requests.
Intra-pod device collectives (parallel/mesh.py) stay out of this tier.

Every role of the port is served here: the broker (with the time-series
endpoint POST /timeseries/api/v1/query_range), the server (with the
multistage /mailbox and /multistage/submit endpoints the distributed stages
ride), and the controller's REST service with its client
(RemoteControllerClient), which a broker in its own process routes through.
"""

from __future__ import annotations

import json
import socket
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import TYPE_CHECKING
from urllib.parse import urlsplit

from pinot_tpu_torch.cluster.controller import Controller
from pinot_tpu_torch.common import datatable
from pinot_tpu_torch.common.errors import QueryErrorCode, code_of, http_status_of, retry_after_of
from pinot_tpu_torch.common.frontend_obs import (
    ConnTracker,
    CountingReader,
    CountingWriter,
    PhaseTimeline,
    SchedLagProbe,
    active_timeline,
    frontend_snapshot,
)
from pinot_tpu_torch.common.wire import FRAME_END, FRAME_ERR, get_pool, read_exact

if TYPE_CHECKING:  # the server and the broker load torch; a controller process imports neither
    from pinot_tpu_torch.cluster.broker import Broker
    from pinot_tpu_torch.cluster.server import Server


def _host_port(base_url: str) -> tuple[str, int]:
    u = urlsplit(base_url)
    return u.hostname or "127.0.0.1", u.port or (443 if u.scheme == "https" else 80)


def _frontend_role(service_obj, role: str) -> str | None:
    """The observability role for a service's HTTP plane, or None when
    ObservabilityConfig.frontend_obs_enabled is off for the owning broker
    (servers/controllers without a config default to instrumented)."""
    cfg = getattr(service_obj, "obs_config", None)
    return role if getattr(cfg, "frontend_obs_enabled", True) else None


def _tl_mark(name: str) -> None:
    """Close the current wire-phase interval on the active request timeline
    (no-op when the frontend plane is off)."""
    tl = active_timeline()
    if tl is not None:
        tl.mark(name)


def _serve(
    handler_cls, port: int, role: str | None = None
) -> tuple[ThreadingHTTPServer, int, threading.Thread]:
    class _Server(ThreadingHTTPServer):
        # socketserver's default accept backlog of 5 refuses connections the
        # moment 100s of clients connect at once (bench.py qps drives 128+);
        # a deep backlog lets the thread-per-request model absorb the burst
        request_queue_size = 256

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self._live_conns: set = set()
            self._conn_lock = threading.Lock()
            self._obs_role = role
            self._conn_tracker = ConnTracker(role) if role is not None else None
            # accept() timestamps keyed by socket, consumed by the handler's
            # setup(): measures accept->handler-thread dispatch delay
            self._accept_ts: dict = {}

        def process_request(self, request, client_address):
            with self._conn_lock:
                self._live_conns.add(request)
                if self._conn_tracker is not None:
                    self._accept_ts[request] = time.perf_counter()
            try:
                super().process_request(request, client_address)
            except Exception:
                # the accept succeeded but the socket never reached a
                # handler thread (thread-spawn failure under load): that is
                # a refused connection — count it before socketserver's
                # handle_error/shutdown_request cleanup
                if self._conn_tracker is not None:
                    self._conn_tracker.conn_refused()
                raise

        def shutdown_request(self, request):
            with self._conn_lock:
                self._live_conns.discard(request)
                self._accept_ts.pop(request, None)
            super().shutdown_request(request)

        def handle_error(self, request, client_address):
            # peer aborts (RST mid-request, write to a closed socket) are an
            # accounting event on the connection plane, not a crash worth a
            # stderr traceback
            exc = sys.exc_info()[1]
            if isinstance(exc, (ConnectionError, TimeoutError)):
                if self._conn_tracker is not None:
                    self._conn_tracker.conn_reset()
                return
            super().handle_error(request, client_address)

        def shutdown(self):
            # stop the accept loop, then force-close accepted keep-alive
            # sockets: their daemon handler threads otherwise block in
            # readline() forever, and a pooled client holding the other
            # end would see an ESTABLISHED socket to a dead service
            # instead of the FIN that triggers health eviction
            super().shutdown()
            self.server_close()
            with self._conn_lock:
                conns = list(self._live_conns)
                self._live_conns.clear()
            for s in conns:
                try:
                    s.shutdown(socket.SHUT_RDWR)
                except OSError:
                    pass

    # HTTP/1.1 keep-alive: pooled clients reuse one TCP connection across
    # requests. Every handler sends Content-Length (or Connection: close on
    # the unbounded /query/stream), so persistent framing is well-defined.
    handler_cls.protocol_version = "HTTP/1.1"
    # TCP_NODELAY: gather-written iovec responses are multiple small sends
    # per response; on a persistent connection Nagle would stall each one
    # behind the peer's delayed ACK
    handler_cls.disable_nagle_algorithm = True
    httpd = _Server(("127.0.0.1", port), handler_cls)
    if role is not None:
        # one heartbeat thread per process no matter how many services start
        SchedLagProbe.ensure(role)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return httpd, httpd.server_address[1], t


class _InstrumentedHandler(BaseHTTPRequestHandler):
    """BaseHTTPRequestHandler with the request-lifecycle observability plane
    woven into the stdlib hooks (no-op passthrough when the owning _Server
    carries no ConnTracker):

    * setup()              — connection accounting + byte-counting rfile/wfile
    * parse_request()      — starts the PhaseTimeline at the request's first
                             byte (keep-alive idle excluded), marks
                             `headersRead`, charges the accept->thread
                             dispatch delay to the first request
    * handle_one_request() — finishes the timeline (drain/handler remainder),
                             folds phases into `<role>.http.phase.*` timers,
                             counts peer resets instead of raising
    * send_response()      — `<role>.http.status{code=}` labelled meters
    * finish()             — connection lifetime + requests-served histograms

    Hot endpoints (broker /query/sql, server /query) add the finer
    bodyRead/parse/execute/serialize/write marks via `_tl_mark`."""

    def setup(self):
        super().setup()
        tracker = getattr(self.server, "_conn_tracker", None)
        self._fe_tracker = tracker
        self._fe_tl = None
        self._fe_started = False
        if tracker is None:
            return
        self.rfile = CountingReader(self.rfile)
        self.wfile = CountingWriter(self.wfile)
        self._fe_conn_t0 = time.perf_counter()
        self._fe_requests = 0
        self._fe_first = True
        with self.server._conn_lock:
            accept_t = self.server._accept_ts.pop(self.request, None)
        # accept -> handler-thread dispatch delay: the thread-per-connection
        # starvation signal, charged to the first request's `accept` phase
        self._fe_accept_ms = (
            (self._fe_conn_t0 - accept_t) * 1e3 if accept_t is not None else 0.0
        )
        tracker.conn_opened()

    def parse_request(self):
        tracker = self._fe_tracker
        if tracker is None:
            return super().parse_request()
        # timeline epoch = first byte of this request, so keep-alive idle and
        # client think time never pollute the request wall
        t0 = self.rfile.first_byte_t
        tl = PhaseTimeline(self.server._obs_role, t0=t0)
        if self._fe_first:
            self._fe_first = False
            tl.record_pre("accept", self._fe_accept_ms)
        self._fe_tl = tl
        tl.activate()
        ok = super().parse_request()
        tl.mark("headersRead")
        if ok:
            self._fe_requests += 1
            self._fe_started = True
            tracker.request_started()
        return ok

    def handle_one_request(self):
        tracker = self._fe_tracker
        if tracker is None:
            super().handle_one_request()
            return
        self.rfile.begin_request()
        self.wfile.begin_request()
        try:
            super().handle_one_request()
        except (ConnectionError, TimeoutError):
            # peer reset / write to a closed socket mid-request: count it
            # and end the keep-alive loop instead of letting the handler
            # thread die with a traceback
            tracker.conn_reset()
            self.close_connection = True
        finally:
            tl = self._fe_tl
            if tl is not None:
                self._fe_tl = None
                # instrumented endpoints marked `write` already: the rest is
                # the post-handler flush (drain). Coarse endpoints charge
                # everything since headersRead to `handler`.
                tl.mark("drain" if "write" in tl.phases else "handler")
                tl.deactivate()
                tl.finish()
            if self._fe_started:
                self._fe_started = False
                tracker.request_finished(self.rfile.taken(), self.wfile.taken())

    def send_response(self, code, message=None):
        role = getattr(self.server, "_obs_role", None)
        if role is not None:
            from pinot_tpu_torch.common.metrics import get_registry

            get_registry(role).meter(f"{role}.http.status", code=str(code)).mark()
        super().send_response(code, message)

    def finish(self):
        try:
            super().finish()
        finally:
            tracker = getattr(self, "_fe_tracker", None)
            if tracker is not None:
                self._fe_tracker = None
                tracker.conn_closed(
                    (time.perf_counter() - self._fe_conn_t0) * 1e3, self._fe_requests
                )


def _serve_metrics(handler, registry) -> None:
    """GET /metrics: Prometheus text exposition 0.0.4 by default (the
    jmx_exporter scrape surface); `?format=json` or an application/json
    Accept header keeps the legacy structured snapshot."""
    from pinot_tpu_torch.common.metrics import PROMETHEUS_CONTENT_TYPE, prometheus_text

    query = handler.path.partition("?")[2]
    want_json = "format=json" in query or "application/json" in (handler.headers.get("Accept") or "")
    if want_json:
        payload = json.dumps(registry.snapshot()).encode()
        ctype = "application/json"
    else:
        payload = prometheus_text(registry).encode()
        ctype = PROMETHEUS_CONTENT_TYPE
    handler.send_response(200)
    handler.send_header("Content-Type", ctype)
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)


def _send_json(handler, doc, status: int = 200) -> None:
    payload = json.dumps(doc).encode()
    handler.send_response(status)
    handler.send_header("Content-Type", "application/json")
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)


def _serve_pprof(handler) -> None:
    """GET /debug/pprof[?seconds=N][&format=json]: sampling-profiler output
    (common/profiler.py). Default is flamegraph.pl collapsed-stack text of
    the continuous ring; `?seconds=N` takes a fresh bounded capture window
    inline (the pprof-style on-demand profile); `format=json` returns the
    structured stacks with per-query attribution counts."""
    from pinot_tpu_torch.common.profiler import SamplingProfiler, get_profiler

    query = handler.path.partition("?")[2]
    params = dict(p.split("=", 1) for p in query.split("&") if "=" in p)
    prof = get_profiler()
    if "seconds" in params:
        try:
            seconds = float(params["seconds"])
        except ValueError:
            handler.send_error(400, "seconds must be a number")
            return
        doc = prof.capture(seconds)
    else:
        doc = prof.profile()
    if params.get("format") == "json":
        _send_json(handler, doc)
        return
    payload = SamplingProfiler.collapsed_text(doc).encode()
    handler.send_response(200)
    handler.send_header("Content-Type", "text/plain; charset=utf-8")
    handler.send_header("Content-Length", str(len(payload)))
    handler.end_headers()
    handler.wfile.write(payload)


def _serve_workload(handler) -> None:
    """GET /debug/workload: per-(tenant, table) cpu_ns/bytes/queries rollups
    from the process accountant — the measurement substrate for quota tuning
    and load shedding."""
    from pinot_tpu_torch.common.accounting import default_accountant

    _send_json(handler, {"rollups": default_accountant.workload_rollups()})


def _serve_ready(handler, readiness_fn) -> None:
    """GET /health/ready: 200 + component detail when ready, 503 + the
    failing components otherwise (readiness, distinct from the bare
    liveness `/health`)."""
    ready, components = readiness_fn()
    _send_json(
        handler,
        {"status": "ready" if ready else "not ready", "components": components},
        status=200 if ready else 503,
    )


def _hints_with_traceparent(hints: dict, headers) -> dict:
    """Re-inject an incoming W3C `traceparent` header as the __traceCtx__
    hints marker (the wire format of the v1 data-plane hop; the server pops
    the marker and records its span subtree under the propagated context)."""
    tp = headers.get("traceparent")
    if tp:
        from pinot_tpu_torch.common.trace import TraceContext

        tc = TraceContext.from_header(tp)
        if tc is not None and tc.sampled:
            hints = dict(hints)
            hints["__traceCtx__"] = tc.to_dict()
    return hints


class BrokerHTTPService:
    """POST /query/sql {"sql": ...} -> Pinot-shaped JSON broker response."""

    def __init__(self, broker: Broker, port: int = 0):
        svc = self

        class Handler(_InstrumentedHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_POST(self):
                if self.path not in (
                    "/query/sql",
                    "/timeseries/api/v1/query_range",
                    "/debug/alerts/attach",
                ):
                    self.send_error(404)
                    return
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                _tl_mark("bodyRead")
                body = json.loads(raw or b"{}")
                _tl_mark("parse")
                if self.path == "/debug/alerts/attach":
                    # controller SLO plane pushing an alert transition: stamp
                    # alertId into matching slow-query exemplars and emit a
                    # span event on the trace if its request is still running
                    _send_json(self, svc.broker.attach_alert(body))
                    return
                try:
                    identity = None
                    ac = getattr(svc.broker, "access_control", None)
                    if ac is not None:
                        identity = ac.authenticate(dict(self.headers))
                    if self.path == "/timeseries/api/v1/query_range":
                        # TimeSeriesRequestHandler parity: language-selected
                        # planner over the broker's SQL surface. The shim
                        # forwards the authenticated identity so table-level
                        # access control evaluates the real principal, not
                        # anonymous.
                        from pinot_tpu_torch.timeseries import RangeTimeSeriesRequest, TimeSeriesEngine

                        req = RangeTimeSeriesRequest(
                            query=body["query"],
                            start=float(body["start"]),
                            end=float(body["end"]),
                            step=float(body.get("step", 60)),
                            language=body.get("language", "m3ql"),
                        )

                        class _IdentityExecutor:
                            def execute(self, sql):
                                return svc.broker.execute(sql, identity=identity)

                        out = TimeSeriesEngine(_IdentityExecutor()).execute_dict(req)
                        payload = json.dumps(out).encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "application/json")
                        self.send_header("Content-Length", str(len(payload)))
                        self.end_headers()
                        self.wfile.write(payload)
                        return
                    res = svc.broker.execute(body["sql"], identity=identity)
                    _tl_mark("execute")
                    payload = json.dumps(res.to_dict()).encode()
                    _tl_mark("serialize")
                    self.send_response(200)
                except PermissionError as e:
                    _tl_mark("execute")
                    payload = json.dumps({"exceptions": [{"message": str(e)}]}).encode()
                    self.send_response(403)
                except Exception as e:  # error surface parity: exceptions JSON
                    # QueryTimeoutError/QueryCancelledError carry distinct
                    # error codes (BrokerResponse errorCode parity); sampled
                    # queries add the trace exemplar id, accountant kills
                    # their structured reason
                    _tl_mark("execute")
                    entry = {"errorCode": code_of(e), "message": str(e)}
                    if getattr(e, "trace_id", None):
                        entry["traceId"] = e.trace_id
                    if getattr(e, "kill_reason", None):
                        entry["killReason"] = e.kill_reason
                    payload = json.dumps({"exceptions": [entry]}).encode()
                    # admission rejections ride real HTTP statuses (503 shed
                    # / 429 quota) + Retry-After so load balancers and
                    # clients back off without parsing the body; every other
                    # error keeps the BrokerResponse-style 200 + exceptions[]
                    status = http_status_of(e)
                    self.send_response(status or 200)
                    if status is not None:
                        self.send_header("Retry-After", str(int(retry_after_of(e) + 0.5)))
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)
                _tl_mark("write")

            def do_GET(self):
                if self.path == "/health":
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"OK")
                elif self.path == "/health/ready":
                    _serve_ready(self, svc.broker.readiness)
                elif self.path.partition("?")[0] == "/debug/pprof":
                    _serve_pprof(self)
                elif self.path == "/debug/workload":
                    _serve_workload(self)
                elif self.path.partition("?")[0] == "/metrics":
                    from pinot_tpu_torch.common.metrics import BrokerTimer, broker_metrics

                    reg = broker_metrics()
                    # ensure the core latency families exist even before the
                    # first query hits this broker (stable scrape schema)
                    reg.timer(BrokerTimer.QUERY_TOTAL)
                    _serve_metrics(self, reg)
                elif self.path == "/debug/frontend":
                    # request-lifecycle & transport plane: connection gauges,
                    # wire-phase histograms, status rates, scheduling lag
                    _send_json(
                        self,
                        frontend_snapshot(
                            "broker", tracker=getattr(self.server, "_conn_tracker", None)
                        ),
                    )
                elif self.path == "/debug/admission":
                    # live admission-plane state: scheduler queue depths,
                    # per-group tokens, service-time estimates, shed/quota
                    # counters (the runbook's first stop under overload)
                    _send_json(self, svc.broker.admission_snapshot())
                elif self.path == "/debug/hedge":
                    # hedged-scatter state: enabled flag, cumulative primary
                    # legs vs hedges issued (the <=budget-fraction evidence)
                    _send_json(self, svc.broker.hedge_snapshot())
                elif self.path == "/debug/cache":
                    # query-cache plane: per-tier hit/miss/eviction/
                    # invalidation counters + sizes (runbook: low hit rate →
                    # check normalization; staleness → version-vector series)
                    _send_json(self, svc.broker.cache_snapshot())
                elif self.path.partition("?")[0] == "/debug/slowQueries":
                    # structured slow-query ring buffer (broker-side triage)
                    payload = json.dumps(list(svc.broker.slow_queries)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif self.path == "/queries":
                    # in-flight query listing (ClusterInfoAccessor running
                    # queries parity); ids here feed DELETE /query/{id}
                    payload = json.dumps(svc.broker.running_queries()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif self.path.partition("?")[0].startswith("/debug/traces"):
                    # assembled distributed traces: the list view returns
                    # summaries, /debug/traces/{requestId} the full
                    # OTLP-flavored document (trace id also accepted)
                    tail = self.path.partition("?")[0][len("/debug/traces") :].strip("/")
                    if tail:
                        doc = svc.broker.get_trace(tail)
                        if doc is None:
                            self.send_error(404, f"no trace for {tail!r}")
                            return
                        payload = json.dumps(doc).encode()
                    else:
                        payload = json.dumps(svc.broker.recent_traces()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self.send_error(404)

            def do_DELETE(self):
                # DELETE /query/{id}: cancel an in-flight query
                # (PinotClientRequest.cancelQuery REST parity)
                parts = [p for p in self.path.split("/") if p]
                if len(parts) == 2 and parts[0] == "query":
                    try:
                        found = svc.broker.cancel_query(parts[1])
                    except Exception as e:
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                        ).encode()
                        self.send_response(500)
                    else:
                        payload = json.dumps(
                            {"queryId": parts[1], "cancelled": bool(found)}
                        ).encode()
                        self.send_response(200 if found else 404)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self.send_error(404)

        self.broker = broker
        self.httpd, self.port, self._thread = _serve(
            Handler, port, role=_frontend_role(broker, "broker")
        )

    def stop(self):
        self.httpd.shutdown()


class ServerHTTPService:
    """POST /query {"table","sql","segments","hints"} -> DataTable-encoded
    partials (v2 iovec segments gather-written straight onto the socket).
    POST /segments/add|/segments/remove carry the Helix state-transition
    messages for cross-process clusters (segment dirs live on a filesystem
    both processes see — the deep-store mount assumption)."""

    def __init__(self, server: Server, port: int = 0):
        svc = self

        class Handler(_InstrumentedHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if self.path == "/mailbox":
                    # cross-process multistage shuffle delivery
                    # (PinotMailbox.open stream analog, mailbox.proto:24-25)
                    from pinot_tpu_torch.multistage.transport import handle_mailbox_post

                    handle_mailbox_post(svc.server.mailbox_registry, self)
                    return
                if self.path in ("/dimtables/load", "/dimtables/unload"):
                    # the controller's dimension-table refresh for a server
                    # in a process of its own: rebuild this process's PK map
                    # from the table's deep-store segment dirs
                    from pinot_tpu_torch.cluster import dimension
                    from pinot_tpu_torch.common.types import Schema

                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        if self.path == "/dimtables/load":
                            schema = Schema.from_json(body["schema"]) if body.get("schema") else None
                            size = dimension.load_dim_table(body["table"], schema, body["locations"]).size
                        else:
                            dimension.unregister_dim_table(body["table"])
                            size = 0
                        _send_json(self, {"status": "ok", "rows": size})
                    except Exception as e:
                        _send_json(self, {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}, status=500)
                    return
                if self.path == "/multistage/submit":
                    # distributed stage dispatch (PinotQueryWorker.Submit analog)
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        svc.server.multistage_submit(body)
                        payload = b'{"status": "started"}'
                        self.send_response(200)
                    except Exception as e:
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                        ).encode()
                        status = http_status_of(e)
                        self.send_response(status or 500)
                        if status is not None:
                            self.send_header("Retry-After", str(int(retry_after_of(e) + 0.5)))
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path == "/query/cancel":
                    # broker cancel fan-out target: flip the cancel flag on an
                    # in-flight v1 partial execution or v2 stage workers
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        found = svc.server.cancel_query(body.get("queryId", ""))
                        payload = json.dumps({"found": bool(found)}).encode()
                        self.send_response(200)
                    except Exception as e:
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                        ).encode()
                        self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path == "/debug/faults":
                    # runtime chaos arming: replace this process's fault-rule
                    # set ({"points": {point: rule}, "seed": n}; empty points
                    # disarms). The chaos bench uses this to turn one server
                    # into a seeded delay straggler mid-run without a restart.
                    from pinot_tpu_torch.common.faults import FAULT_POINTS, FAULTS

                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        points = body.get("points") or {}
                        unknown = sorted(set(points) - FAULT_POINTS)
                        if unknown:
                            raise ValueError(f"unknown fault points: {unknown}")
                        FAULTS.configure(points, seed=int(body.get("seed", 0)))
                        payload = json.dumps({"armed": sorted(points)}).encode()
                        self.send_response(200)
                    except Exception as e:
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                        ).encode()
                        self.send_response(400)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path == "/segments/scrub":
                    # on-demand integrity pass over this server's local
                    # segment copies (the controller's IntegrityScrubber
                    # calls this on remote handles; ops can too)
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        body = json.loads(self.rfile.read(n) or b"{}")
                        budget = body.get("ioBudgetBytes")
                        out = svc.server.scrub(
                            io_budget_bytes=int(budget) if budget is not None else None
                        )
                        payload = json.dumps(out).encode()
                        self.send_response(200)
                    except Exception as e:
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                        ).encode()
                        self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path in ("/segments/add", "/segments/remove"):
                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    try:
                        if self.path == "/segments/add":
                            svc.server.add_segment(body["table"], body["segment"], body["dir"])
                        else:
                            svc.server.remove_segment(body["table"], body["segment"])
                        payload = b'{"status": "ok"}'
                        self.send_response(200)
                    except Exception as e:
                        payload = json.dumps(
                            {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                        ).encode()
                        self.send_response(500)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                if self.path == "/query/stream":
                    # framed streaming results (GrpcQueryServer.submit parity,
                    # server.proto:24-26): [u32 len][DataTable frame]...,
                    # terminated by [u32 0] on success or [u32 0xFFFFFFFF]
                    # [u32 len][error] on mid-stream failure. No
                    # Content-Length — the broker reads frames incrementally
                    # and may close early once its LIMIT is satisfied,
                    # bounding memory on BOTH sides. EOF without a terminator
                    # is a protocol error the client must surface, never a
                    # silently-truncated success.
                    import struct as _struct

                    n = int(self.headers.get("Content-Length", 0))
                    body = json.loads(self.rfile.read(n) or b"{}")
                    self.send_response(200)
                    self.send_header("Content-Type", "application/x-pinot-datatable-stream")
                    self.send_header("Connection", "close")
                    self.end_headers()
                    try:
                        try:
                            for frame in svc.server.execute_partials_stream(
                                body["table"],
                                body["sql"],
                                body.get("segments", []),
                                _hints_with_traceparent(body.get("hints") or {}, self.headers),
                                max_rows=body.get("maxRows"),
                            ):
                                # iovec gather-write: length prefix + the
                                # encoder's segments, no intermediate concat
                                segments = datatable.encode_segments(frame)
                                total = sum(len(s) for s in segments)
                                self.wfile.write(_struct.pack("<I", total))
                                self.wfile.writelines(segments)
                        except Exception as e:  # mid-stream failure marker
                            # the numeric code rides in the marker text so the
                            # broker side can still classify the failure
                            msg = f"{type(e).__name__}: {e} [errorCode {code_of(e)}]".encode()
                            self.wfile.write(_struct.pack("<I", FRAME_ERR))
                            self.wfile.write(_struct.pack("<I", len(msg)))
                            self.wfile.write(msg)
                            return
                        self.wfile.write(_struct.pack("<I", FRAME_END))
                    except (BrokenPipeError, ConnectionResetError):
                        pass  # broker closed early: expected fast-path exit
                    return
                if self.path != "/query":
                    self.send_error(404)
                    return
                from pinot_tpu_torch.common.trace import ServerQueryPhase, phase_timer

                n = int(self.headers.get("Content-Length", 0))
                try:
                    raw = self.rfile.read(n)
                    _tl_mark("bodyRead")
                    with phase_timer(ServerQueryPhase.REQUEST_DESERIALIZATION, role="server"):
                        body = json.loads(raw or b"{}")
                    _tl_mark("parse")
                    out = svc.server.execute_partials(
                        body["table"],
                        body["sql"],
                        body.get("segments", []),
                        _hints_with_traceparent(body.get("hints") or {}, self.headers),
                    )
                    _tl_mark("execute")
                except Exception as e:
                    # surface the real error to the broker instead of a
                    # dropped connection; accountant kills keep their reason.
                    # Scheduler rejections (queue overflow) ride their real
                    # status (503) + Retry-After so the broker can classify
                    # the shed without string-matching
                    _tl_mark("execute")
                    doc = {"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}
                    if getattr(e, "kill_reason", None):
                        doc["killReason"] = e.kill_reason
                    payload = json.dumps(doc).encode()
                    status = http_status_of(e)
                    self.send_response(status or 500)
                    if status is not None:
                        self.send_header("Retry-After", str(int(retry_after_of(e) + 0.5)))
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                    return
                with phase_timer(ServerQueryPhase.RESPONSE_SERIALIZATION, role="server"):
                    # iovec encode: header scratch + zero-copy column views;
                    # writelines() gather-writes them without materializing
                    # the payload a second time (no BytesIO/getvalue concat)
                    segments = datatable.encode_segments(out)
                _tl_mark("serialize")
                self.send_response(200)
                self.send_header("Content-Type", "application/x-pinot-datatable")
                self.send_header("Content-Length", str(sum(len(s) for s in segments)))
                self.end_headers()
                self.wfile.writelines(segments)
                _tl_mark("write")

            def do_GET(self):
                if self.path == "/health":
                    self.send_response(200)
                    self.send_header("Content-Length", "2")
                    self.end_headers()
                    self.wfile.write(b"OK")
                elif self.path == "/health/ready":
                    _serve_ready(self, svc.server.readiness)
                elif self.path.partition("?")[0] == "/debug/pprof":
                    _serve_pprof(self)
                elif self.path == "/debug/workload":
                    _serve_workload(self)
                elif self.path.partition("?")[0] == "/debug/roofline":
                    # per-(kernel, shape-bucket) achieved GB/s vs configured
                    # peak + HBM live/peak (common/kernel_obs.py); ?top=N
                    # bounds the offender list
                    from pinot_tpu_torch.common.kernel_obs import KERNELS

                    from urllib.parse import parse_qs

                    qs = parse_qs(self.path.partition("?")[2])
                    try:
                        top = int(qs.get("top", ["10"])[0])
                    except ValueError:
                        top = 10
                    _send_json(self, KERNELS.roofline(top=top))
                elif self.path.partition("?")[0] == "/debug/segments":
                    # per-segment heat map (common/segment_heat.py): query
                    # count, docs scanned, bytes touched, decaying heat —
                    # ranked hot→cold; ?cold=true inverts for eviction
                    # candidates, ?top=N bounds the list
                    from pinot_tpu_torch.common.segment_heat import HEAT

                    from urllib.parse import parse_qs

                    qs = parse_qs(self.path.partition("?")[2])
                    try:
                        top = int(qs.get("top", ["0"])[0]) or None
                    except ValueError:
                        top = None
                    cold = qs.get("cold", ["false"])[0].lower() in ("1", "true", "yes")
                    _send_json(self, HEAT.snapshot(top=top, cold=cold))
                elif self.path == "/debug/frontend":
                    # request-lifecycle & transport plane (server role)
                    _send_json(
                        self,
                        frontend_snapshot(
                            "server", tracker=getattr(self.server, "_conn_tracker", None)
                        ),
                    )
                elif self.path == "/debug/admission":
                    # live scheduler state (server role): queue depths,
                    # in-flight counts, per-group tokens
                    _send_json(self, svc.server.admission_snapshot())
                elif self.path == "/debug/faults":
                    # armed fault points + per-point fire counts (chaos
                    # evidence: did the injected rule actually trigger?)
                    from pinot_tpu_torch.common.faults import FAULTS

                    _send_json(self, {"enabled": FAULTS.enabled, "counts": FAULTS.counts()})
                elif self.path == "/debug/queries":
                    # ThreadResourceTracker/QueryResourceTracker REST parity
                    from pinot_tpu_torch.common.accounting import default_accountant

                    payload = json.dumps(default_accountant.query_trackers()).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif self.path.startswith("/segments/file/"):
                    # verified raw segment bytes for peer-replica repair
                    # (the scrubber's last-resort fetch when the deep-store
                    # copy is bad); 404 when this server has no healthy copy
                    parts = self.path.split("/")[3:]
                    data = (
                        svc.server.fetch_segment_file(parts[0], parts[1])
                        if len(parts) == 2
                        else None
                    )
                    if data is None:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "application/octet-stream")
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif self.path == "/debug/storage":
                    # quarantine runbook surface: data dir, local copies and
                    # their deep-store sources, *.quarantined files on disk
                    _send_json(self, svc.server.local_segment_report())
                elif self.path.startswith("/segments/"):
                    # hosted-segment listing (VerifySegmentState's live view)
                    table = self.path.split("/", 2)[2]
                    payload = json.dumps(svc.server.segments_of(table)).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                elif self.path.partition("?")[0] == "/metrics":
                    from pinot_tpu_torch.common.metrics import ServerTimer, server_metrics

                    reg = server_metrics()
                    # ensure the core latency families exist even before the
                    # first query hits this server (stable scrape schema)
                    reg.timer(ServerTimer.QUERY_EXECUTION)
                    _serve_metrics(self, reg)
                elif self.path == "/debug/resources":
                    # leak-tracker + scheduler backlog (NettyLeakListener-
                    # style observability surfaced as a REST debug endpoint)
                    from pinot_tpu_torch.common.leakcheck import staging_tracker

                    sched = getattr(server, "_scheduler", None)
                    doc = {
                        "stagedDeviceSegments": staging_tracker.live(),
                        "schedulerPending": sched.pending() if sched is not None else None,
                    }
                    payload = json.dumps(doc).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(payload)))
                    self.end_headers()
                    self.wfile.write(payload)
                else:
                    self.send_error(404)

        self.server = server
        self.httpd, self.port, self._thread = _serve(
            Handler, port, role=_frontend_role(server, "server")
        )

    def stop(self):
        self.httpd.shutdown()


class RemoteServerClient:
    """Broker-side handle to a server over HTTP; mirrors Server's
    execute_partials/add_segment surface (QueryRouter connection analog).
    All requests ride pooled keep-alive connections from common/wire.py —
    one TCP connection per (broker, server) pair carries many scatter hops
    instead of a fresh connect per request."""

    def __init__(self, base_url: str, timeout: float = 10.0):
        """timeout: per-hop data-plane timeout (Pinot brokerTimeoutMs analog).
        A dead/hung server must fail the query quickly, not stall the broker."""
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout
        self._host, self._port = _host_port(self.base_url)

    def _hop_timeout(self, hints: dict | None) -> float:
        """Per-call socket timeout bounded by the query deadline riding in the
        hints markers: a hop must not outlive the query (+0.5s grace so the
        server-side deadline error wins the race and reaches the broker)."""
        import time as _time

        dl = (hints or {}).get("__deadlineTs__")
        if dl is None:
            return self.timeout
        return max(0.1, min(self.timeout, float(dl) - _time.time() + 0.5))

    @staticmethod
    def _trace_headers(hints: dict) -> dict:
        """Pop the broker's __traceCtx__ marker into a real W3C traceparent
        header — tracing context travels as HTTP metadata on the wire, not
        inside the query payload."""
        headers = {"Content-Type": "application/json"}
        tctx = hints.pop("__traceCtx__", None)
        if tctx:
            from pinot_tpu_torch.common.trace import TraceContext

            headers["traceparent"] = TraceContext.from_dict(tctx).to_header()
        return headers

    def execute_partials(self, table: str, sql: str, segment_names: list[str], hints: dict | None = None):
        hints = dict(hints or {})
        headers = self._trace_headers(hints)
        body = json.dumps(
            {"table": table, "sql": sql, "segments": segment_names, "hints": hints}
        ).encode()
        try:
            with get_pool().request(
                self._host,
                self._port,
                "POST",
                "/query",
                body=body,
                headers=headers,
                timeout_s=self._hop_timeout(hints),
            ) as resp:
                payload = resp.read()
                status = resp.status
                retry_after = resp.getheader("Retry-After")
        except (TimeoutError, OSError) as e:
            raise RuntimeError(f"server {self.base_url} unreachable: {e}") from None
        if status >= 400:
            detail = bytes(payload).decode(errors="replace")
            try:
                doc = json.loads(detail)
            except Exception:  # pinotlint: disable=deadline-swallow — non-JSON error detail; the RuntimeError below carries it verbatim
                doc = {}
            if status == 503 and doc.get("errorCode") == int(QueryErrorCode.SERVER_OUT_OF_CAPACITY):
                # server-side shed stays typed across the hop: the broker
                # surfaces it as its own 503 + Retry-After, not a failover
                from pinot_tpu_torch.query.scheduler import SchedulerRejectedError

                raise SchedulerRejectedError(
                    f"server {self.base_url} out of capacity: {doc.get('error', detail)}",
                    retry_after_s=float(retry_after or 1.0),
                ) from None
            err = RuntimeError(f"server error from {self.base_url}: {detail}")
            if doc.get("killReason"):
                err.kill_reason = doc["killReason"]  # re-attach across the HTTP hop
            raise err from None
        return datatable.decode(payload)

    def cancel_query(self, qid: str) -> bool:
        """Fan-out target for Broker.cancel_query; False when the server
        doesn't know the id (or can't be reached — it is failing the query
        its own way)."""
        try:
            return bool(self._post_json("/query/cancel", {"queryId": qid}).get("found"))
        except RuntimeError:
            return False

    def execute_partials_stream(
        self, table: str, sql: str, segment_names: list[str], hints: dict | None = None, max_rows: int | None = None
    ):
        """Generator over streamed (frame, matched, seg_docs, seg_scan)
        tuples — seg_scan is the segment's scan record on its first frame,
        None on later chunks. Closing the generator closes the HTTP
        response, telling the server to stop."""
        import struct as _struct

        hints = dict(hints or {})
        headers = self._trace_headers(hints)
        body = json.dumps(
            {
                "table": table,
                "sql": sql,
                "segments": segment_names,
                "hints": hints,
                "maxRows": max_rows,
            }
        ).encode()
        try:
            resp = get_pool().request(
                self._host,
                self._port,
                "POST",
                "/query/stream",
                body=body,
                headers=headers,
                timeout_s=self._hop_timeout(hints),
            )
        except (TimeoutError, OSError) as e:
            raise RuntimeError(f"server {self.base_url} unreachable: {e}") from None
        try:
            # frame-by-frame: each frame decodes (zero-copy views over its
            # own receive buffer) as it arrives — the full result set never
            # materializes on the broker side
            while True:
                hdr = resp.read(4)
                if len(hdr) < 4:
                    # EOF without a terminator = truncated stream (server
                    # died mid-write): NEVER a silent success
                    raise RuntimeError(f"server {self.base_url} stream truncated mid-response")
                n = _struct.unpack("<I", hdr)[0]
                if n == 0:
                    break
                if n == 0xFFFFFFFF:  # mid-stream server error marker
                    (elen,) = _struct.unpack("<I", resp.read(4))
                    raise RuntimeError(
                        f"server error from {self.base_url}: {resp.read(elen).decode(errors='replace')}"
                    )
                try:
                    frame = read_exact(resp, n)
                except OSError:
                    raise RuntimeError(
                        f"server {self.base_url} stream truncated mid-response"
                    ) from None
                yield datatable.decode(frame)
        finally:
            resp.close()

    def _post_json(self, path: str, doc: dict) -> dict:
        body = json.dumps(doc).encode()
        try:
            with get_pool().request(
                self._host,
                self._port,
                "POST",
                path,
                body=body,
                headers={"Content-Type": "application/json"},
                timeout_s=self.timeout,
            ) as resp:
                payload = resp.read()
                status = resp.status
        except (TimeoutError, OSError) as e:
            raise RuntimeError(f"server {self.base_url} unreachable: {e}") from None
        if status >= 400:
            detail = bytes(payload).decode(errors="replace")
            raise RuntimeError(f"server error from {self.base_url}: {detail}") from None
        return json.loads(payload)

    def add_segment(self, table: str, segment_name: str, seg_dir) -> None:
        self._post_json("/segments/add", {"table": table, "segment": segment_name, "dir": str(seg_dir)})

    def remove_segment(self, table: str, segment_name: str) -> None:
        self._post_json("/segments/remove", {"table": table, "segment": segment_name})

    def segments_of(self, table: str) -> list[str]:
        with get_pool().request(
            self._host, self._port, "GET", f"/segments/{table}", timeout_s=self.timeout
        ) as resp:
            return json.loads(resp.read())

    def get_segment_object(self, table: str, segment_name: str):
        """Remote servers don't ship segment objects over HTTP; multistage
        leaf scans run ON the server via multistage_submit instead."""
        return None

    def scrub(self, io_budget_bytes: int | None = None) -> dict:
        body = {} if io_budget_bytes is None else {"ioBudgetBytes": int(io_budget_bytes)}
        return self._post_json("/segments/scrub", body)

    def fetch_segment_file(self, table: str, segment_name: str) -> bytes | None:
        """Verified segment bytes from the remote server's copy, or None
        when it has no healthy copy (404)."""
        try:
            with get_pool().request(
                self._host,
                self._port,
                "GET",
                f"/segments/file/{table}/{segment_name}",
                timeout_s=self.timeout,
            ) as resp:
                if resp.status != 200:
                    return None
                return bytes(resp.read())
        except (OSError, RuntimeError):
            return None

    def multistage_submit(self, doc: dict) -> None:
        self._post_json("/multistage/submit", doc)

    def load_dim_table(self, table: str, schema, locations: list) -> None:
        """Have the server process (re)load dimension table `table` from
        its segments' deep-store dirs (cluster/dimension.py)."""
        self._post_json(
            "/dimtables/load",
            {"table": table, "schema": schema.to_json() if schema is not None else None, "locations": list(locations)},
        )

    def unload_dim_table(self, table: str) -> None:
        self._post_json("/dimtables/unload", {"table": table})


class ControllerHTTPService:
    """Controller REST surface (pinot-controller/.../api/resources/ parity,
    the subset that matters for clients/CLI):

      GET  /health | /health/ready | /tables | /tables/{t} | /tables/{t}/schema
           /tables/{t}/idealstate | /tables/{t}/segments | /brokers | /instances
           /tasks?state=... | /debug/cluster | /debug/alerts
      POST /schemas            {schema json}
      POST /tables             {table config json}
      POST /instances          {"type": "server"|"broker", "id", "host", "port"}
      POST /segments/{table}   raw ptseg segment-dir tarball (upload path)
      POST /tasks/schedule     {"taskType": optional}

    A standby (a controller with HA enabled that does not hold the lease)
    answers mutating endpoints with 503 + `leaderUrl`, and a fenced write
    with 503 + errorCode 270. The task endpoints serve the `task_manager`
    (a minion.PinotTaskManager) and answer 404 without one; GET /tasks lists
    every task, whatever `state` asks, as the reference's does.
    """

    def __init__(self, controller: Controller, port: int = 0, task_manager=None):
        svc = self
        self.controller = controller
        self.task_manager = task_manager

        class Handler(_InstrumentedHandler):
            def log_message(self, *a):
                pass

            def _json(self, doc, code=200):
                payload = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(payload)))
                self.end_headers()
                self.wfile.write(payload)

            def _reject_standby(self, c) -> bool:
                """Standby gate for mutating endpoints: 503 + leaderUrl hint
                (the lead-controller REST redirect contract — clients follow
                the hint instead of mutating through a non-lead)."""
                if c.is_leader:
                    return False
                self._json(
                    {
                        "error": f"not leader: controller {c.controller_id!r} is standby",
                        "errorCode": int(QueryErrorCode.CONTROLLER_UNAVAILABLE),
                        "leaderUrl": c.leader_url(),
                    },
                    503,
                )
                return True

            def _fenced(self, c, e) -> None:
                """A mutation slipped past the standby gate on a stale
                ex-leader (lease lost mid-request) and the store rejected it:
                same 503 + leaderUrl contract as the gate."""
                self._json(
                    {
                        "error": f"{type(e).__name__}: {e}",
                        "errorCode": int(QueryErrorCode.CONTROLLER_UNAVAILABLE),
                        "leaderUrl": c.leader_url(),
                    },
                    503,
                )

            def do_GET(self):
                c = svc.controller
                try:
                    parts = [p for p in self.path.split("?")[0].split("/") if p]
                    if self.path in ("/", "/index.html"):
                        # single-page controller UI (React SPA analog,
                        # cluster/ui.py): tables drill-down, instances,
                        # metrics, query console
                        from pinot_tpu_torch.cluster.ui import UI_HTML

                        html = UI_HTML.encode()
                        self.send_response(200)
                        self.send_header("Content-Type", "text/html")
                        self.send_header("Content-Length", str(len(html)))
                        self.end_headers()
                        self.wfile.write(html)
                    elif self.path.partition("?")[0] == "/metrics":
                        from pinot_tpu_torch.common.metrics import controller_metrics

                        _serve_metrics(self, controller_metrics())
                    elif self.path == "/health":
                        self._json({"status": "OK"})
                    elif self.path == "/health/ready":
                        _serve_ready(self, c.readiness)
                    elif self.path == "/leader":
                        # lease observability for failover probes and the
                        # chaos bench: role, epoch, takeover/fence counters
                        self._json(c.ha_status())
                    elif self.path == "/debug/faults":
                        from pinot_tpu_torch.common.faults import FAULTS

                        self._json({"enabled": FAULTS.enabled, "counts": FAULTS.counts()})
                    elif self.path == "/debug/frontend":
                        self._json(
                            frontend_snapshot(
                                "controller",
                                tracker=getattr(self.server, "_conn_tracker", None),
                            )
                        )
                    elif self.path.partition("?")[0] == "/debug/cluster":
                        # federated cluster view assembled by the
                        # ClusterMetricsAggregator periodic task
                        agg = c.cluster_aggregator
                        if agg is None:
                            self._json({"error": "no ClusterMetricsAggregator registered"}, 404)
                        else:
                            self._json(agg.debug_cluster())
                    elif self.path.partition("?")[0] == "/debug/alerts":
                        agg = c.cluster_aggregator
                        if agg is None:
                            self._json({"error": "no ClusterMetricsAggregator registered"}, 404)
                        else:
                            self._json(
                                {
                                    "alerts": agg.evaluator.alerts(),
                                    "slo": agg.evaluator.status(),
                                }
                            )
                    elif self.path == "/tables":
                        self._json({"tables": c.tables()})
                    elif len(parts) == 2 and parts[0] == "tables":
                        tc = c.get_table(parts[1])
                        if tc is None:
                            self._json({"error": "not found"}, 404)
                        else:
                            self._json(json.loads(tc.to_json()))
                    elif len(parts) == 3 and parts[0] == "tables" and parts[2] == "schema":
                        sch = c.get_schema(parts[1])
                        self._json(json.loads(sch.to_json()) if sch else {"error": "not found"}, 200 if sch else 404)
                    elif len(parts) == 3 and parts[0] == "tables" and parts[2] == "idealstate":
                        self._json(c.ideal_state(parts[1]))
                    elif len(parts) == 3 and parts[0] == "tables" and parts[2] == "segments":
                        self._json(c.all_segment_metadata(parts[1]))
                    elif self.path.partition("?")[0] == "/routingversions":
                        # batched version-vector read for broker cache keys:
                        # one RTT regardless of how many tables a query touches
                        from urllib.parse import parse_qs

                        qs = parse_qs(self.path.partition("?")[2])
                        names = [t for t in (qs.get("tables", [""])[0]).split(",") if t]
                        self._json(c.routing_versions(names))
                    elif len(parts) == 3 and parts[0] == "tables" and parts[2] == "consumingSegmentsInfo":
                        info = {}
                        for sid, srv in c.servers().items():
                            fn = getattr(srv, "consumption_status", None)
                            st = fn(parts[1]) if fn is not None else []
                            if st:
                                info[sid] = st
                        self._json(info)
                    elif self.path == "/brokers":
                        self._json(c.brokers())
                    elif self.path == "/instances":
                        self._json({p.split("/")[-1]: c.store.get(p) for p in c.store.list("/instances/")})
                    elif parts and parts[0] == "tasks" and svc.task_manager is not None:
                        self._json(
                            [
                                {"taskId": t.task_id, "type": t.task_type, "state": t.state.value}
                                for t in svc.task_manager.tasks()
                            ]
                        )
                    else:
                        self._json({"error": "not found"}, 404)
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}, 500)

            def do_DELETE(self):
                from pinot_tpu_torch.cluster.metadata import FencedWriteError

                c = svc.controller
                parts = self.path.strip("/").split("/")
                # the query-cancel proxy stays available on standbys (it only
                # fans out to brokers); metadata deletes are lead-only
                if len(parts) == 2 and parts[0] in ("tables", "schemas") and self._reject_standby(c):
                    return
                try:
                    if len(parts) == 2 and parts[0] == "tables":
                        removed = c.delete_table(parts[1])
                        self._json({"status": "ok", "segmentsRemoved": removed})
                    elif len(parts) == 2 and parts[0] == "schemas":
                        c.delete_schema(parts[1])
                        self._json({"status": "ok"})
                    elif len(parts) == 2 and parts[0] == "query":
                        # cancel proxy (PinotRunningQueryResource parity): the
                        # client knows only the controller; try every broker
                        qid = parts[1]
                        cancelled_on = []
                        for bid, base_url in sorted(c.brokers().items()):
                            bhost, bport = _host_port(base_url.rstrip("/"))
                            try:
                                with get_pool().request(
                                    bhost, bport, "DELETE", f"/query/{qid}", timeout_s=5.0
                                ) as resp:
                                    body = resp.read()
                                    if resp.status < 400 and json.loads(body).get("cancelled"):
                                        cancelled_on.append(bid)
                            except (ValueError, OSError):
                                continue
                        self._json(
                            {"queryId": qid, "cancelled": bool(cancelled_on), "brokers": cancelled_on},
                            200 if cancelled_on else 404,
                        )
                    else:
                        self._json({"error": "not found"}, 404)
                except FencedWriteError as e:
                    self._fenced(c, e)
                except ValueError as e:
                    self._json({"error": str(e)}, 409)
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}, 500)

            def do_POST(self):  # noqa: C901
                from pinot_tpu_torch.cluster.metadata import FencedWriteError
                from pinot_tpu_torch.common.config import TableConfig
                from pinot_tpu_torch.common.types import Schema

                c = svc.controller
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n)
                if self.path == "/debug/faults":
                    # runtime chaos arming, deliberately NOT lead-gated: the
                    # split-brain test arms lease.renew on the current lead,
                    # then must disarm it AFTER it has become a fenced standby
                    from pinot_tpu_torch.common.faults import FAULT_POINTS, FAULTS

                    try:
                        body = json.loads(raw or b"{}")
                        points = body.get("points") or {}
                        unknown = sorted(set(points) - FAULT_POINTS)
                        if unknown:
                            raise ValueError(f"unknown fault points: {unknown}")
                        FAULTS.configure(points, seed=int(body.get("seed", 0)))
                        self._json({"armed": sorted(points)})
                    except Exception as e:
                        self._json({"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}, 400)
                    return
                if self._reject_standby(c):
                    return
                try:
                    parts = [p for p in self.path.split("/") if p]
                    ac = getattr(c, "access_control", None)
                    if ac is not None:
                        # every mutating controller endpoint needs WRITE
                        # (controller api/access AccessControl parity); the
                        # table resource is the path's table component when
                        # present
                        from pinot_tpu_torch.cluster.access import WRITE

                        ident = ac.authenticate(dict(self.headers))
                        table_res = parts[1] if len(parts) >= 2 and parts[0] in ("segments", "tables") else None
                        ac.check(ident, table_res, WRITE)
                    if self.path == "/schemas":
                        c.add_schema(Schema.from_json(raw.decode()))
                        self._json({"status": "ok"})
                    elif self.path == "/tables":
                        c.add_table(TableConfig.from_json(raw.decode()))
                        self._json({"status": "ok"})
                    elif self.path == "/instances":
                        body = json.loads(raw)
                        if body.get("type") == "broker":
                            c.register_broker(body["id"], body["host"], int(body["port"]))
                        else:
                            c.register_server(body["id"], host=body["host"], port=int(body["port"]))
                        self._json({"status": "ok"})
                    elif len(parts) == 3 and parts[0] == "segments" and parts[2] == "reload":
                        body = json.loads(raw or b"{}")
                        names = c.reload_segments(parts[1], body.get("segment"))
                        self._json({"status": "ok", "reloaded": names})
                    elif len(parts) == 2 and parts[0] == "segments":
                        # segment upload: tarball of the segment directory
                        import io as _io
                        import tarfile
                        import tempfile

                        from pinot_tpu_torch.segment.loader import load_segment

                        with tempfile.TemporaryDirectory() as tmp:
                            with tarfile.open(fileobj=_io.BytesIO(raw), mode="r:gz") as tf:
                                tf.extractall(tmp, filter="data")
                            entries = list(Path(tmp).iterdir())
                            seg_root = entries[0] if len(entries) == 1 and entries[0].is_dir() else Path(tmp)
                            seg = load_segment(seg_root)
                            assigned = c.upload_segment(parts[1], seg)
                        self._json({"status": "ok", "segment": seg.name, "servers": assigned})
                    elif self.path == "/tasks/schedule" and svc.task_manager is not None:
                        body = json.loads(raw or b"{}")
                        tasks = svc.task_manager.schedule_tasks(body.get("taskType"))
                        self._json({"scheduled": [t.task_id for t in tasks]})
                    elif len(parts) == 3 and parts[0] == "tables" and parts[2] in (
                        "pauseConsumption",
                        "resumeConsumption",
                    ):
                        pause = parts[2] == "pauseConsumption"
                        hit = []
                        for sid, srv in c.servers().items():
                            fn = getattr(srv, "pause_consumption" if pause else "resume_consumption", None)
                            if fn is not None and fn(parts[1]):
                                hit.append(sid)
                        self._json({"status": "ok", "servers": hit, "paused": pause})
                    elif len(parts) == 3 and parts[0] == "tables" and parts[2] == "rebalance":
                        from pinot_tpu_torch.cluster.rebalance import rebalance_table

                        body = json.loads(raw or b"{}")
                        r = rebalance_table(
                            c,
                            parts[1],
                            dry_run=bool(body.get("dryRun")),
                            drain_grace_sec=float(body.get("drainGraceSec") or 0.0),
                            bootstrap=bool(body.get("bootstrap")),
                        )
                        self._json(
                            {
                                "status": r.status,
                                "adds": r.adds,
                                "drops": r.drops,
                                "target": r.target,
                            }
                        )
                    else:
                        self._json({"error": "not found"}, 404)
                except PermissionError as e:
                    self._json({"error": str(e)}, 403)
                except FencedWriteError as e:
                    self._fenced(c, e)
                except Exception as e:
                    self._json({"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}, 500)

        self.httpd, self.port, self._thread = _serve(
            Handler, port, role=_frontend_role(controller, "controller")
        )

    def stop(self):
        self.httpd.shutdown()


class RemoteControllerClient:
    """Client-side controller handle over REST (used by CLI/clients and by
    broker processes running apart from the controller). Control-plane
    calls share the same keep-alive pool as the data plane.

    HA failover: accepts one URL, a comma-separated list, or a list of
    URLs. Requests walk the candidates with bounded retry + backoff on
    ConnectionError/503; a standby's 503 `leaderUrl` hint is followed and
    promoted to the front (so subsequent calls go straight to the lead).
    When every candidate is down or refusing leadership, a typed
    `ControllerUnavailableError` surfaces instead of a raw ConnectionError."""

    def __init__(self, base_url, timeout: float = 30.0, max_attempts: int = 3, backoff_s: float = 0.1):
        if isinstance(base_url, (list, tuple)):
            raw_urls = [str(u) for u in base_url]
        else:
            raw_urls = str(base_url).split(",")
        self.urls = [u.strip().rstrip("/") for u in raw_urls if u.strip()]
        if not self.urls:
            raise ValueError("RemoteControllerClient needs at least one controller URL")
        self.timeout = timeout
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s

    @property
    def base_url(self) -> str:
        """Current preferred candidate (the known/most-recent lead)."""
        return self.urls[0]

    def _promote(self, url: str) -> None:
        u = url.rstrip("/")
        cur = self.urls
        if cur and cur[0] == u:
            return
        # single reference assignment: racing request threads see either
        # order, both of which contain every candidate
        self.urls = [u] + [x for x in cur if x != u]

    def _request(self, method: str, path: str, body: bytes | None = None,
                 content_type: str = "application/json") -> dict:
        from pinot_tpu_torch.common.errors import ControllerUnavailableError

        headers = {"Content-Type": content_type} if body is not None else None
        last_err: Exception | None = None
        for attempt in range(self.max_attempts):
            for url in list(self.urls):
                host, port = _host_port(url)
                try:
                    with get_pool().request(
                        host, port, method, path, body=body, headers=headers, timeout_s=self.timeout
                    ) as resp:
                        payload = resp.read()
                        status = resp.status
                except OSError as e:
                    last_err = e  # dead candidate: try the next one
                    continue
                if status == 503:
                    # a standby (or a just-fenced ex-lead): follow its
                    # leaderUrl hint when offered, else walk the candidates
                    try:
                        hint = json.loads(payload).get("leaderUrl")
                    except (ValueError, AttributeError):
                        hint = None
                    if hint:
                        self._promote(hint)
                    last_err = RuntimeError(
                        f"controller {url} not leading ({status}): "
                        f"{bytes(payload).decode(errors='replace')}"
                    )
                    continue
                if status >= 400:
                    raise RuntimeError(
                        f"controller error ({status}): {bytes(payload).decode(errors='replace')}"
                    )
                self._promote(url)
                return json.loads(payload)
            if attempt + 1 < self.max_attempts:
                time.sleep(self.backoff_s * (attempt + 1))
        raise ControllerUnavailableError(
            f"no controller reachable and leading after {self.max_attempts} attempts "
            f"across {self.urls}: {last_err}",
            candidates=list(self.urls),
        )

    def _get(self, path: str) -> dict:
        return self._request("GET", path)

    def _post(self, path: str, data: bytes, content_type: str = "application/json") -> dict:
        return self._request("POST", path, body=data, content_type=content_type)

    def health(self) -> bool:
        try:
            return self._get("/health").get("status") == "OK"
        except OSError:
            return False

    def tables(self) -> list[str]:
        return self._get("/tables")["tables"]

    def brokers(self) -> dict[str, str]:
        return self._get("/brokers")

    def ideal_state(self, table: str) -> dict:
        return self._get(f"/tables/{table}/idealstate")

    def all_segment_metadata(self, table: str) -> dict:
        return self._get(f"/tables/{table}/segments")

    def segment_metadata(self, table: str, segment: str) -> dict | None:
        return self.all_segment_metadata(table).get(segment)

    def routing_versions(self, tables: list[str]) -> dict[str, int]:
        if not tables:
            return {}
        return {t: int(v) for t, v in self._get(f"/routingversions?tables={','.join(tables)}").items()}

    def routing_version(self, table: str) -> int:
        return self.routing_versions([table]).get(table, 0)

    def get_table(self, name: str):
        from pinot_tpu_torch.common.config import TableConfig

        try:
            return TableConfig.from_json(json.dumps(self._get(f"/tables/{name}")))
        except RuntimeError:
            return None

    def get_schema(self, name: str):
        from pinot_tpu_torch.common.types import Schema

        try:
            return Schema.from_json(json.dumps(self._get(f"/tables/{name}/schema")))
        except RuntimeError:
            return None

    def servers(self) -> dict[str, object]:
        """Server handles from the instance registry (a Broker running in its
        own process builds its routing table from these)."""
        out = {}
        for sid, doc in self._get("/instances").items():
            if doc and doc.get("port"):
                out[sid] = RemoteServerClient(f"http://{doc['host']}:{doc['port']}")
        return out

    def add_schema(self, schema) -> None:
        self._post("/schemas", schema.to_json().encode())

    def add_table(self, config) -> None:
        self._post("/tables", config.to_json().encode())

    def _delete(self, path: str) -> dict:
        return self._request("DELETE", path)

    def leader(self) -> dict:
        """GET /leader: the answering controller's lease view (role, epoch,
        takeover/fence counters, leaderUrl)."""
        return self._get("/leader")

    def delete_table(self, name: str) -> dict:
        return self._delete(f"/tables/{name}")

    def delete_schema(self, name: str) -> dict:
        return self._delete(f"/schemas/{name}")

    def register_instance(self, kind: str, instance_id: str, host: str, port: int) -> None:
        self._post(
            "/instances",
            json.dumps({"type": kind, "id": instance_id, "host": host, "port": port}).encode(),
        )

    def upload_segment_dir(self, table: str, seg_dir: str | Path) -> dict:
        """Tar up a written segment directory and push it (the tar.gz segment
        upload REST path)."""
        import io as _io
        import tarfile

        buf = _io.BytesIO()
        seg_dir = Path(seg_dir)
        with tarfile.open(fileobj=buf, mode="w:gz") as tf:
            tf.add(seg_dir, arcname=seg_dir.name)
        return self._post(f"/segments/{table}", buf.getvalue(), "application/gzip")

    def upload_segment(self, table: str, seg) -> dict:
        """Push a built in-memory segment: write to a temp dir, tar, upload.
        Mirrors the in-process Controller.upload_segment surface so batch
        runners/connectors work against either handle."""
        import tempfile

        from pinot_tpu_torch.segment.builder import write_segment

        with tempfile.TemporaryDirectory() as tmp:
            seg_dir = write_segment(seg, Path(tmp))
            return self.upload_segment_dir(table, seg_dir)

    def schedule_tasks(self, task_type: str | None = None) -> list[str]:
        body = json.dumps({"taskType": task_type} if task_type else {}).encode()
        return self._post("/tasks/schedule", body)["scheduled"]

    def rebalance_table(
        self,
        table: str,
        dry_run: bool = False,
        drain_grace_sec: float = 0.0,
        bootstrap: bool = False,
    ) -> dict:
        body = {"dryRun": dry_run, "drainGraceSec": drain_grace_sec, "bootstrap": bootstrap}
        return self._post(f"/tables/{table}/rebalance", json.dumps(body).encode())


def query_broker_http(base_url: str, sql: str) -> dict:
    """Client helper: POST a SQL query to a broker endpoint over a pooled
    keep-alive connection."""
    host, port = _host_port(base_url.rstrip("/"))
    body = json.dumps({"sql": sql}).encode()
    with get_pool().request(
        host,
        port,
        "POST",
        "/query/sql",
        body=body,
        headers={"Content-Type": "application/json"},
        timeout_s=60,
    ) as resp:
        payload = resp.read()
        status = resp.status
        retry_after = resp.getheader("Retry-After")
    if status >= 400:
        detail = bytes(payload).decode(errors="replace")
        if status in (429, 503):
            _raise_admission_error(status, detail, retry_after)
        raise RuntimeError(f"broker error ({status}): {detail}")
    return json.loads(payload)


def _raise_admission_error(status: int, detail: str, retry_after) -> None:
    """Map a broker 429/503 admission rejection back to the typed exception
    it started as (QuotaExceededError / SchedulerRejectedError), preserving
    the Retry-After hint — clients get a class to catch and a backoff to
    honor instead of a generic RuntimeError."""
    try:
        message = json.loads(detail)["exceptions"][0]["message"]
    except Exception:  # pinotlint: disable=deadline-swallow — non-JSON rejection body; the raw detail is the message
        message = detail
    wait_s = float(retry_after or 1.0)
    if status == 429:
        from pinot_tpu_torch.cluster.quota import QuotaExceededError

        raise QuotaExceededError(message, retry_after_s=wait_s)
    from pinot_tpu_torch.query.scheduler import SchedulerRejectedError

    raise SchedulerRejectedError(message, retry_after_s=wait_s)
