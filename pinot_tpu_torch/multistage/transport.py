"""Cross-process mailbox transport for the multistage (v2) engine.

Reference parity: GrpcSendingMailbox / ReceivingMailbox + the PinotMailbox
bidi stream (pinot-common/src/main/proto/mailbox.proto:24-25,
pinot-query-runtime/.../mailbox/GrpcSendingMailbox.java:42). The TPU build's
DCN tier is HTTP (cluster/http.py is the Netty analog), so stage-to-stage
blocks travel as DataTable-encoded payloads POSTed to the receiving process's
/mailbox endpoint; same-process pairs short-circuit through the in-memory
queues exactly like InMemorySendingMailbox.

Envelope format (one POST per block, over a pooled keep-alive connection —
one persistent socket per peer instead of a fresh urlopen per block):
    4-byte little-endian header length | JSON header | body bytes
    header: {"qid", "rs", "rw", "ss", "kind": "block"|"eos"|"err", "msg"?}
    body:   DataTable v2 segments for kind=block, empty otherwise

This is the JAX package's `multistage/transport.py` without pandas. A block
is the runtime's `Block` of positional numpy columns; it travels as the
DataTable frame whose columns are named "0", "1", ... in order, which is
what the reference writes for its DataFrame with positional labels, so an
envelope is the reference's byte for byte, and a received frame decodes
back into a `Block` in column order.
"""

from __future__ import annotations

import json
import random
import struct
import threading
import time

from pinot_tpu_torch.common import datatable
from pinot_tpu_torch.common.wire import get_pool
from pinot_tpu_torch.multistage import runtime as R


def encode_envelope_segments(qid: str, rs: int, rw: int, ss: int, payload) -> list:
    """payload: runtime.Block | runtime._EOS | ("__eos__", [stats]) |
    ("__err__", msg[, code]). A stats-carrying EOS ships the sender's
    accumulated OperatorStats records in the header (trailing-EOS-block
    parity); an error marker ships the sender's numeric error code so a
    deadline/cancel failure keeps its class across processes.

    Returns iovec segments ([len+header] + zero-copy DataTable column
    views) for a gather-write over the pooled transport."""
    if isinstance(payload, R.Block):
        header = {"qid": qid, "rs": rs, "rw": rw, "ss": ss, "kind": "block"}
        body_segments = datatable.encode_segments(
            datatable.Frame((str(i), col) for i, col in enumerate(payload.cols))
        )
    elif isinstance(payload, tuple) and payload and payload[0] == "__err__":
        header = {"qid": qid, "rs": rs, "rw": rw, "ss": ss, "kind": "err", "msg": str(payload[1])}
        if len(payload) > 2 and payload[2] is not None:
            header["code"] = int(payload[2])
        body_segments = []
    else:  # EOS
        header = {"qid": qid, "rs": rs, "rw": rw, "ss": ss, "kind": "eos"}
        if isinstance(payload, tuple) and len(payload) > 1 and payload[1]:
            header["stats"] = payload[1]
        body_segments = []
    hb = json.dumps(header).encode()
    return [struct.pack("<I", len(hb)) + hb, *body_segments]


def encode_envelope(qid: str, rs: int, rw: int, ss: int, payload) -> bytes:
    """One-buffer form of encode_envelope_segments (tests, local loopback)."""
    return b"".join(encode_envelope_segments(qid, rs, rw, ss, payload))


def decode_envelope(data: bytes):
    """-> (header dict, payload as used by MailboxService queues).

    Every length/slice is bounds-checked (io/readers.py discipline): a
    truncated or garbled POST body raises ValueError("corrupt mailbox
    envelope ..."), never a raw struct.error/JSONDecodeError, so /mailbox
    can answer 400 instead of 500."""
    if len(data) < 4:
        raise ValueError(
            f"corrupt mailbox envelope: {len(data)} bytes, need >= 4 for header length"
        )
    (hlen,) = struct.unpack_from("<I", data, 0)
    if hlen == 0 or 4 + hlen > len(data):
        raise ValueError(
            f"corrupt mailbox envelope: header length {hlen} exceeds body ({len(data)} bytes)"
        )
    try:
        header = json.loads(data[4 : 4 + hlen].decode())
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"corrupt mailbox envelope: bad JSON header ({e})") from None
    if not isinstance(header, dict) or not all(k in header for k in ("qid", "rs", "rw", "ss")):
        raise ValueError("corrupt mailbox envelope: header missing qid/rs/rw/ss")
    kind = header.get("kind")
    if kind == "block":
        try:
            # memoryview slice: the DataTable decodes zero-copy over the
            # received envelope buffer, no body-copy per block
            frame = datatable.decode(memoryview(data)[4 + hlen :])
        except Exception as e:  # pinotlint: disable=deadline-swallow — decode sees only parse failures; ValueError is the 400-vs-500 contract
            raise ValueError(f"corrupt mailbox envelope: bad block payload ({e})") from None
        if not isinstance(frame, datatable.Frame):
            raise ValueError(f"corrupt mailbox envelope: block payload is a {type(frame).__name__}, not a frame")
        # wire format stringifies column labels; runtime blocks are
        # positional, in the frame's column order
        payload = R.Block(frame.values())
    elif kind == "err":
        msg = header.get("msg", "remote stage failed")
        code = header.get("code")
        # legacy 2-tuple when the sender shipped no code; receive_all accepts both
        payload = ("__err__", msg, code) if code is not None else ("__err__", msg)
    elif kind == "eos":
        stats = header.get("stats")
        payload = ("__eos__", stats) if stats else R._EOS
    else:
        raise ValueError(f"corrupt mailbox envelope: unknown kind {kind!r}")
    return header, payload


class MailboxRegistry:
    """Per-process registry: query id -> DistributedMailbox. Entries are
    created on first touch (blocks may arrive before the local workers
    start) and expire after `ttl_s` to bound leakage from abandoned
    queries. Closed query ids are tombstoned for `tombstone_ttl_s` so a
    late straggler envelope is dropped (and counted) instead of silently
    recreating the mailbox and leaking it until TTL."""

    def __init__(self, ttl_s: float = 600.0, tombstone_ttl_s: float = 60.0):
        self._boxes: dict[str, tuple[float, "DistributedMailbox"]] = {}
        self._lock = threading.Lock()
        self._ttl = ttl_s
        self._tombstone_ttl = tombstone_ttl_s
        self._tombstones: dict[str, float] = {}  # closed qid -> close time
        self.straggler_drops = 0

    def get(self, qid: str) -> "DistributedMailbox":
        now = time.monotonic()
        with self._lock:
            for k in [k for k, (t, _) in self._boxes.items() if now - t > self._ttl]:
                if k != qid:
                    del self._boxes[k]
            # re-opening a closed qid (e.g. explicit get() by a retry) clears
            # its tombstone — the id is live again
            self._tombstones.pop(qid, None)
            ent = self._boxes.get(qid)
            if ent is None:
                ent = (now, DistributedMailbox())
            # refresh the timestamp on every touch: the TTL bounds ABANDONED
            # queries only — an actively streaming query must never lose its
            # mailbox mid-flight to creation-time eviction
            self._boxes[qid] = (now, ent[1])
            return ent[1]

    def close(self, qid: str) -> None:
        now = time.monotonic()
        with self._lock:
            self._boxes.pop(qid, None)
            self._tombstones[qid] = now
            # the tombstone set stays short: drop expired ones on each close
            for k in [k for k, t in self._tombstones.items() if now - t > self._tombstone_ttl]:
                del self._tombstones[k]

    def live_queries(self) -> list[str]:
        with self._lock:
            return sorted(self._boxes)

    def deliver(self, data: bytes) -> None:
        """HTTP-handler entry: route one envelope into the right mailbox.
        Envelopes for a tombstoned (recently closed) query are dropped and
        counted — a straggler block from a cancelled/finished query must not
        resurrect its mailbox."""
        from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
        from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics
        from pinot_tpu_torch.common.trace import trace_event

        try:
            FAULTS.maybe_fail("mailbox.deliver")
        except InjectedFault:
            trace_event("fault.injected", point="mailbox.deliver")
            raise
        header, payload = decode_envelope(data)
        qid = header["qid"]
        now = time.monotonic()
        with self._lock:
            t = self._tombstones.get(qid)
            if t is not None and now - t <= self._tombstone_ttl:
                self.straggler_drops += 1
                server_metrics().meter(ServerMeter.MAILBOX_STRAGGLER_DROPS).mark()
                return
        box = self.get(qid)
        box.deliver_local(header["rs"], header["rw"], header["ss"], payload)


class DistributedMailbox(R.MailboxService):
    """MailboxService whose send() routes by worker placement: local
    (stage, worker) pairs use the in-process queues, remote pairs POST the
    DataTable envelope to the owner's /mailbox endpoint."""

    #: connection-class send failures retry with exponential backoff +
    #: deterministic jitter, bounded by the query deadline (gRPC mailbox
    #: retry policy parity). Defaults match ResilienceConfig.
    send_retries: int = 3
    retry_initial_s: float = 0.05
    retry_max_s: float = 1.0

    def __init__(self):
        super().__init__()
        self.qid: str = ""
        self.my_id: str = ""
        self.placement: dict[tuple[int, int], str] = {}  # (stage, worker) -> participant
        self.addresses: dict[str, str] = {}  # participant -> base URL
        self.timeout: float = 30.0

    def configure(self, qid, my_id, placement, addresses, timeout=30.0) -> None:
        self.qid, self.my_id = qid, my_id
        self.placement, self.addresses = dict(placement), dict(addresses)
        self.timeout = timeout

    def deliver_local(self, rs: int, rw: int, ss: int, payload) -> None:
        super().send(ss, rs, rw, payload)

    def send(self, send_stage: int, recv_stage: int, recv_worker: int, payload) -> None:
        from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
        from pinot_tpu_torch.common.trace import trace_event

        owner = self.placement.get((recv_stage, recv_worker), self.my_id)
        if owner == self.my_id:
            super().send(send_stage, recv_stage, recv_worker, payload)
            return
        base = self.addresses[owner].rstrip("/")
        url = base + "/mailbox"
        from pinot_tpu_torch.cluster.http import _host_port

        host, port = _host_port(base)
        backoff = self.retry_initial_s
        for attempt in range(self.send_retries + 1):
            # encode per attempt: a callable payload (trailing EOS carrying
            # the trace subtree) re-snapshots, so fault/retry span events
            # recorded by a failed attempt ride the retry that succeeds
            segments = encode_envelope_segments(
                self.qid, recv_stage, recv_worker, send_stage, payload() if callable(payload) else payload
            )
            try:
                try:
                    FAULTS.maybe_fail("mailbox.send")
                except InjectedFault:
                    # span event before the retry machinery sees it: injected
                    # faults must be visible in the assembled trace
                    trace_event("fault.injected", point="mailbox.send", owner=owner, attempt=attempt)
                    raise
                # pooled keep-alive: one persistent connection per peer
                # carries every block of the shuffle; a stale socket is
                # evicted and the request re-checks-out a fresh one
                with get_pool().request(
                    host,
                    port,
                    "POST",
                    "/mailbox",
                    body=segments,
                    headers={"Content-Type": "application/x-pinot-mailbox"},
                    timeout_s=self.timeout,
                ) as resp:
                    body = resp.read()
                    status = resp.status
                if status >= 400:
                    # the envelope reached a live handler which rejected it:
                    # retrying the same bytes cannot succeed
                    detail = bytes(body).decode(errors="replace")
                    raise RuntimeError(
                        f"mailbox send to {owner} ({url}) failed: HTTP {status}: {detail}"
                    ) from None
                return
            except OSError as e:
                # connection-class (refused/reset/timeout): transient by
                # definition — retry within deadline budget
                if attempt >= self.send_retries:
                    raise RuntimeError(f"mailbox send to {owner} ({url}) failed: {e}") from None
                dl = self.deadline
                if dl is not None and dl.cancelled:
                    raise RuntimeError(
                        f"mailbox send to {owner} ({url}) abandoned: query cancelled"
                    ) from None
                # deterministic jitter: replayable under a fixed fault seed
                rng = random.Random(f"{self.qid}:{owner}:{attempt}")
                sleep_s = min(backoff, self.retry_max_s) * (0.5 + rng.random())
                if dl is not None:
                    rem = dl.remaining()
                    if rem is not None:
                        if rem <= 0:
                            raise RuntimeError(
                                f"mailbox send to {owner} ({url}) failed: {e} "
                                "(deadline exhausted)"
                            ) from None
                        sleep_s = min(sleep_s, rem)
                # a retried send is ONE span event, never a duplicated span
                trace_event(
                    "mailbox.retry",
                    owner=owner,
                    stage=recv_stage,
                    attempt=attempt,
                    sleepS=round(sleep_s, 4),
                )
                time.sleep(sleep_s)
                backoff *= 2


def handle_mailbox_post(registry: MailboxRegistry, handler) -> None:
    """Shared /mailbox POST handling for every participant's HTTP service
    (ServerHTTPService and MailboxHTTPService): read the envelope, deliver,
    answer 200 'ok'. A corrupt envelope (ValueError from decode_envelope) is
    the sender's fault — 400; anything else is ours — 500."""
    n = int(handler.headers.get("Content-Length", 0))
    try:
        registry.deliver(handler.rfile.read(n))
        handler.send_response(200)
        handler.send_header("Content-Length", "2")
        handler.end_headers()
        handler.wfile.write(b"ok")
    except Exception as e:
        from pinot_tpu_torch.common.errors import code_of

        msg = json.dumps({"error": f"{type(e).__name__}: {e}", "errorCode": code_of(e)}).encode()
        handler.send_response(400 if isinstance(e, ValueError) else 500)
        handler.send_header("Content-Length", str(len(msg)))
        handler.end_headers()
        handler.wfile.write(msg)


class MailboxHTTPService:
    """Standalone /mailbox listener for participants without a server HTTP
    service (the broker's root stage). Servers reuse their existing
    ServerHTTPService port instead."""

    def __init__(self, registry: MailboxRegistry, port: int = 0):
        from http.server import BaseHTTPRequestHandler

        from pinot_tpu_torch.cluster.http import _serve

        reg = registry

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def do_POST(self):
                if self.path != "/mailbox":
                    self.send_error(404)
                    return
                handle_mailbox_post(reg, self)

        self.registry = registry
        self.httpd, self.port, self._thread = _serve(Handler, port)
        self.url = f"http://127.0.0.1:{self.port}"

    def stop(self):
        self.httpd.shutdown()
