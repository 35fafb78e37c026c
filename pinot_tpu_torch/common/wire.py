"""Pooled persistent HTTP transport for the cross-process wire plane.

Reference parity: the gRPC channel reuse in GrpcSendingMailbox /
GrpcQueryClient (pinot-query-runtime/.../mailbox/GrpcSendingMailbox.java,
one persistent channel per peer) replacing the urlopen-per-request tax the
v1 wire paid: every scatter hop and every mailbox block previously opened a
fresh TCP connection (3-way handshake + slow start) for a single POST.

`ConnectionPool` keeps keep-alive `http.client.HTTPConnection`s keyed by
(host, port):

* **max-per-host** — at most `max_per_host` live connections per peer;
  excess checkouts wait on a condition variable, bounded by the caller's
  timeout/deadline (`WireTimeout` on expiry).
* **health eviction** — idle sockets past `idle_ttl_s`, or readable while
  idle (server closed or sent junk: an idle HTTP connection must be
  silent), are closed and replaced instead of handed out.
* **stale retry** — a *connection-class* failure (ConnectionError /
  RemoteDisconnected) on a *reused* connection is indistinguishable from a
  keep-alive socket the peer closed under us; the request retries exactly
  once on a freshly connected socket. Failures on fresh connections
  propagate (the peer really is down), and timeouts never retry — a slow
  peer may already be executing the non-idempotent POST, so a re-send
  would double-deliver; they raise WireTimeout instead.

Lock discipline (pinotlint blocking-under-lock): all socket operations —
connect, close, select() health probes, request I/O — happen OUTSIDE the
pool's condition lock; the only blocking call under it is the condition's
own `wait()`, which releases the lock.

Counters live both in `get_registry("wire")` (exposition) and as plain
ints inside the pool (`stats()`, immune to `reset_registries()` mid-run).
"""

from __future__ import annotations

import http.client
import select
import socket
import struct
import threading
import time

from pinot_tpu_torch.common.faults import FAULTS
from pinot_tpu_torch.common.metrics import get_registry


class WireError(OSError):
    """Transport-layer failure (connect, send, or framing)."""


class WireTimeout(WireError, TimeoutError):
    """Checkout or request deadline expired."""


#: stream-frame markers shared by /query/stream and the micro bench:
#: [u32 len][payload]... then [u32 0]; error mid-stream: [u32 0xFFFFFFFF]
#: [u32 len][message]
FRAME_END = 0
FRAME_ERR = 0xFFFFFFFF
_U32 = struct.Struct("<I")


def read_exact(stream, n: int) -> bytearray:
    """Read exactly `n` bytes via readinto — one buffer, no concat of
    partial recv()s. Raises WireError on premature EOF."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = stream.readinto(view[got:])
        if not k:
            raise WireError(f"stream truncated: expected {n} bytes, got {got}")
        got += k
    return buf


def write_frame(wfile, segments) -> int:
    """Length-prefix + gather-write one frame of iovec segments; returns
    the payload byte count."""
    total = sum(len(s) for s in segments)
    wfile.write(_U32.pack(total))
    wfile.writelines(segments)
    return total


class PooledConnection:
    """One live HTTPConnection plus its pool bookkeeping."""

    __slots__ = ("conn", "key", "idle_since", "reused")

    def __init__(self, conn, key):
        self.conn = conn
        self.key = key
        self.idle_since = 0.0
        self.reused = False


class WireResponse:
    """HTTPResponse wrapper tying response lifecycle to pool return. Use as
    a context manager: on clean exit the connection goes back to the pool
    iff the body was fully drained and the server kept the connection open;
    on error (or an undrained body) the socket is discarded."""

    __slots__ = ("_pool", "_entry", "resp", "status")

    def __init__(self, pool, entry, resp):
        self._pool = pool
        self._entry = entry
        self.resp = resp
        self.status = resp.status

    def read(self, amt=None):
        return self.resp.read(amt)

    def readinto(self, b):
        return self.resp.readinto(b)

    def getheader(self, name, default=None):
        return self.resp.getheader(name, default)

    @property
    def length(self):
        return self.resp.length

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        self.close(discard=exc_type is not None)

    def close(self, discard: bool = False) -> None:
        entry, self._entry = self._entry, None
        if entry is None:
            return
        resp = self.resp
        reusable = not discard and resp.isclosed() and not resp.will_close
        try:
            resp.close()
        except OSError:
            reusable = False
        if reusable:
            self._pool.release(entry)
        else:
            self._pool.discard(entry)


class ConnectionPool:
    """Keep-alive HTTPConnection pool keyed by (host, port)."""

    def __init__(
        self,
        max_per_host: int = 128,
        idle_ttl_s: float = 60.0,
        connect_timeout_s: float = 5.0,
    ):
        self.max_per_host = max_per_host
        self.idle_ttl_s = idle_ttl_s
        self.connect_timeout_s = connect_timeout_s
        self._cv = threading.Condition()
        self._idle: dict[tuple, list[PooledConnection]] = {}
        self._total: dict[tuple, int] = {}  # live conns (idle + checked out)
        self._closed = False
        self._hits = 0
        self._misses = 0
        self._evictions = 0
        self._stale_retries = 0
        self._checkout_timeouts = 0

    # -- metrics ------------------------------------------------------------

    def _mark(self, name: str) -> None:
        get_registry("wire").meter(f"wire.pool.{name}").mark()

    def stats(self) -> dict:
        with self._cv:
            return {
                "hits": self._hits,
                "misses": self._misses,
                "evictions": self._evictions,
                "staleRetries": self._stale_retries,
                "checkoutTimeouts": self._checkout_timeouts,
                "idle": sum(len(v) for v in self._idle.values()),
                "live": sum(self._total.values()),
            }

    # -- connection lifecycle ----------------------------------------------

    def _connect(self, host: str, port: int) -> http.client.HTTPConnection:
        FAULTS.maybe_fail("wire.connect")
        conn = http.client.HTTPConnection(host, port, timeout=self.connect_timeout_s)
        t0 = time.perf_counter()
        try:
            conn.connect()
            # TCP_NODELAY: segment-list bodies go out as several small
            # sends; on a reused connection Nagle would hold each behind
            # the peer's delayed ACK
            conn.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        except OSError:
            conn.close()
            raise
        # client-side wire phase: TCP dial time (pool misses only — the
        # connect share of the client-minus-server latency gap)
        get_registry("wire").timer("wire.connectMs").update_ms(
            (time.perf_counter() - t0) * 1e3
        )
        return conn

    @staticmethod
    def _stale(entry: PooledConnection, idle_ttl_s: float) -> bool:
        if time.monotonic() - entry.idle_since > idle_ttl_s:
            return True
        sock = entry.conn.sock
        if sock is None:
            return True
        try:
            readable, _, _ = select.select([sock], [], [], 0)
        except (OSError, ValueError):
            return True
        # an idle keep-alive connection must be silent: readable means the
        # peer closed it (EOF pending) or is violating the protocol
        return bool(readable)

    def checkout(self, host: str, port: int, timeout_s=None, deadline_ts=None) -> PooledConnection:
        """Borrow a connection, waiting (bounded by timeout_s and/or an
        absolute `deadline_ts` from time.monotonic()) when the per-host cap
        is exhausted. Stale idle sockets found on the way are evicted."""
        key = (host, int(port))
        limit = None
        if timeout_s is not None:
            limit = time.monotonic() + timeout_s
        if deadline_ts is not None:
            limit = deadline_ts if limit is None else min(limit, deadline_ts)
        while True:
            entry = None
            fresh = False
            with self._cv:
                while True:
                    if self._closed:
                        raise WireError("connection pool is closed")
                    bucket = self._idle.get(key)
                    if bucket:
                        entry = bucket.pop()
                        break
                    if self._total.get(key, 0) < self.max_per_host:
                        self._total[key] = self._total.get(key, 0) + 1
                        fresh = True
                        break
                    remaining = None
                    if limit is not None:
                        remaining = limit - time.monotonic()
                        if remaining <= 0:
                            self._checkout_timeouts += 1
                            break
                    self._cv.wait(remaining)
            if not fresh and entry is None:  # timed out above
                self._mark("checkoutTimeouts")
                raise WireTimeout(
                    f"connection pool checkout to {host}:{port} timed out "
                    f"(max_per_host={self.max_per_host} all busy)"
                )
            if fresh:
                try:
                    conn = self._connect(host, port)
                except BaseException:
                    with self._cv:
                        self._total[key] -= 1
                        self._cv.notify()
                    raise
                with self._cv:
                    self._misses += 1
                self._mark("misses")
                return PooledConnection(conn, key)
            # idle candidate: probe health outside the lock
            if self._stale(entry, self.idle_ttl_s):
                self._evict(entry)
                continue
            entry.reused = True
            with self._cv:
                self._hits += 1
            self._mark("hits")
            return entry

    def release(self, entry: PooledConnection) -> None:
        """Return a healthy connection to the idle list."""
        entry.idle_since = time.monotonic()
        entry.reused = False
        with self._cv:
            if not self._closed:
                self._idle.setdefault(entry.key, []).append(entry)
                self._cv.notify()
                return
            self._total[entry.key] -= 1
            self._cv.notify()
        entry.conn.close()

    def discard(self, entry: PooledConnection) -> None:
        """Drop a connection that must not be reused (error, no keep-alive)."""
        with self._cv:
            self._total[entry.key] -= 1
            self._cv.notify()
        try:
            entry.conn.close()
        except OSError:
            pass

    def _evict(self, entry: PooledConnection) -> None:
        with self._cv:
            self._total[entry.key] -= 1
            self._evictions += 1
            self._cv.notify()
        self._mark("evictions")
        try:
            entry.conn.close()
        except OSError:
            pass

    def close(self) -> None:
        """Close all idle connections and refuse new checkouts (tests)."""
        with self._cv:
            self._closed = True
            idle = [e for bucket in self._idle.values() for e in bucket]
            self._idle.clear()
            for e in idle:
                self._total[e.key] -= 1
            self._cv.notify_all()
        for e in idle:
            try:
                e.conn.close()
            except OSError:
                pass

    def reset(self) -> None:
        """Close idle conns, zero counters, reopen (test isolation)."""
        self.close()
        with self._cv:
            self._closed = False
            self._hits = self._misses = self._evictions = 0
            self._stale_retries = self._checkout_timeouts = 0

    # -- request helper ------------------------------------------------------

    def request(
        self,
        host: str,
        port: int,
        method: str,
        path: str,
        body=None,
        headers=None,
        timeout_s: float = 30.0,
        deadline_ts=None,
    ) -> WireResponse:
        """One HTTP exchange over a pooled connection.

        `body` may be None, a bytes-like, or a list of iovec segments (the
        `datatable.encode_segments` shape) — segments are gather-written
        with an explicit Content-Length so http.client never falls back to
        chunked transfer (the stdlib server can't decode it).

        A connection-class failure (peer closed the keep-alive socket:
        ConnectionError / RemoteDisconnected) on a REUSED connection retries
        once on a fresh socket; the stale one is discarded either way.
        Timeouts NEVER retry: a slow peer may already be executing the
        (non-idempotent) request, so a re-send would double-deliver — they
        surface as WireTimeout after discarding the socket.
        """
        retried = False
        while True:
            entry = self.checkout(host, port, timeout_s=timeout_s, deadline_ts=deadline_ts)
            try:
                resp = self._exchange(entry, method, path, body, headers, timeout_s, deadline_ts)
                return WireResponse(self, entry, resp)
            except WireTimeout:
                self.discard(entry)
                raise
            except TimeoutError as e:  # socket.timeout: slow peer, not stale
                self.discard(entry)
                raise WireTimeout(
                    f"HTTP exchange with {host}:{port} timed out ({method} {path})"
                ) from e
            except (OSError, http.client.HTTPException) as e:
                self.discard(entry)
                # retry only connection-class failures — the signature of a
                # keep-alive socket the peer closed under us. RemoteDisconnected
                # subclasses ConnectionResetError, so one check covers EOF on
                # getresponse(), EPIPE/ECONNRESET on send, and refused dials.
                if entry.reused and not retried and isinstance(e, ConnectionError):
                    retried = True
                    with self._cv:
                        self._stale_retries += 1
                    self._mark("staleRetries")
                    continue
                if isinstance(e, http.client.HTTPException):
                    raise WireError(f"HTTP exchange with {host}:{port} failed: {e}") from e
                raise

    def _exchange(self, entry, method, path, body, headers, timeout_s, deadline_ts):
        remaining = timeout_s
        if deadline_ts is not None:
            remaining = min(
                remaining if remaining is not None else float("inf"),
                deadline_ts - time.monotonic(),
            )
            if remaining <= 0:
                raise WireTimeout(f"deadline expired before {method} {path}")
        conn = entry.conn
        if conn.sock is not None:
            conn.sock.settimeout(remaining)
        hdrs = dict(headers or {})
        t0 = time.perf_counter()
        if body is None:
            conn.request(method, path, headers=hdrs)
        else:
            if isinstance(body, (bytes, bytearray, memoryview)):
                length = len(body)
            else:
                body = list(body)
                length = sum(len(s) for s in body)
            hdrs.setdefault("Content-Length", str(length))
            hdrs.setdefault("Content-Type", "application/octet-stream")
            conn.request(method, path, body=body, headers=hdrs)
        t_sent = time.perf_counter()
        resp = conn.getresponse()
        t_first = time.perf_counter()
        # client-side wire phases: request write vs time-to-first-byte (the
        # TTFB slice contains the server's whole handling time; subtracting
        # the server-reported time isolates queueing + wire)
        reg = get_registry("wire")
        reg.timer("wire.sendMs").update_ms((t_sent - t0) * 1e3)
        reg.timer("wire.ttfbMs").update_ms((t_first - t_sent) * 1e3)
        return resp


#: process-global pool shared by the v1 scatter client, the v2 mailbox
#: sender, and the controller proxy. Sized so a saturating client fleet
#: (bench.py qps runs 128 threads) never queues on checkout by default.
POOL = ConnectionPool()


def get_pool() -> ConnectionPool:
    return POOL
