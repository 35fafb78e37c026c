"""The port's pooled keep-alive transport (common/wire.py) against the JAX
package's: reuse, stale eviction, the connection-class retry, WireTimeout and
the stream framing, from `tests/test_wire.py`. Each case runs through both
packages on the same echo server and must leave the same pool statistics.
"""

import http.server
import importlib
import io
import socket
import struct
import threading
import time

import numpy as np
import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")


def _mods(pkg):
    return (
        importlib.import_module(f"{pkg}.common.wire"),
        importlib.import_module(f"{pkg}.common.faults"),
        importlib.import_module(f"{pkg}.common.datatable"),
    )


@pytest.fixture(autouse=True)
def _clean_faults():
    for pkg in PKGS:
        _mods(pkg)[1].FAULTS.reset()
    yield
    for pkg in PKGS:
        _mods(pkg)[1].FAULTS.reset()


class _EchoHandler(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    connections: list = []

    def do_POST(self):
        body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).connections.append(self.connection)
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    do_GET = do_POST

    def log_message(self, *a):
        pass


def _serve(handler_cls, port=0):
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", port), handler_cls)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv


def _stop(srv):
    srv.shutdown()
    srv.server_close()


def _both(fn):
    """fn(pkg) -> a result; the two packages' results must be equal."""
    got = {pkg: fn(pkg) for pkg in PKGS}
    assert got["pinot_tpu_torch"] == got["pinot_tpu"], got
    return got["pinot_tpu_torch"]


def test_read_exact_eof():
    def run(pkg):
        wire = _mods(pkg)[0]
        head = bytes(wire.read_exact(io.BytesIO(b"abcdef"), 4))
        with pytest.raises(wire.WireError, match="truncated"):
            wire.read_exact(io.BytesIO(b"ab"), 4)
        return head

    assert _both(run) == b"abcd"


def test_pool_hit_miss_and_release():
    srv = _serve(_EchoHandler)
    port = srv.server_address[1]

    def run(pkg):
        pool = _mods(pkg)[0].ConnectionPool()
        try:
            bodies = []
            for _ in range(3):
                with pool.request("127.0.0.1", port, "POST", "/x", body=b"ping") as resp:
                    bodies.append((resp.status, resp.read()))
            s = pool.stats()
            return bodies, {k: s[k] for k in ("misses", "hits", "live", "idle")}
        finally:
            pool.close()

    try:
        bodies, s = _both(run)
        assert bodies == [(200, b"ping")] * 3
        assert s == {"misses": 1, "hits": 2, "live": 1, "idle": 1}
    finally:
        _stop(srv)


def test_connection_close_is_not_pooled():
    class _CloseHandler(_EchoHandler):
        def do_POST(self):
            body = self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(body)

    srv = _serve(_CloseHandler)
    port = srv.server_address[1]

    def run(pkg):
        pool = _mods(pkg)[0].ConnectionPool()
        try:
            for _ in range(2):
                with pool.request("127.0.0.1", port, "POST", "/x", body=b"d") as resp:
                    resp.read()
            s = pool.stats()
            return {k: s[k] for k in ("misses", "hits", "live")}
        finally:
            pool.close()

    try:
        assert _both(run) == {"misses": 2, "hits": 0, "live": 0}
    finally:
        _stop(srv)


def test_max_per_host_checkout_timeout():
    srv = _serve(_EchoHandler)
    port = srv.server_address[1]

    def run(pkg):
        wire = _mods(pkg)[0]
        pool = wire.ConnectionPool(max_per_host=1)
        try:
            held = pool.checkout("127.0.0.1", port)
            t0 = time.monotonic()
            with pytest.raises(wire.WireTimeout, match="all busy"):
                pool.checkout("127.0.0.1", port, timeout_s=0.2)
            assert time.monotonic() - t0 < 2.0
            got = []
            t = threading.Thread(target=lambda: got.append(pool.checkout("127.0.0.1", port, timeout_s=5.0)))
            t.start()
            pool.release(held)
            t.join(timeout=5.0)
            reused = bool(got) and got[0].reused
            if got:
                pool.release(got[0])
            return pool.stats()["checkoutTimeouts"], reused
        finally:
            pool.close()

    try:
        assert _both(run) == (1, True)
    finally:
        _stop(srv)


def test_deadline_honored():
    srv = _serve(_EchoHandler)
    port = srv.server_address[1]

    def run(pkg):
        wire = _mods(pkg)[0]
        pool = wire.ConnectionPool(max_per_host=1)
        try:
            with pytest.raises(wire.WireTimeout):
                pool.request("127.0.0.1", port, "POST", "/x", body=b"d", deadline_ts=time.monotonic() - 0.01)
            held = pool.checkout("127.0.0.1", port)
            t0 = time.monotonic()
            with pytest.raises(wire.WireTimeout):
                pool.checkout("127.0.0.1", port, deadline_ts=time.monotonic() + 0.2)
            waited = time.monotonic() - t0 < 2.0
            pool.release(held)
            return waited
        finally:
            pool.close()

    try:
        assert _both(run) is True
    finally:
        _stop(srv)


def test_ttl_stale_eviction():
    srv = _serve(_EchoHandler)
    port = srv.server_address[1]

    def run(pkg):
        pool = _mods(pkg)[0].ConnectionPool(idle_ttl_s=0.05)
        try:
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"a") as resp:
                resp.read()
            time.sleep(0.1)
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"b") as resp:
                body = resp.read()
            s = pool.stats()
            return body, {k: s[k] for k in ("evictions", "misses", "hits")}
        finally:
            pool.close()

    try:
        assert _both(run) == (b"b", {"evictions": 1, "misses": 2, "hits": 0})
    finally:
        _stop(srv)


@pytest.mark.parametrize("pkg", PKGS)
def test_server_restart_evicts_stale_socket(pkg):
    """A server restarted behind a live pool entry: the stale socket is
    evicted, or the connection-class retry runs the request on a fresh
    connection to the new process."""

    class _H(_EchoHandler):
        connections = []

    srv = _serve(_H)
    port = srv.server_address[1]
    pool = _mods(pkg)[0].ConnectionPool()
    srv2 = None
    try:
        with pool.request("127.0.0.1", port, "POST", "/x", body=b"one") as resp:
            resp.read()
        _stop(srv)
        for c in _H.connections:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        srv2 = _serve(_EchoHandler, port=port)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            if pool._stale(pool._idle[("127.0.0.1", port)][0], pool.idle_ttl_s):
                break
            time.sleep(0.01)
        with pool.request("127.0.0.1", port, "POST", "/x", body=b"two") as resp:
            assert resp.read() == b"two"
        s = pool.stats()
        assert s["evictions"] + s["staleRetries"] >= 1, s
    finally:
        pool.close()
        if srv2 is not None:
            _stop(srv2)


def test_2d_array_content_length_over_http():
    srv = _serve(_EchoHandler)
    port = srv.server_address[1]
    arr = np.arange(5000 * 4, dtype=np.float64).reshape(5000, 4)

    def run(pkg):
        wire, _, dt = _mods(pkg)
        pool = wire.ConnectionPool()
        try:
            with pool.request("127.0.0.1", port, "POST", "/x", body=dt.encode_segments({"m": arr})) as resp:
                echoed = resp.read()
            np.testing.assert_array_equal(dt.decode(echoed)["m"], arr)
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"ok") as resp:
                follow = resp.read()
            s = pool.stats()
            return echoed, follow, s["hits"], s["staleRetries"]
        finally:
            pool.close()

    try:
        _, follow, hits, retries = _both(run)
        assert (follow, hits, retries) == (b"ok", 1, 0)
    finally:
        _stop(srv)


def test_write_frame_prefix_matches_payload_2d():
    arr = np.arange(4096 * 3, dtype=np.int64).reshape(4096, 3)

    def run(pkg):
        wire, _, dt = _mods(pkg)
        buf = io.BytesIO()
        total = wire.write_frame(buf, dt.encode_segments(arr))
        raw = buf.getvalue()
        assert struct.unpack("<I", raw[:4])[0] == total == len(raw) - 4
        np.testing.assert_array_equal(dt.decode(raw[4:]), arr)
        return raw

    _both(run)


def test_slow_response_times_out_without_retry():
    """A timeout on a reused connection takes no stale retry: exactly one
    delivery of the POST and a WireTimeout."""

    class _SlowHandler(_EchoHandler):
        slow_hits = 0

        def do_POST(self):
            if self.path == "/slow":
                type(self).slow_hits += 1
                time.sleep(0.4)
            try:
                super().do_POST()
            except OSError:
                pass

    srv = _serve(_SlowHandler)
    port = srv.server_address[1]

    def run(pkg):
        wire = _mods(pkg)[0]
        pool = wire.ConnectionPool()
        _SlowHandler.slow_hits = 0
        try:
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"warm") as resp:
                resp.read()
            with pytest.raises(wire.WireTimeout):
                pool.request("127.0.0.1", port, "POST", "/slow", body=b"d", timeout_s=0.1)
            time.sleep(0.45)
            s = pool.stats()
            return _SlowHandler.slow_hits, s["staleRetries"], s["hits"]
        finally:
            pool.close()

    try:
        assert _both(run) == (1, 0, 1)
    finally:
        _stop(srv)


def test_wire_connect_fault_point():
    srv = _serve(_EchoHandler)
    port = srv.server_address[1]

    def run(pkg):
        wire, faults, _ = _mods(pkg)
        pool = wire.ConnectionPool()
        try:
            faults.FAULTS.configure({"wire.connect": faults.FaultRule(max_count=1)})
            with pytest.raises(faults.InjectedFault):
                pool.request("127.0.0.1", port, "POST", "/x", body=b"d")
            fired = faults.FAULTS.counts()["wire.connect"]
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"d") as resp:
                body = (resp.status, resp.read())
            return fired, body, pool.stats()["live"]
        finally:
            faults.FAULTS.reset()
            pool.close()

    try:
        assert _both(run) == (1, (200, b"d"), 1)
    finally:
        _stop(srv)


def test_connection_class_error_retries_once_on_a_fresh_socket():
    """A reused socket the peer closed without a FIN the pool could see:
    the request fails connection-class on it and is re-sent once on a
    fresh dial (staleRetries 1), in both packages."""

    class _OneShot(_EchoHandler):
        def do_POST(self):
            super().do_POST()
            self.close_connection = True  # no Connection: close header

    srv = _serve(_OneShot)
    port = srv.server_address[1]

    def run(pkg):
        wire = _mods(pkg)[0]
        pool = wire.ConnectionPool(idle_ttl_s=60.0)
        try:
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"a") as resp:
                resp.read()
            entry = pool._idle[("127.0.0.1", port)][0]
            pool._stale = lambda e, ttl: False  # the FIN is not visible yet
            with pool.request("127.0.0.1", port, "POST", "/x", body=b"b") as resp:
                body = resp.read()
            s = pool.stats()
            return body, s["staleRetries"] + s["evictions"] >= 1, entry is not None
        finally:
            pool.close()

    try:
        assert _both(run) == (b"b", True, True)
    finally:
        _stop(srv)


@pytest.mark.parametrize("pkg", PKGS)
def test_mid_stream_disconnect_is_clean_error(pkg):
    http_mod = importlib.import_module(f"{pkg}.cluster.http")

    class _TruncHandler(http.server.BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self.send_response(200)
            self.send_header("Connection", "close")
            self.end_headers()
            self.wfile.write(b"\x64\x00\x00\x00" + b"x" * 10)
            self.close_connection = True

        def log_message(self, *a):
            pass

    srv = _serve(_TruncHandler)
    try:
        client = http_mod.RemoteServerClient(f"http://127.0.0.1:{srv.server_address[1]}")
        with pytest.raises(RuntimeError, match="stream truncated"):
            list(client.execute_partials_stream("t", "SELECT 1", ["s0"]))
    finally:
        _stop(srv)


def test_get_pool_is_process_wide_and_counts():
    """get_pool() is one pool a process; stats() carries the keys the
    cluster phases read (hits, misses, live, idle)."""
    port_wire = _mods("pinot_tpu_torch")[0]
    assert port_wire.get_pool() is port_wire.get_pool()
    assert {"hits", "misses", "live", "idle", "evictions", "staleRetries"} <= set(port_wire.get_pool().stats())
    assert set(port_wire.get_pool().stats()) == set(_mods("pinot_tpu")[0].get_pool().stats())
