"""The port's sampling profiler and /debug/pprof against the JAX package's
(mirrors the profiler and pprof cases of tests/test_profiling.py). Profiler
ticks are driven explicitly with sample_once(); the only real-time waits are
the bounded /debug/pprof?seconds=N capture windows. Attribution shares are
held to the reference's bound (>= 90% of a busy query thread's samples);
folded stacks and collapsed text are compared exactly."""

import json
import re
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from pinot_tpu.common import profiler as rprof
from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.common.accounting import ResourceAccountant, default_accountant
from pinot_tpu_torch.common.profiler import SamplingProfiler, fold_stack, get_profiler, reset_profiler
from pinot_tpu_torch.segment import SegmentBuilder


def _http_get(url: str):
    try:
        with urllib.request.urlopen(url, timeout=15) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _busy_thread(acct, qid: str):
    """A worker spinning in pure Python under acct.scope(qid); returns
    (thread, stop_event) once the accountant binding is visible."""
    stop = threading.Event()
    bound = threading.Event()

    def busy():
        with acct.scope(qid):
            bound.set()
            while not stop.is_set():
                sum(range(200))

    t = threading.Thread(target=busy, name="busy-query", daemon=True)
    t.start()
    assert bound.wait(timeout=10)
    return t, stop


def test_fold_stack_equals_reference():
    frame = sys._current_frames()[threading.get_ident()]
    folded = fold_stack(frame)
    assert folded == rprof.fold_stack(frame)
    parts = folded.split(";")
    assert parts[-1] == "test_torch_profiling:test_fold_stack_equals_reference"
    assert all(":" in p for p in parts)
    assert fold_stack(frame, max_depth=3) == rprof.fold_stack(frame, max_depth=3)


def test_collapsed_text_equals_reference():
    doc = {
        "stacks": [
            {"queryId": "q1", "stack": ["a:b", "c:d"], "count": 7},
            {"queryId": "", "stack": ["a:b"], "count": 2},
        ]
    }
    assert SamplingProfiler.collapsed_text(doc) == rprof.SamplingProfiler.collapsed_text(doc)
    assert SamplingProfiler.collapsed_text({"stacks": []}) == ""


def test_profiler_attribution_deterministic():
    acct = ResourceAccountant()
    prof = SamplingProfiler(accountant=acct)
    t, stop = _busy_thread(acct, "q-busy-1")
    try:
        for _ in range(25):
            prof.sample_once()
    finally:
        stop.set()
        t.join(timeout=10)
    doc = prof.profile()
    assert doc["kind"] == "ring" and doc["samples"] >= 25
    busy = [s for s in doc["stacks"] if any(f.endswith(":busy") for f in s["stack"])]
    total = sum(s["count"] for s in busy)
    attributed = sum(s["count"] for s in busy if s["queryId"] == "q-busy-1")
    assert total >= 25
    assert attributed >= 0.9 * total
    assert re.search(r"^query:q-busy-1;.* \d+$", SamplingProfiler.collapsed_text(doc), re.M)


def test_profiler_ring_eviction_bounded():
    prof = SamplingProfiler(accountant=ResourceAccountant(), ring_max_stacks=8)
    with prof._lock:
        for i in range(50):
            prof._ring[(f"q{i}", f"a:b;c:d{i}")] = 1 + (i % 3)
        prof._evict_locked()
    doc = prof.profile()
    assert len(doc["stacks"]) <= 8
    assert doc["droppedStacks"] >= 42


def test_profiler_daemon_start_stop():
    prof = SamplingProfiler(hz=200.0)
    prof.start()
    try:
        assert prof.running
        prof.start()  # idempotent
    finally:
        prof.stop()
    assert not prof.running


def _small_cluster(tmp_path):
    controller = Controller(PropertyStore(), tmp_path / "deepstore")
    server = Server("server_0", device="cpu")
    controller.register_server("server_0", server)
    schema = Schema.build("t", dimensions=[("d", DataType.INT)], metrics=[("v", DataType.LONG)])
    controller.add_schema(schema)
    controller.add_table(TableConfig("t"))
    controller.upload_segment(
        "t", SegmentBuilder(schema).build({"d": np.arange(64, dtype=np.int32), "v": np.arange(64, dtype=np.int64)}, "t_0")
    )
    return controller, server


@pytest.mark.parametrize("role", ["server", "broker"])
def test_pprof_http_capture_attributes_running_query(tmp_path, role):
    """GET /debug/pprof?seconds=N on the server's and the broker's HTTP
    service during a running query: >= 90% of the in-query samples carry
    that query's id; the default is collapsed text of the ring; a bad
    `seconds` is a 400."""
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, ServerHTTPService

    controller, server = _small_cluster(tmp_path)
    broker = Broker(controller)
    reset_profiler()
    t, stop = _busy_thread(default_accountant, "q-live-7")
    svc = ServerHTTPService(server, port=0) if role == "server" else BrokerHTTPService(broker, port=0)
    try:
        status, body = _http_get(f"http://127.0.0.1:{svc.port}/debug/pprof?seconds=0.5&format=json")
        assert status == 200
        doc = json.loads(body)
        assert doc["kind"] == "window" and doc["samples"] > 0
        busy = [s for s in doc["stacks"] if any(f.endswith(":busy") for f in s["stack"])]
        total = sum(s["count"] for s in busy)
        attributed = sum(s["count"] for s in busy if s["queryId"] == "q-live-7")
        assert total > 0
        assert attributed >= 0.9 * total
        status, body = _http_get(f"http://127.0.0.1:{svc.port}/debug/pprof?seconds=0.2")
        assert status == 200
        lines = body.decode().splitlines()
        assert lines and all(re.fullmatch(r".+:.+ \d+", ln) for ln in lines)
        status, _ = _http_get(f"http://127.0.0.1:{svc.port}/debug/pprof")
        assert status == 200
        status, _ = _http_get(f"http://127.0.0.1:{svc.port}/debug/pprof?seconds=bogus")
        assert status == 400
    finally:
        stop.set()
        t.join(timeout=10)
        svc.stop()
        broker.shutdown()
        reset_profiler()


def test_profiler_enabled_config_starts_continuous_profiler(tmp_path):
    from pinot_tpu_torch.common.config import ObservabilityConfig

    reset_profiler()
    try:
        b = Broker(
            Controller(PropertyStore(), tmp_path / "deepstore"),
            obs_config=ObservabilityConfig(profiler_enabled=True, profiler_hz=200.0),
        )
        prof = get_profiler()
        assert prof.running and prof.hz == 200.0
        b.shutdown()
    finally:
        reset_profiler()
    # default config leaves the profiler off
    Broker(Controller(PropertyStore(), tmp_path / "deepstore2")).shutdown()
    assert not get_profiler().running
