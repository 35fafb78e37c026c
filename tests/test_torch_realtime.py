"""The port's realtime ingestion against the JAX package's, on the CPU.

Every case drives both packages with the same seeded stream: produce, let
the consumers catch up, stop the managers, then compare what each package
committed (segment names, offsets and numDocs in the controller metadata,
the deep-store files byte for byte) and the rows of a query corpus through
each package's Broker. The cases are the reference's `tests/test_realtime.py`,
`tests/test_chaos.py`, `test_survivability.py::test_stream_lag_fault_is_lag_not_loss`,
the two realtime cases of `tests/test_query_cache.py` and the ingest series of
`tests/test_frontend_obs.py`, each run through both packages; plus the empty
and one-doc consuming segment, the sealed segment that stays queryable while
its commit runs, and ChangeTableState reaching a real consumer.
Tolerance: rows equal (exact integer sums, COUNT, group keys).
"""

import random
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.realtime as r_realtime
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.realtime as p_realtime

REF = SimpleNamespace(
    name="ref", cluster=r_cluster, common=r_common, realtime=r_realtime, server=lambda sid: r_cluster.Server(sid)
)
PORT = SimpleNamespace(
    name="port",
    cluster=p_cluster,
    common=p_common,
    realtime=p_realtime,
    server=lambda sid: p_cluster.Server(sid, device="cpu"),
)
PKGS = (REF, PORT)


def _schema(pkg, shard=True):
    dt = pkg.common.DataType
    dims = [("kind", dt.STRING)] + ([("shard", dt.INT)] if shard else [])
    return pkg.common.Schema.build("events", dimensions=dims, metrics=[("value", dt.LONG)])


def _cluster(pkg, root, partitions=2, shard=True, server_id="server_rt"):
    controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / "deep")
    server = pkg.server(server_id)
    controller.register_server(server_id, server)
    schema = _schema(pkg, shard)
    controller.add_schema(schema)
    config = pkg.common.TableConfig("events", table_type=pkg.common.TableType.REALTIME, replication=1)
    controller.add_table(config)
    stream = pkg.realtime.InMemoryStream(partitions=partitions)
    return controller, server, schema, config, stream


def _produce(stream, n, start=0, partitions=2, shard=True):
    for i in range(start, start + n):
        row = {"kind": f"k{i % 5}", "value": i}
        if shard:
            row["shard"] = i % partitions
        stream.produce(i % partitions, row)


def _wait(pred, timeout=15.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _committed(controller, table="events"):
    """Committed segment -> (startOffset, endOffset, numDocs, partition)."""
    return {
        n: (m["startOffset"], m["endOffset"], m["numDocs"], m["partition"])
        for n, m in sorted(controller.all_segment_metadata(table).items())
        if "endOffset" in m
    }


def _deep_bytes(controller, table="events"):
    """Committed segment -> its deep-store files' bytes."""
    out = {}
    for n, m in sorted(controller.all_segment_metadata(table).items()):
        if "endOffset" in m and m.get("location"):
            d = Path(m["location"])
            out[n] = {p.name: p.read_bytes() for p in sorted(d.iterdir()) if p.is_file()}
    return out


CORPUS = [
    "SELECT COUNT(*), SUM(value) FROM events",
    "SELECT kind, COUNT(*), SUM(value), MIN(value), MAX(value) FROM events GROUP BY kind ORDER BY kind LIMIT 10",
    "SELECT kind, DISTINCTCOUNT(value) FROM events WHERE value % 3 = 1 GROUP BY kind ORDER BY kind",
    "SELECT value FROM events WHERE kind = 'k2' ORDER BY value DESC LIMIT 7",
    "SELECT DISTINCT kind FROM events ORDER BY kind",
]


def _rows(pkg, controller, queries=CORPUS):
    broker = pkg.cluster.Broker(controller)
    try:
        return [broker.execute(q).rows for q in queries]
    finally:
        broker.shutdown()


def _settle(controller, want_committed, timeout=10.0):
    """Wait until `want_committed` segments carry their end offsets."""
    _wait(lambda: len(_committed(controller)) >= want_committed, timeout)


# -- MutableSegment ---------------------------------------------------------


def _describe(seg):
    return {
        "name": seg.name,
        "n_docs": seg.n_docs,
        "columns": {
            c: (ci.cardinality, [v.item() if isinstance(v, np.generic) else v for v in ci.materialize()])
            for c, ci in sorted(seg.columns.items())
        },
    }


def test_mutable_segment_append_snapshot_seal():
    out = {}
    for pkg in PKGS:
        ms = pkg.realtime.MutableSegment("m0", _schema(pkg))
        for i in range(100):
            ms.index({"kind": f"k{i % 3}", "shard": i % 4, "value": i})
        assert ms.n_docs == 100
        snap = ms.snapshot()
        assert snap.n_docs == 100 and snap.columns["kind"].cardinality == 3
        assert ms.snapshot() is snap  # cached until more rows land
        ms.index({"kind": "k9", "shard": 0, "value": -1})
        snap2 = ms.snapshot()
        assert snap2 is not snap and snap2.n_docs == 101
        sealed = ms.seal()
        assert sealed.n_docs == 101
        assert ms.get_row(100) == {"kind": "k9", "shard": 0, "value": -1}
        out[pkg.name] = _describe(sealed)
    assert out["port"] == out["ref"]
    from pinot_tpu_torch.query import QueryEngine

    ms = p_realtime.MutableSegment("m0", _schema(PORT))
    for i in range(101):
        ms.index({"kind": "k9" if i == 100 else f"k{i % 3}", "shard": i % 4, "value": i})
    r = QueryEngine([ms.seal()], device="cpu").execute("SELECT COUNT(*) FROM events WHERE kind = 'k9'")
    assert r.rows == [[1]]


def test_mutable_null_substitution():
    out = {}
    for pkg in PKGS:
        ms = pkg.realtime.MutableSegment("m0", _schema(pkg))
        ms.index({"kind": None, "shard": 1})  # value missing entirely
        snap = ms.snapshot()
        assert snap.columns["kind"].materialize()[0] == "null"
        assert snap.columns["value"].forward[0] == np.iinfo(np.int64).min
        out[pkg.name] = _describe(snap)
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("n", [0, 1])
def test_empty_and_one_doc_consuming_segment(n, tmp_path):
    """Right after a rollover the consuming segment holds 0 docs, then 1:
    the snapshot (padded to the doc pad) answers every corpus query through
    the broker, with the reference's rows, beside a committed segment."""
    out = {}
    for pkg in PKGS:
        controller, server, schema, config, stream = _cluster(pkg, tmp_path / pkg.name, partitions=1)
        _produce(stream, 20 + n, partitions=1)
        mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=20)
        mgr.start()
        try:
            assert mgr.wait_until_caught_up([20 + n])
            _settle(controller, 1)
            assert _wait(lambda: mgr.consumers[0]._seg_name() == "events__0__1")
            assert mgr.consumers[0]._mutable.n_docs == n
            assert _wait(lambda: "events__0__1" in controller.ideal_state("events"))
            consuming = server._resolve_segments("events", ["events__0__1"])
            assert [s.n_docs for s in consuming] == [n]
            out[pkg.name] = {"rows": _rows(pkg, controller), "committed": _committed(controller)}
        finally:
            mgr.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["rows"][0] == [[20 + n, float(sum(range(20 + n)))]]


# -- consume, roll over, resume ---------------------------------------------


def test_consume_and_query_consuming_segments(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, schema, config, stream = _cluster(pkg, tmp_path / pkg.name)
        _produce(stream, 500)
        mgr = pkg.realtime.RealtimeTableManager(
            controller, server, schema, config, stream, max_rows_per_segment=10_000
        )
        mgr.start()
        try:
            assert mgr.wait_until_caught_up([stream.latest_offset(0), stream.latest_offset(1)])
            broker = pkg.cluster.Broker(controller)
            assert broker.execute("SELECT COUNT(*) FROM events").rows == [[500]]
            res = broker.execute("SELECT kind, COUNT(*) FROM events GROUP BY kind ORDER BY kind LIMIT 10")
            assert [r[1] for r in res.rows] == [100] * 5
            broker.shutdown()
            out[pkg.name] = _rows(pkg, controller)
        finally:
            mgr.stop()
    assert out["port"] == out["ref"]


def test_rollover_commits_segments(tmp_path):
    """Committed names, offsets and numDocs, the deep-store bytes of every
    committed segment and the corpus rows equal the reference's."""
    out = {}
    for pkg in PKGS:
        controller, server, schema, config, stream = _cluster(pkg, tmp_path / pkg.name)
        _produce(stream, 1000)
        mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=120)
        mgr.start()
        try:
            assert mgr.wait_until_caught_up([stream.latest_offset(0), stream.latest_offset(1)])
            _settle(controller, 8)  # 500 rows a partition / 120 a segment
            committed = _committed(controller)
            assert len(committed) == 8
            for name, (start, end, docs, _p) in committed.items():
                assert end > start and docs == end - start == 120
            res = pkg.cluster.Broker(controller).execute("SELECT COUNT(*), SUM(value) FROM events")
            assert res.rows[0][0] == 1000 and res.rows[0][1] == float(sum(range(1000)))
            rows = _rows(pkg, controller)
        finally:
            mgr.stop()
        out[pkg.name] = {"committed": committed, "bytes": _deep_bytes(controller), "rows": rows}
    assert out["port"]["committed"] == out["ref"]["committed"]
    assert out["port"]["bytes"] == out["ref"]["bytes"]
    assert out["port"]["rows"] == out["ref"]["rows"]


def test_checkpoint_resume_no_duplicates(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, schema, config, stream = _cluster(pkg, tmp_path / pkg.name)
        _produce(stream, 300)
        mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=100)
        mgr.start()
        assert mgr.wait_until_caught_up([stream.latest_offset(0), stream.latest_offset(1)])
        assert _wait(lambda: {m.get("partition") for m in controller.all_segment_metadata("events").values()
                              if "endOffset" in m} >= {0, 1})
        mgr.stop()
        # uncommitted consuming rows are re-consumed from the last committed
        # offset by the restarted manager: every row exactly once
        _produce(stream, 200, start=300)
        server2 = pkg.server("server_rt")
        controller._servers["server_rt"] = server2
        for name, m in controller.all_segment_metadata("events").items():
            if "endOffset" in m:
                server2.add_segment("events", name, m["location"])
        mgr2 = pkg.realtime.RealtimeTableManager(
            controller, server2, schema, config, stream, max_rows_per_segment=100
        )
        assert [(c.offset, c.sequence) for c in mgr2.consumers] == [
            mgr2._recover(p) for p in range(2)
        ]
        mgr2.start()
        try:
            assert mgr2.wait_until_caught_up([stream.latest_offset(0), stream.latest_offset(1)])
            _settle(controller, 4)
            res = pkg.cluster.Broker(controller).execute("SELECT COUNT(*), DISTINCTCOUNT(value) FROM events")
            assert res.rows[0] == [500, 500]
            rows = _rows(pkg, controller)
        finally:
            mgr2.stop()
        out[pkg.name] = {"committed": _committed(controller), "rows": rows, "bytes": _deep_bytes(controller)}
    assert out["port"] == out["ref"]


def test_rollover_keeps_sealed_rows_queryable(tmp_path):
    """While a single-replica commit uploads, the sealed segment still
    answers under its consuming name (the port keeps it in pending_sealed),
    so a query routed before the commit lands counts every row."""
    controller, server, schema, config, stream = _cluster(PORT, tmp_path, partitions=1)
    mgr = p_realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=30)
    c = mgr.consumers[0]
    committing, release = threading.Event(), threading.Event()
    real = c.commit_fn

    def slow_commit(seg, start, end):
        committing.set()
        assert release.wait(20.0)
        real(seg, start, end)

    c.commit_fn = slow_commit
    _produce(stream, 30, partitions=1)
    mgr.start()
    try:
        assert committing.wait(15.0)
        segs = server._resolve_segments("events", ["events__0__0"])
        assert [s.n_docs for s in segs] == [30]
        res = p_cluster.Broker(controller).execute("SELECT COUNT(*), SUM(value) FROM events")
        assert res.rows == [[30, float(sum(range(30)))]]
        release.set()
        assert _wait(lambda: c.pending_sealed("events__0__0") is None)
        assert "events__0__0" in server.segments_of("events")
    finally:
        release.set()
        mgr.stop()


# -- chaos, pause / resume, stats history (tests/test_chaos.py) -------------


def _mk(pkg, root, partitions=2, max_rows=50):
    controller, server, schema, config, stream = _cluster(pkg, root, partitions=partitions, shard=False)
    mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=max_rows)
    return controller, server, stream, mgr, config, schema


def _produce_p(stream, partition, n, start):
    for i in range(start, start + n):
        stream.produce(partition, {"kind": f"k{i % 5}", "value": i})


def test_pause_resume_consumption(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, stream, mgr, config, schema = _mk(pkg, tmp_path / pkg.name, partitions=1)
        mgr.start()
        try:
            _produce_p(stream, 0, 30, 0)
            assert mgr.wait_until_caught_up([30], timeout=10)
            mgr.pause()
            assert _wait(lambda: mgr.consumers[0].state == "PAUSED", 2.0)
            assert mgr.paused
            assert controller.store.get("/tables/events/pauseStatus") == {"paused": True}
            _produce_p(stream, 0, 20, 30)
            time.sleep(0.2)
            assert mgr.consumers[0].current_offset == 30  # nothing consumed while paused
            status = mgr.consumption_status()[0]
            assert status["state"] == "PAUSED" and status["offsetLag"] == 20
            assert server.consumption_status("events") == mgr.consumption_status()
            mgr.resume()
            assert mgr.wait_until_caught_up([50], timeout=10)
            assert not mgr.paused
            out[pkg.name] = {"status": status, "rows": _rows(pkg, controller, CORPUS[:2])}
        finally:
            mgr.stop()
    assert out["port"] == out["ref"]
    assert out["port"]["rows"][0] == [[50, float(sum(range(50)))]]


def test_stats_history_recorded_on_commit(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, stream, mgr, config, schema = _mk(pkg, tmp_path / pkg.name, partitions=1, max_rows=20)
        mgr.start()
        try:
            _produce_p(stream, 0, 65, 0)  # 3 committed segments of 20 + 5 consuming
            assert mgr.wait_until_caught_up([65], timeout=10)
            assert _wait(lambda: len(mgr.stats_history()) >= 3, 5.0)
            hist = mgr.stats_history()
            assert len(hist) == 3 and all(e["numDocs"] == 20 for e in hist)
            assert mgr.estimated_cardinality("kind") == 5
            assert mgr.estimated_cardinality("nope") is None
            out[pkg.name] = hist
        finally:
            mgr.stop()
    assert out["port"] == out["ref"]


def test_pause_resume_via_controller_rest(tmp_path):
    """pauseConsumption / resumeConsumption / consumingSegmentsInfo through
    each package's ControllerHTTPService reach the server's consumer."""
    out = {}
    for pkg in PKGS:
        http = __import__(f"{pkg.cluster.__name__}.http", fromlist=["ControllerHTTPService"])
        controller, server, stream, mgr, config, schema = _mk(pkg, tmp_path / pkg.name, partitions=1)
        svc = http.ControllerHTTPService(controller)
        rc = http.RemoteControllerClient(f"http://127.0.0.1:{svc.port}")
        mgr.start()
        try:
            _produce_p(stream, 0, 10, 0)
            assert mgr.wait_until_caught_up([10], timeout=10)
            paused = rc._post("/tables/events/pauseConsumption", b"{}")
            assert paused["servers"] == ["server_rt"]
            assert _wait(lambda: mgr.paused, 2.0)
            # `paused` is set at once; each consumer writes its PAUSED state
            # on its next loop turn, which consumingSegmentsInfo reports
            assert _wait(lambda: all(c.state == "PAUSED" for c in mgr.consumers), 2.0)
            info = rc._get("/tables/events/consumingSegmentsInfo")
            assert info["server_rt"][0]["currentOffset"] == 10
            rc._post("/tables/events/resumeConsumption", b"{}")
            _produce_p(stream, 0, 5, 10)
            assert mgr.wait_until_caught_up([15], timeout=10)
            out[pkg.name] = {"paused": paused, "info": info}
        finally:
            mgr.stop()
            svc.stop()
    assert out["port"] == out["ref"]


def test_change_table_state_reaches_the_consumer(tmp_path):
    """The admin tool's ChangeTableState pauses and resumes a real consumer
    through the controller's REST endpoints."""
    from pinot_tpu_torch.cluster.http import ControllerHTTPService
    from pinot_tpu_torch.tools import admin

    controller, server, stream, mgr, config, schema = _mk(PORT, tmp_path, partitions=1)
    svc = ControllerHTTPService(controller)
    url = f"http://127.0.0.1:{svc.port}"
    mgr.start()
    try:
        _produce_p(stream, 0, 10, 0)
        assert mgr.wait_until_caught_up([10], timeout=10)
        assert admin.main(["ChangeTableState", "--controller-url", url, "--table", "events", "--state", "pause"]) == 0
        assert _wait(lambda: mgr.consumers[0].state == "PAUSED", 2.0)
        _produce_p(stream, 0, 5, 10)
        time.sleep(0.2)
        assert mgr.consumers[0].current_offset == 10
        assert admin.main(["ChangeTableState", "--controller-url", url, "--table", "events", "--state", "resume"]) == 0
        assert mgr.wait_until_caught_up([15], timeout=10)
        assert controller.store.get("/tables/events/pauseStatus") == {"paused": False}
    finally:
        mgr.stop()
        svc.stop()


def _chaos(pkg, root):
    rng = random.Random(1234)
    controller, server, stream, mgr, config, schema = _mk(pkg, root, partitions=2, max_rows=40)
    mgr.start()
    total = [0, 0]
    actions = []
    try:
        for _ in range(6):
            for p in range(2):
                n = rng.randint(10, 60)
                _produce_p(stream, p, n, total[p])
                total[p] += n
            action = rng.choice(["pause_resume", "restart_manager", "reload_segment", "none"])
            actions.append(action)
            if action == "pause_resume":
                mgr.pause()
                time.sleep(0.05)
                mgr.resume()
            elif action == "restart_manager":
                # kill the consumers mid-stream; a new manager resumes from
                # the committed checkpoints without loss or duplication
                mgr.stop()
                mgr = pkg.realtime.RealtimeTableManager(
                    controller, server, schema, config, stream, max_rows_per_segment=40
                )
                mgr.start()
            elif action == "reload_segment":
                metas = controller.all_segment_metadata("events")
                if metas:
                    name, meta = sorted(metas.items())[rng.randrange(len(metas))]
                    server.remove_segment("events", name)
                    server.add_segment("events", name, meta["location"])
        assert mgr.wait_until_caught_up(total, timeout=20)
        expect = [[sum(total), float(sum(sum(range(t)) for t in total))]]
        broker = pkg.cluster.Broker(controller)
        assert _wait(lambda: broker.execute("SELECT COUNT(*), SUM(value) FROM events").rows == expect, 10.0)
        broker.shutdown()
        rows = _rows(pkg, controller)
    finally:
        mgr.stop()
    per_kind = {f"k{k}": 0 for k in range(5)}
    for p in range(2):
        for i in range(total[p]):
            per_kind[f"k{i % 5}"] += 1
    assert {r[0]: r[1] for r in rows[1]} == per_kind
    return {"total": total, "actions": actions, "rows": rows}


def test_chaos_monkey_ingestion_correctness(tmp_path):
    """Pause / resume storms, manager restarts and segment reloads during
    ingestion end with exactly-once results at either package's broker."""
    out = {pkg.name: _chaos(pkg, tmp_path / pkg.name) for pkg in PKGS}
    assert out["port"] == out["ref"]


# -- survivability, cache, observability -------------------------------------


def test_stream_lag_fault_is_lag_not_loss(tmp_path):
    out = {}
    for pkg in PKGS:
        faults = __import__(f"{pkg.common.__name__}.faults", fromlist=["FAULTS"])
        controller, server, stream, mgr, config, schema = _mk(pkg, tmp_path / pkg.name, partitions=1)
        # every other fetch round fails for the first 20 fires: consumption
        # lags but the poll loop retries — no message may be skipped
        faults.FAULTS.configure({"stream.lag": faults.FaultRule(prob=0.5, max_count=20)}, seed=9)
        mgr.start()
        try:
            _produce_p(stream, 0, 120, 0)
            assert mgr.wait_until_caught_up([120], timeout=15)
            assert faults.FAULTS.counts().get("stream.lag", 0) > 0  # chaos actually ran
            _settle(controller, 2)
            res = pkg.cluster.Broker(controller).execute("SELECT COUNT(*), SUM(value) FROM events")
            assert res.rows == [[120, float(sum(range(120)))]]  # lag, not loss
            out[pkg.name] = {"committed": _committed(controller), "rows": _rows(pkg, controller)}
        finally:
            mgr.stop()
            faults.FAULTS.reset()
    assert out["port"] == out["ref"]


def test_realtime_commit_bumps_routing_version(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, schema, config, stream = _cluster(pkg, tmp_path / pkg.name, partitions=1)
        for i in range(300):
            stream.produce(0, {"kind": "a", "shard": 0, "value": i})
        v0 = controller.routing_version("events")
        mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=100)
        mgr.start()
        try:
            assert mgr.wait_until_caught_up([stream.latest_offset(0)])
            _settle(controller, 3)
            assert _committed(controller), "no segment committed within the deadline"
            assert controller.routing_version("events") > v0
            out[pkg.name] = _committed(controller)
        finally:
            mgr.stop()
    assert out["port"] == out["ref"]


def test_realtime_entries_carry_ttl_offline_do_not(tmp_path):
    out = {}
    for pkg in PKGS:
        dt = pkg.common.DataType
        controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), tmp_path / pkg.name / "ds")
        server = pkg.server("s0")
        controller.register_server("s0", server)
        schema = pkg.common.Schema.build("t", dimensions=[("d", dt.INT)], metrics=[("v", dt.LONG)])
        controller.add_schema(schema)
        controller.add_table(pkg.common.TableConfig("t", replication=1))
        builder = __import__(f"{pkg.common.__name__.rsplit('.', 1)[0]}.segment", fromlist=["SegmentBuilder"])
        controller.upload_segment(
            "t",
            builder.SegmentBuilder(schema).build({"d": np.arange(4, dtype=np.int32), "v": np.ones(4, dtype=np.int64)}, "t_0"),
        )
        broker = pkg.cluster.Broker(controller)
        try:
            broker.execute("SELECT SUM(v) FROM t")
            (offline_entry,) = broker.caches.result._d.values()
            assert offline_entry["expires"] is None  # offline: lives until a bump
            rt_schema = pkg.common.Schema.build("events", dimensions=[("shard", dt.INT)], metrics=[("value", dt.LONG)])
            controller.add_schema(rt_schema)
            rt_config = pkg.common.TableConfig("events", table_type=pkg.common.TableType.REALTIME, replication=1)
            controller.add_table(rt_config)
            stream = pkg.realtime.InMemoryStream(partitions=1)
            stream.produce(0, {"shard": 0, "value": 7})
            mgr = pkg.realtime.RealtimeTableManager(
                controller, server=server, schema=rt_schema, config=rt_config, stream=stream,
                max_rows_per_segment=10_000,
            )
            mgr.start()
            try:
                assert mgr.wait_until_caught_up([stream.latest_offset(0)])
                res = broker.execute("SELECT SUM(value) FROM events")
                rt_entries = [e for e in broker.caches.result._d.values() if e["expires"] is not None]
                assert rt_entries  # consuming segment => realtimeTtlMs freshness cap
                out[pkg.name] = res.rows
            finally:
                mgr.stop()
        finally:
            broker.shutdown()
    assert out["port"] == out["ref"] == [[7.0]]


def test_ingest_lag_gauge_commit_latency_and_freshness(tmp_path):
    """The ingest series (tests/test_frontend_obs.py): one lag gauge a
    partition, the commit-latency timer, and the freshness histogram, one
    sample a stamped message, under the reference's names and labels."""
    out = {}
    for pkg in PKGS:
        metrics = __import__(f"{pkg.common.__name__}.metrics", fromlist=["server_metrics"])
        metrics.reset_registries()
        controller, server, schema, config, stream = _cluster(pkg, tmp_path / pkg.name)
        _produce(stream, 400)
        mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=120)
        mgr.start()
        try:
            assert mgr.wait_until_caught_up([stream.latest_offset(0), stream.latest_offset(1)])
            _settle(controller, 2)
        finally:
            mgr.stop()
        snap = metrics.server_metrics().snapshot()
        lag = {k: (v["type"], v["labels"], v["value"]) for k, v in snap.items() if k.startswith("server.ingest.lagEvents{")}
        assert len(lag) == 2 and all(t == "gauge" and lb["table"] == "events" and v == 0 for t, lb, v in lag.values())
        commits = {k: v for k, v in snap.items() if k.startswith("server.ingest.commitLatencyMs{")}
        assert sum(v["count"] for v in commits.values()) == 2 and all(v["totalMs"] > 0 for v in commits.values())
        fresh = metrics.server_metrics().histogram(metrics.ServerHistogram.FRESHNESS, table="events")
        assert fresh.count == 400
        out[pkg.name] = {
            "lag": lag,
            "commit_keys": sorted(commits),
            "freshness": (metrics.ServerHistogram.FRESHNESS.value, fresh.count),
            "lag_name": metrics.IngestGauge.LAG_EVENTS.value,
        }
        metrics.reset_registries()
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("kind", ["INT", "LONG", "DOUBLE", "STRING"])
def test_dictionary_get_and_insertion_index_of(kind):
    """Dictionary.get and insertion_index_of (Java binarySearch's -(pos+1)
    when absent) equal the reference's, found and absent values alike."""
    from pinot_tpu.segment.dictionary import Dictionary as RDict
    from pinot_tpu_torch.segment.dictionary import Dictionary as PDict

    rng = np.random.default_rng(7)
    raw = rng.integers(-50, 50, 40)
    vals = {"STRING": raw.astype(str).astype(object), "DOUBLE": raw / 4.0}.get(kind, raw)
    probes = {"STRING": ["-3", "7", "zz", "", "10"], "DOUBLE": [-12.5, 0.25, 99.0, 3.0]}.get(kind, [-51, -3, 0, 7, 60, 2.5])
    out = {}
    for name, D, dt in (("ref", RDict, getattr(r_common.DataType, kind)), ("port", PDict, getattr(p_common.DataType, kind))):
        d, ids = D.from_column(dt, np.asarray(vals))
        out[name] = ([d.get(i) for i in range(len(d))], [d.insertion_index_of(v) for v in probes], ids.tolist())
    assert out["port"] == out["ref"]
    assert all(type(v) is not np.generic for v in out["port"][0])


def test_replaced_snapshot_frees_its_staged_copy_without_the_collector():
    """A consuming generation's staged copy goes with its snapshot: once a
    newer snapshot replaces it (and no query holds it), its DeviceSegment
    is freed by reference counting alone, with the cyclic collector off."""
    import gc
    import weakref

    ms = p_realtime.MutableSegment("events__0__0", _schema(PORT))
    for i in range(50):
        ms.index({"kind": f"k{i % 3}", "shard": 0, "value": i})
    gc.collect()
    gc.disable()
    try:
        snap = ms.snapshot()
        staged = weakref.ref(snap.to_device_cached("cpu"))
        assert staged().host.n_docs == 50 and staged().host.name == snap.name
        del snap
        ms.index({"kind": "k9", "shard": 0, "value": 99})
        newer = ms.snapshot()
        assert newer.n_docs == 51
        assert staged() is None
    finally:
        gc.enable()


def test_concurrent_segment_states_are_all_kept(tmp_path):
    """Consumer threads of many partitions open segments and commit at once:
    every CONSUMING entry and every uploaded segment stays in the ideal
    state (a get-then-set would drop some, and a consuming segment with no
    entry is never routed)."""
    import sys

    controller, server, schema, config, stream = _cluster(PORT, tmp_path, partitions=1)
    from pinot_tpu_torch.segment import SegmentBuilder

    seg = SegmentBuilder(schema).build({"kind": np.array(["a"], dtype=object), "shard": np.zeros(1, dtype=np.int32),
                                        "value": np.zeros(1, dtype=np.int64)}, "events__99__0")
    barrier = threading.Barrier(16)

    def open_segments(p):
        barrier.wait()
        for seq in range(25):
            controller.set_segment_state("events", f"events__{p}__{seq}", "server_rt", "CONSUMING")
        if p == 0:
            controller.upload_segment("events", seg)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=open_segments, args=(p,)) for p in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    ideal = controller.ideal_state("events")
    assert len(ideal) == 16 * 25 + 1
    assert ideal["events__99__0"] == {"server_rt": "ONLINE"}
