"""The port's controller periodic tasks, cluster metrics aggregator and SLO
evaluator against the JAX package's, and the surfaces that serve them: the
controller's `/debug/cluster`, `/debug/alerts` and UI, and StartController's
`--ha`, `--cold-start` and `--with-periodics` with the options bench.py
passes.

The cases are `tests/test_periodic_quota.py`'s periodic ones and
`tests/test_cluster_observability.py`'s. The same seeded inputs go through
both packages: the bucket helpers on random series, the tasks on the same
in-process cluster (the port's servers on the CPU), the aggregator with an
injected `fetch` and `now_fn` (no sockets), the evaluator on an injected
clock. Documents must be equal; the one difference allowed is the roofline's
peak: the port divides by an H100's 3,350 GB/s.
"""

import importlib
import json
import random
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")
H100_GBPS = 3350.0


def _pkg(name):
    m = importlib.import_module
    P = types.SimpleNamespace(
        name=name,
        cluster=m(f"{name}.cluster"),
        http=m(f"{name}.cluster.http"),
        periodic=m(f"{name}.cluster.periodic"),
        common=m(f"{name}.common"),
        config=m(f"{name}.common.config"),
        metrics=m(f"{name}.common.metrics"),
        slo=m(f"{name}.common.slo"),
        segment=m(f"{name}.segment"),
        admin=m(f"{name}.tools.admin"),
    )
    port = name.endswith("_torch")
    P.Server = (lambda sid, **kw: P.cluster.Server(sid, device="cpu", **kw)) if port else P.cluster.Server
    return P


@pytest.fixture
def both():
    return [_pkg(n) for n in PKGS]


def _norm(obj, root):
    return json.loads(json.dumps(obj, sort_keys=True, default=str).replace(str(root), "<root>"))


# -- the bucket helpers -------------------------------------------------------


def _random_series(rng):
    pool = [0.5, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0]
    series = []
    for _ in range(rng.randint(1, 5)):
        cum, pairs = 0, []
        for b in sorted(rng.sample(pool, rng.randint(1, 6))):
            cum += rng.randint(0, 20)
            pairs.append((b, cum))
        if rng.random() < 0.5:  # some nodes expose an explicit +Inf bucket
            cum += rng.randint(0, 10)
            pairs.append((float("inf"), cum))
        series.append(pairs)
    return series


def test_merge_cumulative_buckets_invariant_property(both):
    ref, port = both
    rng = random.Random(8)
    for _ in range(200):
        series = _random_series(rng)
        merged = port.metrics.merge_cumulative_buckets(series)
        assert merged == ref.metrics.merge_cumulative_buckets(series)
        assert merged[-1] == (float("inf"), sum(s[-1][1] for s in series))
        assert all(merged[i][1] <= merged[i + 1][1] for i in range(len(merged) - 1))
        assert port.metrics._bucket_deltas(series[0]) == ref.metrics._bucket_deltas(series[0])


def test_rebucket_is_conservative_and_conserves_totals(both):
    ref, port = both
    rng = random.Random(9)
    target = [1.0, 2.0, 4.0, 8.0, 16.0]
    for _ in range(200):
        cum, pairs = 0, []
        for b in sorted(rng.sample([0.3, 0.9, 1.5, 3.0, 6.0, 12.0, 24.0, 48.0], rng.randint(1, 5))):
            cum += rng.randint(0, 9)
            pairs.append((b, cum))
        per = port.metrics.rebucket_counts(pairs, target)
        assert per == ref.metrics.rebucket_counts(pairs, target)
        assert len(per) == len(target) + 1 and sum(per) == cum
    assert port.metrics.rebucket_counts([(3.0, 10)], target) == [0, 0, 10, 0, 0, 0]


def test_buckets_json_roundtrip_and_quantiles(both):
    ref, port = both
    rng = random.Random(10)
    for _ in range(100):
        for pairs in _random_series(rng):
            raw = json.loads(json.dumps(port.metrics.buckets_to_json(pairs)))
            assert port.metrics.buckets_from_json(raw) == ref.metrics.buckets_from_json(raw) == pairs
            for q in (0.5, 0.9, 0.99, 0.999):
                assert port.metrics.quantile_from_buckets(pairs, q) == ref.metrics.quantile_from_buckets(pairs, q)
    pairs = [(1.0, 3), (8.0, 9), (float("inf"), 10)]
    assert port.metrics.quantile_from_buckets(pairs, 0.999) == 8.0
    assert port.metrics.quantile_from_buckets([], 0.99) == 0.0


def test_snapshot_exposes_cumulative_buckets(both):
    """The JSON snapshot a node serves carries the bucket lists the
    aggregator folds, and `load_cumulative` republishes a merged series."""
    outs = []
    for P in both:
        P.metrics.reset_registries()
        t = P.metrics.broker_metrics().timer("broker.queryTotalMs")
        for ms in (1.0, 5.0, 40.0, 0.003, 9e5):
            t.update_ms(ms)
        entry = P.metrics.broker_metrics().snapshot()["broker.queryTotalMs"]
        h = P.metrics.controller_metrics().histogram("cluster.latencyMs")
        h.load_cumulative([(2.0, 5), (7.0, 9), (float("inf"), 12)], total_ms=50.0, max_ms=30.0)
        loaded = P.metrics.controller_metrics().snapshot()["cluster.latencyMs"]
        outs.append((entry, loaded, h.quantile_ms(0.5)))
    assert outs[1] == outs[0]
    entry, loaded, _ = outs[1]
    assert port_pairs_total(both[1], entry) == 5 == entry["count"]
    assert port_pairs_total(both[1], loaded) == 12


def port_pairs_total(P, entry):
    return P.metrics.buckets_from_json(entry["buckets"])[-1][1]


# -- the periodic tasks -------------------------------------------------------


def _mk(P, root, name="t", replication=1, realtime=False, extra=None):
    controller = P.cluster.Controller(P.cluster.PropertyStore(), root / "ds")
    controller.register_server("s0", P.Server("s0"))
    dt = P.common.DataType
    schema = P.common.Schema.build(
        name, dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)], date_times=[("ts", dt.LONG)]
    )
    controller.add_schema(schema)
    tt = P.common.TableType.REALTIME if realtime else P.common.TableType.OFFLINE
    tc = P.common.TableConfig(name, table_type=tt, replication=replication, time_column="ts")
    tc.extra = dict(extra or {})
    controller.add_table(tc)
    return controller, schema


def _seg(P, schema, name, ts):
    n = len(ts)
    return P.segment.SegmentBuilder(schema).build(
        {"k": np.array(["x"] * n, dtype=object), "v": np.ones(n, dtype=np.int64), "ts": np.asarray(ts, dtype=np.int64)},
        name,
    )


def _run(both, tmp_path, script):
    out = []
    for P in both:
        root = tmp_path / P.name
        root.mkdir()
        out.append(_norm(script(P, root), root))
    return out


def test_segment_status_checker(both, tmp_path):
    def script(P, root):
        controller, schema = _mk(P, root, replication=2)
        controller.register_server("s1", P.Server("s1"))
        controller.upload_segment("t", _seg(P, schema, "a", [1, 2]))
        healthy = P.periodic.SegmentStatusChecker(controller).run_once()
        controller.set_segment_state("t", "a", "s1", None)
        degraded = P.periodic.SegmentStatusChecker(controller).run_once()
        gauges = {k: v["value"] for k, v in P.metrics.controller_metrics().snapshot().items() if k.startswith("controller.t.")}
        return [healthy, degraded, gauges]

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port[0]["t"] == {"segments": 1, "minReplicas": 2, "percent": 100}
    assert port[1]["t"] == {"segments": 1, "minReplicas": 1, "percent": 50}


def test_retention_manager_purges_old_segments(both, tmp_path):
    def script(P, root):
        controller, schema = _mk(P, root, extra={"retention": {"value": 100}})
        controller.upload_segment("t", _seg(P, schema, "old", [10, 20]))
        controller.upload_segment("t", _seg(P, schema, "new", [950, 990]))
        rm = P.periodic.RetentionManager(controller, now_fn=lambda: 1000.0)
        first, again = rm.run_once(), rm.run_once()
        plain, pschema = _mk(P, root / "plain")
        plain.upload_segment("t", _seg(P, pschema, "a", [1]))
        unconfigured = P.periodic.RetentionManager(plain, now_fn=lambda: 1e12).run_once()
        return [first, again, list(controller.ideal_state("t")), unconfigured]

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port == [{"t": {"purged": ["old"]}}, {"t": {"purged": []}}, ["new"], {"t": {"purged": []}}]


def test_rebalance_checker_detects_and_fixes(both, tmp_path):
    def script(P, root):
        controller, schema = _mk(P, root, replication=2)
        controller.upload_segment("t", _seg(P, schema, "a", [1]))
        controller.register_server("s1", P.Server("s1"))
        detect = P.periodic.RebalanceChecker(controller).run_once()
        fix = P.periodic.RebalanceChecker(controller, auto_fix=True).run_once()
        after = P.periodic.RebalanceChecker(controller).run_once()
        return [detect, fix, after, controller.ideal_state("t")]

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port[0]["t"]["needsRebalance"] is True and port[1]["t"]["fixed"] is True
    assert port[2]["t"]["needsRebalance"] is False and port[3] == {"a": {"s0": "ONLINE", "s1": "ONLINE"}}


def test_missing_consuming_segment_finder(both, tmp_path):
    def script(P, root):
        controller, _ = _mk(P, root, name="rt", realtime=True, extra={"streamPartitions": 2})
        controller.set_segment_state("rt", "rt__0__0", "s0", "CONSUMING")
        first = P.periodic.MissingConsumingSegmentFinder(controller).run_once()
        controller.set_segment_state("rt", "rt__1__0", "s0", "CONSUMING")
        return [first, P.periodic.MissingConsumingSegmentFinder(controller).run_once()]

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port == [{"rt": {"missingPartitions": [1]}}, {"rt": {"missingPartitions": []}}]


def test_scheduler_runs_in_background(both, tmp_path):
    counts = []
    for P in both:
        controller, _ = _mk(P, tmp_path / P.name)
        runs = []

        class Probe(P.periodic.SegmentStatusChecker):
            interval_sec = 0.01

            def process_table(self, table):
                runs.append(table)
                return {}

        sched = P.periodic.PeriodicTaskScheduler()
        sched.register(Probe(controller))
        sched.start()
        try:
            deadline = time.time() + 5
            while time.time() < deadline and len(runs) < 2:
                time.sleep(0.02)
        finally:
            sched.stop()
        counts.append((len(runs) >= 2, set(runs), [t.name for t in sched.tasks]))
    assert counts[1] == counts[0] == (True, {"t"}, ["SegmentStatusChecker"])


# -- the aggregator (injected fetch and clock) ---------------------------------


def _broker_snapshot(queries, failures=0, buckets=None):
    return {
        "broker.queries": {"type": "meter", "count": queries},
        "broker.requestFailures": {"type": "meter", "count": failures},
        "broker.queryTotalMs": {
            "type": "timer", "count": queries, "totalMs": 4.0 * queries, "maxMs": 4.0,
            "buckets": buckets if buckets is not None else [[4.0, queries]],
        },
    }


def _server_snapshot(executed):
    return {
        "server.queryExecutionMs": {
            "type": "timer", "count": executed, "totalMs": 2.0 * executed, "maxMs": 2.0,
            "buckets": [[2.0, executed]],
        }
    }


class FakeCluster:
    """A controller of package P with fake registered nodes, and an
    aggregator whose fetch serves `responses[node]`: a dict, a raw string
    (a malformed exposition) or an Exception (a node down)."""

    def __init__(self, P, root, responses, brokers=("broker-0",), servers=("server-0",)):
        P.metrics.reset_registries()
        self.responses = responses
        self.controller = P.cluster.Controller(P.cluster.PropertyStore(), root / "deepstore")
        for bid in brokers:
            self.controller.register_broker(bid, bid, 80)
        for sid in servers:
            self.controller.register_server(sid, None, host=sid, port=80)
        self.clock = [1000.0]
        self.agg = P.periodic.ClusterMetricsAggregator(self.controller, fetch=self.fetch, now_fn=lambda: self.clock[0])

    def fetch(self, url):
        r = self.responses[url.split("//")[1].split(":")[0]]
        if isinstance(r, Exception):
            raise r
        if isinstance(r, str):
            return r
        for key, path in (("snapshot", "/metrics"), ("workload", "/debug/workload"), ("slow", "/debug/slowQueries"),
                          ("roofline", "/debug/roofline"), ("segments", "/debug/segments")):
            if path in url:
                doc = r.get(key, {} if key == "snapshot" else [])
                wrap = {"workload": "rollups", "roofline": "kernels", "segments": "segments"}.get(key)
                return json.dumps({wrap: doc} if wrap else doc)
        raise OSError(f"no {url}")

    def step(self, seconds=10.0):
        self.clock[0] += seconds
        return self.agg.run_once()


def _both_clusters(both, tmp_path, responses_of, **kw):
    return [FakeCluster(P, tmp_path / P.name, responses_of(), **kw) for P in both]


def _equal_docs(clusters):
    docs = [c.agg.debug_cluster() for c in clusters]
    for d in docs:  # rebalance progress is process-wide: earlier tests' runs, on the wall clock
        d["rebalance"] = sorted(d["rebalance"])
    docs[0]["cluster"]["roofline"]["hbmPeakGBps"] = H100_GBPS
    for r in docs[0]["cluster"]["roofline"]["kernels"] + docs[0]["cluster"]["roofline"]["offenders"]:
        for r2 in docs[1]["cluster"]["roofline"]["kernels"] + docs[1]["cluster"]["roofline"]["offenders"]:
            if (r2["kernel"], r2["shape"]) == (r["kernel"], r["shape"]):
                for k in ("pctOfPeak", "rooflineGap", "lostMs"):
                    r[k] = r2[k]
    assert docs[1] == docs[0]
    return docs[1]


def test_scrape_node_down_marks_stale_not_missing(both, tmp_path):
    clusters = _both_clusters(both, tmp_path, lambda: {
        "broker-0": {"snapshot": _broker_snapshot(50)}, "server-0": {"snapshot": _server_snapshot(40)}})
    firsts = [c.agg.run_once() for c in clusters]
    assert firsts[1] == firsts[0] == {"scraped": {"broker-0": True, "server-0": True}, "queries": 50,
                                      "errors": 0, "transitions": []}
    _equal_docs(clusters)
    for c in clusters:
        c.responses["server-0"] = OSError("connection refused")
    assert [c.step() for c in clusters][1]["scraped"] == {"broker-0": True, "server-0": False}
    node = _equal_docs(clusters)["nodes"]["server-0"]
    assert node["stale"] and not node["healthy"] and node["staleForMs"] == 10_000.0
    assert [e["ok"] for e in node["timeline"]] == [True, False]
    for c in clusters:
        c.responses["server-0"] = {"snapshot": _server_snapshot(45)}
        c.step()
    doc = _equal_docs(clusters)
    assert doc["nodes"]["server-0"]["healthy"] and doc["cluster"]["serverLatency"]["count"] == 45


def test_scrape_malformed_exposition_is_a_failed_scrape(both, tmp_path):
    clusters = _both_clusters(both, tmp_path, lambda: {
        "broker-0": "this is not json {", "server-0": {"snapshot": _server_snapshot(7)}})
    outs = [c.agg.run_once() for c in clusters]
    assert outs[1] == outs[0] and outs[1]["scraped"] == {"broker-0": False, "server-0": True}
    assert "JSONDecodeError" in _equal_docs(clusters)["nodes"]["broker-0"]["lastError"]
    for c in clusters:
        c.responses["broker-0"] = json.dumps([1, 2, 3])  # a JSON scalar is equally malformed
    assert [c.step() for c in clusters][1]["scraped"]["broker-0"] is False
    _equal_docs(clusters)


def test_scrape_counter_reset_detected_as_restart(both, tmp_path):
    clusters = _both_clusters(both, tmp_path, lambda: {
        "broker-0": {"snapshot": _broker_snapshot(100, failures=4)}, "server-0": {"snapshot": _server_snapshot(10)}})
    for c in clusters:
        c.agg.run_once()
        c.responses["broker-0"] = {"snapshot": _broker_snapshot(40, failures=1)}
    outs = [c.step() for c in clusters]
    assert outs[1] == outs[0] and outs[1]["errors"] == 5
    doc = _equal_docs(clusters)
    assert doc["nodes"]["broker-0"]["restarts"] == 1 and doc["cluster"]["queries"] == 140
    for c in clusters:
        c.responses["broker-0"] = {"snapshot": _broker_snapshot(60, failures=1)}
        c.step()
    doc = _equal_docs(clusters)
    assert doc["nodes"]["broker-0"]["restarts"] == 1 and doc["cluster"]["queries"] == 160


def test_scrape_merges_histograms_across_heterogeneous_brokers(both, tmp_path):
    clusters = _both_clusters(both, tmp_path, lambda: {
        "broker-0": {"snapshot": _broker_snapshot(10, buckets=[[1.0, 5], [4.0, 9], ["+Inf", 10]])},
        "broker-1": {"snapshot": _broker_snapshot(7, buckets=[[2.0, 3], [8.0, 7]])},
        "server-0": {"snapshot": _server_snapshot(3)}}, brokers=("broker-0", "broker-1"))
    for c in clusters:
        c.agg.run_once()
    doc = _equal_docs(clusters)
    assert doc["cluster"]["queries"] == 17 and doc["cluster"]["latency"]["count"] == 17
    snaps = [P.metrics.controller_metrics().snapshot() for P in both]
    assert snaps[1]["cluster.latencyMs"] == snaps[0]["cluster.latencyMs"]
    assert both[1].metrics.buckets_from_json(snaps[1]["cluster.latencyMs"]["buckets"])[-1][1] == 17
    assert snaps[1]["cluster.nodes"]["value"] == 3


def test_scrape_folds_workload_and_top_tables(both, tmp_path):
    rollups = [
        {"tenant": "DefaultTenant", "table": "orders", "queries": 12, "cpuTimeNs": 900, "allocatedBytes": 64,
         "segmentsExecuted": 24, "queriesKilled": 0},
        {"tenant": "DefaultTenant", "table": "lineorder", "queries": 8, "cpuTimeNs": 4000, "allocatedBytes": 32,
         "segmentsExecuted": 8, "queriesKilled": 0},
    ]
    clusters = _both_clusters(both, tmp_path, lambda: {
        "broker-0": {"snapshot": _broker_snapshot(20)},
        "server-0": {"snapshot": _server_snapshot(20), "workload": rollups}})
    for c in clusters:
        c.agg.run_once()
    doc = _equal_docs(clusters)
    assert doc["cluster"]["workload"]["DefaultTenant/orders"]["queries"] == 12
    assert [t["table"] for t in doc["topTables"]["byCpu"]][0] == "lineorder"


def test_roofline_divides_by_the_h100_peak(both, tmp_path):
    """Server roofline rows merge by (kernel, shape) as the reference's do;
    the port's achieved share is of 3,350 GB/s, the reference's of its TPU
    figure."""
    rows = [
        {"kernel": "grouped_sum_count", "shape": "2^17", "calls": 3, "deviceMs": 0.3, "bytesMoved": 600_000_000, "flops": 9},
        {"kernel": "grouped_extreme", "shape": "2^20", "calls": 1, "deviceMs": 2.0, "bytesMoved": 1_000_000, "flops": 0},
    ]
    clusters = _both_clusters(both, tmp_path, lambda: {
        "broker-0": {"snapshot": _broker_snapshot(4)},
        "server-0": {"snapshot": _server_snapshot(4), "roofline": rows},
        "server-1": {"snapshot": _server_snapshot(4), "roofline": rows[:1]}}, servers=("server-0", "server-1"))
    for c in clusters:
        c.agg.run_once()
    roof = _equal_docs(clusters)["cluster"]["roofline"]
    assert roof["hbmPeakGBps"] == H100_GBPS
    by = {r["kernel"]: r for r in roof["kernels"]}
    b1 = by["grouped_sum_count"]
    assert (b1["calls"], b1["bytesMoved"], b1["deviceMs"]) == (6, 1_200_000_000, 0.6)
    assert b1["achievedGBps"] == 2000.0 and b1["pctOfPeak"] == round(100 * 2000.0 / H100_GBPS, 3)
    assert all(r["pctOfPeak"] <= 100 for r in roof["kernels"])


# -- the SLO evaluator (injected clock) ----------------------------------------


def _sample(queries, errors, buckets=(), tables=None, exemplars=()):
    return {"queries": queries, "errors": errors, "latencyBuckets": list(buckets), "tables": tables or {},
            "exemplars": list(exemplars)}


def _evaluators(both, objectives, registry=False):
    clock = [0.0]
    evs = [
        P.slo.SloEvaluator(objectives, now_fn=lambda: clock[0],
                           registry=P.metrics.MetricsRegistry("controller") if registry else None)
        for P in both
    ]
    return clock, evs


def _observe(evs, sample):
    outs = [ev.observe(sample) for ev in evs]
    assert outs[1] == outs[0]
    return outs[1]


def test_slo_availability_fire_dedupe_resolve(both):
    clock, evs = _evaluators(
        both, {"availability": 0.99, "burnRateThreshold": 2.0, "shortWindowS": 300.0, "longWindowS": 3600.0}, registry=True
    )
    assert _observe(evs, _sample(100, 0)) == []
    clock[0] = 10.0
    tr = _observe(evs, _sample(200, 50, exemplars=[{"traceId": "abc123", "table": "t"}]))
    assert len(tr) == 1 and tr[0]["state"] == "firing" and tr[0]["exemplar"]["traceId"] == "abc123"
    clock[0] = 20.0
    assert _observe(evs, _sample(300, 100)) == []
    clock[0] = 400.0
    tr = _observe(evs, _sample(400, 100))
    assert len(tr) == 1 and tr[0]["state"] == "resolved" and tr[0]["resolvedAtMs"] == 400_000.0
    assert evs[1].alerts() == evs[0].alerts() and evs[1].status() == evs[0].status()
    assert evs[1].status()["firing"] == 0
    assert evs[1].registry.snapshot() == evs[0].registry.snapshot()


def test_slo_needs_both_windows_to_fire(both):
    clock, evs = _evaluators(
        both, {"availability": 0.99, "burnRateThreshold": 2.0, "shortWindowS": 60.0, "longWindowS": 3600.0}
    )
    _observe(evs, _sample(0, 0))
    clock[0] = 3000.0
    _observe(evs, _sample(100_000, 0))
    clock[0] = 3010.0
    assert _observe(evs, _sample(100_050, 50)) == []
    assert evs[1].status() == evs[0].status() and evs[1].status()["firing"] == 0


def test_slo_per_table_p99_override(both):
    clock, evs = _evaluators(both, {"availability": None, "p99LatencyMs": None, "shortWindowS": 300.0,
                                    "longWindowS": 3600.0, "tables": {"orders": {"p99LatencyMs": 50.0}}})
    slow = {"orders": {"queries": 10, "errors": 0, "latencyBuckets": [(100.0, 10)]}}
    tr = _observe(evs, _sample(10, 0, tables=slow, exemplars=[{"traceId": "t1", "table": "orders"}]))
    assert len(tr) == 1 and tr[0]["slo"] == "p99Latency" and tr[0]["table"] == "orders"
    assert tr[0]["measured"]["p99ShortMs"] == 100.0
    clock[0] = 400.0
    fast = {"orders": {"queries": 30, "errors": 0, "latencyBuckets": [(8.0, 20), (100.0, 30)]}}
    tr = _observe(evs, _sample(30, 0, tables=fast))
    assert len(tr) == 1 and tr[0]["state"] == "resolved"
    assert both[1].slo.DEFAULT_OBJECTIVES == both[0].slo.DEFAULT_OBJECTIVES


# -- the controller's surfaces -------------------------------------------------


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_controller_readiness_transitions(both, tmp_path):
    outs = []
    for P in both:
        controller = P.cluster.Controller(P.cluster.PropertyStore(), tmp_path / P.name / "deepstore")
        steps = [controller.readiness()]
        sched = P.periodic.PeriodicTaskScheduler(controller)
        sched.register(P.periodic.SegmentStatusChecker(controller))
        steps.append(controller.readiness())
        svc = P.http.ControllerHTTPService(controller)
        try:
            code, body = _get(f"http://127.0.0.1:{svc.port}/health/ready")
            steps.append([code, json.loads(body)])
            sched.start()
            try:
                code, body = _get(f"http://127.0.0.1:{svc.port}/health/ready")
                steps.append([code, json.loads(body)])
            finally:
                sched.stop()
            steps.append(controller.readiness())
        finally:
            svc.stop()
        outs.append(json.loads(json.dumps(steps)))
    assert outs[1] == outs[0]
    assert outs[1][0][0] is True and outs[1][1][0] is False
    assert [outs[1][2][0], outs[1][3][0]] == [503, 200] and outs[1][4][0] is False


def test_debug_cluster_alerts_and_ui_over_http(both, tmp_path):
    """GET / serves the reference's UI byte for byte; /debug/cluster and
    /debug/alerts serve the registered aggregator's documents (404 before
    one registers), as in the reference."""
    outs, uis = [], []
    for P in both:
        fc = FakeCluster(P, tmp_path / P.name, {"broker-0": {"snapshot": _broker_snapshot(5)},
                                                 "server-0": {"snapshot": _server_snapshot(5)}})
        bare = P.cluster.Controller(P.cluster.PropertyStore(), tmp_path / P.name / "bare")
        svc, bare_svc = P.http.ControllerHTTPService(fc.controller), P.http.ControllerHTTPService(bare)
        try:
            fc.agg.run_once()
            base = f"http://127.0.0.1:{svc.port}"
            code, html = _get(f"{base}/")
            uis.append((code, html, _get(f"{base}/index.html")[1]))
            cluster = json.loads(_get(f"{base}/debug/cluster")[1])
            alerts = json.loads(_get(f"{base}/debug/alerts")[1])
            missing = [_get(f"http://127.0.0.1:{bare_svc.port}{p}")[0] for p in ("/debug/cluster", "/debug/alerts")]
            outs.append((sorted(cluster), cluster["nodes"], cluster["cluster"]["queries"], alerts, missing))
        finally:
            svc.stop()
            bare_svc.stop()
    assert uis[1] == uis[0] and uis[1][0] == 200 and uis[1][1] == uis[1][2]
    assert uis[1][1] == importlib.import_module("pinot_tpu.cluster.ui").UI_HTML.encode()
    assert outs[1] == outs[0]
    assert outs[1][2] == 5 and outs[1][4] == [404, 404]


def _controller_args(P, root, *flags):
    return P.admin.build_parser().parse_args([
        "StartController", "--store-dir", str(root / "store"), "--deep-store", str(root / "deep"),
        "--controller-id", "ha_c1", *flags,
    ])


def test_start_controller_flags_run_the_control_plane(both, tmp_path):
    """StartController --ha --cold-start --with-periodics with bench.py's
    --lease-ttl, --renew-every, --metrics-interval, --scrub-interval and
    --slo-json: the controller leads, its scheduler runs the aggregator and
    the scrubber at the given intervals, and the SLO objectives are set."""
    outs = []
    for P in both:
        root = tmp_path / P.name
        args = _controller_args(
            P, root, "--ha", "--lease-ttl", "30", "--renew-every", "0.2", "--cold-start", "--with-periodics",
            "--metrics-interval", "2", "--scrub-interval", "1", "--slo-json", '{"freshnessP99Ms": 2000}',
        )
        h = args.fn(args)
        c, sched = h["controller"], h["periodic_scheduler"]
        try:
            deadline = time.time() + 10
            while time.time() < deadline and c.cluster_aggregator.evaluator.status() is None:
                time.sleep(0.05)
            outs.append({
                "leader": c.is_leader, "epoch": c.lease_fence(), "lease": [args.lease_ttl, args.renew_every],
                "tasks": [(t.name, t.interval_sec) for t in sched.tasks],
                "objectives": c.cluster_aggregator.evaluator.objectives["freshnessP99Ms"],
                "leaderUrl": c.leader_url() == f"http://127.0.0.1:{h['service'].port}",
                "ready": c.readiness()[0],
            })
        finally:
            sched.stop()
            c.stop_ha()
            h["service"].stop()
    assert outs[1] == outs[0]
    assert outs[1]["leader"] and outs[1]["epoch"] == 1 and outs[1]["leaderUrl"] and outs[1]["ready"]
    assert outs[1]["tasks"] == [("ClusterMetricsAggregator", 2.0), ("IntegrityScrubber", 1.0)]
    assert outs[1]["objectives"] == 2000 and outs[1]["lease"] == [30.0, 0.2]


_NO_TORCH_CONTROLLER = """
import json, sys
sys.modules["torch"] = None  # any import of torch now fails
from pinot_tpu_torch.cluster.http import RemoteControllerClient
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.tools.admin import build_parser

args = build_parser().parse_args(["StartController", "--store-dir", sys.argv[1] + "/s", "--deep-store",
    sys.argv[1] + "/d", "--ha", "--cold-start", "--with-periodics", "--metrics-interval", "0.05"])
h = args.fn(args)
rc = RemoteControllerClient(f"http://127.0.0.1:{h['service'].port}")
rc.add_schema(Schema.build("t", dimensions=[("k", DataType.STRING)], metrics=[("v", DataType.LONG)]))
rc.add_table(TableConfig("t", replication=2))
rc.register_instance("server", "s0", "127.0.0.1", 9)  # a server that is down: its add is queued
import numpy as np
from pinot_tpu_torch.segment import SegmentBuilder, write_segment
seg = SegmentBuilder(Schema.build("t", dimensions=[("k", DataType.STRING)], metrics=[("v", DataType.LONG)])).build(
    {"k": np.array(["a", "b"], dtype=object), "v": np.array([1, 2], dtype=np.int64)}, "t_0")
rc.upload_segment_dir("t", write_segment(seg, sys.argv[1] + "/built"))
doc = h["controller"].cluster_aggregator.debug_cluster()
out = {"leader": h["controller"].is_leader, "reb": rc.rebalance_table("t")["status"],
       "ideal": rc.ideal_state("t"), "peak": doc["cluster"]["roofline"]["hbmPeakGBps"],
       "ha": doc["controllerHa"]["leaseEpoch"], "torch": "torch" in sys.modules and sys.modules["torch"] is not None}
h["periodic_scheduler"].stop(); h["controller"].stop_ha(); h["service"].stop()
print(json.dumps(out))
"""


def test_controller_process_runs_without_torch(tmp_path):
    """The controller has no device work: StartController with --ha,
    --cold-start and --with-periodics, its REST service, a segment upload, a
    rebalance and the aggregator's /debug/cluster document run in a process
    where importing torch fails (a controller process starts and serves
    without loading it)."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, "-c", _NO_TORCH_CONTROLLER, str(tmp_path)], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1]) == {
        "leader": True, "reb": "NO_OP", "ideal": {"t_0": {"s0": "ONLINE"}}, "peak": H100_GBPS, "ha": 1, "torch": False}


_NO_TORCH_INGEST = """
import json, sys
sys.modules["torch"] = None  # any import of torch now fails
import numpy as np
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.io import batch
from pinot_tpu_torch.minion import SegmentProcessorConfig, process_segments
from pinot_tpu_torch.segment import load_segment

root = sys.argv[1]
s = Schema.build("t", dimensions=[("k", DataType.STRING)], metrics=[("v", DataType.LONG)])
for i in range(3):
    open(f"{root}/in{i}.csv", "w").write("k,v\\n" + "".join(f"{'ab'[j % 2]},{j + i}\\n" for j in range(6)))
spec = batch.SegmentGenerationJobSpec("t", s, root, include_file_name_pattern="in*.csv", output_dir_uri=root + "/out")
files = []
dirs = batch.run_distributed_segment_generation_job(spec, n_workers=2, report=files)
segs = [load_segment(d) for d in dirs]
[rolled] = process_segments(segs, SegmentProcessorConfig(schema=s, merge_type="ROLLUP"))
[deduped] = process_segments(segs, SegmentProcessorConfig(schema=s, merge_type="DEDUP"))
print(json.dumps({"workers": sorted({(f["pid"], f["torch"]) for f in files}),
                  "rolled": rolled.columns["v"].materialize().tolist(), "deduped": deduped.n_docs,
                  "torch": "torch" in sys.modules and sys.modules["torch"] is not None}))
"""


def test_ingestion_workers_and_minion_processing_run_without_torch(tmp_path):
    """A distributed ingestion job's worker processes load no torch (each
    records whether torch was loaded where it built its segment), and the
    minion's processing (ROLLUP, DEDUP) runs in a process where importing
    torch fails."""
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    p = subprocess.run([sys.executable, "-c", _NO_TORCH_INGEST, str(tmp_path)], cwd=repo,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert len(out["workers"]) == 2 and not any(torch for _, torch in out["workers"])
    assert out["rolled"] == [sum(range(0, 6, 2)) * 3 + 9, sum(range(1, 6, 2)) * 3 + 9] and out["deduped"] == 2
    assert out["torch"] is False
