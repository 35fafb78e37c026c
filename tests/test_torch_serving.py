"""The port's serving tier against the JAX package's on the same inputs:
admission (ADMIT / DEGRADE / SHED), query quotas, the result cache (keys,
hits, routing-version invalidation), tenancy, the frontend wire-phase
timelines and the FailureDetector. The cases are those of
`tests/test_admission.py`, `tests/test_periodic_quota.py` (its quota cases),
`tests/test_query_cache.py`, `tests/test_tenancy.py`,
`tests/test_frontend_obs.py` and `tests/test_routing2.py`; each scenario runs
in both packages and must give the same outcome.
"""

import importlib
import json
import threading
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")


def P(pkg):
    """The package's modules the serving tier touches, and a Server maker
    (the port's on the CPU)."""
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    ns = types.SimpleNamespace(
        cluster=m("cluster"),
        common=m("common"),
        config=m("common.config"),
        admission=m("cluster.admission"),
        quota=m("cluster.quota"),
        cache=m("cluster.result_cache"),
        failure=m("cluster.failure"),
        tenancy=m("cluster.tenancy"),
        http=m("cluster.http"),
        metrics=m("common.metrics"),
        errors=m("common.errors"),
        fobs=m("common.frontend_obs"),
        trace=m("common.trace"),
        faults=m("common.faults"),
        context=m("query.context"),
        scheduler=m("query.scheduler"),
        segment=m("segment"),
    )
    ns.name = pkg
    kw = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    ns.Server = lambda sid, **k: ns.cluster.Server(sid, **kw, **k)
    return ns


def both(fn):
    got = {pkg: fn(P(pkg)) for pkg in PKGS}
    assert got["pinot_tpu_torch"] == got["pinot_tpu"], got
    return got["pinot_tpu_torch"]


@pytest.fixture(autouse=True)
def _clean_state():
    for pkg in PKGS:
        P(pkg).faults.FAULTS.reset()
        P(pkg).metrics.reset_registries()
    yield
    for pkg in PKGS:
        P(pkg).faults.FAULTS.reset()
        P(pkg).metrics.reset_registries()


def _cluster(p, root, n_servers=2, replication=1, table_extra=None, n_segs=4, **broker_kw):
    controller = p.cluster.Controller(p.cluster.PropertyStore(), root)
    for i in range(n_servers):
        controller.register_server(f"s{i}", p.Server(f"s{i}"))
    dt = p.common.DataType
    schema = p.common.Schema.build("t", dimensions=[("d", dt.INT)], metrics=[("v", dt.LONG)])
    controller.add_schema(schema)
    controller.add_table(p.common.TableConfig("t", replication=replication, extra=table_extra or {}))
    b = p.segment.SegmentBuilder(schema)
    rng = np.random.default_rng(0)
    for i in range(n_segs):
        controller.upload_segment(
            "t", b.build({"d": rng.integers(0, 10, 200).astype(np.int32), "v": np.full(200, i, dtype=np.int64)}, f"t_{i}")
        )
    return controller, schema, p.cluster.Broker(controller, **broker_kw)


class _StubScheduler:
    def __init__(self, pending=0, in_flight=0, num_runners=1):
        self.num_runners, self._pending, self._in_flight = num_runners, pending, in_flight

    def start(self):
        pass

    def stop(self):
        pass

    def pending(self):
        return self._pending

    def in_flight(self):
        return self._in_flight

    def queue_depths(self):
        return {"t": self._pending}

    def stats(self):
        return {"kind": "stub", "pending": self._pending}


# -- admission ---------------------------------------------------------------


@pytest.mark.parametrize(
    "pending,in_flight,service_ms,timeout_ms,allow",
    [
        (0, 0, None, 30_000, False),
        (10, 1, 200.0, 300, False),
        (10, 1, 200.0, 300, True),
        (2, 1, 50.0, 300, False),
        (3, 2, 100.0, 1000, True),
        (40, 4, 10.0, 200, False),
    ],
)
def test_admission_decisions_equal(pending, in_flight, service_ms, timeout_ms, allow):
    def run(p):
        ac = p.admission.AdmissionController(
            p.config.SchedulerConfig(), scheduler=_StubScheduler(pending, in_flight, num_runners=1)
        )
        if service_ms is not None:
            ac.note_service_time("t", service_ms)
        try:
            out = ac.decide("t", p.context.Deadline.from_timeout_ms(timeout_ms), allow_partial=allow)
        except p.scheduler.SchedulerRejectedError as e:
            out = ("SHED", p.errors.code_of(e), p.errors.http_status_of(e), p.errors.retry_after_of(e) >= 1.0)
        return out, ac.admitted, ac.shed, ac.degraded

    both(run)


def test_service_estimator_equal():
    def run(p):
        ac = p.admission.AdmissionController(
            p.config.SchedulerConfig(min_service_ms=2.0, service_ewma_alpha=0.5), scheduler=_StubScheduler()
        )
        seq = [ac.service_estimate_ms("t")]
        for ms in (100.0, 50.0, 7.0):
            ac.note_service_time("t", ms)
            seq.append(ac.service_estimate_ms("t"))
        return seq, ac.service_estimate_ms("other")

    assert both(run) == ([2.0, 100.0, 75.0, 41.0], 41.0)


def test_broker_sheds_then_admits(tmp_path):
    def run(p):
        controller, _, broker = _cluster(
            p, tmp_path / p.name,
            scheduler_config=p.config.SchedulerConfig(num_runners=2),
        )
        try:
            broker.admission.note_service_time("t", 10_000.0)
            with pytest.raises(p.scheduler.SchedulerRejectedError) as ei:
                broker.execute("SET timeoutMs = 500; SELECT COUNT(*) FROM t")
            code = p.errors.code_of(ei.value)
            shed = broker.admission_snapshot()["counters"]["shed"]
            return code, shed, broker.execute("SELECT COUNT(*) FROM t").rows
        finally:
            broker.shutdown()

    assert both(run) == (211, 1, [[800]])


def test_broker_degrades_fanout(tmp_path):
    def run(p):
        _, _, broker = _cluster(p, tmp_path / p.name, scheduler_config=p.config.SchedulerConfig(num_runners=2))
        try:
            broker.admission.note_service_time("t", 10_000.0)
            res = broker.execute("SET timeoutMs = 500; SET allowPartialResults = true; SELECT COUNT(*) FROM t")
            return (
                res.partial_result,
                sorted({e["errorCode"] for e in res.exceptions}),
                res.num_servers_queried,
                0 < res.rows[0][0] < 800,
                broker.admission.degraded,
            )
        finally:
            broker.shutdown()

    assert both(run) == (True, [211], 1, True, 1)


def test_scheduler_disabled_runs_inline(tmp_path):
    def run(p):
        _, _, broker = _cluster(p, tmp_path / p.name, scheduler_config=p.config.SchedulerConfig(enabled=False))
        try:
            return broker.admission is None, broker.execute("SELECT COUNT(*) FROM t").rows, broker.admission_snapshot()["enabled"]
        finally:
            broker.shutdown()

    assert both(run) == (True, [[800]], False)


def _post_query(port, sql):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/query/sql", data=json.dumps({"sql": sql}).encode(),
        headers={"Content-Type": "application/json"},
    )
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def test_http_shed_503_and_quota_429(tmp_path):
    def run(p):
        _, _, broker = _cluster(
            p, tmp_path / p.name, table_extra={"queryQuotaQps": 2},
            scheduler_config=p.config.SchedulerConfig(num_runners=2),
        )
        svc = p.http.BrokerHTTPService(broker, port=0)
        try:
            broker.admission.note_service_time("t", 10_000.0)
            status, headers, doc = _post_query(svc.port, "SET timeoutMs = 500; SELECT COUNT(*) FROM t")
            shed = (status, int(headers["Retry-After"]) >= 1, doc["exceptions"][0]["errorCode"])
            with pytest.raises(p.scheduler.SchedulerRejectedError):
                p.http.query_broker_http(f"http://127.0.0.1:{svc.port}", "SET timeoutMs = 500; SELECT COUNT(*) FROM t")
            status2, headers2, _ = _post_query(svc.port, "SELECT COUNT(*) FROM t")
            with urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/debug/admission", timeout=10) as resp:
                snap = json.loads(resp.read())
            with urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/metrics", timeout=10) as resp:
                text = resp.read().decode()
            return shed, (status2, "Retry-After" in headers2), snap["counters"]["shed"], "broker_admission_shed" in text
        finally:
            svc.stop()
            broker.shutdown()

    assert both(run) == ((503, True, 211), (429, True), 2, True)


def test_server_scheduler_configs(tmp_path):
    def run(p):
        out = []
        for sched in ("fcfs", p.config.SchedulerConfig(kind="priority", num_runners=2), p.config.SchedulerConfig(enabled=False)):
            s = p.Server("s0", scheduler=sched)
            snap = s.admission_snapshot()
            out.append((snap["enabled"], (snap["scheduler"] or {}).get("kind")))
            s.shutdown()
        return out

    assert both(run) == [(True, "fcfs"), (True, "priority"), (False, None)]


# -- quotas ------------------------------------------------------------------


def test_query_quota_manager(tmp_path):
    def run(p):
        controller, _, broker = _cluster(p, tmp_path / p.name, table_extra={"queryQuotaQps": 3})
        broker.shutdown()
        q = p.quota.QueryQuotaManager(controller)
        out = []
        for _ in range(4):
            try:
                q.acquire("t")
                out.append("ok")
            except p.quota.QuotaExceededError as e:
                out.append((p.errors.code_of(e), p.errors.http_status_of(e)))
        q.acquire("other")  # unknown / unquota'd tables admit freely
        return out

    assert both(run) == ["ok", "ok", "ok", (429, 429)]


def test_tenant_quota_shared_across_tables(tmp_path):
    def run(p):
        controller = p.cluster.Controller(p.cluster.PropertyStore(), tmp_path / p.name)
        controller.register_server("s0", p.Server("s0"))
        dt = p.common.DataType
        for table in ("a", "b"):
            schema = p.common.Schema.build(table, dimensions=[("d", dt.INT)], metrics=[("v", dt.LONG)])
            controller.add_schema(schema)
            controller.add_table(p.common.TableConfig(table, replication=1))
            controller.upload_segment(
                table,
                p.segment.SegmentBuilder(schema).build(
                    {"d": np.zeros(10, dtype=np.int32), "v": np.ones(10, dtype=np.int64)}, f"{table}_0"
                ),
            )
        broker = p.cluster.Broker(controller, scheduler_config=p.config.SchedulerConfig(tenant_qps={"DefaultTenant": 2}))
        try:
            out = [broker.execute("SELECT COUNT(*) FROM a").rows, broker.execute("SELECT COUNT(*) FROM b").rows]
            with pytest.raises(p.quota.QuotaExceededError):
                broker.execute("SELECT COUNT(*) FROM a")
            return out, broker.admission_snapshot()["counters"]["quotaRejected"]
        finally:
            broker.shutdown()

    assert both(run) == ([[[10]], [[10]]], 1)


def test_query_logger_counts(tmp_path):
    def run(p):
        ql = p.quota.QueryLogger(max_rate_per_sec=2)
        return [ql.log(f"q{i}", "t", 1.0, 10) for i in range(3)], ql.emitted, ql.dropped_total

    assert both(run) == ([True, True, False], 2, 1)


# -- result cache ------------------------------------------------------------


def test_cache_hits_keys_and_invalidation(tmp_path):
    def run(p):
        controller, schema, broker = _cluster(p, tmp_path / p.name, n_servers=1, n_segs=1)
        try:
            seq = []
            for sql in (
                "SELECT SUM(v) FROM t",
                "SELECT SUM(v) FROM t",
                "SELECT   SUM(v)\n  FROM    t",
                "SET timeoutMs = 9000; SELECT SUM(v) FROM t",
            ):
                res = broker.execute(sql)
                seq.append((res.rows, res.cache_hit, res.to_dict()["cacheHit"]))
            v0 = controller.routing_version("t")
            b = p.segment.SegmentBuilder(schema)
            controller.upload_segment(
                "t", b.build({"d": np.array([4, 5], dtype=np.int32), "v": np.array([10, 10], dtype=np.int64)}, "t_1")
            )
            seq.append(controller.routing_version("t") > v0)
            for _ in range(2):
                res = broker.execute("SELECT SUM(v) FROM t")
                seq.append((res.rows, res.cache_hit))
            controller.upload_segment(
                "t", b.build({"d": np.array([4, 5], dtype=np.int32), "v": np.array([100, 100], dtype=np.int64)}, "t_1")
            )
            res = broker.execute("SELECT SUM(v) FROM t")
            seq.append((res.rows, res.cache_hit))
            snap = broker.cache_snapshot()["result"]
            seq.append((snap["hits"], snap["invalidations"] >= 2))
            return seq
        finally:
            broker.shutdown()

    out = both(run)
    assert out[1][1] and out[2][1] and not out[3][1]
    assert out[-2] == ([[200.0]], False)


def test_cache_keys_and_normalization_equal():
    def run(p):
        sqls = ["SELECT SUM(v) FROM t", "select sum(v)  from t", "SELECT 'a  b' FROM t", "SELECT 'a b' FROM t"]
        return [p.cache.normalize_sql(s) for s in sqls], p.cache.options_fingerprint({"timeoutMs": "9000", "a": "b"})

    norm, _ = both(run)
    assert norm[2] != norm[3]


def test_result_cache_ttl_and_versions():
    def run(p):
        cache = p.cache.ResultCache(max_bytes=1 << 20, max_entries=16, stats=p.cache.CacheStats())
        versions = (("t", 1),)
        cache.put("k", "value", versions, size=100, ttl_s=0.05)
        now = time.monotonic()
        out = [cache.get("k", versions, now=now), cache.get("k", versions, now=now + 1.0), cache.stats.invalidations]
        cache.put("k", "value", versions, size=100, ttl_s=None)
        out += [cache.get("k", (("t", 2),)), cache.stats.invalidations]
        return out

    assert both(run) == ["value", None, 1, None, 2]


def test_byte_bound_eviction(tmp_path):
    def run(p):
        _, _, broker = _cluster(p, tmp_path / p.name, n_servers=1, n_segs=1, cache_config=p.config.CacheConfig(max_bytes=4096))
        try:
            rows = [broker.execute(f"SELECT SUM(v) FROM t WHERE d < {i}").rows for i in range(8)]
            snap = broker.cache_snapshot()["result"]
            return rows, snap["evictions"] > 0, snap["bytes"] <= 4096, snap["entries"] < 8
        finally:
            broker.shutdown()

    both(run)


def test_single_flight_compiles_twice(tmp_path):
    def run(p):
        _, _, broker = _cluster(p, tmp_path / p.name, n_servers=1, n_segs=1)
        try:
            n = 16
            barrier = threading.Barrier(n)
            results = [None] * n

            def worker(i):
                barrier.wait(timeout=10)
                results[i] = broker.execute("SELECT SUM(v) FROM t")

            threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
            timer = p.metrics.get_registry("broker").timer("broker.phase.requestCompilationMs")
            return [r.rows for r in results], timer.count, sum(1 for r in results if r.cache_hit) >= n - 1
        finally:
            broker.shutdown()

    assert both(run)[1:] == (2, True)


def test_quota_charged_on_hits_and_errors_not_cached(tmp_path):
    def run(p):
        _, _, broker = _cluster(p, tmp_path / p.name, n_servers=1, n_segs=1, table_extra={"queryQuotaQps": 2})
        try:
            out = [broker.execute("SELECT SUM(v) FROM t").cache_hit, broker.execute("SELECT SUM(v) FROM t").cache_hit]
            with pytest.raises(p.quota.QuotaExceededError):
                broker.execute("SELECT SUM(v) FROM t")
        finally:
            broker.shutdown()
        _, _, broker = _cluster(p, tmp_path / f"{p.name}b", n_servers=1, n_segs=1)
        try:
            for _ in range(2):
                with pytest.raises(Exception):
                    broker.execute("SELEC nope FROM t")
            out.append(len(broker.caches.result))
        finally:
            broker.shutdown()
        return out

    assert both(run) == [False, True, 0]


def test_cache_config_wire_form_and_off_broker(tmp_path):
    def run(p):
        CacheConfig = p.config.CacheConfig
        cfg = CacheConfig.from_dict({"enabled": True, "maxBytes": 1024, "realtimeTtlMs": 50.0})
        with pytest.raises((KeyError, TypeError, ValueError)):
            CacheConfig.from_dict({"maxByte": 1024})
        with pytest.raises((KeyError, ValueError)):
            CacheConfig(kind="arc").make()
        _, _, broker = _cluster(p, tmp_path / p.name, n_servers=1, n_segs=1, cache_config=CacheConfig(enabled=False))
        try:
            hits = [broker.execute("SELECT SUM(v) FROM t").cache_hit for _ in range(3)]
            return cfg.to_dict(), CacheConfig.from_dict(cfg.to_dict()).to_dict(), broker.caches is None, hits, broker.cache_snapshot()
        finally:
            broker.shutdown()

    out = both(run)
    assert out[2] and out[3] == [False, False, False]


def test_estimate_result_bytes_equal():
    class R:
        rows = [[1, "abc"]] * 100

    class Small:
        rows = [[1]]

    got = both(lambda p: (p.cache.estimate_result_bytes(R()), p.cache.estimate_result_bytes(Small())))
    assert got[0] > got[1] > 0


# -- tenancy -----------------------------------------------------------------


def _tenant_cluster(p, root):
    ctrl = p.cluster.Controller(p.cluster.PropertyStore(), root)
    servers = {}
    for tenant in ("A", "B"):
        for i in range(2):
            sid = f"srv{tenant}_{i}"
            servers[sid] = p.Server(sid)
            ctrl.register_server(sid, handle=servers[sid], tags=[f"tenant{tenant}_OFFLINE"])
    dt = p.common.DataType
    for name, tenant in (("ta", "tenantA"), ("tb", "tenantB")):
        ctrl.add_schema(p.common.Schema.build(name, dimensions=[("g", dt.STRING)], metrics=[("v", dt.LONG)]))
        ctrl.add_table(p.common.TableConfig(name, replication=2, extra={"tenants": {"broker": tenant, "server": tenant}}))
    return ctrl, servers


def _tseg(p, name, seg_name, seed):
    rng = np.random.default_rng(seed)
    dt = p.common.DataType
    schema = p.common.Schema.build(name, dimensions=[("g", dt.STRING)], metrics=[("v", dt.LONG)])
    return p.segment.SegmentBuilder(schema).build(
        {"g": np.asarray(["a", "b"], dtype=object)[rng.integers(0, 2, 200)], "v": rng.integers(1, 100, 200).astype(np.int64)},
        seg_name,
    )


def test_tenant_assignment_routing_and_gate(tmp_path):
    def run(p):
        ctrl, servers = _tenant_cluster(p, tmp_path / p.name)
        for name, seed in (("ta", 1), ("tb", 2)):
            for k in range(3):
                ctrl.upload_segment(name, _tseg(p, name, f"{name}_s{k}", seed + k))
        touched = []
        for sid, srv in servers.items():
            orig = srv.execute_partials

            def spy(table, sql, names, hints=None, workload="PRIMARY", _sid=sid, _orig=orig):
                touched.append((_sid, table))
                return _orig(table, sql, names, hints)

            srv.execute_partials = spy
        broker = p.cluster.Broker(ctrl)
        gate = p.cluster.Broker(ctrl, tenant_tags=["tenantA_BROKER"])
        try:
            rows = {t: broker.execute(f"SELECT g, SUM(v) FROM {t} GROUP BY g ORDER BY g").rows for t in ("ta", "tb")}
            with pytest.raises(PermissionError):
                gate.execute("SELECT COUNT(*) FROM tb")
            gated = gate.execute("SELECT COUNT(*) FROM ta").rows
            return (
                ctrl.ideal_state("ta"),
                ctrl.ideal_state("tb"),
                sorted(set(touched)),
                rows,
                gated,
                p.tenancy.tagged_servers(ctrl, "tenantA_OFFLINE"),
            )
        finally:
            broker.shutdown()
            gate.shutdown()

    ideal_a, ideal_b, touched, _, gated, tagged = both(run)
    assert all(s.startswith("srvA_") for reps in ideal_a.values() for s in reps)
    assert all(s.startswith("srvB_") for reps in ideal_b.values() for s in reps)
    assert all(sid.startswith(f"srv{t[1].upper()}_") for sid, t in touched)
    assert gated == [[600]] and tagged == ["srvA_0", "srvA_1"]


def test_retag_and_reregistration(tmp_path):
    def run(p):
        ctrl, servers = _tenant_cluster(p, tmp_path / p.name)
        ctrl.update_server_tags("srvB_0", ["tenantA_OFFLINE"])
        out = [p.tenancy.tagged_servers(ctrl, "tenantA_OFFLINE"), p.tenancy.tagged_servers(ctrl, "tenantB_OFFLINE")]
        ctrl.register_server("srvA_0", handle=servers["srvA_0"])  # restart, no tags
        out.append(p.tenancy.tagged_servers(ctrl, "tenantA_OFFLINE"))
        out.append(p.tenancy.candidate_servers(ctrl, ctrl.get_table("tb")))
        return out

    assert both(run)[1] == ["srvB_1"]


# -- frontend timelines ------------------------------------------------------


def test_phase_timeline_marks_equal():
    def run(p):
        tl = p.fobs.PhaseTimeline("broker", t0=100.0)
        for name, t in (("headersRead", 100.010), ("bodyRead", 100.025), ("parse", 100.027), ("execute", 100.127),
                        ("serialize", 100.130), ("write", 100.140), ("drain", 100.141), ("drain", 100.100)):
            tl.mark(name, now=t)
        snap = tl.snapshot()
        pre = p.fobs.PhaseTimeline("broker", t0=50.0)
        pre.record_pre("accept", 5.0)
        pre.mark("headersRead", now=50.002)
        return (
            {k: round(v, 6) for k, v in snap["phasesMs"].items()},
            round(tl.wall_ms(now=100.141), 6),
            round(pre.wall_ms(now=50.002), 6),
            {k: round(v, 6) for k, v in pre.snapshot()["phasesMs"].items()},
        )

    phases, wall, pre_wall, _ = both(run)
    assert phases["execute"] == 100.0 and wall == 141.0 and pre_wall == 7.0


def test_sub_phases_fold_into_registry_and_trace():
    def run(p):
        p.metrics.reset_registries()
        p.fobs.record_timeline_sub("admission", 1.0)
        tl = p.fobs.PhaseTimeline("broker")
        tl.activate()
        try:
            active = p.fobs.active_timeline() is tl
            p.fobs.record_timeline_sub("admission", 1.5)
            p.fobs.record_timeline_sub("queueWait", 0.5)
        finally:
            tl.deactivate()
        tl.mark("execute")
        with p.trace.start_trace("q", context=p.trace.TraceContext.mint()) as tr:
            tl.trace = tr
            out = tl.finish()
        snap = p.metrics.broker_metrics().snapshot()
        return (
            active,
            out["subPhasesMs"],
            "admission" in out["phasesMs"],
            snap["broker.http.phase.admissionMs"]["count"],
            tr.to_dict()["phaseTimesMs"]["http.execute"] > 0,
        )

    assert both(run) == (True, {"admission": 1.5, "queueWait": 0.5}, False, 1, True)


def test_attribute_client_gap_equal():
    def run(p):
        samples = [
            {"clientMs": 10.0 + i, "ttfbMs": 8.0 + i, "brokerPhasesMs": {"execute": 5.0, "parse": 0.5}} for i in range(20)
        ]
        try:
            return p.fobs.attribute_client_gap(samples)
        except Exception as e:  # the same failure in both is parity too
            return type(e).__name__

    both(run)


def test_debug_frontend_endpoint_and_conn_gauges(tmp_path):
    def run(p):
        _, _, broker = _cluster(p, tmp_path / p.name, n_servers=1, n_segs=1)
        svc = p.http.BrokerHTTPService(broker, port=0)
        try:
            for _ in range(3):
                p.http.query_broker_http(f"http://127.0.0.1:{svc.port}", "SELECT COUNT(*) FROM t")
            with urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/debug/frontend", timeout=10) as r:
                doc = json.loads(r.read())
            return sorted(doc), doc["role"] if "role" in doc else None
        finally:
            svc.stop()
            broker.shutdown()

    keys, _ = both(run)
    assert keys


# -- failure detector --------------------------------------------------------


def test_failure_detector_backoff_and_recovery():
    def run(p):
        fd = p.failure.FailureDetector(initial_delay_sec=0.05, backoff_factor=2.0)
        out = [fd.is_healthy("s0")]
        fd.mark_failure("s0")
        out += [fd.is_healthy("s0"), fd.unhealthy_servers()]
        time.sleep(0.06)
        out.append(fd.is_healthy("s0"))
        fd.mark_failure("s0")
        time.sleep(0.06)
        out.append(fd.is_healthy("s0"))
        fd.mark_success("s0")
        out.append(fd.is_healthy("s0"))
        fd2 = p.failure.FailureDetector(initial_delay_sec=10)
        fd2.mark_failure("s0")
        ideal = {"seg0": {"s0": "ONLINE", "s1": "ONLINE"}, "seg1": {"s0": "ONLINE"}}
        out.append(fd2.filter_ideal_state(ideal))
        return out

    assert both(run)[:6] == [True, False, ["s0"], True, False, True]
