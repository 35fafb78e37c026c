"""The port's table rebalance against the JAX package's: the target
assignment, the moves with their drain ordering, progress, the fault point,
a rebalance under live load and on a fenced ex-leader, the REST endpoint and
the admin command, and the compatibility verifier that replays op suites
(rebalance among them) against a fresh cluster.

The cases are the rebalance and HA cases of `tests/test_survivability.py`
and `tests/test_routing2.py`. Each script runs on both packages' in-process
clusters (the port's servers on the CPU); targets, moves, ideal states,
progress documents and rows must be equal. Under live load every wait is
bounded and the test asserts outcomes, never timings.
"""

import importlib
import json
import random
import threading
import time
import types

import numpy as np
import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")
TOTAL_ROWS = 5 * 200


def _pkg(name):
    m = importlib.import_module
    P = types.SimpleNamespace(
        name=name,
        cluster=m(f"{name}.cluster"),
        ha=m(f"{name}.cluster.ha"),
        http=m(f"{name}.cluster.http"),
        metadata=m(f"{name}.cluster.metadata"),
        rebalance=m(f"{name}.cluster.rebalance"),
        failure=m(f"{name}.cluster.failure"),
        common=m(f"{name}.common"),
        faults=m(f"{name}.common.faults"),
        metrics=m(f"{name}.common.metrics"),
        segment=m(f"{name}.segment"),
        admin=m(f"{name}.tools.admin"),
        compat=m(f"{name}.tools.compat_verifier"),
    )
    port = name.endswith("_torch")
    P.Server = (lambda sid, **kw: P.cluster.Server(sid, device="cpu", **kw)) if port else P.cluster.Server
    P.Broker = (lambda c, **kw: P.cluster.Broker(c, device="cpu", **kw)) if port else P.cluster.Broker
    P.Verifier = (lambda wd=None: P.compat.CompatVerifier(wd, device="cpu")) if port else P.compat.CompatVerifier
    return P


@pytest.fixture
def both():
    pkgs = [_pkg(n) for n in PKGS]
    for P in pkgs:
        P.faults.FAULTS.reset()
        P.metrics.reset_registries()
    yield pkgs
    for P in pkgs:
        P.faults.FAULTS.reset()


def _build_cluster(P, root, n_servers=2, replication=1, rows_per_seg=200, n_segs=5):
    controller = P.cluster.Controller(P.cluster.PropertyStore(), root / "ds")
    servers = {f"s{i}": P.Server(f"s{i}") for i in range(n_servers)}
    for sid, s in servers.items():
        controller.register_server(sid, s)
    dt = P.common.DataType
    schema = P.common.Schema.build("t", dimensions=[("d", dt.INT)], metrics=[("v", dt.LONG)])
    controller.add_schema(schema)
    controller.add_table(P.common.TableConfig("t", replication=replication))
    b = P.segment.SegmentBuilder(schema)
    rng = np.random.default_rng(0)
    for i in range(n_segs):
        controller.upload_segment(
            "t",
            b.build({"d": rng.integers(0, 10, rows_per_seg).astype(np.int32),
                     "v": np.full(rows_per_seg, i, dtype=np.int64)}, f"t_{i}"),
        )
    return controller, servers


def _result(r):
    return {"status": r.status, "adds": sorted(r.adds), "drops": sorted(r.drops), "target": r.target}


def _progress(P, table="t"):
    doc = P.rebalance.rebalance_progress(table)
    return {k: doc.get(k) for k in ("status", "totalMoves", "doneMoves", "currentSegment")}


def _run(both, tmp_path, script):
    out = []
    for P in both:
        root = tmp_path / P.name
        root.mkdir()
        out.append(json.loads(json.dumps(script(P, root), sort_keys=True, default=str).replace(str(root), "<root>")))
    return out


# -- the target assignment ----------------------------------------------------


def test_compute_target_matches_on_random_placements(both):
    ref, port = both
    assert port.rebalance.compute_target_assignment(
        ["a", "b"], ["s0", "s1"], 1, {"a": {"s0": "ONLINE"}, "b": {"s0": "ONLINE"}}
    ) == {"a": ["s0"], "b": ["s0"]}
    rng = random.Random(16)
    for _ in range(300):
        servers = [f"s{i}" for i in range(rng.randint(1, 6))]
        segs = [f"t_{i}" for i in range(rng.randint(1, 9))]
        current = {
            s: {sid: "ONLINE" for sid in rng.sample(servers + ["gone"], rng.randint(0, min(3, len(servers))))}
            for s in segs
        }
        candidates = {s: rng.sample(servers, rng.randint(1, len(servers))) for s in segs if rng.random() < 0.3}
        args = (segs, servers, rng.randint(1, 3), current, candidates or None, rng.random() < 0.5)
        want = ref.rebalance.compute_target_assignment(*args)
        assert port.rebalance.compute_target_assignment(*args) == want
        assert all(len(set(v)) == len(v) for v in want.values())


def test_compute_target_refuses_to_cross_a_dead_pool(both):
    msgs = []
    for P in both:
        with pytest.raises(RuntimeError) as ei:
            P.rebalance.compute_target_assignment(["a"], ["s0"], 1, {}, {"a": ["s9"]})
        msgs.append(str(ei.value))
    assert msgs[1] == msgs[0] and "none of its candidate servers" in msgs[1]


# -- moves ----------------------------------------------------------------------


def test_rebalance_after_server_addition(both, tmp_path):
    def script(P, root):
        controller, servers = _build_cluster(P, root, n_servers=1, replication=2, n_segs=3)
        clamped = controller.ideal_state("t")
        s1 = P.Server("s1")
        controller.register_server("s1", s1)
        r = P.rebalance.rebalance_table(controller, "t")
        return {
            "clamped": clamped, "result": _result(r), "ideal": controller.ideal_state("t"),
            "hosted": s1.segments_of("t"), "servers": {s: controller.segment_metadata("t", s)["servers"] for s in clamped},
            "rows": P.Broker(controller).execute("SELECT COUNT(*) FROM t").rows,
            "again": P.rebalance.rebalance_table(controller, "t").status, "progress": _progress(P),
        }

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert all(len(r) == 1 for r in port["clamped"].values())
    assert port["result"]["status"] == "DONE" and {a[1] for a in port["result"]["adds"]} == {"s1"}
    assert port["hosted"] == ["t_0", "t_1", "t_2"] and port["rows"] == [[600]] and port["again"] == "NO_OP"
    assert port["progress"] == {"status": "DONE", "totalMoves": 3, "doneMoves": 3, "currentSegment": None}


def test_rebalance_dry_run_moves_nothing(both, tmp_path):
    def script(P, root):
        controller, _ = _build_cluster(P, root, n_servers=1, replication=2, n_segs=1)
        before = controller.ideal_state("t")
        controller.register_server("s1", P.Server("s1"))
        r = P.rebalance.rebalance_table(controller, "t", dry_run=True)
        return {"result": _result(r), "before": before, "after": controller.ideal_state("t")}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["result"]["adds"] == [["t_0", "s1"]] and port["after"] == port["before"]


def test_bootstrap_rebalance_balances_scale_out(both, tmp_path):
    def script(P, root):
        controller, _ = _build_cluster(P, root, n_servers=2, replication=2, n_segs=4)
        for i in range(2, 4):
            controller.register_server(f"s{i}", P.Server(f"s{i}"))
        plain = P.rebalance.rebalance_table(controller, "t").status
        r = P.rebalance.rebalance_table(controller, "t", bootstrap=True)
        load = {f"s{i}": 0 for i in range(4)}
        for replicas in controller.ideal_state("t").values():
            for sid in replicas:
                load[sid] += 1
        return {"plain": plain, "result": _result(r), "load": load,
                "rows": P.Broker(controller).execute("SELECT COUNT(*) FROM t").rows}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["plain"] == "NO_OP" and port["result"]["adds"] and port["result"]["drops"]
    assert set(port["load"].values()) == {2} and port["rows"] == [[800]]


def test_rebalance_move_fault_marks_progress_failed_then_recovers(both, tmp_path):
    def script(P, root):
        controller, _ = _build_cluster(P, root, n_servers=2, replication=2)
        for i in range(2, 4):
            controller.register_server(f"s{i}", P.Server(f"s{i}"))
        P.faults.FAULTS.configure({"rebalance.move": P.faults.FaultRule()}, seed=3)
        with pytest.raises(P.faults.InjectedFault):
            P.rebalance.rebalance_table(controller, "t", bootstrap=True)
        failed, fired = _progress(P), P.faults.FAULTS.counts()["rebalance.move"]
        P.faults.FAULTS.reset()
        r = P.rebalance.rebalance_table(controller, "t", bootstrap=True)
        return {"failed": failed, "fired": fired, "result": _result(r), "done": _progress(P),
                "rows": P.Broker(controller).execute("SELECT COUNT(*) FROM t").rows}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["failed"]["status"] == "FAILED" and port["fired"] == 1
    assert port["done"]["status"] == "DONE" and port["rows"] == [[TOTAL_ROWS]]


def test_rebalance_under_live_load_drops_no_queries(both, tmp_path):
    """ADD-new, ONLINE, de-route, drain, REMOVE-old: four clients querying
    through the move never see a segment with no ONLINE replica."""
    outs = []
    for P in both:
        controller, _ = _build_cluster(P, tmp_path / P.name, n_servers=2, replication=2)
        for i in range(2, 4):
            controller.register_server(f"s{i}", P.Server(f"s{i}"))
        broker = P.Broker(controller, failure_detector=P.failure.FailureDetector())
        errors, oks, lock, stop = [], [0], threading.Lock(), threading.Event()

        def drive():
            while not stop.is_set():
                try:
                    n = broker.execute("SELECT COUNT(*) FROM t").rows[0][0]
                    with lock:
                        if n == TOTAL_ROWS:
                            oks[0] += 1
                        else:
                            errors.append(f"short read: {n}")
                except Exception as e:  # noqa: BLE001 - every failure is an outcome to report
                    with lock:
                        errors.append(repr(e))

        threads = [threading.Thread(target=drive, daemon=True) for _ in range(4)]
        for t in threads:
            t.start()
        try:
            deadline = time.time() + 10
            while time.time() < deadline and oks[0] == 0 and not errors:
                time.sleep(0.01)
            r = P.rebalance.rebalance_table(controller, "t", drain_grace_sec=0.02, bootstrap=True)
            mark = oks[0]
            deadline = time.time() + 10
            while time.time() < deadline and oks[0] == mark and not errors:
                time.sleep(0.01)
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=30)
            broker.shutdown()
        outs.append({"result": _result(r), "errors": errors, "served": oks[0] > 0, "progress": _progress(P),
                     "ideal": controller.ideal_state("t")})
    assert outs[1] == outs[0]
    assert outs[1]["errors"] == [] and outs[1]["served"] and outs[1]["result"]["adds"]
    assert outs[1]["progress"]["status"] == "DONE"


def test_rebalance_on_a_fenced_ex_leader_fails_and_the_new_lead_finishes(both, tmp_path, monkeypatch):
    """A rebalance running on a controller whose lease a standby has taken
    is fenced at its first metadata write; the new lead's rebalance then
    converges the placement."""

    def script(P, root):
        controller, _ = _build_cluster(P, root, n_servers=2, replication=2)
        for i in range(2, 4):
            controller.register_server(f"s{i}", P.Server(f"s{i}"))
        store = controller.store
        controller._election = P.ha.LeaderElection(store, "c1", ttl=3600.0)
        controller._election._tick()
        store.update(P.metadata.LEASE_PATH, lambda d: {"owner": "c2", "expires": time.time() + 3600, "epoch": d["epoch"] + 1})
        with pytest.raises(P.metadata.FencedWriteError):
            P.rebalance.rebalance_table(controller, "t", bootstrap=True)
        failed = _progress(P)
        lead = P.cluster.Controller(store, root / "ds", controller_id="c2")
        for sid, h in controller.servers().items():
            lead._servers[sid] = h
        lead._election = P.ha.LeaderElection(store, "c2", ttl=3600.0)
        lead._election._tick()
        r = P.rebalance.rebalance_table(lead, "t", bootstrap=True)
        return {"failed": failed, "epoch": lead.lease_fence(), "result": _result(r), "done": _progress(P),
                "rows": P.Broker(lead).execute("SELECT COUNT(*) FROM t").rows}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["failed"]["status"] == "FAILED" and port["failed"]["doneMoves"] == 0
    assert port["epoch"] == 3 and port["done"]["status"] == "DONE" and port["rows"] == [[TOTAL_ROWS]]


# -- REST and the admin command ---------------------------------------------------


def test_rebalance_over_rest_and_the_admin_command(both, tmp_path, capsys):
    """POST /tables/{t}/rebalance (dry run, then bootstrap with a drain
    grace), RemoteControllerClient.rebalance_table and the RebalanceTable
    command answer as the reference's."""

    def script(P, root):
        controller, _ = _build_cluster(P, root, n_servers=2, replication=2)
        for i in range(2, 4):
            controller.register_server(f"s{i}", P.Server(f"s{i}"))
        svc = P.http.ControllerHTTPService(controller)
        url = f"http://127.0.0.1:{svc.port}"
        try:
            client = P.http.RemoteControllerClient(url)
            dry = client.rebalance_table("t", dry_run=True, bootstrap=True)
            untouched = controller.ideal_state("t")
            capsys.readouterr()
            rc = P.admin.main(["RebalanceTable", "--controller-url", url, "--table", "t", "--bootstrap",
                               "--drain-grace-sec", "0.01"])
            printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
            again = client.rebalance_table("t", bootstrap=True)
        finally:
            svc.stop()
        return {"dry": dry, "untouched": untouched, "rc": rc, "printed": printed, "again": again,
                "ideal": controller.ideal_state("t"), "progress": _progress(P)}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["dry"]["status"] == "DONE" and port["dry"]["adds"] and port["rc"] == 0
    assert port["printed"]["adds"] == port["dry"]["adds"] and port["again"]["status"] == "NO_OP"


# -- the compatibility verifier ---------------------------------------------------


def _seeded_suite(seed=5):
    rng = np.random.default_rng(seed)
    kinds = np.array(["a", "b", "c"])
    batches = [
        [{"kind": str(kinds[k]), "value": int(v)} for k, v in zip(rng.integers(0, 3, 20), rng.integers(0, 100, 20))]
        for _ in range(3)
    ]
    rows = [r for b in batches for r in b]
    sums = {k: float(sum(r["value"] for r in rows if r["kind"] == k)) for k in ("a", "b", "c")}
    after = [r for b in batches[1:] for r in b]
    return {
        "operations": [
            {"op": "createTable", "schema": {
                "schemaName": "compatEvents",
                "fields": [{"name": "kind", "dataType": "STRING", "fieldType": "DIMENSION"},
                           {"name": "value", "dataType": "LONG", "fieldType": "METRIC"}],
                "primaryKeyColumns": []},
             "config": {"tableName": "compatEvents", "replication": 1}},
            *({"op": "ingestRows", "table": "compatEvents", "rows": b} for b in batches),
            {"op": "query", "sql": "SELECT COUNT(*) FROM compatEvents", "expectedRows": [[len(rows)]]},
            {"op": "query", "sql": "SELECT kind, SUM(value) FROM compatEvents GROUP BY kind ORDER BY kind",
             "expectedRows": [[k, v] for k, v in sorted(sums.items())]},
            {"op": "query", "sql": "SELECT COUNT(*) FROM compatEvents WHERE kind = 'a'",
             "expectedRows": [[sum(r["kind"] == "a" for r in rows)]], "expectedNumDocsScanned": sum(r["kind"] == "a" for r in rows)},
            {"op": "deleteSegment", "table": "compatEvents", "segment": "compatEvents_compat_0"},
            {"op": "query", "sql": "SELECT COUNT(*) FROM compatEvents", "expectedRows": [[len(after)]]},
            {"op": "reloadSegments", "table": "compatEvents"},
            {"op": "rebalance", "table": "compatEvents"},
            {"op": "query", "sql": "SELECT kind FROM compatEvents ORDER BY kind LIMIT 3", "unordered": True,
             "expectedRows": [[k] for k in sorted(r["kind"] for r in after)[:3]]},
        ]
    }


def test_compat_suites_pass_or_fail_at_the_same_op(both):
    ref, port = both
    for suite in (ref.compat.SAMPLE_SUITE, _seeded_suite()):
        results = []
        for P in both:
            v = P.Verifier()
            try:
                results.append(v.run_suite(suite))
            finally:
                v.close()
        assert results[1] == results[0] and all(r["status"] == "PASSED" for r in results[1])
    broken = _seeded_suite()
    broken["operations"][5]["expectedRows"] = [["a", 0.0]]  # a wrong expectation
    broken["operations"].insert(7, {"op": "noSuchOp"})
    for ops in (broken["operations"], broken["operations"][:5] + broken["operations"][6:]):
        errs = []
        for P in both:
            v = P.Verifier()
            try:
                with pytest.raises(P.compat.CompatFailure) as ei:
                    v.run_suite({"operations": ops})
                errs.append(str(ei.value))
            finally:
                v.close()
        assert errs[1] == errs[0]


def test_compat_verifier_cli(both, tmp_path, capsys):
    outs = []
    for P in both:
        path = tmp_path / f"{P.name}.json"
        path.write_text(json.dumps(_seeded_suite(6)))
        argv = ["--suite", str(path), "--workdir", str(tmp_path / P.name)]
        capsys.readouterr()
        rc = P.compat.main(argv + (["--device", "cpu"] if P.name.endswith("_torch") else []))
        outs.append((rc, json.loads(capsys.readouterr().out.strip().splitlines()[-1])))
    assert outs[1] == outs[0] == (0, {"status": "PASSED", "operations": 12})
