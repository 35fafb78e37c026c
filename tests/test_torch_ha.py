"""The port's controller HA against the JAX package's: lead-controller
leases with fencing epochs, the durable transition queue and its
reconciler, the standby gate over HTTP, the lead-only periodic planes, and
a cold restart from the store dir and the deep store.

The cases are `tests/test_controller_ha.py`'s. Each runs one script on both
packages' in-process clusters (the port's servers on the CPU) and compares
what the script records: lease documents, epochs and takeovers, fence
outcomes, queued transitions, ideal and external views, and rows. Where a
lease is timed, the election and the queue run on a controlled clock (their
module's `time`), ticked and drained by hand; the planes' and the real
election's threads are waited on with bounded waits.
"""

import importlib
import json
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")


def _pkg(name):
    m = importlib.import_module
    P = types.SimpleNamespace(
        name=name,
        cluster=m(f"{name}.cluster"),
        ha=m(f"{name}.cluster.ha"),
        http=m(f"{name}.cluster.http"),
        metadata=m(f"{name}.cluster.metadata"),
        periodic=m(f"{name}.cluster.periodic"),
        common=m(f"{name}.common"),
        faults=m(f"{name}.common.faults"),
        metrics=m(f"{name}.common.metrics"),
        segment=m(f"{name}.segment"),
    )
    port = name.endswith("_torch")
    P.Server = (lambda sid, **kw: P.cluster.Server(sid, device="cpu", **kw)) if port else P.cluster.Server
    P.Broker = (lambda c, **kw: P.cluster.Broker(c, device="cpu", **kw)) if port else P.cluster.Broker
    return P


@pytest.fixture
def both():
    return [_pkg(n) for n in PKGS]


def _schema(P):
    dt = P.common.DataType
    return P.common.Schema.build("t", dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)])


def _segment(P, i, n=500):
    rng = np.random.default_rng(i)
    return P.segment.SegmentBuilder(_schema(P)).build(
        {
            "k": np.asarray([f"k{j % 4}" for j in range(n)], dtype=object),
            "v": rng.integers(0, 100, n).astype(np.int64),
        },
        f"t_{i}",
    )


def _flaky(P, sid, fail_n):
    """A server of package P whose first `fail_n` add_segment calls fail."""

    class FlakyServer(P.cluster.Server):
        def add_segment(self, table, segment, seg_dir):
            if self.failures_injected < self.fail_n:
                self.failures_injected += 1
                raise RuntimeError(f"server {self.server_id} unreachable (injected)")
            return super().add_segment(table, segment, seg_dir)

    s = FlakyServer(sid, device="cpu") if P.name.endswith("_torch") else FlakyServer(sid)
    s.fail_n, s.failures_injected = fail_n, 0
    return s


class Clock:
    """The controlled clock a package's ha module reads through `time`."""

    def __init__(self, t0=1_000_000.0):
        self.now = t0

    def time(self):
        return self.now

    def sleep(self, s):
        time.sleep(min(s, 0.01))

    def advance(self, s):
        self.now += s


def _clocked(P, monkeypatch, t0=1_000_000.0):
    clock = Clock(t0)
    monkeypatch.setattr(P.ha, "time", clock)
    return clock


def _ha_controller(P, store, deep, cid, ttl=1.0, servers=()):
    """A controller with an election and a transition queue that nothing
    drives but the test: `_tick()` renews, `drain_once()` delivers. The
    servers register before it joins the election, as a standby's
    registration would be fenced."""
    c = P.cluster.Controller(store, deep, controller_id=cid)
    for sid, s in servers:
        c.register_server(sid, s)
    c._election = P.ha.LeaderElection(store, cid, ttl=ttl, renew_every=0.2)
    c._transitions = P.ha.TransitionManager(c, c._election)
    c._election._tick()
    return c


def _norm(obj, root):
    """obj with the package's temp root spelled `<root>`."""
    return json.loads(json.dumps(obj, sort_keys=True, default=str).replace(str(root), "<root>"))


def _queue(store):
    msgs = [store.get(p) for p in store.list("/transitions/")]
    return sorted(
        ((m["table"], m["segment"], m["server"], m["action"], m["attempts"]) for m in msgs if m), key=repr
    )


def _run(both, tmp_path, script, **kw):
    """script(P, root, **kw) on both packages; returns (reference, port)."""
    out = []
    for P in both:
        root = tmp_path / P.name
        root.mkdir()
        out.append(_norm(script(P, root, **kw), root))
    return out


# -- leases -------------------------------------------------------------------


def _lease_script(P, root, monkeypatch):
    clock = _clocked(P, monkeypatch)
    store = P.cluster.PropertyStore(root / "store")
    c1 = _ha_controller(P, store, root / "deep", "c1")
    c2 = _ha_controller(P, store, root / "deep", "c2")
    trace = []

    def note(step):
        lease = store.get(P.metadata.LEASE_PATH)
        trace.append({
            "step": step,
            "lease": {"owner": lease["owner"], "epoch": lease["epoch"], "ttlLeft": round(lease["expires"] - clock.now, 6)},
            "c1": [c1.is_leader, c1.lease_fence(), c1._election.takeovers],
            "c2": [c2.is_leader, c2.lease_fence(), c2._election.takeovers],
        })

    note("start")
    clock.advance(0.5)
    c1._election._tick()
    c2._election._tick()
    note("renewed")
    clock.advance(1.1)  # c1 crashed: it renews no more
    c2._election._tick()
    note("takeover")
    c1._election._tick()  # c1 wakes to a live foreign lease
    note("demoted")
    c2._election.stop(release=True)
    note("released")
    c1._election._tick()
    note("reclaimed")
    c1._election.stop(release=False)
    return trace


def test_lease_failover(both, tmp_path, monkeypatch):
    ref, port = _run(both, tmp_path, _lease_script, monkeypatch=monkeypatch)
    assert port == ref
    by = {t["step"]: t for t in port}
    assert by["start"]["lease"] == {"owner": "c1", "epoch": 1, "ttlLeft": 1.0}
    assert by["start"]["c1"][0] and not by["start"]["c2"][0]
    assert by["takeover"]["lease"]["owner"] == "c2" and by["takeover"]["lease"]["epoch"] == 2
    assert by["demoted"]["c1"][0] is False and by["demoted"]["c2"] == [True, 2, 1]
    assert by["released"]["lease"] == {"owner": "", "epoch": 2, "ttlLeft": -1_000_001.6}
    assert by["reclaimed"]["lease"]["epoch"] == 3 and by["reclaimed"]["c1"] == [True, 3, 2]


def test_enable_ha_elects_one_leader_on_real_threads(both, tmp_path):
    """Controller.enable_ha / stop_ha as the reference runs them: one leader,
    a crashed lead's standby takes over after the TTL at a higher epoch."""
    outs = []
    for P in both:
        store = P.cluster.PropertyStore()
        c1 = P.cluster.Controller(store, tmp_path / P.name / "deep", controller_id="c1")
        c2 = P.cluster.Controller(store, tmp_path / P.name / "deep", controller_id="c2")
        c1.enable_ha(lease_ttl=2.0, renew_every=0.1)
        c2.enable_ha(lease_ttl=2.0, renew_every=0.1)
        try:
            first = (c1.is_leader, c2.is_leader, c1.lease_fence(), c2.ha_status()["enabled"])
            c1.stop_ha(release_lease=False)
            deadline = time.time() + 10
            while time.time() < deadline and not c2.is_leader:
                time.sleep(0.05)
            st = c2.ha_status()
            outs.append((first, c2.is_leader, st["leaseEpoch"], st["takeovers"], sorted(st), c1.ha_status()["enabled"]))
        finally:
            c1.stop_ha()
            c2.stop_ha()
    assert outs[1] == outs[0]
    assert outs[1][0] == (True, False, 1, True) and outs[1][1:4] == (True, 2, 1)


# -- the transition queue and the reconciler ----------------------------------


def _retry_script(P, root, monkeypatch):
    clock = _clocked(P, monkeypatch)
    store = P.cluster.PropertyStore()
    c = _ha_controller(P, store, root / "deep", "c1", ttl=3600.0)
    flaky = _flaky(P, "s0", fail_n=3)
    c.register_server("s0", flaky)
    c.add_schema(_schema(P))
    c.add_table(P.common.TableConfig("t", replication=1))
    c.upload_segment("t", _segment(P, 0))  # the add fails: queued
    steps = [{"queue": _queue(store), "ev": store.get("/tables/t/externalview")}]
    for _ in range(6):
        delivered = c._transitions.drain_once()
        steps.append({"delivered": delivered, "queue": _queue(store), "ev": store.get("/tables/t/externalview")})
        clock.advance(P.ha.TransitionManager.BACKOFF_MAX)
    steps.append({"rows": P.Broker(c).execute("SELECT COUNT(*) FROM t").rows, "injected": flaky.failures_injected})
    return steps


def test_transition_retry_converges(both, tmp_path, monkeypatch):
    ref, port = _run(both, tmp_path, _retry_script, monkeypatch=monkeypatch)
    assert port == ref
    assert port[0]["queue"] == [["t", "t_0", "s0", "add", 0]]
    assert [s.get("delivered") for s in port[1:7]] == [0, 0, 1, 0, 0, 0]
    assert port[3]["ev"] == {"t_0": {"s0": "ONLINE"}}
    assert port[-1] == {"rows": [[500]], "injected": 3}


def _reconcile_script(P, root, monkeypatch):
    clock = _clocked(P, monkeypatch, t0=time.time())
    store = P.cluster.PropertyStore()
    c = P.cluster.Controller(store, root / "deep", controller_id="c1")
    server = P.Server("s0")
    c.register_server("s0", server)
    c.add_schema(_schema(P))
    c.add_table(P.common.TableConfig("t", replication=1))
    c.upload_segment("t", _segment(P, 0))
    server.remove_segment("t", "t_0")  # the server lost its state
    store.delete("/tables/t/externalview")
    c._election = P.ha.LeaderElection(store, "c1", ttl=3600.0)
    c._transitions = P.ha.TransitionManager(c, c._election)
    c._election._tick()
    young = c._transitions.reconcile()  # inside the upload grace: no enqueue
    clock.advance(P.ha.TransitionManager.RECONCILE_GRACE_S + 1.0)
    enqueued = c._transitions.reconcile()
    queued = _queue(store)
    again = c._transitions.reconcile()  # already pending: no duplicate
    delivered = c._transitions.drain_once()
    return {
        "young": young, "enqueued": enqueued, "queued": queued, "again": again, "delivered": delivered,
        "ev": store.get("/tables/t/externalview"),
        "rows": P.Broker(c).execute("SELECT COUNT(*) FROM t").rows,
    }


def test_reconciler_heals_missing_replica(both, tmp_path, monkeypatch):
    ref, port = _run(both, tmp_path, _reconcile_script, monkeypatch=monkeypatch)
    assert port == ref
    assert port == {"young": 0, "enqueued": 1, "queued": [["t", "t_0", "s0", "add", 0]], "again": 0,
                    "delivered": 1, "ev": {"t_0": {"s0": "ONLINE"}}, "rows": [[500]]}


def _lead_death_script(P, root, monkeypatch):
    clock = _clocked(P, monkeypatch)
    store = P.cluster.PropertyStore()
    flaky = _flaky(P, "s0", fail_n=4)
    c1 = _ha_controller(P, store, root / "deep", "c1", servers=[("s0", flaky)])
    c2 = _ha_controller(P, store, root / "deep", "c2", servers=[("s0", flaky)])
    c1.add_schema(_schema(P))
    c1.add_table(P.common.TableConfig("t", replication=1))
    for i in range(3):
        c1.upload_segment("t", _segment(P, i))
    queued = _queue(store)
    clock.advance(1.5)  # the lead crashed before its queue drained
    c2._election._tick()
    c1._election._tick()
    rounds = []
    for _ in range(4):
        rounds.append(c2._transitions.drain_once())
        clock.advance(P.ha.TransitionManager.BACKOFF_MAX)
    # the ex-leader's queue writes are fenced now
    try:
        c1._transitions.enqueue("t", "t_0", "s0", "add")
        fenced = None
    except P.metadata.FencedWriteError as e:
        fenced = [e.fence, e.current_epoch]
    return {
        "queued": queued, "leaders": [c1.is_leader, c2.is_leader], "epoch": c2.lease_fence(),
        "rounds": rounds, "left": _queue(store), "fenced": fenced,
        "rows": P.Broker(c2).execute("SELECT COUNT(*) FROM t").rows,
    }


def test_chaos_lead_death_mid_ingestion(both, tmp_path, monkeypatch):
    ref, port = _run(both, tmp_path, _lead_death_script, monkeypatch=monkeypatch)
    assert port == ref
    assert len(port["queued"]) == 3 and port["leaders"] == [False, True] and port["epoch"] == 2
    assert sum(port["rounds"]) == 3 and port["left"] == [] and port["fenced"] == [1, 2]
    assert port["rows"] == [[1500]]


# -- fencing ------------------------------------------------------------------


def _fence_script(P, root, monkeypatch, freeze):
    clock = _clocked(P, monkeypatch)
    P.faults.FAULTS.reset()
    store = P.cluster.PropertyStore(root / "store")
    c1 = _ha_controller(P, store, root / "deep", "c1", ttl=0.5)
    stale = c1.lease_fence()
    fenced_before = P.metrics.controller_metrics().meter("controller.ha.fencedWrites").count
    try:
        if freeze:
            # the lead's renewal freezes (the lease.renew fault point)
            P.faults.FAULTS.configure({"lease.renew": {"mode": "error", "prob": 1.0}})
            clock.advance(0.7)
            c1._election._tick()
            still = c1.is_leader
        else:
            still = None
        store.update(
            P.metadata.LEASE_PATH,
            lambda d: {"owner": "c2", "expires": clock.now + 30, "epoch": d["epoch"] + 1},
        )
        try:
            store.set("/tables/t/idealstate", {"t_0": {"s0": "ONLINE"}}, fence=stale)
            err = None
        except P.metadata.FencedWriteError as e:
            err = [type(e).__name__, e.fence, e.current_epoch]
        P.faults.FAULTS.reset()
        c1._election._tick()  # thawed: it sees the foreign lease and demotes
        return {
            "stale": stale, "frozenStillLeads": still, "err": err,
            "landed": store.get("/tables/t/idealstate"),
            "fencedDelta": P.metrics.controller_metrics().meter("controller.ha.fencedWrites").count - fenced_before,
            "after": [c1.is_leader, c1.ha_status()["fencedWrites"] >= 1],
        }
    finally:
        P.faults.FAULTS.reset()


@pytest.mark.parametrize("freeze", [False, True], ids=["takeover", "frozen_renewal"])
def test_fenced_write_rejected_after_takeover(both, tmp_path, monkeypatch, freeze):
    ref, port = _run(both, tmp_path, _fence_script, monkeypatch=monkeypatch, freeze=freeze)
    assert port == ref
    assert port["err"] == ["FencedWriteError", 1, 2] and port["landed"] is None
    assert port["fencedDelta"] == 1 and port["after"] == [False, True]
    assert port["frozenStillLeads"] == (True if freeze else None)


# -- the standby gate over HTTP -----------------------------------------------


def _standby_script(P, root, monkeypatch):
    _clocked(P, monkeypatch)
    store = P.cluster.PropertyStore(root / "store")
    c1 = P.cluster.Controller(store, root / "deep", controller_id="c1")
    c2 = P.cluster.Controller(store, root / "deep", controller_id="c2")
    svc1, svc2 = P.http.ControllerHTTPService(c1), P.http.ControllerHTTPService(c2)
    try:
        c1.register_controller_endpoint("127.0.0.1", svc1.port)
        c2.register_controller_endpoint("127.0.0.1", svc2.port)
        for c in (c1, c2):
            c._election = P.ha.LeaderElection(store, c.controller_id, ttl=3600.0)
            c._election._tick()
        req = urllib.request.Request(
            f"http://127.0.0.1:{svc2.port}/schemas", data=_schema(P).to_json().encode(),
            headers={"Content-Type": "application/json"}, method="POST",
        )
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        body = json.loads(ei.value.read())
        lead = f"http://127.0.0.1:{svc1.port}"
        unmutated = store.get("/schemas/t") is None
        client = P.http.RemoteControllerClient(f"http://127.0.0.1:{svc2.port}")
        client.add_schema(_schema(P))  # follows the leaderUrl hint
        leader = client.leader()
        return {
            "status": ei.value.code, "bodyKeys": sorted(body), "hintIsLead": body.get("leaderUrl") == lead,
            "unmutated": unmutated, "landed": store.get("/schemas/t") is not None,
            "leaderIsLead": leader["leaderUrl"] == lead, "leaderKeys": sorted(leader),
            "roles": [c1.is_leader, c2.is_leader],
        }
    finally:
        svc1.stop()
        svc2.stop()


def test_standby_503_and_leader_url_redirect(both, tmp_path, monkeypatch):
    ref, port = _run(both, tmp_path, _standby_script, monkeypatch=monkeypatch)
    assert port == ref
    assert port["status"] == 503 and port["hintIsLead"] and port["unmutated"] and port["landed"]
    assert port["leaderIsLead"] and port["roles"] == [True, False]


# -- lead-only planes ---------------------------------------------------------


def _wait(pred, timeout=5.0):
    deadline = time.time() + timeout
    while time.time() < deadline and not pred():
        time.sleep(0.02)
    return pred()


def test_lead_only_planes_follow_lease_flap(both, tmp_path):
    """A plane bound to a controller runs only while it holds the lease."""
    outs = []
    for P in both:
        store = P.cluster.PropertyStore(tmp_path / P.name / "store")
        c1 = P.cluster.Controller(store, tmp_path / P.name / "deep", controller_id="c1")
        c1._election = P.ha.LeaderElection(store, "c1", ttl=3600.0)
        c1._election._tick()

        class CountingTask:
            name = "counting"
            interval_sec = 0.05
            runs = 0

            def run_once(self):
                self.runs += 1
                return {}

        task = CountingTask()
        sched = P.periodic.PeriodicTaskScheduler(controller=c1)
        sched.register(task)
        sched.start()
        try:
            ran = _wait(lambda: task.runs > 0)
            store.update(P.metadata.LEASE_PATH, lambda d: {"owner": "c2", "expires": time.time() + 3600, "epoch": d["epoch"] + 1})
            c1._election._tick()
            demoted = not c1.is_leader
            time.sleep(0.3)  # a run already past the gate may finish
            mark = task.runs
            time.sleep(0.5)
            idle = task.runs == mark
            store.update(P.metadata.LEASE_PATH, lambda d: {"owner": "", "expires": 0.0, "epoch": d["epoch"]})
            c1._election._tick()
            resumed = _wait(lambda: task.runs > mark)
            outs.append((ran, demoted, idle, c1.is_leader, c1.lease_fence(), resumed, c1.readiness()[1]["periodicScheduler"]))
        finally:
            sched.stop()
    assert outs[1] == outs[0]
    assert outs[1][:6] == (True, True, True, True, 3, True)


# -- cold restart and a store carried across ----------------------------------

_GROUPED = "SELECT k, SUM(v) FROM t GROUP BY k ORDER BY k"


def _cold_restart(P, store_dir, deep, sdata, monkeypatch, t0):
    clock = _clocked(P, monkeypatch, t0=t0)
    store = P.cluster.PropertyStore(store_dir)
    c = P.cluster.Controller(store, deep, controller_id="c1")
    s = P.Server("s0", data_dir=sdata)  # an empty disk: re-downloads
    c.register_server("s0", s)
    cleared = c.reset_external_views()
    c._election = P.ha.LeaderElection(store, "c1", ttl=2.0)
    c._transitions = P.ha.TransitionManager(c, c._election)
    c._election._tick()
    clock.advance(P.ha.TransitionManager.RECONCILE_GRACE_S + 1.0)
    enqueued = c._transitions.reconcile()
    delivered = c._transitions.drain_once()
    return {
        "cleared": cleared, "epoch": c.lease_fence(), "enqueued": enqueued, "delivered": delivered,
        "rows": P.Broker(c).execute(_GROUPED).rows, "ev": store.get("/tables/t/externalview"),
    }


def _first_generation(P, root, monkeypatch):
    _clocked(P, monkeypatch, t0=time.time())
    store = P.cluster.PropertyStore(root / "store")
    c1 = _ha_controller(P, store, root / "deep", "c1", ttl=2.0)
    c1.register_server("s0", P.Server("s0", data_dir=root / "sdata"))
    c1.add_schema(_schema(P))
    c1.add_table(P.common.TableConfig("t", replication=1))
    for i in range(3):
        c1.upload_segment("t", _segment(P, i))
    want = P.Broker(c1).execute(_GROUPED).rows
    c1._election.stop(release=True)  # a clean shutdown releases the lease
    return {"want": want, "epoch": c1.lease_fence(), "ev": store.get("/tables/t/externalview")}


def _cold_script(P, root, monkeypatch):
    first = _first_generation(P, root, monkeypatch)
    second = _cold_restart(P, root / "store", root / "deep", root / "sdata2", monkeypatch, time.time())
    return {"first": first, "second": second}


def test_cold_restart_recovers_from_store_and_deep_store(both, tmp_path, monkeypatch):
    ref, port = _run(both, tmp_path, _cold_script, monkeypatch=monkeypatch)
    assert port == ref
    assert port["first"]["epoch"] == 1 and len(port["first"]["ev"]) == 3
    assert port["second"]["cleared"] == 1 and port["second"]["epoch"] == 2
    assert port["second"]["enqueued"] == port["second"]["delivered"] == 3
    assert port["second"]["rows"] == port["first"]["want"] and port["second"]["ev"] == port["first"]["ev"]


def test_port_cold_starts_a_store_the_reference_wrote(both, tmp_path, monkeypatch):
    """State carried across: a store dir and a deep store written by the
    reference's HA controller, cold-started by the port's controller. The
    port's epoch goes past the reference's, and the rows are the same."""
    ref, port = both
    root = tmp_path / "carried"
    root.mkdir()
    first = _first_generation(ref, root, monkeypatch)
    second = _cold_restart(port, root / "store", root / "deep", root / "sdata_port", monkeypatch, time.time())
    assert second["epoch"] > first["epoch"]
    assert second["cleared"] == 1 and second["enqueued"] == second["delivered"] == 3
    assert second["rows"] == first["want"] and second["ev"] == first["ev"]
