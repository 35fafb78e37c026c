"""The port's storage integrity against the JAX package's: crash-consistent
writes, a corrupt local copy quarantined and downloaded again, the peer
fallback, the typed SEGMENT_CORRUPTED error, the server's scrub with its IO
budget, and the controller's IntegrityScrubber, which repairs a corrupt
deep-store copy from a healthy replica and feeds unrepairable corruption to
the SLO evaluator.

The cases are `tests/test_integrity.py`'s. Each script runs on both
packages (the port's servers on the CPU) over the same seeded segments and
the same bit flips; the scrub reports, storage meters, files left on disk,
error codes and rows must be equal.
"""

import errno
import importlib
import json
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest

PKGS = ("pinot_tpu", "pinot_tpu_torch")


def _pkg(name):
    m = importlib.import_module
    P = types.SimpleNamespace(
        name=name,
        cluster=m(f"{name}.cluster"),
        http=m(f"{name}.cluster.http"),
        periodic=m(f"{name}.cluster.periodic"),
        common=m(f"{name}.common"),
        durability=m(f"{name}.common.durability"),
        errors=m(f"{name}.common.errors"),
        faults=m(f"{name}.common.faults"),
        metrics=m(f"{name}.common.metrics"),
        slo=m(f"{name}.common.slo"),
        segment=m(f"{name}.segment"),
        loader=m(f"{name}.segment.loader"),
        store=m(f"{name}.segment.store"),
    )
    port = name.endswith("_torch")
    P.Server = (lambda sid, **kw: P.cluster.Server(sid, device="cpu", **kw)) if port else P.cluster.Server
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


def _schema(P, name="orders"):
    dt = P.common.DataType
    return P.common.Schema.build(name, dimensions=[("region", dt.STRING)], metrics=[("amount", dt.LONG)])


def _segment(P, name="orders_0", seed=7, n=40):
    rng = np.random.default_rng(seed)
    data = {
        "region": np.array(["EU", "US", "APAC"], dtype=object)[rng.integers(0, 3, n)],
        "amount": rng.integers(1, 1000, n).astype(np.int64),
    }
    return P.segment.SegmentBuilder(_schema(P)).build(data, name)


def _flip_bit(path: Path, offset: int = None) -> None:
    raw = bytearray(path.read_bytes())
    raw[(len(raw) // 2) if offset is None else offset] ^= 0x10
    path.write_bytes(bytes(raw))


def _cluster(P, root, n_servers=2, replication=2, data_dirs=True):
    controller = P.cluster.Controller(P.cluster.PropertyStore(root / "zk"), root / "deepstore")
    servers = {}
    for i in range(n_servers):
        sid = f"server_{i}"
        servers[sid] = P.Server(sid, data_dir=(root / f"data_{i}") if data_dirs else None)
        controller.register_server(sid, servers[sid])
    controller.add_schema(_schema(P))
    controller.add_table(P.common.TableConfig("orders", replication=replication))
    seg = _segment(P)
    controller.upload_segment("orders", seg)
    return controller, servers, seg


def _meters(P, role, *names):
    reg = getattr(P.metrics, f"{role}_metrics")()
    return {n: int(reg.meter(n).count) for n in names}


def _run(both, tmp_path, script):
    out = []
    for P in both:
        root = tmp_path / P.name
        root.mkdir()
        out.append(json.loads(json.dumps(script(P, root), sort_keys=True, default=str).replace(str(root), "<root>")))
    return out


def _rows(P, controller):
    b = P.cluster.Broker(controller, device="cpu") if P.name.endswith("_torch") else P.cluster.Broker(controller)
    return b.execute("SELECT region, SUM(amount), COUNT(*) FROM orders GROUP BY region ORDER BY region").rows


# -- crash consistency ---------------------------------------------------------


def test_property_store_torn_write_every_offset(both, tmp_path):
    def script(P, root):
        store = P.cluster.PropertyStore(root / "zk")
        old, new = {"v": 0, "who": "before"}, {"v": 1, "who": "after", "pad": "x" * 32}
        store.set("/tables/t/segments/s", old)
        seen = []
        for off in range(len(json.dumps(new).encode()) + 1):
            P.faults.FAULTS.configure({"storage.write": {"mode": "torn", "offset": off}})
            with pytest.raises(P.faults.TornWriteFault):
                store.set("/tables/t/segments/s", new)
            P.faults.FAULTS.reset()
            recovered = P.cluster.PropertyStore(root / "zk")
            seen.append([recovered.get("/tables/t/segments/s") == old, recovered.list("/tables/t/segments")])
        store.set("/tables/t/segments/s", new)
        return {"seen": seen, "final": P.cluster.PropertyStore(root / "zk").get("/tables/t/segments/s")}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert all(s == [True, ["/tables/t/segments/s"]] for s in port["seen"]) and port["final"]["v"] == 1


def test_segment_file_torn_write_every_offset(both, tmp_path):
    def script(P, root):
        seg_dir = P.store.write_segment_file(_segment(P, seed=1, n=8), root / "seg")
        f = seg_dir / P.store.SEGMENT_FILE
        old_crc = P.store.verify_segment_file(f)
        new_image = (P.store.write_segment_file(_segment(P, seed=2, n=8), root / "v2") / P.store.SEGMENT_FILE).read_bytes()
        held = []
        for off in range(0, len(new_image) + 1, 7):
            P.faults.FAULTS.configure({"storage.write": {"mode": "torn", "offset": off}})
            with pytest.raises(P.faults.TornWriteFault):
                P.durability.atomic_write_bytes(f, new_image)
            P.faults.FAULTS.reset()
            held.append(P.store.verify_segment_file(f) == old_crc and P.loader.load_segment(seg_dir).n_docs == 8)
        P.durability.atomic_write_bytes(f, new_image)
        return {"held": held, "old": old_crc, "new": P.store.verify_segment_file(f), "bytes": len(new_image)}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert all(port["held"]) and port["new"] != port["old"]


def test_torn_write_via_segment_builder_commit(both, tmp_path):
    def script(P, root):
        P.faults.FAULTS.configure({"storage.write": {"mode": "torn", "offset": 100}})
        with pytest.raises(P.faults.TornWriteFault):
            P.store.write_segment_file(_segment(P, seed=3, n=8), root / "seg")
        P.faults.FAULTS.reset()
        return (root / "seg" / P.store.SEGMENT_FILE).exists()

    assert _run(both, tmp_path, script) == [False, False]


# -- corruption detection and the healing chain -------------------------------------


def test_upload_records_file_crc_in_metadata(both, tmp_path):
    def script(P, root):
        controller, _, seg = _cluster(P, root)
        meta = controller.segment_metadata("orders", seg.name)
        P.store.verify_segment_file(Path(meta["location"]) / P.store.SEGMENT_FILE, expected_crc=meta["fileCrc"])
        return [meta["fileCrc"], P.store.segment_file_crc(Path(meta["location"])), meta["servers"]]

    ref, port = _run(both, tmp_path, script)
    assert port == ref and port[0] == port[1]


def test_corrupt_local_copy_quarantined_and_redownloaded(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root)
        server = servers["server_0"]
        local = server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE
        _flip_bit(local)
        with pytest.raises(P.errors.SegmentCorruptedError):
            P.store.verify_segment_file(local)
        server.add_segment("orders", seg.name, controller.segment_metadata("orders", seg.name)["location"])
        P.store.verify_segment_file(local)
        return {"meters": _meters(P, "server", "storage.corruption.detected", "storage.repaired"),
                "quarantined": local.with_name(local.name + ".quarantined").exists(),
                "hosted": server.segments_of("orders"), "rows": _rows(P, controller)}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["meters"]["storage.corruption.detected"] == 1 and port["quarantined"] and port["hosted"] == ["orders_0"]


def test_peer_fallback_when_deep_store_also_bad(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root)
        server = servers["server_0"]
        good = (servers["server_1"].data_dir / "orders" / seg.name / P.store.SEGMENT_FILE).read_bytes()
        meta = controller.segment_metadata("orders", seg.name)
        _flip_bit(server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE)
        _flip_bit(Path(meta["location"]) / P.store.SEGMENT_FILE)
        calls = []
        server.peer_fetch = lambda table, name: calls.append([table, name]) or good
        server.add_segment("orders", seg.name, meta["location"])
        P.store.verify_segment_file(server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE)
        return {"calls": calls, "meters": _meters(P, "server", "storage.corruption.detected", "storage.repaired")}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["calls"] == [["orders", "orders_0"]] and port["meters"]["storage.repaired"] == 1


def _both_sources_bad(P, root):
    controller, servers, seg = _cluster(P, root)
    server = servers["server_0"]
    meta = controller.segment_metadata("orders", seg.name)
    _flip_bit(server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE)
    _flip_bit(Path(meta["location"]) / P.store.SEGMENT_FILE)
    server.peer_fetch = lambda table, name: None
    return server, seg, meta


def test_every_source_bad_surfaces_typed_error(both, tmp_path):
    def script(P, root):
        server, seg, meta = _both_sources_bad(P, root)
        with pytest.raises(P.errors.SegmentCorruptedError) as ei:
            server.add_segment("orders", seg.name, meta["location"])
        return [int(P.errors.code_of(ei.value)), bool(ei.value.path)]

    assert _run(both, tmp_path, script) == [[260, True], [260, True]]


def test_segment_corrupted_code_crosses_http_hop(both, tmp_path):
    def script(P, root):
        server, seg, meta = _both_sources_bad(P, root)
        svc = P.http.ServerHTTPService(server, port=0)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/segments/add",
                data=json.dumps({"table": "orders", "segment": seg.name, "dir": meta["location"]}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(req, timeout=30)
            return [ei.value.code, json.loads(ei.value.read())["errorCode"]]
        finally:
            svc.stop()

    ref, port = _run(both, tmp_path, script)
    assert port == ref and port[1] == 260


# -- the scrubber -------------------------------------------------------------------


def test_server_scrub_detects_and_repairs(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root)
        server = servers["server_0"]
        clean = server.scrub()
        local = server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE
        _flip_bit(local)
        dirty = server.scrub()
        P.store.verify_segment_file(local)
        return {"clean": clean, "dirty": dirty, "quarantined": local.with_name(local.name + ".quarantined").exists(),
                "meters": _meters(P, "server", "storage.scrub.corrupted", "storage.scrub.repaired"),
                "hosted": server.segments_of("orders"), "rows": _rows(P, controller)}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["clean"]["verified"] == 1 and port["clean"]["corrupted"] == 0
    assert (port["dirty"]["corrupted"], port["dirty"]["repaired"], port["dirty"]["unrepairable"]) == (1, 1, 0)
    assert port["quarantined"] and port["meters"]["storage.scrub.repaired"] == 1


def test_server_scrub_io_budget_and_cursor(both, tmp_path):
    def script(P, root):
        controller = P.cluster.Controller(P.cluster.PropertyStore(root / "zk"), root / "deepstore")
        server = P.Server("server_0", data_dir=root / "data")
        controller.register_server("server_0", server)
        controller.add_schema(_schema(P))
        controller.add_table(P.common.TableConfig("orders", replication=1))
        for i in range(4):
            controller.upload_segment("orders", _segment(P, f"orders_{i}", seed=i))
        budgeted = [server.scrub(io_budget_bytes=1) for _ in range(4)]
        return {"budgeted": budgeted, "whole": server.scrub()}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert [b["verified"] for b in port["budgeted"]] == [1, 1, 1, 1] and port["whole"]["verified"] == 4


def test_controller_scrubber_repairs_deep_store_from_replica(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root)
        meta = controller.segment_metadata("orders", seg.name)
        deep = Path(meta["location"]) / P.store.SEGMENT_FILE
        _flip_bit(deep)
        scrubber = P.periodic.IntegrityScrubber(controller)
        first = scrubber.run_once()
        meta2 = controller.segment_metadata("orders", seg.name)
        P.store.verify_segment_file(deep, expected_crc=meta2["fileCrc"])
        second = scrubber.run_once()
        return {"first": first, "second": second, "quarantined": deep.with_name(deep.name + ".quarantined").exists(),
                "crc": [meta["fileCrc"], meta2["fileCrc"]], "lastRun": scrubber.last_run == second,
                "meters": _meters(P, "controller", "storage.scrub.verified", "storage.scrub.corrupted",
                                  "storage.scrub.repaired", "storage.scrub.unrepairable"),
                "rows": _rows(P, controller)}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert (port["first"]["corrupted"], port["first"]["repaired"], port["first"]["unrepairable"]) == (1, 1, 0)
    assert port["second"]["corrupted"] == 0 and port["second"]["verified"] >= 1 and port["quarantined"]
    assert port["meters"]["storage.scrub.repaired"] == 1 and port["lastRun"]


def test_scrubber_unrepairable_feeds_slo_plane(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root, n_servers=1, replication=1)
        _flip_bit(Path(controller.segment_metadata("orders", seg.name)["location"]) / P.store.SEGMENT_FILE)
        servers["server_0"].remove_segment("orders", seg.name)  # no repair source remains
        out = P.periodic.IntegrityScrubber(controller).run_once()
        clock = [1000.0]
        ev = P.slo.SloEvaluator(now_fn=lambda: clock[0])
        base = {"queries": 100, "errors": 0, "latencyBuckets": [], "freshnessBuckets": [], "tables": {}, "exemplars": []}
        ev.observe({**base, "scrubUnrepairable": 0})
        clock[0] += 10
        fired = [t for t in ev.observe({**base, "scrubUnrepairable": 1}) if t["slo"] == "scrubUnrepairable"]
        return {"out": out, "fired": fired}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["out"]["corrupted"] == 1 and port["out"]["unrepairable"] == 1 and port["fired"][0]["state"] == "firing"


# -- upload ordering and disk faults --------------------------------------------


def _single(P, root):
    controller = P.cluster.Controller(P.cluster.PropertyStore(root / "zk"), root / "deepstore")
    controller.register_server("server_0", P.Server("server_0"))
    controller.add_schema(_schema(P))
    controller.add_table(P.common.TableConfig("orders", replication=1))
    return controller


def test_upload_enospc_is_typed_and_leaves_no_partial_dir(both, tmp_path):
    def script(P, root):
        controller = _single(P, root)
        P.faults.FAULTS.configure({"storage.write": {"mode": "enospc"}})
        with pytest.raises(P.errors.SegmentUploadError) as ei:
            controller.upload_segment("orders", _segment(P))
        P.faults.FAULTS.reset()
        left = [(root / "deepstore" / "orders").exists(), controller.segment_metadata("orders", "orders_0"),
                controller.ideal_state("orders")]
        controller.upload_segment("orders", _segment(P))
        return {"errno": ei.value.errno, "left": left, "after": sorted(controller.ideal_state("orders"))}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port == {"errno": errno.ENOSPC, "left": [False, None, {}], "after": ["orders_0"]}


def test_crash_between_write_and_assign_leaves_no_partial_dir(both, tmp_path):
    def script(P, root):
        controller = _single(P, root)
        P.faults.FAULTS.configure({"storage.write": {"mode": "torn", "offset": 64}})
        with pytest.raises(P.errors.SegmentUploadError):
            controller.upload_segment("orders", _segment(P))
        P.faults.FAULTS.reset()
        return (root / "deepstore" / "orders").exists()

    assert _run(both, tmp_path, script) == [False, False]


def test_storage_read_bitflip_surfaces_typed_error(both, tmp_path):
    def script(P, root):
        seg_dir = root / "seg"
        P.store.write_segment_file(_segment(P, seed=5, n=8), seg_dir)
        P.faults.FAULTS.configure({"storage.read": {"mode": "bitflip", "offset": 40}})
        with pytest.raises(P.errors.SegmentCorruptedError) as ei:
            P.loader.load_segment(seg_dir)
        P.faults.FAULTS.reset()
        return [int(P.errors.code_of(ei.value)), P.loader.load_segment(seg_dir).n_docs]

    assert _run(both, tmp_path, script) == [[260, 8], [260, 8]]


def test_debug_faults_endpoint_arms_storage_points(both, tmp_path):
    def script(P, root):
        svc = P.http.ServerHTTPService(P.Server("server_0"), port=0)
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{svc.port}/debug/faults",
                data=json.dumps({"points": {"storage.read": {"mode": "bitflip", "offset": 3},
                                            "storage.write": {"mode": "enospc"}}}).encode(),
                headers={"Content-Type": "application/json"},
            )
            with urllib.request.urlopen(req, timeout=30) as resp:
                armed = json.loads(resp.read())["armed"]
            with urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/debug/faults", timeout=30) as resp:
                enabled = json.loads(resp.read())["enabled"]
            return [armed, enabled, P.faults.FAULTS.enabled]
        finally:
            svc.stop()
            P.faults.FAULTS.reset()

    ref, port = _run(both, tmp_path, script)
    assert port == ref == [["storage.read", "storage.write"], True, True]


# -- remote scrub and the peer fetch over HTTP ---------------------------------------


def test_remote_scrub_and_fetch_segment_file(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root, n_servers=1, replication=1)
        server = servers["server_0"]
        svc = P.http.ServerHTTPService(server, port=0)
        try:
            remote = P.http.RemoteServerClient(f"http://127.0.0.1:{svc.port}")
            out = remote.scrub(io_budget_bytes=10**9)
            data = remote.fetch_segment_file("orders", seg.name)
            local = (server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE).read_bytes()
            return {"out": out, "same": data == local, "missing": remote.fetch_segment_file("orders", "no_such_segment")}
        finally:
            svc.stop()

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert port["out"]["verified"] == 1 and port["same"] and port["missing"] is None


def test_local_segment_report_lists_quarantined(both, tmp_path):
    def script(P, root):
        controller, servers, seg = _cluster(P, root, n_servers=1, replication=1)
        server = servers["server_0"]
        _flip_bit(server.data_dir / "orders" / seg.name / P.store.SEGMENT_FILE)
        server.scrub()
        report = server.local_segment_report()
        return {k: sorted(v) if isinstance(v, list) else v for k, v in report.items()}

    ref, port = _run(both, tmp_path, script)
    assert port == ref
    assert "orders/orders_0" in port["localSegments"] and any(p.endswith(".quarantined") for p in port["quarantined"])
