"""The port's cluster against the JAX package's: controller, servers and broker
in process and over HTTP, on the same seeded data.

The fixture and cases are `tests/test_cluster.py`'s (3 servers, 6 segments of
3,000 rows, replication 2), plus replica failover, the remote error surface,
a streamed selection that stops early, the multistage route and its
self-join, and a hybrid table's time boundary (`tests/test_routing2.py`).
Each query's rows, `total_docs` and pruning counts, and the ideal state,
must equal the reference's.
"""

import importlib

import numpy as np
import pytest

from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
from pinot_tpu_torch.cluster.http import BrokerHTTPService, RemoteServerClient, ServerHTTPService, query_broker_http
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder

import pinot_tpu.cluster as rc
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "region": np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE"], dtype=object)[rng.integers(0, 4, n)],
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "revenue": rng.integers(100, 600_000, n).astype(np.int64),
    }


def _build(pkg_cluster, schema_mod, cfg_cls, builder_cls, root, make_server):
    dt, schema_cls = schema_mod
    controller = pkg_cluster.Controller(pkg_cluster.PropertyStore(), root / "deepstore")
    servers = {f"server_{i}": make_server(f"server_{i}") for i in range(3)}
    for sid, s in servers.items():
        controller.register_server(sid, s)
    schema = schema_cls.build(
        "lineorder",
        dimensions=[("region", dt.STRING), ("year", dt.INT)],
        metrics=[("revenue", dt.LONG)],
    )
    controller.add_schema(schema)
    controller.add_table(cfg_cls("lineorder", replication=2))
    b = builder_cls(schema)
    for i in range(6):
        controller.upload_segment("lineorder", b.build(_data(200 + i, 3000), f"lineorder_{i}"))
    return controller, servers


class _Pkg:
    Controller, PropertyStore = Controller, PropertyStore


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """(reference, port, port over HTTP): each a (controller, broker,
    servers); the HTTP leg is a second port controller on the same store
    whose servers are the port's servers behind ServerHTTPService, queried
    through a BrokerHTTPService."""
    root = tmp_path_factory.mktemp("torch_cluster")
    r_ctrl, r_servers = _build(rc, (RDataType, RSchema), RTableConfig, RSegmentBuilder, root / "ref", rc.Server)
    p_ctrl, p_servers = _build(
        _Pkg, (DataType, Schema), TableConfig, SegmentBuilder, root / "port", lambda sid: Server(sid, device="cpu")
    )
    r_broker, p_broker = rc.Broker(r_ctrl), Broker(p_ctrl)
    svcs = {sid: ServerHTTPService(s) for sid, s in p_servers.items()}
    h_ctrl = Controller(p_ctrl.store, root / "port" / "deepstore")
    for sid, svc in svcs.items():
        h_ctrl.register_server(sid, RemoteServerClient(f"http://127.0.0.1:{svc.port}"))
    h_broker = Broker(h_ctrl, device="cpu")
    bsvc = BrokerHTTPService(h_broker)
    try:
        yield {
            "ref": (r_ctrl, r_broker, r_servers),
            "port": (p_ctrl, p_broker, p_servers),
            "http": (h_ctrl, h_broker, svcs, f"http://127.0.0.1:{bsvc.port}"),
        }
    finally:
        bsvc.stop()
        for svc in svcs.values():
            svc.stop()
        for b in (r_broker, p_broker, h_broker):
            b.shutdown()


QUERIES = [
    "SELECT COUNT(*) FROM lineorder",
    "SELECT region, SUM(revenue) FROM lineorder GROUP BY region ORDER BY region LIMIT 10",
    "SELECT year, COUNT(*), AVG(revenue), MIN(revenue), MAX(revenue) FROM lineorder GROUP BY year ORDER BY year",
    "SELECT region, year, SUM(revenue) FROM lineorder WHERE year BETWEEN 1993 AND 1995 GROUP BY region, year "
    "ORDER BY SUM(revenue) DESC LIMIT 7",
    "SELECT region, COUNT(*) FROM lineorder GROUP BY region HAVING COUNT(*) > 4000 ORDER BY region",
    "SELECT DISTINCTCOUNT(year), SUM(revenue) FROM lineorder WHERE region IN ('ASIA', 'EUROPE')",
    "SELECT revenue FROM lineorder ORDER BY revenue DESC LIMIT 5",
    "SELECT region, year, revenue FROM lineorder WHERE revenue < 2000 ORDER BY revenue, region LIMIT 9",
    "SELECT DISTINCT region FROM lineorder ORDER BY region",
    "SELECT COUNT(*) FROM lineorder WHERE year > 3000",
    "SELECT PERCENTILEEST(revenue, 90) FROM lineorder",
]

#: through the broker's in-process multistage route
MULTISTAGE = [
    "SELECT region, total FROM (SELECT region, SUM(revenue) AS total FROM lineorder GROUP BY region) s "
    "ORDER BY total DESC LIMIT 10",
    "SELECT COUNT(*) FROM (SELECT DISTINCT region FROM lineorder) a CROSS JOIN (SELECT DISTINCT year FROM lineorder) b",
]


def _same(got, want):
    assert got.columns == want.columns
    assert got.rows == want.rows
    assert got.total_docs == want.total_docs
    assert got.num_segments_pruned == want.num_segments_pruned


def test_assignment_and_ideal_state_equal(clusters):
    r_ctrl, _, r_servers = clusters["ref"]
    p_ctrl, _, p_servers = clusters["port"]
    ideal = p_ctrl.ideal_state("lineorder")
    assert ideal == r_ctrl.ideal_state("lineorder")
    assert all(len(reps) == 2 for reps in ideal.values())
    for sid in p_servers:
        assert p_servers[sid].segments_of("lineorder") == r_servers[sid].segments_of("lineorder")
        assert len(p_servers[sid].segments_of("lineorder")) == 4
    assert p_ctrl.routing_version("lineorder") == r_ctrl.routing_version("lineorder")
    r_meta = r_ctrl.all_segment_metadata("lineorder")
    p_meta = p_ctrl.all_segment_metadata("lineorder")
    for name in r_meta:
        for key in ("numDocs", "stats", "servers", "fileCrc"):
            assert p_meta[name][key] == r_meta[name][key], (name, key)


@pytest.mark.parametrize("sql", QUERIES + MULTISTAGE)
def test_in_process_rows_equal(clusters, sql):
    _same(clusters["port"][1].execute(sql), clusters["ref"][1].execute(sql))


@pytest.mark.parametrize("sql", QUERIES)
def test_http_rows_equal(clusters, sql):
    """The HTTP leg: broker behind BrokerHTTPService, servers behind
    ServerHTTPService, partials in DataTable bytes."""
    want = clusters["ref"][1].execute(sql)
    resp = query_broker_http(clusters["http"][3], sql)
    assert resp["resultTable"]["rows"] == want.rows
    assert resp["totalDocs"] == want.total_docs


@pytest.mark.parametrize("sql", MULTISTAGE)
def test_http_multistage_names_its_item(clusters, sql):
    """Over remote servers the broker dispatches the stages to the servers
    (multistage/distributed.py), blocks crossing their sockets through
    /mailbox: the rows equal the reference's in-process cluster's."""
    want = clusters["ref"][1].execute(sql)
    resp = query_broker_http(clusters["http"][3], sql)
    assert not resp.get("exceptions"), resp
    assert resp["resultTable"]["rows"] == want.rows
    assert clusters["http"][1]._dispatcher is not None


def test_remote_partials_equal_local(clusters):
    _, _, servers = clusters["port"]
    svc = clusters["http"][2]["server_0"]
    remote = RemoteServerClient(f"http://127.0.0.1:{svc.port}")
    segs = servers["server_0"].segments_of("lineorder")
    for sql in ("SELECT COUNT(*) FROM lineorder", "SELECT region, SUM(revenue) FROM lineorder GROUP BY region"):
        p_remote = remote.execute_partials("lineorder", sql, segs)
        p_local = servers["server_0"].execute_partials("lineorder", sql, segs)
        assert p_remote[1:3] == p_local[1:3]
        for a, b in zip(p_remote[0], p_local[0]):
            if isinstance(b, dict):
                assert list(a) == list(b) and all(a[c].tolist() == b[c].tolist() for c in b)
            else:
                assert a == b


def test_remote_error_surfaces(clusters):
    svc = clusters["http"][2]["server_0"]
    remote = RemoteServerClient(f"http://127.0.0.1:{svc.port}")
    with pytest.raises(RuntimeError, match="SqlParseError"):
        remote.execute_partials("lineorder", "SELEC bogus", [])
    bad = query_broker_http(clusters["http"][3], "SELECT COUNT(*) FROM nosuchtable")
    assert "exceptions" in bad


def test_streamed_selection_stops_early(clusters):
    """A plain SELECT streams frames and stops once LIMIT rows arrived: 5
    rows out of 18,000 docs, through both the in-process and the HTTP leg."""
    sql = "SELECT region, year, revenue FROM lineorder LIMIT 5"
    want = clusters["ref"][1].execute(sql)
    for broker in (clusters["port"][1], clusters["http"][1]):
        got = broker.execute(sql + " ")  # a distinct text: no result-cache hit
        assert len(got.rows) == len(want.rows) == 5
        assert got.columns == want.columns
        assert 1 <= got.num_stream_frames <= 6
        assert got.num_docs_scanned < got.total_docs == want.total_docs


def test_star_expansion(clusters):
    got = clusters["port"][1].execute("SELECT * FROM lineorder LIMIT 3")
    want = clusters["ref"][1].execute("SELECT * FROM lineorder LIMIT 3")
    assert got.columns == want.columns == ["region", "year", "revenue"]
    assert len(got.rows) == 3


def test_result_cache_hits_and_invalidates(clusters):
    _, broker, _ = clusters["port"]
    sql = "SELECT year, SUM(revenue) FROM lineorder GROUP BY year ORDER BY year"
    first = broker.execute(sql)
    again = broker.execute(sql)
    assert again.cache_hit and again.rows == first.rows


# -- replica failover ------------------------------------------------------


class _Flaky:
    def __init__(self, inner, failures):
        self.inner = inner
        self.failures = failures

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def execute_partials(self, *a, **kw):
        if self.failures > 0:
            self.failures -= 1
            raise RuntimeError("server http://flaky unreachable: connection refused")
        return self.inner.execute_partials(*a, **kw)


def _failover(pkg, tmp_path, failures):
    cl = importlib.import_module(f"{pkg}.cluster")
    common = importlib.import_module(f"{pkg}.common")
    seg_mod = importlib.import_module(f"{pkg}.segment")
    from_failure = importlib.import_module(f"{pkg}.cluster.failure")
    kw = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    controller = cl.Controller(cl.PropertyStore(), tmp_path / pkg)
    controller.register_server("s_flaky", _Flaky(cl.Server("s_flaky", **kw), failures=failures))
    if failures < 99:
        controller.register_server("s_good", cl.Server("s_good", **kw))
    schema = common.Schema.build("t", dimensions=[("d", common.DataType.INT)], metrics=[("v", common.DataType.LONG)])
    controller.add_schema(schema)
    controller.add_table(common.TableConfig("t", replication=2))
    b = seg_mod.SegmentBuilder(schema)
    for i in range(2):
        controller.upload_segment(
            "t", b.build({"d": np.arange(10, dtype=np.int32), "v": np.full(10, i, dtype=np.int64)}, f"t_{i}")
        )
    fd = from_failure.FailureDetector(initial_delay_sec=30)
    broker = cl.Broker(controller, failure_detector=fd)
    try:
        if failures >= 99:
            with pytest.raises(RuntimeError, match="unreachable|no surviving"):
                broker.execute("SELECT COUNT(*) FROM t")
            return None
        first = broker.execute("SELECT COUNT(*), SUM(v) FROM t").rows
        return first, fd.unhealthy_servers(), broker.execute("SELECT COUNT(*) FROM t ").rows
    finally:
        broker.shutdown()


def test_replica_failover(tmp_path):
    got = _failover("pinot_tpu_torch", tmp_path, 1)
    assert got == _failover("pinot_tpu", tmp_path, 1)
    assert got == ([[20, 10.0]], ["s_flaky"], [[20]])


def test_failover_exhausted_raises(tmp_path):
    _failover("pinot_tpu", tmp_path, 99)
    _failover("pinot_tpu_torch", tmp_path, 99)


def test_selector_routes_around_a_down_server(clusters):
    from pinot_tpu_torch.cluster.routing import BalancedInstanceSelector

    ideal = clusters["port"][0].ideal_state("lineorder")
    downed = {seg: {s: st for s, st in reps.items() if s != "server_0"} for seg, reps in ideal.items()}
    plan, unroutable = BalancedInstanceSelector().select(downed, list(downed))
    assert unroutable == [] and "server_0" not in plan
    assert sorted(s for segs in plan.values() for s in segs) == sorted(ideal)


# -- hybrid table ----------------------------------------------------------


def _hybrid(pkg, tmp_path):
    cl = importlib.import_module(f"{pkg}.cluster")
    common = importlib.import_module(f"{pkg}.common")
    config = importlib.import_module(f"{pkg}.common.config")
    seg_mod = importlib.import_module(f"{pkg}.segment")
    kw = {"device": "cpu"} if pkg == "pinot_tpu_torch" else {}
    controller = cl.Controller(cl.PropertyStore(), tmp_path / pkg)
    controller.register_server("s0", cl.Server("s0", **kw))
    dt = common.DataType
    for name in ("web", "web_REALTIME"):
        controller.add_schema(
            common.Schema.build(
                name, dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)], date_times=[("ts", dt.LONG)]
            )
        )
    controller.add_table(config.TableConfig("web", time_column="ts"))
    controller.add_table(config.TableConfig("web_REALTIME", table_type=config.TableType.REALTIME, time_column="ts"))
    b = seg_mod.SegmentBuilder(controller.get_schema("web"))
    for table, name, lo in (("web", "off_0", 0), ("web_REALTIME", "rt_0", 5)):
        controller.upload_segment(
            table,
            b.build(
                {
                    "k": np.array(["a", "b"] * 5, dtype=object),
                    "v": np.arange(lo, lo + 10, dtype=np.int64),
                    "ts": np.arange(lo, lo + 10, dtype=np.int64),
                },
                name,
            ),
        )
    broker = cl.Broker(controller)
    try:
        return [
            broker.execute(sql).rows
            for sql in (
                "SELECT COUNT(*), SUM(v) FROM web",
                "SELECT k, COUNT(*), MAX(ts) FROM web GROUP BY k ORDER BY k",
                "SELECT COUNT(*) FROM web_REALTIME",
            )
        ]
    finally:
        broker.shutdown()


def test_hybrid_time_boundary(tmp_path):
    """Offline ts 0..9, realtime 5..14: the boundary (9) splits the query so
    the overlap is counted once."""
    got = _hybrid("pinot_tpu_torch", tmp_path)
    assert got == _hybrid("pinot_tpu", tmp_path)
    assert got[0] == [[15, 105.0]] and got[2] == [[10]]


def test_time_boundary_sql_rewrites():
    from pinot_tpu.cluster.routing import TimeBoundary as RTB
    from pinot_tpu_torch.cluster.routing import TimeBoundary

    for sql in (
        "SELECT COUNT(*) FROM t WHERE x = 1 LIMIT 5",
        "SELECT COUNT(*) FROM t GROUP BY k",
        "SELECT COUNT(*) FROM t WHERE a = 1 OR b = 2",
        "SELECT COUNT(*) FROM t WHERE s = 'where group by'",
    ):
        assert TimeBoundary("ts", 100).offline_sql(sql) == RTB("ts", 100).offline_sql(sql)
        assert TimeBoundary("ts", 100).realtime_sql(sql) == RTB("ts", 100).realtime_sql(sql)


# -- cuts ------------------------------------------------------------------


def test_cuts_name_their_roadmap_item(clusters, tmp_path):
    """The cuts left name their ROADMAP item (A10b); what A9b, A10a and
    A10c cut is ported: access control, the controller's REST service and
    client, the stage submit (whose body a bare dict fails to carry), a
    realtime table's manager attached to a server, and the lead-controller
    election (`enable_ha` elects this controller, which still answers)."""
    ctrl, _, servers = clusters["port"]
    standby = Controller(ctrl.store, tmp_path / "standby_deep", controller_id="standby")
    ctrl.enable_ha(lease_ttl=30.0, renew_every=0.2)
    try:
        standby.enable_ha(lease_ttl=30.0, renew_every=0.2)
        assert ctrl.is_leader and not standby.is_leader
        assert ctrl.ha_status()["leaseEpoch"] >= 1 and ctrl.ha_status()["enabled"]
        assert Broker(ctrl).execute("SELECT COUNT(*) FROM lineorder").rows == [[18000]]
    finally:
        standby.stop_ha()
        ctrl.stop_ha()

    class _Manager:
        consumers = []
        paused = False

        def pause(self):
            self.paused = True

        def consumption_status(self):
            return [{"paused": self.paused}]

    servers["server_0"].attach_realtime("rt_probe", _Manager())
    assert servers["server_0"].pause_consumption("rt_probe")
    assert servers["server_0"].consumption_status("rt_probe") == [{"paused": True}]
    assert not servers["server_0"].pause_consumption("lineorder")
    with pytest.raises(KeyError, match="placement"):
        servers["server_0"].multistage_submit({})
    from pinot_tpu_torch.cluster.access import AllowAllAccessControl
    from pinot_tpu_torch.cluster.http import ControllerHTTPService, RemoteControllerClient

    b = Broker(ctrl, access_control=AllowAllAccessControl())
    assert b.execute("SELECT COUNT(*) FROM lineorder").rows == clusters["ref"][1].execute("SELECT COUNT(*) FROM lineorder").rows
    b.shutdown()
    with pytest.raises(NotImplementedError, match="A10b"):
        ControllerHTTPService(ctrl, task_manager=object())
    svc = ControllerHTTPService(ctrl)
    try:
        assert RemoteControllerClient(f"http://127.0.0.1:{svc.port}").tables() == ctrl.tables()
    finally:
        svc.stop()


def test_server_without_a_card_raises_at_its_first_engine(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    s = Server("s_cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        s._engine("t")


# -- fast32 ------------------------------------------------------------------


def test_fast32_server_keeps_its_own_staged_copy(tmp_path):
    """Server(fast32=True) stages DOUBLE columns as float32; a lossless
    engine over the same segment object keeps its own float64 copy (the
    staging memo keys on fast32). The lossless SUM equals the reference's
    exactly, the fast32 one the reference's fast32 engine within float32's
    rounding (rel 1e-6)."""
    from pinot_tpu.query import QueryEngine as RQueryEngine
    from pinot_tpu_torch.query import QueryEngine

    rng = np.random.default_rng(5)
    data = {
        "g": np.array(["x", "y", "z"], dtype=object)[rng.integers(0, 3, 4000)],
        "m": rng.random(4000) * 1e3,
    }
    seg = SegmentBuilder(
        Schema.build("d", dimensions=[("g", DataType.STRING)], metrics=[("m", DataType.DOUBLE)])
    ).build(data, "d_0")
    rseg = RSegmentBuilder(
        RSchema.build("d", dimensions=[("g", RDataType.STRING)], metrics=[("m", RDataType.DOUBLE)])
    ).build(data, "d_0")
    sql = "SELECT g, SUM(m), MAX(m) FROM d GROUP BY g ORDER BY g"
    fast = Server("s_fast", device="cpu", fast32=True)
    fast.add_segment_object("d", seg)
    got_fast = fast.execute_partials("d", sql, ["d_0"])
    lossless = QueryEngine([seg], device="cpu").execute(sql).rows
    assert sorted(seg._device_cache) == ["cpu", "cpu/f32"]
    assert seg._device_cache["cpu/f32"].arrays["m"].dtype.is_floating_point
    assert str(seg._device_cache["cpu/f32"].arrays["m"].dtype) == "torch.float32"
    assert str(seg._device_cache["cpu"].arrays["m"].dtype) == "torch.float64"
    assert lossless == RQueryEngine([rseg]).execute(sql).rows
    ctrl = Controller(PropertyStore(), tmp_path)
    ctrl.register_server("s_fast", fast)
    ctrl.add_schema(Schema.build("d", dimensions=[("g", DataType.STRING)], metrics=[("m", DataType.DOUBLE)]))
    ctrl.add_table(TableConfig("d"))
    ctrl.set_segment_state("d", "d_0", "s_fast", "ONLINE")
    ctrl.store.set("/tables/d/segments/d_0", {"numDocs": 4000, "stats": {}})
    broker = Broker(ctrl)
    try:
        rows = broker.execute(sql).rows
    finally:
        broker.shutdown()
    want = RQueryEngine([rseg], fast32=True).execute(sql).rows
    assert [r[0] for r in rows] == [r[0] for r in want]
    for r, w in zip(rows, want):
        assert r[1:] == pytest.approx(w[1:], rel=1e-6)
    assert got_fast[2] == 4000


def test_concurrent_queries_stage_each_copy_once(tmp_path):
    """Many client threads (more than cores) through one uncached broker,
    with a short thread switch interval: every answer equals the
    reference's, and each server's segment object is staged once (the
    staging memo's lock), as the staging tracker counts."""
    import sys
    import threading

    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.common.leakcheck import staging_tracker

    ctrl, servers = _build(
        _Pkg, (DataType, Schema), TableConfig, SegmentBuilder, tmp_path, lambda sid: Server(sid, device="cpu")
    )
    for s in servers.values():  # fresh names: the tracker is process-wide
        for segs in s._tables.values():
            for seg in segs.values():
                seg.name = f"stress_{seg.name}"
    broker = Broker(ctrl, cache_config=CacheConfig(enabled=False))
    r_ctrl, _ = _build(rc, (RDataType, RSchema), RTableConfig, RSegmentBuilder, tmp_path / "ref", rc.Server)
    r_broker = rc.Broker(r_ctrl)
    sqls = QUERIES[:8]
    want = {sql: r_broker.execute(sql).rows for sql in sqls}
    r_broker.shutdown()
    got, errors = [], []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-4)
    try:
        def client(i):
            try:
                for j in range(3):
                    sql = sqls[(i + j) % len(sqls)]
                    got.append((sql, broker.execute(sql).rows))
            except Exception as e:  # noqa: BLE001 - asserted below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(i,)) for i in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
        broker.shutdown()
    assert not errors and len(got) == 72
    assert all(rows == want[sql] for sql, rows in got)
    live = {n: c for n, c in staging_tracker.live().items() if n.startswith("stress_")}
    staged = {}
    for s in servers.values():
        for seg in s._tables["lineorder"].values():
            staged[seg.name] = staged.get(seg.name, 0) + len(seg._device_cache)
    assert live == {n: c for n, c in staged.items() if c} and all(c <= 2 for c in staged.values())
