"""Wire and metadata interop between the port's cluster and the JAX package's.

- A port Server behind the port's ServerHTTPService answers a reference
  Broker through the reference's RemoteServerClient (DataTable bytes both
  ways, the streamed selection path included).
- A reference Server behind the reference's ServerHTTPService answers a port
  Broker through the port's RemoteServerClient.
- A port Controller opens a file-backed store root and deep store that a
  reference Controller wrote: schemas, table configs, ideal states, segment
  metadata, routing versions and `__v` read the same, and it assigns and
  serves the same segments.

In each case the rows must equal those of the reference's own in-process
cluster on the same data.
"""

import numpy as np
import pytest

import pinot_tpu.cluster as rc
import pinot_tpu.cluster.http as rhttp
import pinot_tpu_torch.cluster as pc
import pinot_tpu_torch.cluster.http as phttp
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder

N_SEGS = 4

QUERIES = [
    "SELECT COUNT(*) FROM lineorder",
    "SELECT region, SUM(revenue) FROM lineorder GROUP BY region ORDER BY region",
    "SELECT year, COUNT(*), AVG(revenue), MAX(revenue) FROM lineorder WHERE region <> 'ASIA' GROUP BY year ORDER BY year",
    "SELECT DISTINCTCOUNT(year) FROM lineorder",
    "SELECT revenue, region FROM lineorder ORDER BY revenue DESC LIMIT 6",
    "SELECT DISTINCT year FROM lineorder ORDER BY year",
    "SELECT COUNT(*) FROM lineorder WHERE year > 3000",
]


def _data(seed, n=2000):
    rng = np.random.default_rng(seed)
    return {
        "region": np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE"], dtype=object)[rng.integers(0, 4, n)],
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "revenue": rng.integers(100, 600_000, n).astype(np.int64),
    }


def _ref_schema():
    return RSchema.build(
        "lineorder", dimensions=[("region", RDataType.STRING), ("year", RDataType.INT)], metrics=[("revenue", RDataType.LONG)]
    )


def _port_schema():
    return Schema.build(
        "lineorder", dimensions=[("region", DataType.STRING), ("year", DataType.INT)], metrics=[("revenue", DataType.LONG)]
    )


def _ref_setup(controller, n_segs=N_SEGS):
    controller.add_schema(_ref_schema())
    controller.add_table(RTableConfig("lineorder", replication=2))
    b = RSegmentBuilder(_ref_schema())
    for i in range(n_segs):
        controller.upload_segment("lineorder", b.build(_data(300 + i), f"lineorder_{i}"))


@pytest.fixture(scope="module")
def oracle(tmp_path_factory):
    """The reference's own in-process cluster: rows per query."""
    controller = rc.Controller(rc.PropertyStore(), tmp_path_factory.mktemp("interop_oracle"))
    for i in range(2):
        controller.register_server(f"s{i}", rc.Server(f"s{i}"))
    _ref_setup(controller)
    broker = rc.Broker(controller)
    try:
        yield {sql: broker.execute(sql).rows for sql in QUERIES + ["SELECT region, year FROM lineorder LIMIT 4"]}
    finally:
        broker.shutdown()


def test_port_server_answers_reference_broker(tmp_path, oracle):
    servers = {f"s{i}": pc.Server(f"s{i}", device="cpu") for i in range(2)}
    svcs = {sid: phttp.ServerHTTPService(s) for sid, s in servers.items()}
    broker = None
    try:
        controller = rc.Controller(rc.PropertyStore(), tmp_path / "ds")
        for sid, svc in svcs.items():
            controller.register_server(sid, rhttp.RemoteServerClient(f"http://127.0.0.1:{svc.port}"))
        # the reference controller's uploads reach the port servers over
        # POST /segments/add; they load the reference-written segment files
        _ref_setup(controller)
        assert {sid: s.segments_of("lineorder") for sid, s in servers.items()} == {
            "s0": ["lineorder_0", "lineorder_1", "lineorder_2", "lineorder_3"],
            "s1": ["lineorder_0", "lineorder_1", "lineorder_2", "lineorder_3"],
        }
        broker = rc.Broker(controller)
        for sql in QUERIES:
            assert broker.execute(sql).rows == oracle[sql], sql
        # the streamed selection path: the port's /query/stream frames
        got = broker.execute("SELECT region, year FROM lineorder LIMIT 4")
        assert len(got.rows) == 4 and got.num_stream_frames >= 1
    finally:
        if broker is not None:
            broker.shutdown()
        for svc in svcs.values():
            svc.stop()


def test_reference_server_answers_port_broker(tmp_path, oracle):
    servers = {f"s{i}": rc.Server(f"s{i}") for i in range(2)}
    svcs = {sid: rhttp.ServerHTTPService(s) for sid, s in servers.items()}
    broker = None
    try:
        controller = pc.Controller(pc.PropertyStore(), tmp_path / "ds")
        for sid, svc in svcs.items():
            controller.register_server(sid, phttp.RemoteServerClient(f"http://127.0.0.1:{svc.port}"))
        controller.add_schema(_port_schema())
        controller.add_table(TableConfig("lineorder", replication=2))
        b = SegmentBuilder(_port_schema())
        for i in range(N_SEGS):
            controller.upload_segment("lineorder", b.build(_data(300 + i), f"lineorder_{i}"))
        broker = pc.Broker(controller)
        for sql in QUERIES:
            assert broker.execute(sql).rows == oracle[sql], sql
        got = broker.execute("SELECT region, year FROM lineorder LIMIT 4")
        assert len(got.rows) == 4 and got.num_stream_frames >= 1
    finally:
        if broker is not None:
            broker.shutdown()
        for svc in svcs.values():
            svc.stop()


def test_port_controller_opens_reference_store(tmp_path, oracle):
    """A reference controller writes a file-backed store and a deep store;
    a port controller on the same root and deep store reads every document
    the same, its servers load the segments the ideal state names, and its
    broker answers with the reference's rows."""
    root, deep = tmp_path / "store", tmp_path / "deep"
    r_ctrl = rc.Controller(rc.PropertyStore(root), deep)
    for i in range(2):
        r_ctrl.register_server(f"s{i}", rc.Server(f"s{i}"))
    _ref_setup(r_ctrl)

    p_store = pc.PropertyStore(root)
    paths = r_ctrl.store.list("/")
    assert paths and p_store.list("/") == paths
    for path in paths:
        assert p_store.get_versioned(path) == r_ctrl.store.get_versioned(path), path
    p_ctrl = pc.Controller(p_store, deep)
    assert p_ctrl.get_schema("lineorder").to_json() == r_ctrl.get_schema("lineorder").to_json()
    assert p_ctrl.get_table("lineorder").to_json() == r_ctrl.get_table("lineorder").to_json()
    assert p_ctrl.ideal_state("lineorder") == r_ctrl.ideal_state("lineorder")
    assert p_ctrl.routing_version("lineorder") == r_ctrl.routing_version("lineorder")
    assert p_ctrl.all_segment_metadata("lineorder") == r_ctrl.all_segment_metadata("lineorder")

    # the same servers, now the port's: replay the ideal state onto them
    servers = {f"s{i}": pc.Server(f"s{i}", device="cpu") for i in range(2)}
    for sid, s in servers.items():
        p_ctrl.register_server(sid, s)
    for seg, replicas in p_ctrl.ideal_state("lineorder").items():
        for sid in replicas:
            servers[sid].add_segment("lineorder", seg, p_ctrl.segment_metadata("lineorder", seg)["location"])
    broker = pc.Broker(p_ctrl)
    try:
        for sql in QUERIES:
            assert broker.execute(sql).rows == oracle[sql], sql
        # a new upload through the port lands where the reference's
        # balanced assignment puts it, and bumps the shared routing version
        want = r_ctrl._assign("lineorder", "lineorder_new", 2)
        v0 = r_ctrl.routing_version("lineorder")
        got = p_ctrl.upload_segment("lineorder", SegmentBuilder(_port_schema()).build(_data(399), "lineorder_new"))
        assert got == want
        assert r_ctrl.routing_version("lineorder") > v0
        assert r_ctrl.ideal_state("lineorder")["lineorder_new"] == {sid: "ONLINE" for sid in want}
        assert broker.execute("SELECT COUNT(*) FROM lineorder").rows == [[2000 * (N_SEGS + 1)]]
    finally:
        broker.shutdown()


def test_store_cas_and_versions_interoperate(tmp_path):
    """`__v` versions and cas across the two packages' stores on one root."""
    r_store, p_store = rc.PropertyStore(tmp_path), pc.PropertyStore(tmp_path)
    r_store.set("/a", {"x": 1})
    doc, v = p_store.get_versioned("/a")
    assert doc == {"x": 1} and v == 1
    assert p_store.cas("/a", v, {"x": 2})
    assert not r_store.cas("/a", v, {"x": 3})
    assert r_store.get_versioned("/a") == ({"x": 2}, 2)
    p_store.set("/tables/t/segments/seg__1", {"y": 1})
    assert r_store.list("/tables/t/segments/") == ["/tables/t/segments/seg__1"]
