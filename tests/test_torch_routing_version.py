"""The port's routing-version bumps against the JAX package's: upload, delete
and set_segment_state through both controllers, on the same seeded segments.

`Controller._update_ideal` bumps the table's routing version after every
ideal-state write, so no caller can forget it. Each step must leave both
controllers at the same version, and the port's broker must answer the next
query afresh (not from its result cache) with the rows the reference gives.
"""

import numpy as np
import pytest

from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder

import pinot_tpu.cluster as rc
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder

TABLE = "lineorder"
SQL = f"SELECT year, COUNT(*), SUM(revenue) FROM {TABLE} GROUP BY year ORDER BY year"


def _data(seed: int, n: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "revenue": rng.integers(100, 600_000, n).astype(np.int64),
    }


def _side(root, cluster, dt, schema_cls, cfg_cls, builder_cls, make_server):
    controller = cluster.Controller(cluster.PropertyStore(), root / "deepstore")
    for i in range(2):
        controller.register_server(f"server_{i}", make_server(f"server_{i}"))
    schema = schema_cls.build(TABLE, dimensions=[("year", dt.INT)], metrics=[("revenue", dt.LONG)])
    controller.add_schema(schema)
    controller.add_table(cfg_cls(TABLE, replication=2))
    return controller, builder_cls(schema)


class _Port:
    Controller, PropertyStore = Controller, PropertyStore


@pytest.fixture
def sides(tmp_path):
    ref = _side(tmp_path / "ref", rc, RDataType, RSchema, RTableConfig, RSegmentBuilder, rc.Server)
    port = _side(tmp_path / "port", _Port, DataType, Schema, TableConfig, SegmentBuilder,
                 lambda sid: Server(sid, device="cpu"))
    return {"ref": ref, "port": port}


def _rows(result) -> list:
    return [[int(v) for v in row] for row in result.rows]


def _steps():
    """(label, action(controller, builder)) in order: two uploads, a
    replica dropped, a replica put back, a delete."""
    return [
        ("upload lineorder_0", lambda c, b: c.upload_segment(TABLE, b.build(_data(300, 2000), "lineorder_0"))),
        ("upload lineorder_1", lambda c, b: c.upload_segment(TABLE, b.build(_data(301, 3000), "lineorder_1"))),
        ("drop a replica", lambda c, b: c.set_segment_state(TABLE, "lineorder_0", "server_1", None)),
        ("replica back", lambda c, b: c.set_segment_state(TABLE, "lineorder_0", "server_1", "ONLINE")),
        ("delete lineorder_1", lambda c, b: c.delete_segment(TABLE, "lineorder_1")),
    ]


def test_routing_version_matches_reference_after_each_step(sides):
    (r_ctrl, r_build), (p_ctrl, p_build) = sides["ref"], sides["port"]
    assert p_ctrl.routing_version(TABLE) == r_ctrl.routing_version(TABLE)
    versions = []
    for label, act in _steps():
        act(r_ctrl, r_build)
        act(p_ctrl, p_build)
        want = r_ctrl.routing_version(TABLE)
        assert p_ctrl.routing_version(TABLE) == want, label
        assert p_ctrl.store.get(f"/tables/{TABLE}/idealstate") == r_ctrl.store.get(f"/tables/{TABLE}/idealstate"), label
        versions.append(want)
    # every step moved the version: none of them left the caches' key as it was
    assert all(b > a for a, b in zip(versions, versions[1:])), versions


@pytest.mark.parametrize("step", range(len(_steps())))
def test_broker_cache_invalidated_by_each_step(sides, step):
    (r_ctrl, r_build), (p_ctrl, p_build) = sides["ref"], sides["port"]
    r_broker, p_broker = rc.Broker(r_ctrl), Broker(p_ctrl, device="cpu")
    steps = _steps()
    for _, act in steps[:step]:
        act(r_ctrl, r_build)
        act(p_ctrl, p_build)
    if step:
        p_broker.execute(SQL)
        cached = p_broker.execute(SQL)
        assert cached.cache_hit, "the broker's result cache should answer a repeated query"
    label, act = steps[step]
    act(r_ctrl, r_build)
    act(p_ctrl, p_build)
    fresh = p_broker.execute(SQL)
    assert not fresh.cache_hit, f"{label}: the broker answered from a cache keyed on the old segment set"
    assert _rows(fresh) == _rows(r_broker.execute(SQL)), label
    assert p_broker.execute(SQL).cache_hit, label
