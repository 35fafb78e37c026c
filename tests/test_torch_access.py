"""The port's access control against the JAX package's (mirrors
tests/test_access.py): the same principals give the same verdicts, the
broker gates reads on the queried tables, the broker's HTTP tier takes
Basic auth (403 without it), and the controller's mutating REST endpoints
need WRITE. Rows are exact."""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import pinot_tpu.cluster as rc
from pinot_tpu.cluster.access import BasicAuthAccessControl as RBasicAuth, Principal as RPrincipal
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder
from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
from pinot_tpu_torch.cluster.access import (
    READ,
    WRITE,
    AccessDenied,
    AllowAllAccessControl,
    BasicAuthAccessControl,
    Principal,
    parse_basic,
)
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder


def _data():
    rng = np.random.default_rng(1)
    return {"g": np.asarray(["a"] * 60 + ["b"] * 40, dtype=object), "v": rng.integers(1, 9, 100).astype(np.int64)}


def _cluster(tmp_path):
    schema = Schema.build("t", dimensions=[("g", DataType.STRING)], metrics=[("v", DataType.LONG)])
    ctrl = Controller(PropertyStore(), tmp_path / "deep")
    ctrl.register_server("s0", handle=Server("s0", device="cpu"))
    ctrl.add_schema(schema)
    ctrl.add_table(TableConfig("t"))
    ctrl.upload_segment("t", SegmentBuilder(schema).build(_data(), "s0seg"))
    return ctrl


def _ref_rows(tmp_path, sql):
    schema = RSchema.build("t", dimensions=[("g", RDataType.STRING)], metrics=[("v", RDataType.LONG)])
    ctrl = rc.Controller(rc.PropertyStore(), tmp_path / "ref_deep")
    ctrl.register_server("s0", handle=rc.Server("s0"))
    ctrl.add_schema(schema)
    ctrl.add_table(RTableConfig("t"))
    ctrl.upload_segment("t", RSegmentBuilder(schema).build(_data(), "s0seg"))
    return rc.Broker(ctrl).execute(sql).rows


PRINCIPALS = [("admin", "secret", ("*",), (READ, WRITE)), ("reader", "r", ("t",), (READ,)),
              ("other", "o", ("elsewhere",), (READ, WRITE))]


@pytest.mark.parametrize(
    "identity",
    [("admin", "secret"), ("reader", "r"), ("other", "o"), ("admin", "wrong"), None],
    ids=["admin", "reader", "other", "wrong_password", "anonymous"],
)
@pytest.mark.parametrize("table", ["t", "elsewhere", None])
@pytest.mark.parametrize("access", [READ, WRITE])
def test_verdicts_equal_reference(identity, table, access):
    port = BasicAuthAccessControl(principals=[Principal(u, p, tables=t, permissions=a) for u, p, t, a in PRINCIPALS])
    ref = RBasicAuth(principals=[RPrincipal(u, p, tables=t, permissions=a) for u, p, t, a in PRINCIPALS])
    ident = parse_basic(*identity) if identity else None
    assert port.has_access(ident, table, access) == ref.has_access(ident, table, access)


def test_principal_table_and_permission_scoping():
    ac = BasicAuthAccessControl(
        principals=[
            Principal("admin", "secret"),
            Principal("reader", "r", tables=("t",), permissions=(READ,)),
            Principal("other", "o", tables=("elsewhere",)),
        ]
    )
    assert ac.has_access(parse_basic("admin", "secret"), "t", WRITE)
    assert ac.has_access(parse_basic("reader", "r"), "t", READ)
    assert not ac.has_access(parse_basic("reader", "r"), "t", WRITE)
    assert not ac.has_access(parse_basic("other", "o"), "t", READ)
    assert not ac.has_access(parse_basic("admin", "wrong"), "t", READ)
    assert not ac.has_access(None, "t", READ)  # anonymous denied
    assert AllowAllAccessControl().has_access(None, "t", WRITE)
    headers = {"Authorization": "Basic " + base64.b64encode(b"reader:r").decode()}
    assert ac.authenticate(headers) == "reader:r"
    assert ac.authenticate({"Authorization": "Bearer r"}) == "reader:r"
    assert ac.authenticate({}) is None


def test_broker_gates_reads(tmp_path):
    ctrl = _cluster(tmp_path)
    ac = BasicAuthAccessControl(principals=[Principal("reader", "r", tables=("t",), permissions=(READ,))])
    broker = Broker(ctrl, access_control=ac)
    sql = "SELECT g, SUM(v) FROM t GROUP BY g ORDER BY g"
    assert broker.execute(sql, identity=parse_basic("reader", "r")).rows == _ref_rows(tmp_path, sql)
    with pytest.raises(AccessDenied):
        broker.execute("SELECT COUNT(*) FROM t")  # anonymous
    with pytest.raises(AccessDenied):
        broker.execute("SELECT COUNT(*) FROM t", identity=parse_basic("reader", "wrong"))
    # no access control configured -> open (AllowAll default)
    assert Broker(ctrl).execute("SELECT COUNT(*) FROM t").rows[0][0] == 100
    broker.shutdown()


def _post(port, path, data: bytes, user=None, pw=None):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data, method="POST")
    if user:
        req.add_header("Authorization", "Basic " + base64.b64encode(f"{user}:{pw}".encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            return r.status, json.loads(r.read().decode())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read().decode() or "{}")


def test_http_basic_auth_end_to_end(tmp_path):
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, ControllerHTTPService

    ctrl = _cluster(tmp_path)
    ac = BasicAuthAccessControl(principals=[Principal("admin", "secret"), Principal("reader", "r", permissions=(READ,))])
    ctrl.access_control = ac
    broker = Broker(ctrl, access_control=ac)
    bsvc = BrokerHTTPService(broker)
    csvc = ControllerHTTPService(ctrl)
    try:
        q = json.dumps({"sql": "SELECT COUNT(*) FROM t"}).encode()
        code, out = _post(bsvc.port, "/query/sql", q, "reader", "r")
        assert code == 200 and out["resultTable"]["rows"][0][0] == 100
        code, out = _post(bsvc.port, "/query/sql", q)
        assert code == 403 and "denied" in out["exceptions"][0]["message"]
        # controller: mutating endpoints need WRITE
        new_schema = Schema.build("t2", dimensions=[("g", DataType.STRING)], metrics=[("v", DataType.LONG)])
        code, _ = _post(csvc.port, "/schemas", new_schema.to_json().encode(), "reader", "r")
        assert code == 403
        code, _ = _post(csvc.port, "/schemas", new_schema.to_json().encode())
        assert code == 403
        assert ctrl.get_schema("t2") is None
        code, _ = _post(csvc.port, "/schemas", new_schema.to_json().encode(), "admin", "secret")
        assert code == 200
        assert ctrl.get_schema("t2").name == "t2"
    finally:
        bsvc.stop()
        csvc.stop()
        broker.shutdown()
