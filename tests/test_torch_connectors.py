"""The port's DataFrame connector against the JAX package's.

The corpus is the connector cases of tests/test_plugins_connectors.py. Both
packages write the same frames into their own cluster and read them back:
the deep-store scan (`read_table`, with and without filter pushdown), the
direct-server scan (`read_table_via_servers`) over in-process and HTTP server
handles, and both over in-process and REST controllers. The port's frame is
a dict of numpy columns; each column must equal the reference DataFrame's
`df[c].to_numpy()` (numbers with the same dtype, strings as values), in the
same column order, and the same errors must be raised.
"""

from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.connectors.dataframe as r_conn
import pinot_tpu.segment as r_segment
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.connectors as p_conn_pkg
import pinot_tpu_torch.connectors.dataframe as p_conn
import pinot_tpu_torch.segment as p_segment
from pinot_tpu.cluster import http as r_http
from pinot_tpu_torch.cluster import http as p_http

REF = SimpleNamespace(cluster=r_cluster, common=r_common, conn=r_conn, segment=r_segment, http=r_http,
                      server=lambda sid: r_cluster.Server(sid), broker=lambda c: r_cluster.Broker(c))
PORT = SimpleNamespace(cluster=p_cluster, common=p_common, conn=p_conn, segment=p_segment, http=p_http,
                       server=lambda sid: p_cluster.Server(sid, device="cpu"),
                       broker=lambda c: p_cluster.Broker(c, device="cpu"))


def assert_same_frame(ref: pd.DataFrame, port: dict):
    """Each port column equals the reference frame's column as numpy gives
    it: the same columns in the same order, numbers with the same dtype,
    strings as values."""
    assert isinstance(port, dict)
    assert list(port) == [str(c) for c in ref.columns]
    for c in ref.columns:
        want, got = ref[c].to_numpy(), port[c]
        assert isinstance(got, np.ndarray) and len(got) == len(want)
        if want.dtype == object or got.dtype == object:
            assert got.dtype == object, (c, got.dtype, want.dtype)
            assert got.tolist() == want.tolist(), c
        else:
            assert got.dtype == want.dtype, (c, got.dtype, want.dtype)
            assert np.array_equal(got, want), c


def _schema(pkg):
    dt = pkg.common.DataType
    return pkg.common.Schema.build("events", dimensions=[("kind", dt.STRING)], metrics=[("value", dt.LONG)])


def _offline_cluster(pkg, tmp_path):
    controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), tmp_path / "deep")
    controller.register_server("s0", pkg.server("s0"))
    controller.add_schema(_schema(pkg))
    controller.add_table(pkg.common.TableConfig("events"))
    return controller


def _frame(n=100):
    return {
        "kind": np.array([f"k{i % 4}" for i in range(n)], dtype=object),
        "value": np.arange(n, dtype=np.int64),
    }


def both(tmp_path, fn):
    """fn(pkg, controller) in each package's own cluster: (ref, port)."""
    return tuple(fn(pkg, _offline_cluster(pkg, tmp_path / name)) for name, pkg in (("r", REF), ("p", PORT)))


def test_package_exports_the_connector():
    assert p_conn_pkg.read_table is p_conn.read_table and p_conn_pkg.write_table is p_conn.write_table
    assert p_conn_pkg.read_table_via_servers is p_conn.read_table_via_servers


def test_write_then_read_roundtrip(tmp_path):
    data = {**_frame(), "extra_ignored": np.zeros(100)}

    def run(pkg, controller):
        df = pd.DataFrame(data)
        # the reference writes a DataFrame; the port a dict of columns
        frame = df[["kind", "value"]] if pkg is REF else {c: data[c] for c in ("kind", "value")}
        names = pkg.conn.write_table(controller, "events", frame, rows_per_segment=30)
        assert names == [f"events_df_{i}" for i in range(4)]
        out = pkg.conn.read_table(controller, "events")
        only = pkg.conn.read_table(controller, "events", columns=["value"], parallelism=2)
        res = pkg.broker(controller).execute("SELECT kind, COUNT(*) FROM events GROUP BY kind ORDER BY kind")
        return out, only, res.rows

    (r_out, r_only, r_rows), (p_out, p_only, p_rows) = both(tmp_path, run)
    assert_same_frame(r_out, p_out)
    assert_same_frame(r_only, p_only)
    assert len(p_out["value"]) == 100 and sorted(p_out) == ["kind", "value"]
    assert p_out["value"].sum() == data["value"].sum()
    assert list(p_only) == ["value"]
    assert p_rows == r_rows and [r[1] for r in p_rows] == [25, 25, 25, 25]


def test_write_takes_a_dataframe_or_any_column_mapping(tmp_path):
    """The port's write_table takes a pandas DataFrame a caller holds, and
    numpy string columns (`<U`), as the reference's DataFrame holds them."""
    data = _frame(50)

    def run(pkg, controller):
        if pkg is REF:
            pkg.conn.write_table(controller, "events", pd.DataFrame(data), rows_per_segment=20)
        else:
            pkg.conn.write_table(controller, "events", pd.DataFrame(data), rows_per_segment=20,
                                 segment_name_prefix="pd")
            pkg.conn.write_table(controller, "events", {"kind": data["kind"].astype(str), "value": data["value"]},
                                 rows_per_segment=20, segment_name_prefix="u")
        return pkg.conn.read_table(controller, "events")

    r_out, p_out = both(tmp_path, run)
    assert p_out["kind"].dtype == object and sorted(p_out["kind"].tolist()) == sorted(r_out["kind"].tolist() * 2)
    assert p_out["value"].dtype == r_out["value"].to_numpy().dtype
    assert sorted(p_out["value"].tolist()) == sorted(r_out["value"].tolist() * 2)


def test_read_with_filter_pushdown(tmp_path):
    data = _frame()

    def run(pkg, controller):
        pkg.conn.write_table(controller, "events", pd.DataFrame(data) if pkg is REF else data, rows_per_segment=25)
        return [
            pkg.conn.read_table(controller, "events", where=w)
            for w in ("value BETWEEN 10 AND 40 AND kind = 'k1'", "value > 1000", "value < 30")
        ]

    ref, port = both(tmp_path, run)
    for r, p in zip(ref, port):
        assert_same_frame(r, p)
    out, none, part = port
    want = (data["value"] >= 10) & (data["value"] <= 40) & (data["kind"] == "k1")
    assert sorted(out["value"].tolist()) == sorted(data["value"][want].tolist())
    # min-max pruning: a predicate outside every segment's range reads nothing
    assert len(none["value"]) == 0
    # pruned segments must not widen int columns to float64
    assert part["value"].dtype.kind in "iu", part["value"].dtype


def test_write_missing_column_raises(tmp_path):
    def run(pkg, controller):
        with pytest.raises(KeyError, match="missing schema column") as e:
            pkg.conn.write_table(controller, "events", pd.DataFrame({"kind": ["a"]}) if pkg is REF else
                                 {"kind": np.array(["a"], dtype=object)})
        return str(e.value)

    r_msg, p_msg = both(tmp_path, run)
    assert p_msg == r_msg


def test_write_unknown_table_raises(tmp_path):
    def run(pkg, controller):
        with pytest.raises(KeyError) as e:
            pkg.conn.write_table(controller, "nope", pd.DataFrame(_frame(3)) if pkg is REF else _frame(3))
        return str(e.value)

    r_msg, p_msg = both(tmp_path, run)
    assert p_msg == r_msg


def test_read_empty_table(tmp_path):
    def run(pkg, controller):
        return (pkg.conn.read_table(controller, "events"),
                pkg.conn.read_table(controller, "events", columns=["kind", "value"]),
                pkg.conn.read_table_via_servers(controller, "events"))

    ref, port = both(tmp_path, run)
    for r, p in zip(ref, port):
        assert_same_frame(r, p)
    assert port[0] == {} and all(len(v) == 0 for v in port[2].values())


def test_connector_against_rest_controller(tmp_path):
    """write_table through RemoteControllerClient (the external-job shape)."""
    data = {"kind": np.array(["x", "y"], dtype=object), "value": np.array([5, 6], dtype=np.int64)}

    def run(pkg, controller):
        svc = pkg.http.ControllerHTTPService(controller)
        try:
            rc = pkg.http.RemoteControllerClient(f"http://127.0.0.1:{svc.port}")
            pkg.conn.write_table(rc, "events", pd.DataFrame(data) if pkg is REF else data)
            return pkg.conn.read_table(rc, "events"), pkg.conn.read_table(rc, "events", where="value > 5")
        finally:
            svc.stop()

    ref, port = both(tmp_path, run)
    for r, p in zip(ref, port):
        assert_same_frame(r, p)
    assert sorted(port[0]["value"].tolist()) == [5, 6] and port[1]["kind"].tolist() == ["y"]


def _two_server_cluster(pkg, tmp_path, all_b=()):
    c = pkg.cluster.Controller(pkg.cluster.PropertyStore(), tmp_path / "deep")
    s0, s1 = pkg.server("server_0"), pkg.server("server_1")
    c.register_server("server_0", s0)
    c.register_server("server_1", s1)
    dt = pkg.common.DataType
    schema = pkg.common.Schema.build("t", dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)])
    c.add_schema(schema)
    c.add_table(pkg.common.TableConfig("t"))
    rng = np.random.default_rng(0)
    for i in range(4):
        kv = np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, 300)]
        vv = rng.integers(0, 100, 300).astype(np.int64)
        if i in all_b:
            kv[:] = "b"
        c.upload_segment("t", pkg.segment.SegmentBuilder(schema).build({"k": kv, "v": vv}, f"s{i}"))
    return c, s0, s1


@pytest.mark.parametrize("all_b", [(), (0, 2)], ids=["every_server_matches", "one_server_empty"])
def test_read_table_via_servers(tmp_path, all_b):
    """Direct-server scan connector (Spark PinotServerDataFetcher analog):
    splits per (server, segments), streamed selection with filter pushdown,
    over both in-process handles and the HTTP data plane. With segments 0 and
    2 all 'b', the server owning them has no row for k = 'a', and its empty
    split sets the columns' type as the reference's concat does."""
    reads = (
        {},
        {"columns": ["v"], "where": "k = 'a'"},
        {"where": "k = 'a'"},
        {"columns": ["v", "k"], "where": "v < 5"},
        {"where": "v > 1000"},
    )
    out = {}
    for name, pkg in (("r", REF), ("p", PORT)):
        c, s0, s1 = _two_server_cluster(pkg, tmp_path / name, all_b)
        got = [pkg.conn.read_table_via_servers(c, "t", **kw) for kw in reads]
        svc0, svc1, csvc = pkg.http.ServerHTTPService(s0), pkg.http.ServerHTTPService(s1), \
            pkg.http.ControllerHTTPService(c)
        try:
            rc = pkg.http.RemoteControllerClient(f"http://127.0.0.1:{csvc.port}")
            rc.register_instance("server", "server_0", "127.0.0.1", svc0.port)
            rc.register_instance("server", "server_1", "127.0.0.1", svc1.port)
            got += [pkg.conn.read_table_via_servers(rc, "t", **kw) for kw in reads]
        finally:
            svc0.stop()
            svc1.stop()
            csvc.stop()
        out[name] = got
    for r, p in zip(out["r"], out["p"]):
        assert_same_frame(r, p)
    full, only_v, a_rows = out["p"][:3]
    assert len(full["k"]) == 1200 and list(full) == ["k", "v"]
    assert list(only_v) == ["v"] and set(a_rows["k"].tolist()) == {"a"}
    assert len(only_v["v"]) == len(a_rows["v"]) and len(out["p"][4]["v"]) == 0
    # the HTTP data plane reads the same rows
    for a, b in zip(out["p"][:5], out["p"][5:]):
        assert {c: v.tolist() for c, v in a.items()} == {c: v.tolist() for c, v in b.items()}


def test_read_table_via_servers_takes_the_first_online_replica(tmp_path):
    """With replication 2 every segment has two ONLINE owners; each split
    goes to its first, so every row is read once."""
    out = {}
    for name, pkg in (("r", REF), ("p", PORT)):
        c = pkg.cluster.Controller(pkg.cluster.PropertyStore(), tmp_path / name / "deep")
        for sid in ("server_0", "server_1"):
            c.register_server(sid, pkg.server(sid))
        c.add_schema(_schema(pkg))
        c.add_table(pkg.common.TableConfig("events", replication=2))
        pkg.conn.write_table(c, "events", pd.DataFrame(_frame(90)) if pkg is REF else _frame(90), rows_per_segment=40)
        assert all(len(v) == 2 for v in c.ideal_state("events").values())
        out[name] = pkg.conn.read_table_via_servers(c, "events")
    assert_same_frame(out["r"], out["p"])
    assert sorted(out["p"]["value"].tolist()) == list(range(90))
