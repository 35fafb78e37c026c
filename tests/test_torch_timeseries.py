"""The port's time-series engine and its broker endpoint against the JAX
package's.

The corpus is tests/test_timeseries.py's 24 cases. Each engine runs over its
own package's QueryEngine on the same rows (the port's with device="cpu"),
and every block must be the reference's: buckets, tag names, series keys in
the same order, and values exactly (NaN equal to NaN). Parse errors match
word for word. Through each package's BrokerHTTPService the JSON bodies of
/timeseries/api/v1/query_range are equal, a denied principal gets the same
403, and an unknown language the same error body.
"""

import base64
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.query as r_query
import pinot_tpu.segment as r_segment
import pinot_tpu.timeseries as r_ts
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.query as p_query
import pinot_tpu_torch.segment as p_segment
import pinot_tpu_torch.timeseries as p_ts
from pinot_tpu.cluster.access import BasicAuthAccessControl as RBasicAuth
from pinot_tpu.cluster.access import Principal as RPrincipal
from pinot_tpu.cluster.http import BrokerHTTPService as RBrokerHTTPService
from pinot_tpu.timeseries import language as r_language
from pinot_tpu_torch.cluster.access import BasicAuthAccessControl as PBasicAuth
from pinot_tpu_torch.cluster.access import Principal as PPrincipal
from pinot_tpu_torch.cluster.http import BrokerHTTPService as PBrokerHTTPService
from pinot_tpu_torch.timeseries import language as p_language


def _metrics_schema(common, dims=("host", "dc")):
    dt = common.DataType
    return common.Schema.build(
        "metrics",
        dimensions=[(d, dt.STRING) for d in dims],
        metrics=[("value", dt.LONG)],
        date_times=[("ts", dt.LONG)],
    )


def _metrics_data(n=40):
    # two hosts, 2 DCs, points at t=0..n-1
    return {
        "host": np.array(["h1", "h2"], dtype=object)[np.arange(n) % 2],
        "dc": np.array(["east", "west"], dtype=object)[(np.arange(n) // 2) % 2],
        "value": np.arange(n, dtype=np.int64),
        "ts": np.arange(n, dtype=np.int64),
    }


@pytest.fixture(scope="module")
def engines():
    data = _metrics_data()
    ref = r_ts.TimeSeriesEngine(
        r_query.QueryEngine([r_segment.SegmentBuilder(_metrics_schema(r_common)).build(dict(data), "m0")])
    )
    port = p_ts.TimeSeriesEngine(
        p_query.QueryEngine([p_segment.SegmentBuilder(_metrics_schema(p_common)).build(dict(data), "m0")], device="cpu")
    )
    return ref, port


def assert_same_block(ref, port):
    assert type(port).__name__ == "TimeSeriesBlock"
    assert port.buckets.dtype == ref.buckets.dtype and np.array_equal(port.buckets, ref.buckets)
    assert port.tag_names == ref.tag_names
    assert list(port.series) == list(ref.series)
    for k, v in ref.series.items():
        assert port.series[k].dtype == v.dtype
        assert np.array_equal(port.series[k], v, equal_nan=True), (k, port.series[k], v)


def run_both(engines, query, start, end, step, language="m3ql"):
    """The port's block, after holding it equal to the reference's."""
    ref, port = engines
    r = ref.execute(r_ts.RangeTimeSeriesRequest(query, start, end, step, language))
    p = port.execute(p_ts.RangeTimeSeriesRequest(query, start, end, step, language))
    assert_same_block(r, p)
    return p


def same_error(exc, fn_ref, fn_port):
    with pytest.raises(exc) as r:
        fn_ref()
    with pytest.raises(exc) as p:
        fn_port()
    assert type(p.value).__name__ == type(r.value).__name__
    assert str(p.value) == str(r.value)
    return str(p.value)


# -- parsing ----------------------------------------------------------------


def _plan_tree(node):
    """A plan tree as nested plain values, for comparing across packages."""
    if hasattr(node, "child"):
        return (type(node).__name__, node.kind, list(node.args), _plan_tree(node.child))
    return (type(node).__name__, node.table, node.value_expr, node.time_column, node.filter_sql, node.agg,
            list(node.group_by))


def test_parse_fetch_and_pipeline():
    q = (
        "fetch table=metrics value=value time=ts filter=\"host = 'h1'\" agg=max groupBy=host,dc"
        " | groupBy host | sum | rate"
    )
    root = p_ts.parse_timeseries(q)
    assert isinstance(root, p_ts.TransformNode) and root.kind == "rate"
    assert root.child.kind == "sum"
    assert root.child.child.kind == "groupby" and root.child.child.args == ["host"]
    leaf = root.child.child.child
    assert isinstance(leaf, p_ts.LeafTimeSeriesPlanNode)
    assert leaf.agg == "max" and leaf.filter_sql == "host = 'h1'"
    assert leaf.group_by == ["host", "dc"]
    assert _plan_tree(root) == _plan_tree(r_ts.parse_timeseries(q))


@pytest.mark.parametrize(
    "query, fragment",
    [
        ("sum | rate", "must start with 'fetch'"),
        ("fetch value=v", "requires table"),
        ("fetch table=t value=v | frobnicate", "unknown timeseries transform"),
        ("fetch table=t", "agg=count"),
        ("fetch table=t value=v | groupBy", "groupBy requires at least one tag"),
        ("fetch table=t value=v agg=median", "fetch agg must be one of"),
        ("fetch table=t value", "fetch args are key=value"),
    ],
)
def test_parse_errors(query, fragment):
    msg = same_error(ValueError, lambda: r_ts.parse_timeseries(query), lambda: p_ts.parse_timeseries(query))
    assert fragment in msg


# -- leaf execution ---------------------------------------------------------


def test_leaf_count_buckets(engines):
    block = run_both(engines, "fetch table=metrics agg=count", 0, 40, 10)
    assert list(block.buckets) == [0.0, 10.0, 20.0, 30.0]
    assert list(block.series[()]) == [10.0, 10.0, 10.0, 10.0]


def test_leaf_sum_with_tags_and_filter(engines):
    block = run_both(engines, "fetch table=metrics value=value groupBy=host filter=\"dc = 'east'\"", 0, 40, 20)
    assert block.tag_names == ["host"]
    east_h1 = [t for t in range(40) if (t // 2) % 2 == 0 and t % 2 == 0]
    assert list(block.series[("h1",)]) == [
        float(sum(t for t in east_h1 if t < 20)),
        float(sum(t for t in east_h1 if t >= 20)),
    ]


def test_leaf_time_range_clips(engines):
    block = run_both(engines, "fetch table=metrics agg=count", 10, 30, 10)
    assert list(block.buckets) == [10.0, 20.0]
    assert list(block.series[()]) == [10.0, 10.0]


def test_empty_bucket_is_nan(engines):
    v = run_both(engines, "fetch table=metrics value=value filter=\"ts < 10\"", 0, 40, 10).series[()]
    assert v[0] == 45.0
    assert np.isnan(v[1:]).all()


def test_leaf_sql_is_the_references(engines):
    """The leaf SQL each engine sends its executor, fractional bounds and
    steps included (`_lit`'s literal form), is the same string."""
    sent = {"ref": [], "port": []}

    class Spy:
        def __init__(self, inner, log):
            self.inner, self.log = inner, log

        def execute(self, sql):
            self.log.append(sql)
            return self.inner.execute(sql)

    ref, port = engines
    for q, start, end, step in (
        ("fetch table=metrics value=value groupBy=host,dc filter=\"dc = 'east'\" agg=avg", 0, 40, 10),
        ("fetch table=metrics agg=count", 2.5, 37.25, 7.5),
    ):
        r = r_ts.TimeSeriesEngine(Spy(ref._sql, sent["ref"])).execute(r_ts.RangeTimeSeriesRequest(q, start, end, step))
        p = p_ts.TimeSeriesEngine(Spy(port._sql, sent["port"])).execute(p_ts.RangeTimeSeriesRequest(q, start, end, step))
        assert_same_block(r, p)
    assert sent["port"] == sent["ref"] and len(sent["port"]) == 2
    assert all(s.endswith("LIMIT 1000000") for s in sent["port"])


# -- transforms -------------------------------------------------------------


def test_groupby_reaggregates(engines):
    block = run_both(engines, "fetch table=metrics value=value groupBy=host,dc | groupBy dc", 0, 40, 40)
    assert set(block.series) == {("east",), ("west",)}
    assert sum(np.nansum(v) for v in block.series.values()) == float(np.arange(40).sum())


def test_cross_series_sum_and_avg(engines):
    base = "fetch table=metrics value=value groupBy=host"
    assert list(run_both(engines, base + " | sum", 0, 40, 10).series[()]) == [45.0, 145.0, 245.0, 345.0]
    assert list(run_both(engines, base + " | avg", 0, 40, 10).series[()]) == [22.5, 72.5, 122.5, 172.5]
    for agg in ("min", "max"):
        run_both(engines, f"{base} | {agg}", 0, 40, 10)


def test_rate(engines):
    v = run_both(engines, "fetch table=metrics value=value | rate", 0, 40, 10).series[()]
    assert np.isnan(v[0])
    assert list(v[1:]) == [10.0, 10.0, 10.0]


def test_shift_scale_movingavg(engines):
    base = "fetch table=metrics agg=count"
    sh = run_both(engines, base + " | shift 1", 0, 40, 10).series[()]
    assert np.isnan(sh[0]) and list(sh[1:]) == [10.0, 10.0, 10.0]
    assert list(run_both(engines, base + " | scale 2.5", 0, 40, 10).series[()]) == [25.0] * 4
    assert list(run_both(engines, base + " | movingAvg 2", 0, 40, 10).series[()]) == [10.0] * 4
    run_both(engines, "fetch table=metrics value=value filter=\"ts < 20\" | shift -1 | movingAvg 3", 0, 40, 10)


def test_topk(engines):
    block = run_both(engines, "fetch table=metrics value=value groupBy=host | topk 1", 0, 40, 40)
    assert list(block.series) == [("h2",)]


def test_keep_last_value(engines):
    block = run_both(engines, "fetch table=metrics value=value filter=\"ts < 10\" | keepLastValue", 0, 40, 10)
    assert list(block.series[()]) == [45.0, 45.0, 45.0, 45.0]


def test_to_dict_json_surface(engines):
    ref, port = engines
    args = ("fetch table=metrics agg=count groupBy=dc", 0, 40, 20)
    d = port.execute_dict(p_ts.RangeTimeSeriesRequest(*args))
    assert d == ref.execute_dict(r_ts.RangeTimeSeriesRequest(*args))
    assert json.dumps(d) == json.dumps(ref.execute_dict(r_ts.RangeTimeSeriesRequest(*args)))
    assert d["timeBuckets"] == [0.0, 20.0]
    assert d["tagNames"] == ["dc"]
    assert {s["tags"]["dc"] for s in d["series"]} == {"east", "west"}
    assert all(len(s["values"]) == 2 for s in d["series"])


# -- the language-plugin SPI and the pipeline-op registry --------------------


def test_language_registry_lists_both_languages():
    p_language.get_timeseries_planner("m3ql")
    p_language.get_timeseries_planner("promql")
    r_language.get_timeseries_planner("promql")
    assert {"m3ql", "promql"} <= set(p_language.registered_languages())
    assert p_language.registered_languages() == r_language.registered_languages()
    assert p_language.registered_series_ops() == r_language.registered_series_ops()
    msg = same_error(
        KeyError, lambda: r_language.get_timeseries_planner("nope"), lambda: p_language.get_timeseries_planner("nope")
    )
    assert "unknown timeseries language" in msg


def test_new_pipeline_ops_via_m3ql(engines):
    v = run_both(engines, "fetch table=metrics value=value time=ts agg=sum | sum | transformNull 0 | integral",
                 0, 40, 10).series[()]
    assert v.tolist() == [45.0, 190.0, 435.0, 780.0]
    run_both(engines, "fetch table=metrics value=value filter=\"ts >= 20\" | integral | absolute", 0, 40, 10)


def test_persecond_and_clamp_ops(engines):
    v = run_both(engines, "fetch table=metrics value=value time=ts agg=sum | sum | perSecond | clampMax 20",
                 0, 40, 10).series[()]
    assert v.tolist() == [4.5, 14.5, 20.0, 20.0]
    run_both(engines, "fetch table=metrics value=value | clampMin 200 | transformNull -1", 0, 40, 10)


def test_bottomk(engines):
    block = run_both(engines, "fetch table=metrics value=value time=ts agg=sum groupBy=host | bottomk 1", 0, 40, 10)
    assert list(block.series) == [("h1",)]


def test_promql_language_end_to_end(engines):
    v = run_both(engines, 'sum(metrics:value{host="h1"})', 0, 40, 10, "promql").series[()]
    want = [sum(i for i in range(b, b + 10) if i % 2 == 0) for b in (0, 10, 20, 30)]
    assert v.tolist() == [float(w) for w in want]


def test_promql_by_grouping(engines):
    block = run_both(engines, "sum by (host) (metrics:value)", 0, 40, 10, "promql")
    assert set(block.series) == {("h1",), ("h2",)}
    evens = [sum(i for i in range(b, b + 10) if i % 2 == 0) for b in (0, 10, 20, 30)]
    assert block.series[("h1",)].tolist() == [float(w) for w in evens]


def test_promql_delta_and_clamp(engines):
    v = run_both(engines, "clamp_min(delta(sum(metrics:value)), 0)", 0, 40, 10, "promql").series[()]
    assert np.isnan(v[0]) and v[1:].tolist() == [100.0, 100.0, 100.0]


def test_promql_count_metric(engines):
    v = run_both(engines, "sum(metrics::count)", 0, 40, 10, "promql").series[()]
    assert v.tolist() == [10.0, 10.0, 10.0, 10.0]


def test_promql_rejects_nonsum_by(engines):
    ref, port = engines
    q = "min by (host) (metrics:value)"
    msg = same_error(
        ValueError,
        lambda: ref.execute(r_ts.RangeTimeSeriesRequest(q, 0, 40, 10, "promql")),
        lambda: port.execute(p_ts.RangeTimeSeriesRequest(q, 0, 40, 10, "promql")),
    )
    assert "only sum supports 'by'" in msg


@pytest.mark.parametrize(
    "query",
    ["sum(metrics:value", 'sum(metrics:value{host=h1})', "sum(metrics:value) )", "sum(metrics:value) @"],
)
def test_promql_parse_errors(query):
    from pinot_tpu.timeseries.promql import plan_promql as r_plan
    from pinot_tpu_torch.timeseries.promql import plan_promql as p_plan

    assert same_error(ValueError, lambda: r_plan(query), lambda: p_plan(query)).startswith("promql: ")


def _broker_cluster(pkg, tmp_path, access_control=None):
    cluster, common, segment = pkg
    ctrl = cluster.Controller(cluster.PropertyStore(), tmp_path / "deep")
    ctrl.add_schema(_metrics_schema(common, dims=("host",)))
    ctrl.add_table(common.TableConfig("metrics"))
    n = 20
    data = {
        "host": np.array(["h1", "h2"], dtype=object)[np.arange(n) % 2],
        "value": np.arange(n, dtype=np.int64),
        "ts": np.arange(n, dtype=np.int64),
    }
    kw = {} if access_control is None else {"access_control": access_control}
    if cluster is p_cluster:
        srv, kw = cluster.Server("server_0", device="cpu"), {**kw, "device": "cpu"}
    else:
        srv = cluster.Server("server_0")
    ctrl.register_server("server_0", srv)
    ctrl.upload_segment("metrics", segment.SegmentBuilder(_metrics_schema(common, dims=("host",))).build(data, "s0"))
    return cluster.Broker(ctrl, **kw)


def _post(port, body: dict, user=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/timeseries/api/v1/query_range",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    if user is not None:
        req.add_header("Authorization", "Basic " + base64.b64encode(user.encode()).decode())
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def test_broker_http_query_range_endpoint(tmp_path):
    """/timeseries/api/v1/query_range on each package's broker HTTP surface,
    both languages and the defaults (step 60, language m3ql): equal bodies,
    byte for byte."""
    ref = RBrokerHTTPService(_broker_cluster((r_cluster, r_common, r_segment), tmp_path / "r"))
    port = PBrokerHTTPService(_broker_cluster((p_cluster, p_common, p_segment), tmp_path / "p"))
    try:
        for body in (
            {"query": "fetch table=metrics value=value time=ts agg=sum | sum", "start": 0, "end": 20, "step": 10,
             "language": "m3ql"},
            {"query": "sum(metrics:value)", "start": 0, "end": 20, "step": 10, "language": "promql"},
            {"query": "sum by (host) (metrics:value)", "start": 0, "end": 20, "step": 5, "language": "promql"},
            {"query": "fetch table=metrics agg=count groupBy=host", "start": 0, "end": 20},
        ):
            (rs, rb), (ps, pb) = _post(ref.port, body), _post(port.port, body)
            assert (ps, pb) == (rs, rb) and ps == 200
        out = json.loads(pb)
        assert out["timeBuckets"] == [0.0] and {s["tags"]["host"] for s in out["series"]} == {"h1", "h2"}
        body = {"query": "sum(metrics:value)", "start": 0, "end": 20, "step": 10, "language": "promql"}
        assert json.loads(_post(port.port, body)[1])["series"][0]["values"] == [45.0, 145.0]
        # an error inside the engine takes the handler's exceptions body
        bad = {"query": "sum(metrics:value)", "start": 0, "end": 20, "language": "sql"}
        assert _post(port.port, bad) == _post(ref.port, bad)
    finally:
        ref.stop()
        port.stop()


def test_broker_http_query_range_forwards_the_identity(tmp_path):
    """The endpoint runs its leaf as the authenticated principal: a reader of
    the table gets the series, a principal without it (and an anonymous
    caller) gets the reference's 403 body."""
    principals = {
        "r": [RPrincipal("reader", "r", tables=("metrics",)), RPrincipal("other", "o", tables=("events",))],
        "p": [PPrincipal("reader", "r", tables=("metrics",)), PPrincipal("other", "o", tables=("events",))],
    }
    ref = RBrokerHTTPService(
        _broker_cluster((r_cluster, r_common, r_segment), tmp_path / "r", RBasicAuth(principals=principals["r"])))
    port = PBrokerHTTPService(
        _broker_cluster((p_cluster, p_common, p_segment), tmp_path / "p", PBasicAuth(principals=principals["p"])))
    body = {"query": "fetch table=metrics value=value | sum", "start": 0, "end": 20, "step": 10}
    try:
        for user in ("reader:r", "other:o", None):
            (rs, rb), (ps, pb) = _post(ref.port, body, user), _post(port.port, body, user)
            assert (ps, pb) == (rs, rb)
            assert ps == (200 if user == "reader:r" else 403)
        assert "denied" in json.loads(_post(port.port, body, "other:o")[1])["exceptions"][0]["message"]
    finally:
        ref.stop()
        port.stop()


def test_promql_time_column_matcher():
    """__time__ reserved matcher selects a non-default time column."""
    n = 20
    data = {
        "h": np.array(["a", "b"], dtype=object)[np.arange(n) % 2],
        "v": np.arange(n, dtype=np.int64),
        "when": np.arange(n, dtype=np.int64),
    }
    engines = []
    for common, segment, query, kw in ((r_common, r_segment, r_query, {}), (p_common, p_segment, p_query,
                                                                           {"device": "cpu"})):
        dt = common.DataType
        schema = common.Schema.build("m2", dimensions=[("h", dt.STRING)], metrics=[("v", dt.LONG)],
                                     date_times=[("when", dt.LONG)])
        ts = r_ts if common is r_common else p_ts
        engines.append(ts.TimeSeriesEngine(query.QueryEngine([segment.SegmentBuilder(schema).build(dict(data), "s0")],
                                                             **kw)))
    v = run_both(tuple(engines), 'sum(m2:v{__time__="when"})', 0, 20, 10, "promql").series[()]
    assert v.tolist() == [45.0, 145.0]


def test_leaf_runs_on_the_host_executor(engines):
    """The leaf's bucket key is an expression GROUP BY key, which the planner
    leaves to the host executor in both packages: no kernel launches."""
    from pinot_tpu_torch.ops import extreme, groupby, grouped_sum_f32

    _, port = engines
    wrappers = (groupby.grouped_multi_sum, groupby.grouped_multi_sum_2l, extreme.grouped_extremes,
                grouped_sum_f32.presence)
    before = [w.launches for w in wrappers]
    modes = dict(port._sql.segment_modes)
    block = port.execute(p_ts.RangeTimeSeriesRequest("fetch table=metrics value=value groupBy=host | sum", 0, 40, 10))
    assert [w.launches for w in wrappers] == before
    assert port._sql.segment_modes["host"] == modes.get("host", 0) + 1
    assert port._sql.segment_modes.get("device", 0) == modes.get("device", 0)
    assert block.series[()].tolist() == [45.0, 145.0, 245.0, 345.0]
