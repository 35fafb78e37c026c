"""The port's Python client, admin CLI and controller REST against the JAX
package's.

Mirrors tests/test_client_cli.py, its QuickStart, ImportData, CreateSegment,
LaunchDistributedDataIngestionJob and ScheduleTasks legs too: each runs
through both packages' admin CLIs, against each package's own cluster. Two
stacks:

- `stack`: controller, server and broker in this process, each behind its
  HTTP service, the broker built over a RemoteControllerClient;
- `procs`: the same roles as OS processes started by
  `python -m pinot_tpu_torch.tools.admin Start...` with `--device cpu`.

Rows must equal those of the reference's own cluster on the same data
(exact: the sums are of int64 columns).
"""

import json
import re
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as rc
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder
from pinot_tpu_torch.client import Cursor, PinotClientError, connect
from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
from pinot_tpu_torch.cluster.http import (
    BrokerHTTPService,
    ControllerHTTPService,
    RemoteControllerClient,
    ServerHTTPService,
)
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder
from pinot_tpu_torch.segment.builder import write_segment
from pinot_tpu_torch.tools.admin import main

import pinot_tpu.cluster.http as r_http
import pinot_tpu.common as r_common
import pinot_tpu.minion as r_minion
import pinot_tpu.minion.tasks as r_tasks
import pinot_tpu.tools.admin as r_admin
import pinot_tpu_torch.cluster.http as p_http
import pinot_tpu_torch.minion as p_minion
import pinot_tpu_torch.minion.tasks as p_tasks
import pinot_tpu_torch.tools.admin as p_admin

REPO = Path(__file__).resolve().parents[1]
START_TIMEOUT_S = 60.0

HITS = {"page": np.array(["a", "b", "a"], dtype=object), "n": np.array([1, 2, 3], dtype=np.int64)}

#: the process cluster's table: 4 segments, replication 2 over 2 servers
N_SEGS, SEG_ROWS = 4, 500
PROC_QUERIES = [
    "SELECT COUNT(*) FROM events",
    "SELECT kind, SUM(v) FROM events GROUP BY kind ORDER BY kind",
    "SELECT year, COUNT(*), MAX(v) FROM events WHERE kind <> 'c' GROUP BY year ORDER BY year",
    "SELECT DISTINCTCOUNT(year) FROM events",
    "SELECT v, kind FROM events ORDER BY v DESC, kind LIMIT 5",
    # distributed multistage: the join's stages run in the server processes
    "SELECT d.label, SUM(e.v) FROM events e JOIN kinds d ON e.kind = d.kind GROUP BY d.label ORDER BY d.label",
]


def _events(i):
    rng = np.random.default_rng(40 + i)
    return {
        "kind": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, SEG_ROWS)],
        "year": rng.integers(1992, 1999, SEG_ROWS).astype(np.int32),
        "v": rng.integers(1, 10_000, SEG_ROWS).astype(np.int64),
    }


KINDS = {"kind": np.array(["a", "b", "c"], dtype=object), "label": np.array(["L0", "L1", "L0"], dtype=object)}


def _schemas(dt, sch):
    events = sch.build("events", dimensions=[("kind", dt.STRING), ("year", dt.INT)], metrics=[("v", dt.LONG)])
    kinds = sch.build("kinds", dimensions=[("kind", dt.STRING), ("label", dt.STRING)], metrics=[])
    return events, kinds


@pytest.fixture(scope="module")
def ref_rows(tmp_path_factory):
    """The reference's in-process cluster on the process cluster's data."""
    controller = rc.Controller(rc.PropertyStore(), tmp_path_factory.mktemp("cli_ref"))
    for i in range(2):
        controller.register_server(f"s{i}", rc.Server(f"s{i}"))
    events, kinds = _schemas(RDataType, RSchema)
    for sch, rep in ((events, 2), (kinds, 1)):
        controller.add_schema(sch)
        controller.add_table(RTableConfig(sch.name, replication=rep))
    for i in range(N_SEGS):
        controller.upload_segment("events", RSegmentBuilder(events).build(_events(i), f"events_{i}"))
    controller.upload_segment("kinds", RSegmentBuilder(kinds).build(KINDS, "kinds_0"))
    broker = rc.Broker(controller)
    return {sql: broker.execute(sql).rows for sql in PROC_QUERIES}


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    """controller + server + broker all over real HTTP, plus REST service."""
    root = tmp_path_factory.mktemp("stack")
    store = PropertyStore(root / "store")  # file-backed: multi-process shape
    controller = Controller(store, root / "deepstore")
    c_svc = ControllerHTTPService(controller)
    c_url = f"http://127.0.0.1:{c_svc.port}"

    # server registers itself via REST, like StartServer does
    server = Server("server_0", device="cpu")
    s_svc = ServerHTTPService(server)
    rcl = RemoteControllerClient(c_url)
    rcl.register_instance("server", "server_0", "127.0.0.1", s_svc.port)

    schema = Schema.build("hits", dimensions=[("page", DataType.STRING)], metrics=[("n", DataType.LONG)])
    rcl.add_schema(schema)
    rcl.add_table(TableConfig("hits"))

    # broker built against the REMOTE controller client (cross-process shape)
    broker = Broker(RemoteControllerClient(c_url))
    b_svc = BrokerHTTPService(broker)
    rcl.register_instance("broker", "broker_0", "127.0.0.1", b_svc.port)

    # push one segment through the REST upload path
    seg_dir = write_segment(SegmentBuilder(schema).build(HITS, "hits_0"), root / "built")
    out = rcl.upload_segment_dir("hits", seg_dir)
    assert out["segment"] == "hits_0"

    yield {"c_url": c_url, "b_url": f"http://127.0.0.1:{b_svc.port}", "rc": rcl, "root": root}
    for svc in (b_svc, s_svc, c_svc):
        svc.stop()
    broker.shutdown()


def _spawn(args, cwd=REPO):
    """Start one admin role; returns (process, URL from its listening line)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "pinot_tpu_torch.tools.admin", *args],
        cwd=cwd,
        stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT,
        text=True,
    )
    deadline = time.monotonic() + START_TIMEOUT_S
    out = []
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    while time.monotonic() < deadline:
        if not sel.select(timeout=max(0.0, deadline - time.monotonic())):
            break
        line = proc.stdout.readline()
        if not line:
            break
        out.append(line)
        m = re.search(r"listening on (http://\S+)", line)
        if m:
            return proc, m.group(1)
    proc.kill()
    proc.wait()
    raise AssertionError(f"{args[0]} did not start within {START_TIMEOUT_S}s: {''.join(out)}")


@pytest.fixture(scope="module")
def procs(tmp_path_factory):
    """Controller, two servers and a broker as OS processes (`--device cpu`),
    the events table uploaded through the controller's REST tarball path."""
    root = tmp_path_factory.mktemp("procs")
    started = []
    try:
        ctl, c_url = _spawn(["StartController", "--store-dir", str(root / "store"), "--deep-store", str(root / "deep")])
        started.append(ctl)
        for i in range(2):
            srv, _ = _spawn(["StartServer", "--controller-url", c_url, "--server-id", f"server_{i}", "--device", "cpu"])
            started.append(srv)
        brk, b_url = _spawn(["StartBroker", "--controller-url", c_url, "--device", "cpu"])
        started.append(brk)
        rcl = RemoteControllerClient(c_url)
        events, kinds = _schemas(DataType, Schema)
        for sch, rep in ((events, 2), (kinds, 1)):
            rcl.add_schema(sch)
            rcl.add_table(TableConfig(sch.name, replication=rep))
        for i in range(N_SEGS):
            rcl.upload_segment_dir("events", write_segment(SegmentBuilder(events).build(_events(i), f"events_{i}"), root / "built"))
        rcl.upload_segment("kinds", SegmentBuilder(kinds).build(KINDS, "kinds_0"))
        yield {"c_url": c_url, "b_url": b_url, "rc": rcl}
    finally:
        for p in started:
            p.kill()
        for p in started:
            p.wait(timeout=30)


# -- controller REST + remote roles -----------------------------------------


def test_rest_reads(stack):
    rcl = stack["rc"]
    assert rcl.health()
    assert rcl.tables() == ["hits"]
    assert rcl.get_table("hits").table_name == "hits"
    assert rcl.get_schema("hits").name == "hits"
    assert rcl.get_table("nope") is None
    assert "hits_0" in rcl.ideal_state("hits")
    assert rcl.all_segment_metadata("hits")["hits_0"]["numDocs"] == 3
    assert rcl.brokers() == {"broker_0": stack["b_url"]}


def test_remote_broker_executes_via_remote_server(stack):
    """Broker(RemoteControllerClient) scatters to the HTTP server."""
    rs = connect(stack["b_url"]).execute("SELECT page, SUM(n) FROM hits GROUP BY page ORDER BY page")
    assert rs.rows == [["a", 4.0], ["b", 2.0]]


def test_a10_endpoints_answer_501(stack, tmp_path):
    """The minion task endpoints answer as the reference's: 404 on a
    controller with no task manager (the stack's), and, with one, GET /tasks
    lists every task and POST /tasks/schedule returns the scheduled ids.
    The control plane's answer as the reference's too: the UI,
    /debug/cluster and /debug/alerts (404 until an aggregator registers) and
    a rebalance."""
    import urllib.error
    import urllib.request

    from pinot_tpu.cluster.http import ControllerHTTPService as RControllerHTTPService
    from pinot_tpu.cluster.ui import UI_HTML
    from pinot_tpu.minion import PinotTaskManager as RPinotTaskManager, TaskConfig as RTaskConfig
    from pinot_tpu_torch.minion import PinotTaskManager, TaskConfig

    for method, path in (("GET", "/tasks"), ("POST", "/tasks/schedule")):
        req = urllib.request.Request(stack["c_url"] + path, data=b"{}" if method == "POST" else None, method=method)
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req, timeout=10)
        assert ei.value.code == 404, path
        assert json.loads(ei.value.read()) == {"error": "not found"}, path
    out = {}
    for name, ctrl, svc_cls, tm_cls, task_cls in (
        ("ref", rc.Controller(rc.PropertyStore(), tmp_path / "ref"), RControllerHTTPService, RPinotTaskManager, RTaskConfig),
        ("port", Controller(PropertyStore(), tmp_path / "port"), ControllerHTTPService, PinotTaskManager, TaskConfig),
    ):
        tm = tm_cls(ctrl)
        svc = svc_cls(ctrl, task_manager=tm)
        url = f"http://127.0.0.1:{svc.port}"
        try:
            tm.submit(task_cls("OkTask", "t"))
            req = urllib.request.Request(url + "/tasks/schedule", data=b"{}", method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                scheduled = json.loads(r.read())
            with urllib.request.urlopen(url + "/tasks?state=COMPLETED", timeout=10) as r:
                listed = json.loads(r.read())
            out[name] = (scheduled, listed, svc.task_manager is tm)
        finally:
            svc.stop()
    assert out["port"] == out["ref"]
    # ?state= is not a filter in the reference either (ROADMAP Queue C)
    assert out["port"] == ({"scheduled": []}, [{"taskId": "Task_OkTask_0", "type": "OkTask", "state": "WAITING"}], True)
    with urllib.request.urlopen(stack["c_url"] + "/", timeout=10) as r:
        assert r.status == 200 and r.read() == UI_HTML.encode()
    for path in ("/debug/cluster", "/debug/alerts"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(stack["c_url"] + path, timeout=10)
        assert ei.value.code == 404, path
        assert json.loads(ei.value.read()) == {"error": "no ClusterMetricsAggregator registered"}
    req = urllib.request.Request(stack["c_url"] + "/tables/hits/rebalance", data=b"{}", method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        assert json.loads(r.read()) == {"status": "NO_OP", "adds": [], "drops": [], "target": {"hits_0": ["server_0"]}}


# -- client -----------------------------------------------------------------


def test_connect_via_controller_discovery(stack):
    conn = connect(controller_url=stack["c_url"])
    rs = conn.execute("SELECT COUNT(*) FROM hits")
    assert rs.rows[0][0] == 3
    assert rs.execution_stats["numDocsScanned"] == 3


def test_client_sql_error_raises(stack):
    with pytest.raises(PinotClientError):
        connect(stack["b_url"]).execute("SELECT COUNT(*) FROM missing_table")


def test_client_failover_skips_dead_broker(stack):
    conn = connect(["http://127.0.0.1:1", stack["b_url"]])
    assert conn.execute("SELECT COUNT(*) FROM hits").rows[0][0] == 3


def test_client_all_brokers_dead():
    with pytest.raises(PinotClientError, match="unreachable"):
        connect(["http://127.0.0.1:1"]).execute("SELECT 1 FROM t")


def test_cursor_dbapi(stack):
    cur = connect(stack["b_url"]).cursor()
    assert isinstance(cur, Cursor)
    cur.execute("SELECT page, SUM(n) FROM hits GROUP BY page ORDER BY page")
    assert [d[0] for d in cur.description] == ["page", "sum(n)"]
    assert cur.fetchone() == ("a", 4.0)
    assert cur.fetchall() == [("b", 2.0)]
    assert cur.fetchone() is None
    cur.execute("SELECT COUNT(*) FROM hits WHERE page = %s", ("a",))
    assert cur.fetchall() == [(2,)]


def test_resultset_to_pandas(stack):
    df = connect(stack["b_url"]).execute("SELECT page, n FROM hits LIMIT 10").to_pandas()
    assert list(df.columns) == ["page", "n"]
    assert len(df) == 3


# -- CLI --------------------------------------------------------------------


def test_cli_add_table_upload_query(stack, tmp_path):
    schema = Schema.build("clicks", dimensions=[("k", DataType.STRING)], metrics=[("v", DataType.LONG)])
    (tmp_path / "schema.json").write_text(schema.to_json())
    (tmp_path / "table.json").write_text(TableConfig("clicks").to_json())
    c_url = stack["c_url"]
    assert main(["AddTable", "--controller-url", c_url, "--schema-file", str(tmp_path / "schema.json"),
                 "--config-file", str(tmp_path / "table.json")]) == 0
    seg = SegmentBuilder(schema).build(
        {"k": np.array(["x", "y", "x"], dtype=object), "v": np.array([1, 2, 3], dtype=np.int64)}, "clicks_0"
    )
    seg_dir = write_segment(seg, tmp_path / "built")
    assert main(["UploadSegment", "--controller-url", c_url, "--table", "clicks", "--segment-dir", str(seg_dir)]) == 0
    assert main(["PostQuery", "--controller-url", c_url, "--query", "SELECT SUM(v) FROM clicks"]) == 0
    rs = connect(stack["b_url"]).execute("SELECT k, SUM(v) FROM clicks GROUP BY k ORDER BY k")
    assert rs.rows == [["x", 4.0], ["y", 2.0]]


def test_cli_schedule_tasks(stack):
    # controller service in this stack has no task manager -> 404 path, as
    # in the reference's test
    with pytest.raises(RuntimeError, match="404"):
        RemoteControllerClient(stack["c_url"]).schedule_tasks()


REF_CLI = SimpleNamespace(name="ref", cluster=rc, common=r_common, minion=r_minion, tasks=r_tasks,
                          admin=r_admin, http=r_http, server=lambda sid: rc.Server(sid),
                          broker=lambda c: rc.Broker(c), device=[])
PORT_CLI = SimpleNamespace(
    name="port", cluster=__import__("pinot_tpu_torch.cluster", fromlist=["Controller"]),
    common=__import__("pinot_tpu_torch.common", fromlist=["Schema"]), minion=p_minion, tasks=p_tasks,
    admin=p_admin, http=p_http, server=lambda sid: Server(sid, device="cpu"),
    broker=lambda c: Broker(c, device="cpu"), device=["--device", "cpu"])


def _cli_cluster(pkg, root, extra=None):
    """An in-process controller behind its REST service (with a task manager
    and a minion's generators), one server, a `clicks` table."""
    controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / "deep")
    controller.register_server("server_0", pkg.server("server_0"))
    dt = pkg.common.DataType
    controller.add_schema(pkg.common.Schema.build("clicks", dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)]))
    tc = pkg.common.TableConfig("clicks")
    tc.extra = extra or {}
    controller.add_table(tc)
    tm = pkg.minion.PinotTaskManager(controller)
    minion = pkg.tasks.make_minion_with_builtins("minion_0", tm, controller)
    svc = pkg.http.ControllerHTTPService(controller, task_manager=tm)
    return controller, svc, f"http://127.0.0.1:{svc.port}", minion


def _clicks_csv(d: Path, n_files: int) -> Path:
    d.mkdir(parents=True, exist_ok=True)
    for i in range(n_files):
        (d / f"data{i}.csv").write_text("k,v\n" + "".join(f"{'xy'[j % 2]},{j + 10 * i}\n" for j in range(5)))
    return d


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def _cli_quickstart(pkg, root, capsys):
    args = pkg.admin.build_parser().parse_args(["QuickStart", "--rows", "200", "--servers", "1", "--exit",
                                                "--dir", str(root), *pkg.device])
    h = args.fn(args)
    try:
        c_url = f"http://127.0.0.1:{h['services'][0].port}"
        rows = h["broker"].execute("SELECT league, COUNT(*), SUM(runs) FROM baseballStats GROUP BY league ORDER BY league").rows
        rcl = pkg.http.RemoteControllerClient(c_url)
        return rows, rcl.tables(), rcl.schedule_tasks(), "sample query" in capsys.readouterr().out
    finally:
        for svc in h["services"]:
            svc.stop()
        h["minion"].stop()


def _cli_import_data(pkg, root, capsys):
    controller, svc, url, _ = _cli_cluster(pkg, root)
    try:
        assert pkg.admin.main(["ImportData", "--controller-url", url, "--table", "clicks", "--input-dir",
                               str(_clicks_csv(root / "in", 2)), "--pattern", "*.csv"]) == 0
        printed = capsys.readouterr().out.strip().splitlines()[-1]
        return printed, pkg.broker(controller).execute("SELECT k, SUM(v) FROM clicks GROUP BY k ORDER BY k").rows
    finally:
        svc.stop()


def _cli_create_segment(pkg, root, capsys):
    dt = pkg.common.DataType
    (root / "schema.json").parent.mkdir(parents=True, exist_ok=True)
    (root / "schema.json").write_text(
        pkg.common.Schema.build("clicks", dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)]).to_json())
    assert pkg.admin.main(["CreateSegment", "--table", "clicks", "--schema-file", str(root / "schema.json"),
                           "--input-dir", str(_clicks_csv(root / "in", 2)), "--output-dir", str(root / "out"),
                           "--segment-prefix", "made"]) == 0
    dirs = _last_json(capsys)["segments"]
    load = __import__(f"{pkg.cluster.__name__.split('.')[0]}.segment", fromlist=["load_segment"]).load_segment
    return [(Path(d).name, {c: ci.materialize().tolist() for c, ci in load(d).columns.items()}) for d in dirs]


def _cli_distributed(pkg, root, capsys):
    controller, svc, url, _ = _cli_cluster(pkg, root)
    try:
        assert pkg.admin.main(["LaunchDistributedDataIngestionJob", "--controller-url", url, "--table", "clicks",
                               "--input-dir", str(_clicks_csv(root / "in", 3)), "--workers", "2",
                               "--segment-prefix", "dist"]) == 0
        return sorted(_last_json(capsys)["pushed"]), pkg.broker(controller).execute(
            "SELECT k, COUNT(*), SUM(v) FROM clicks GROUP BY k ORDER BY k").rows
    finally:
        svc.stop()


def _cli_schedule(pkg, root, capsys):
    controller, svc, url, minion = _cli_cluster(pkg, root, {"mergeRollup": {"minNumSegments": 2}})
    try:
        seg = __import__(f"{pkg.cluster.__name__.split('.')[0]}.segment", fromlist=["SegmentBuilder"])
        schema = controller.get_schema("clicks")
        for i in range(2):
            controller.upload_segment("clicks", seg.SegmentBuilder(schema).build(
                {"k": np.array(["x", "y"], dtype=object), "v": np.array([i, 5], dtype=np.int64)}, f"clicks_{i}"))
        assert pkg.admin.main(["ScheduleTasks", "--controller-url", url]) == 0
        scheduled = _last_json(capsys)
        minion.run_pending()
        return scheduled, sorted(controller.ideal_state("clicks")), pkg.broker(controller).execute(
            "SELECT k, SUM(v) FROM clicks GROUP BY k ORDER BY k").rows
    finally:
        svc.stop()


A10B_COMMANDS = {
    "QuickStart": _cli_quickstart,
    "ImportData": _cli_import_data,
    "CreateSegment": _cli_create_segment,
    "LaunchDistributedDataIngestionJob": _cli_distributed,
    "ScheduleTasks": _cli_schedule,
}
A10B_EXPECTED = {
    "QuickStart": ([["AL", 202, 13329.0], ["NL", 198, 13774.0]], ["baseballStats"], [], True),
    "ImportData": ("pushed 2 segment(s): ['clicks_0', 'clicks_1']", [["x", 42.0], ["y", 28.0]]),
    "CreateSegment": [("made_0", {"k": ["x", "y", "x", "y", "x"], "v": [0, 1, 2, 3, 4]}),
                      ("made_1", {"k": ["x", "y", "x", "y", "x"], "v": [10, 11, 12, 13, 14]})],
    "LaunchDistributedDataIngestionJob": (["dist_0", "dist_1", "dist_2"], [["x", 9, 108.0], ["y", 6, 72.0]]),
    "ScheduleTasks": ({"scheduled": ["Task_MergeRollupTask_0"]}, ["clicks_merged_0_0"], [["x", 1.0], ["y", 10.0]]),
}


@pytest.mark.parametrize(
    "command",
    ["QuickStart", "ImportData", "CreateSegment", "LaunchDistributedDataIngestionJob", "ScheduleTasks",
     "RebalanceTable", "StartController --ha", "StartController --cold-start", "StartController --with-periodics"],
)
def test_a10_commands_exit_naming_a10(command, tmp_path, request, capsys):
    """Every A10 command runs. The batch-ingestion and minion ones (A10b)
    run through both packages' CLIs, each against its own in-process
    cluster, and answer alike (A10B_COMMANDS); RebalanceTable runs against
    the stack's controller; StartController's --ha, --cold-start and
    --with-periodics start the controller with its election, its cleared
    external views or its periodic scheduler."""
    from pinot_tpu_torch.tools.admin import build_parser

    argv = command.split()
    if argv[0] == "StartController":
        argv += ["--store-dir", str(tmp_path / "s"), "--deep-store", str(tmp_path / "d")]
        args = build_parser().parse_args(argv)
        h = args.fn(args)
        try:
            c = h["controller"]
            assert c.is_leader and c.ha_status()["enabled"] == ("--ha" in argv)
            assert ("periodic_scheduler" in h) == ("--with-periodics" in argv)
            if "--cold-start" in argv:
                assert "cold-start: cleared 0 external views" in capsys.readouterr().out
            if "--with-periodics" in argv:
                assert [t.name for t in h["periodic_scheduler"].tasks] == ["ClusterMetricsAggregator", "IntegrityScrubber"]
        finally:
            if "periodic_scheduler" in h:
                h["periodic_scheduler"].stop()
            h["controller"].stop_ha()
            h["service"].stop()
        return
    if argv[0] == "RebalanceTable":
        argv += ["--controller-url", request.getfixturevalue("stack")["c_url"], "--table", "hits", "--dry-run"]
        capsys.readouterr()
        assert main(argv) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["status"] == "NO_OP"
        return
    out = {}
    for pkg in (REF_CLI, PORT_CLI):
        capsys.readouterr()
        out[pkg.name] = A10B_COMMANDS[argv[0]](pkg, tmp_path / pkg.name, capsys)
    assert out["port"] == out["ref"]
    assert out["port"] == A10B_EXPECTED[argv[0]]


def test_cli_long_tail_commands(stack, tmp_path, capsys):
    """GenerateData -> AddSchema -> AddTable -> UploadSegment ->
    ShowClusterInfo -> VerifySegmentState -> JsonToPinotSchema ->
    DeleteTable/DeleteSchema, each over the live HTTP cluster."""
    import csv

    c_url = stack["c_url"]
    schema_doc = {
        "schemaName": "gen",
        "dimensionFieldSpecs": [{"name": "kind", "dataType": "STRING"}],
        "metricFieldSpecs": [{"name": "value", "dataType": "LONG"}],
    }
    schema_file = tmp_path / "gen_schema.json"
    schema_file.write_text(json.dumps(schema_doc))

    assert main(["GenerateData", "--schema-file", str(schema_file), "--output-dir", str(tmp_path / "gen"),
                 "--rows", "60", "--files", "2"]) == 0
    gen_files = sorted((tmp_path / "gen").glob("*.csv"))
    assert len(gen_files) == 2
    # the same files the reference's GenerateData writes for the same seed
    from pinot_tpu.tools.admin import main as ref_main

    assert ref_main(["GenerateData", "--schema-file", str(schema_file), "--output-dir", str(tmp_path / "ref_gen"),
                     "--rows", "60", "--files", "2"]) == 0
    for f in gen_files:
        assert f.read_text() == (tmp_path / "ref_gen" / f.name).read_text()

    assert main(["AddSchema", "--controller-url", c_url, "--schema-file", str(schema_file)]) == 0
    cfg_file = tmp_path / "gen_table.json"
    cfg_file.write_text(TableConfig("gen").to_json())
    assert main(["AddTable", "--controller-url", c_url, "--schema-file", str(schema_file),
                 "--config-file", str(cfg_file)]) == 0

    # one segment a generated file, built here (CreateSegment is A10), then uploaded
    from pinot_tpu_torch.client import connect as _connect

    schema = Schema.from_json(schema_file.read_text())
    total = 0
    for i, f in enumerate(gen_files):
        rows = list(csv.DictReader(f.open()))
        total += sum(int(r["value"]) for r in rows)
        seg = SegmentBuilder(schema).build(
            {"kind": np.array([r["kind"] for r in rows], dtype=object),
             "value": np.array([int(r["value"]) for r in rows], dtype=np.int64)},
            f"gen_{i}",
        )
        d = write_segment(seg, tmp_path / "segs")
        assert main(["UploadSegment", "--controller-url", c_url, "--table", "gen", "--segment-dir", str(d)]) == 0

    client = RemoteControllerClient(c_url)
    assert "gen" in client.tables()
    assert len(client.all_segment_metadata("gen")) == 2
    assert _connect(stack["b_url"]).execute("SELECT SUM(value) FROM gen").rows[0][0] == total

    capsys.readouterr()
    assert main(["ShowClusterInfo", "--controller-url", c_url]) == 0
    info = json.loads(capsys.readouterr().out)
    assert info["tables"]["gen"] == {"segments": 2}
    assert main(["VerifySegmentState", "--controller-url", c_url, "--table", "gen"]) == 0
    assert json.loads(capsys.readouterr().out)["ok"] is True
    assert main(["ChangeTableState", "--controller-url", c_url, "--table", "gen", "--state", "pause"]) == 0
    assert json.loads(capsys.readouterr().out) == {"status": "ok", "servers": [], "paused": True}

    sample = tmp_path / "sample.jsonl"
    sample.write_text("\n".join(json.dumps({"k": f"a{i}", "v": i, "x": i / 2}) for i in range(5)))
    out_schema = tmp_path / "inferred.json"
    assert main(["JsonToPinotSchema", "--input-file", str(sample), "--output-file", str(out_schema),
                 "--table", "inferred"]) == 0
    inferred = json.loads(out_schema.read_text())
    dims = {d["name"] for d in inferred["dimensionFieldSpecs"]}
    mets = {(m["name"], m["dataType"]) for m in inferred["metricFieldSpecs"]}
    assert dims == {"k"} and mets == {("v", "LONG"), ("x", "DOUBLE")}

    assert main(["DeleteTable", "--controller-url", c_url, "--table", "gen"]) == 0
    assert "gen" not in client.tables()
    assert main(["DeleteSchema", "--controller-url", c_url, "--schema", "gen"]) == 0


def test_delete_schema_guard(stack):
    """DELETE /schemas/{s} refuses while the same-named table exists."""
    with pytest.raises(RuntimeError, match="still used"):
        stack["rc"].delete_schema("hits")


# -- the cluster as OS processes ---------------------------------------------


@pytest.mark.parametrize("sql", PROC_QUERIES)
def test_process_cluster_rows_equal_reference(procs, ref_rows, sql):
    rs = connect(procs["b_url"]).execute(sql)
    assert rs.rows == ref_rows[sql]


def test_process_cluster_via_controller_discovery(procs, ref_rows):
    conn = connect(controller_url=procs["c_url"])
    assert conn.execute(PROC_QUERIES[1]).rows == ref_rows[PROC_QUERIES[1]]
    assert conn.execute("SELECT COUNT(*) FROM events").execution_stats["totalDocs"] == N_SEGS * SEG_ROWS


def test_process_cluster_segment_state(procs):
    ideal = procs["rc"].ideal_state("events")
    assert len(ideal) == N_SEGS and all(len(r) == 2 for r in ideal.values())
    assert main(["VerifySegmentState", "--controller-url", procs["c_url"], "--table", "events"]) == 0


def _exits_without_a_card(command: str) -> None:
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    proc = subprocess.run(
        [sys.executable, "-m", "pinot_tpu_torch.tools.admin", command, "--controller-url", "http://127.0.0.1:1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr and "--device cpu" in proc.stderr
    assert "listening" not in proc.stdout


def test_start_server_without_a_card_exits_non_zero(tmp_path):
    """StartServer's default device is the card: with none it must exit
    non-zero rather than serve on the CPU."""
    _exits_without_a_card("StartServer")


def test_start_broker_without_a_card_exits_non_zero():
    """StartBroker's default device (where its distributed root stage runs)
    is the card: with none it must exit non-zero rather than serve on the
    CPU."""
    _exits_without_a_card("StartBroker")
