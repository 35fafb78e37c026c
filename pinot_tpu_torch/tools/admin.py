"""pinot-tpu-torch-admin: multi-command CLI for cluster ops.

Reference parity: pinot-tools PinotAdministrator
(pinot-tools/.../admin/PinotAdministrator.java:93) subcommands. Roles run as
separate OS processes sharing a file-backed property store path and a
deep-store directory (the ZK + deep-store pair), wired over HTTP. Each
Start* command prints one `... listening on http://127.0.0.1:PORT` line and
serves until it is stopped.

This is the JAX package's `tools/admin.py`. A server holds its segments on
`--device` and a broker runs its distributed root stage there ("cuda" unless
the caller passes "cpu"); with no card and no `--device cpu`, StartServer,
StartBroker and QuickStart exit non-zero instead of serving on the CPU.
StartController runs the control plane as the reference does: --ha joins
the lead-controller election, --cold-start clears stale external views, and
--with-periodics runs the metrics aggregator and the integrity scrubber on
whoever leads. ImportData, CreateSegment and
LaunchDistributedDataIngestionJob run the batch runners of `io/batch.py`
(the last in worker processes that load no torch); ScheduleTasks asks the
controller's task manager to generate minion tasks; QuickStart runs the
all-in-one demo cluster with a minion.

Usage:
    python -m pinot_tpu_torch.tools.admin StartController --store-dir S --deep-store D [--port P] [--ha] [--with-periodics]
    python -m pinot_tpu_torch.tools.admin StartServer --controller-url U [--server-id s1] [--device cpu]
    python -m pinot_tpu_torch.tools.admin StartBroker --controller-url U [--port P] [--device cpu]
    python -m pinot_tpu_torch.tools.admin AddTable --controller-url U --schema-file F --config-file F
    python -m pinot_tpu_torch.tools.admin UploadSegment --controller-url U --table T --segment-dir D
    python -m pinot_tpu_torch.tools.admin PostQuery --broker-url U --query SQL
    python -m pinot_tpu_torch.tools.admin RebalanceTable --controller-url U --table T [--bootstrap]
    python -m pinot_tpu_torch.tools.admin ImportData --controller-url U --table T --input-dir D [--pattern '*.csv']
    python -m pinot_tpu_torch.tools.admin LaunchDistributedDataIngestionJob --controller-url U --table T --input-dir D [--workers 2]
    python -m pinot_tpu_torch.tools.admin ScheduleTasks --controller-url U [--task-type MergeRollupTask]
    python -m pinot_tpu_torch.tools.admin QuickStart [--device cpu] [--exit]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path


def _block(services):
    """Run until interrupted, then stop the services."""
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        pass
    finally:
        for s in services:
            stop = getattr(s, "stop", None)
            if stop:
                stop()


def cmd_start_controller(args) -> dict:
    from pinot_tpu_torch.cluster import Controller, PropertyStore
    from pinot_tpu_torch.cluster.http import ControllerHTTPService

    store = PropertyStore(args.store_dir)
    controller = Controller(store, args.deep_store, controller_id=getattr(args, "controller_id", "controller_0"))
    svc = ControllerHTTPService(controller, port=args.port)
    handles = {"controller": controller, "service": svc}
    if getattr(args, "cold_start", False):
        # DR runbook step: after a full-cluster restart the stored external
        # views describe dead server sessions; clear them so the reconciler
        # re-converges every replica from the deep store
        cleared = controller.reset_external_views()
        print(f"cold-start: cleared {cleared} external views", flush=True)
    if getattr(args, "ha", False):
        # HA: publish this controller's endpoint (leaderUrl hints), then join
        # the lease election. A standby's mutating endpoints 503 with the
        # lead's URL until it wins a takeover; the transition queue, scrubber
        # and aggregator only act on whoever holds the lease.
        controller.register_controller_endpoint("127.0.0.1", svc.port)
        controller.enable_ha(
            lease_ttl=getattr(args, "lease_ttl", 2.0),
            renew_every=getattr(args, "renew_every", 0.4),
        )
    if getattr(args, "with_periodics", False):
        # federated metrics hub: scrape every registered broker/server and
        # serve /debug/cluster + /debug/alerts from this process
        from pinot_tpu_torch.cluster.periodic import (
            ClusterMetricsAggregator,
            IntegrityScrubber,
            PeriodicTaskScheduler,
        )

        objectives = json.loads(args.slo_json) if getattr(args, "slo_json", "") else None
        agg = ClusterMetricsAggregator(controller, objectives=objectives)
        agg.interval_sec = args.metrics_interval
        scrubber = IntegrityScrubber(controller)
        scrubber.interval_sec = args.scrub_interval
        sched = PeriodicTaskScheduler(controller=controller)
        sched.register(agg)
        sched.register(scrubber)
        sched.start()
        handles["periodic_scheduler"] = sched
    print(f"controller listening on http://127.0.0.1:{svc.port}", flush=True)
    return handles


def _card_or_exit(command: str, device: str) -> None:
    """A role that serves on `device`: with "cuda", the card must be there
    (else exit non-zero) and the kernels load before any traffic (a build
    cached by digest in pinot_tpu_torch/_build/ loads at once, a missing one
    compiles)."""
    import torch

    if torch.device(device).type != "cuda":
        return
    if not torch.cuda.is_available():
        raise SystemExit(
            f"{command} --device {device}: no CUDA device is available; pass --device cpu to serve on the CPU"
        )
    from pinot_tpu_torch.ops import build

    for name in build.KERNEL_SOURCES:
        build.load(name)


def cmd_start_server(args) -> dict:
    from pinot_tpu_torch.cluster import Server
    from pinot_tpu_torch.cluster.http import RemoteControllerClient, ServerHTTPService
    from pinot_tpu_torch.common.config import SchedulerConfig

    _card_or_exit("StartServer", args.device)

    scheduler = (
        SchedulerConfig(kind=args.scheduler, num_runners=args.runners)
        if args.scheduler
        else None
    )
    server = Server(
        args.server_id,
        device=args.device,
        scheduler=scheduler,
        data_dir=getattr(args, "data_dir", None) or None,
    )
    svc = ServerHTTPService(server, port=args.port)
    RemoteControllerClient(args.controller_url).register_instance(
        "server", args.server_id, "127.0.0.1", svc.port
    )
    print(f"server {args.server_id} listening on http://127.0.0.1:{svc.port}", flush=True)
    return {"server": server, "service": svc}


def cmd_start_broker(args) -> dict:
    import json as _json

    import torch

    from pinot_tpu_torch.cluster.broker import Broker
    from pinot_tpu_torch.cluster.failure import FailureDetector
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, RemoteControllerClient
    from pinot_tpu_torch.common.config import CacheConfig, ResilienceConfig, SchedulerConfig

    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(
            f"StartBroker --device {args.device}: no CUDA device is available; pass --device cpu to serve on the CPU"
        )
    rc = RemoteControllerClient(args.controller_url)
    # --scheduler-json takes SchedulerConfig camelCase keys, e.g.
    # '{"numRunners": 16, "shedHeadroom": 0.8, "tenantQps": {"T": 50}}';
    # empty string keeps the admission tier at defaults
    sched_cfg = (
        SchedulerConfig.from_dict(_json.loads(args.scheduler_json))
        if getattr(args, "scheduler_json", "")
        else None
    )
    # --resilience-json takes ResilienceConfig camelCase keys, e.g.
    # '{"hedgeEnabled": true, "hedgeDelayFactor": 3.0}'; empty string keeps
    # timeouts/hedging at defaults
    res_cfg = (
        ResilienceConfig.from_dict(_json.loads(args.resilience_json))
        if getattr(args, "resilience_json", "")
        else None
    )
    # --cache-json takes CacheConfig camelCase keys, e.g.
    # '{"maxBytes": 134217728, "realtimeTtlMs": 100}' or
    # '{"enabled": false}'; empty string keeps the cache plane at defaults (ON)
    cache_cfg = (
        CacheConfig.from_dict(_json.loads(args.cache_json))
        if getattr(args, "cache_json", "")
        else None
    )
    # a standalone broker process always runs a failure detector: without
    # one, a dead server is a hard query error instead of routing exclusion
    # plus one-round replica failover
    broker = Broker(
        rc,
        scheduler_config=sched_cfg,
        resilience=res_cfg,
        cache_config=cache_cfg,
        max_scatter_threads=args.scatter_threads,
        failure_detector=FailureDetector(),
        device=args.device,
    )
    svc = BrokerHTTPService(broker, port=args.port)
    rc.register_instance("broker", args.broker_id, "127.0.0.1", svc.port)
    print(f"broker listening on http://127.0.0.1:{svc.port}", flush=True)
    return {"broker": broker, "service": svc}


def cmd_add_table(args) -> dict:
    from pinot_tpu_torch.cluster.http import RemoteControllerClient
    from pinot_tpu_torch.common.config import TableConfig
    from pinot_tpu_torch.common.types import Schema

    rc = RemoteControllerClient(args.controller_url)
    schema = Schema.from_json(Path(args.schema_file).read_text())
    config = TableConfig.from_json(Path(args.config_file).read_text())
    rc.add_schema(schema)
    rc.add_table(config)
    print(f"added table {config.table_name}", flush=True)
    return {"table": config.table_name}


def cmd_import_data(args) -> dict:
    """Build segments locally from input files and push them
    (LaunchDataIngestionJob standalone parity)."""
    import tempfile

    from pinot_tpu_torch.cluster.http import RemoteControllerClient
    from pinot_tpu_torch.common.types import Schema
    from pinot_tpu_torch.io.batch import SegmentGenerationJobSpec, run_segment_generation_job

    rc = RemoteControllerClient(args.controller_url)
    schema_doc = rc._get(f"/tables/{args.table}/schema")
    schema = Schema.from_json(json.dumps(schema_doc))
    with tempfile.TemporaryDirectory() as tmp:
        spec = SegmentGenerationJobSpec(
            table_name=args.table,
            schema=schema,
            input_dir_uri=args.input_dir,
            include_file_name_pattern=args.pattern,
            input_format=args.format,
            output_dir_uri=tmp,
            segment_name_prefix=args.segment_prefix or args.table,
        )
        files: list[dict] = []
        seg_dirs = run_segment_generation_job(spec, report=files)
        pushed = []
        for d, f in zip(seg_dirs, files):
            t0 = time.perf_counter()
            pushed.append(rc.upload_segment_dir(args.table, d)["segment"])
            f["push_s"] = time.perf_counter() - t0
    print(f"pushed {len(pushed)} segment(s): {pushed}", flush=True)
    return {"pushed": pushed, "files": files}


def cmd_post_query(args) -> dict:
    from pinot_tpu_torch.client import connect

    conn = (
        connect(controller_url=args.controller_url)
        if args.controller_url
        else connect(args.broker_url)
    )
    rs = conn.execute(args.query)
    out = {"columns": rs.columns, "rows": rs.rows, **rs.execution_stats}
    print(json.dumps(out, default=str), flush=True)
    return out


def cmd_schedule_tasks(args) -> dict:
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    scheduled = RemoteControllerClient(args.controller_url).schedule_tasks(args.task_type)
    print(json.dumps({"scheduled": scheduled}), flush=True)
    return {"scheduled": scheduled}


def cmd_rebalance_table(args) -> dict:
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    out = RemoteControllerClient(args.controller_url).rebalance_table(
        args.table,
        dry_run=args.dry_run,
        drain_grace_sec=args.drain_grace_sec,
        bootstrap=args.bootstrap,
    )
    print(json.dumps(out), flush=True)
    return out


def cmd_add_schema(args) -> dict:
    from pinot_tpu_torch.cluster.http import RemoteControllerClient
    from pinot_tpu_torch.common.types import Schema

    schema = Schema.from_json(Path(args.schema_file).read_text())
    RemoteControllerClient(args.controller_url).add_schema(schema)
    print(f"added schema {schema.name}", flush=True)
    return {"schema": schema.name}


def cmd_delete_table(args) -> dict:
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    out = RemoteControllerClient(args.controller_url).delete_table(args.table)
    print(json.dumps(out), flush=True)
    return out


def cmd_delete_schema(args) -> dict:
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    out = RemoteControllerClient(args.controller_url).delete_schema(args.schema)
    print(json.dumps(out), flush=True)
    return out


def cmd_upload_segment(args) -> dict:
    """Push an already-built segment directory (UploadSegmentCommand)."""
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    rc = RemoteControllerClient(args.controller_url)
    out = rc.upload_segment_dir(args.table, args.segment_dir)
    print(json.dumps(out), flush=True)
    return out


def cmd_create_segment(args) -> dict:
    """Build segments from input files into an output dir WITHOUT pushing
    (CreateSegmentCommand parity)."""
    from pinot_tpu_torch.common.types import Schema
    from pinot_tpu_torch.io.batch import SegmentGenerationJobSpec, run_segment_generation_job

    schema = Schema.from_json(Path(args.schema_file).read_text())
    spec = SegmentGenerationJobSpec(
        table_name=args.table,
        schema=schema,
        input_dir_uri=args.input_dir,
        include_file_name_pattern=args.pattern,
        input_format=args.format,
        output_dir_uri=args.output_dir,
        segment_name_prefix=args.segment_prefix or args.table,
    )
    dirs = run_segment_generation_job(spec)
    print(json.dumps({"segments": dirs}), flush=True)
    return {"segments": dirs}


def cmd_launch_distributed_job(args) -> dict:
    """Distributed ingestion job over worker processes
    (LaunchSparkDataIngestionJobCommand analog on the local-process tier)."""
    from pinot_tpu_torch.cluster.http import RemoteControllerClient
    from pinot_tpu_torch.io.batch import (
        SegmentGenerationJobSpec,
        run_distributed_segment_generation_job,
    )

    rc = RemoteControllerClient(args.controller_url)
    schema = rc.get_schema(args.table)
    if schema is None:
        raise SystemExit(f"no schema for table {args.table!r} on {args.controller_url}")
    spec = SegmentGenerationJobSpec(
        table_name=args.table,
        schema=schema,
        input_dir_uri=args.input_dir,
        job_type="SegmentCreationAndTarPush",
        include_file_name_pattern=args.pattern,
        input_format=args.format,
        segment_name_prefix=args.segment_prefix or args.table,
    )
    files: list[dict] = []
    names = run_distributed_segment_generation_job(
        spec, n_workers=args.workers, controller_url=args.controller_url, report=files
    )
    print(json.dumps({"pushed": names}), flush=True)
    return {"pushed": names, "files": files}


def cmd_generate_data(args) -> dict:
    """Write demo CSV files for a schema (GenerateDataCommand parity):
    strings draw from a small token pool, numerics uniform."""
    import numpy as np

    from pinot_tpu_torch.common.types import DataType, Schema

    schema = Schema.from_json(Path(args.schema_file).read_text())
    rng = np.random.default_rng(args.seed)
    outdir = Path(args.output_dir)
    outdir.mkdir(parents=True, exist_ok=True)
    rows_per = -(-args.rows // args.files)
    written = []
    for f in range(args.files):
        n = min(rows_per, args.rows - f * rows_per)
        if n <= 0:
            break
        cols = {}
        for name, spec in schema.fields.items():
            dt = spec.data_type
            if dt == DataType.STRING:
                cols[name] = [f"{name}_{int(x)}" for x in rng.integers(0, args.cardinality, n)]
            elif dt in (DataType.FLOAT, DataType.DOUBLE):
                cols[name] = np.round(rng.uniform(0, 1000, n), 3)
            else:
                cols[name] = rng.integers(0, 100_000, n)
        path = outdir / f"generated_{f}.csv"
        header = ",".join(schema.fields)
        lines = [header] + [
            ",".join(str(cols[c][i]) for c in schema.fields) for i in range(n)
        ]
        path.write_text("\n".join(lines) + "\n")
        written.append(str(path))
    print(json.dumps({"files": written}), flush=True)
    return {"files": written}


def cmd_show_cluster_info(args) -> dict:
    """Cluster summary (ShowClusterInfoCommand parity)."""
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    rc = RemoteControllerClient(args.controller_url)
    tables = rc.tables()
    info = {
        "tables": {
            t: {"segments": len(rc.all_segment_metadata(t))} for t in tables
        },
        "brokers": rc.brokers(),
        "instances": {k: v for k, v in rc._get("/instances").items()},
    }
    print(json.dumps(info, default=str), flush=True)
    return info


def cmd_verify_segment_state(args) -> dict:
    """Ideal state vs live server state (VerifySegmentState parity):
    reports segments whose assigned replicas don't host them."""
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    rc = RemoteControllerClient(args.controller_url)
    servers = rc.servers()
    hosted: dict[str, set] = {}
    unreachable: list[str] = []
    for sid, handle in servers.items():
        try:
            hosted[sid] = set(handle.segments_of(args.table))
        except Exception:
            unreachable.append(sid)
    mismatches = []
    for seg, owners in rc.ideal_state(args.table).items():
        owner_ids = owners if isinstance(owners, list) else list(owners)
        for sid in owner_ids:
            if sid in unreachable:
                continue  # reported separately — down != drifted
            if sid not in servers:
                # registered without a reachable data-plane port (e.g. an
                # in-process quickstart role): can't be verified from here
                if sid not in unreachable:
                    unreachable.append(sid)
                continue
            if seg not in hosted.get(sid, set()):
                mismatches.append({"segment": seg, "server": sid})
    out = {
        "table": args.table,
        "mismatches": mismatches,
        "unreachableServers": sorted(unreachable),
        "ok": not mismatches and not unreachable,
    }
    print(json.dumps(out), flush=True)
    return out


def cmd_change_table_state(args) -> dict:
    """Pause/resume realtime consumption (ChangeTableState parity over the
    pause/resume REST endpoints)."""
    from pinot_tpu_torch.cluster.http import RemoteControllerClient

    rc = RemoteControllerClient(args.controller_url)
    action = "pauseConsumption" if args.state == "pause" else "resumeConsumption"
    out = rc._post(f"/tables/{args.table}/{action}", b"{}")
    print(json.dumps(out), flush=True)
    return out


def cmd_json_to_schema(args) -> dict:
    """Infer a schema from a JSON-lines sample (JsonToPinotSchema parity):
    strings -> dimensions, integral -> LONG metrics, floats -> DOUBLE."""
    sample = [
        json.loads(line)
        for line in Path(args.input_file).read_text().splitlines()
        if line.strip()
    ][: args.sample_rows]
    if not sample:
        raise ValueError(f"no JSON rows in {args.input_file}")
    dims, metrics = [], []
    keys: dict[str, None] = {}  # union of keys over the sample, first-seen order
    for row in sample:
        for k in row:
            keys.setdefault(k)
    for key in keys:
        vals = [row.get(key) for row in sample if row.get(key) is not None]
        if not vals:
            # all-null in the sample: STRING dimension is the safe default
            dims.append((key, "STRING"))
        elif all(isinstance(v, bool) for v in vals):
            metrics.append((key, "INT"))
        elif all(isinstance(v, int) and not isinstance(v, bool) for v in vals):
            metrics.append((key, "LONG"))
        elif all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in vals):
            metrics.append((key, "DOUBLE"))
        else:
            dims.append((key, "STRING"))
    doc = {
        "schemaName": args.table or Path(args.input_file).stem,
        "dimensionFieldSpecs": [{"name": n, "dataType": t} for n, t in dims],
        "metricFieldSpecs": [{"name": n, "dataType": t} for n, t in metrics],
    }
    text = json.dumps(doc, indent=2)
    if args.output_file:
        Path(args.output_file).write_text(text)
    print(text, flush=True)
    return doc


def cmd_quickstart(args) -> dict:
    """All-in-one in-process cluster with a sample table
    (QuickStartCommand parity: baseballStats-flavored demo data), its
    servers and broker on `--device`, a minion on a thread."""
    import tempfile

    import numpy as np

    from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server
    from pinot_tpu_torch.cluster.http import BrokerHTTPService, ControllerHTTPService, ServerHTTPService
    from pinot_tpu_torch.common import DataType, Schema, TableConfig
    from pinot_tpu_torch.minion import PinotTaskManager
    from pinot_tpu_torch.minion.tasks import make_minion_with_builtins
    from pinot_tpu_torch.segment import SegmentBuilder

    _card_or_exit("QuickStart", args.device)
    workdir = Path(args.dir) if args.dir else Path(tempfile.mkdtemp(prefix="pinot-tpu-quickstart-"))
    controller = Controller(PropertyStore(workdir / "store"), workdir / "deepstore")
    tm = PinotTaskManager(controller)
    minion = make_minion_with_builtins("minion_0", tm, controller)
    servers = {}
    for i in range(args.servers):
        sid = f"server_{i}"
        servers[sid] = Server(sid, device=args.device)
        controller.register_server(sid, servers[sid])

    schema = Schema.build(
        "baseballStats",
        dimensions=[("playerName", DataType.STRING), ("teamID", DataType.STRING), ("league", DataType.STRING)],
        metrics=[("runs", DataType.LONG), ("homeRuns", DataType.LONG)],
        date_times=[("yearID", DataType.INT)],
    )
    controller.add_schema(schema)
    controller.add_table(TableConfig("baseballStats", time_column="yearID"))

    rng = np.random.default_rng(7)
    n = args.rows
    builder = SegmentBuilder(schema)
    teams = np.array(["BOS", "NYA", "CHA", "SFN", "LAN", "SLN"], dtype=object)
    for i in range(2):
        data = {
            "playerName": np.array([f"player {j:04d}" for j in rng.integers(0, max(n // 4, 1), n)], dtype=object),
            "teamID": teams[rng.integers(0, len(teams), n)],
            "league": np.array(["NL", "AL"], dtype=object)[rng.integers(0, 2, n)],
            "runs": rng.integers(0, 130, n).astype(np.int64),
            "homeRuns": rng.integers(0, 45, n).astype(np.int64),
            "yearID": rng.integers(1990, 2024, n).astype(np.int32),
        }
        controller.upload_segment("baseballStats", builder.build(data, f"baseballStats_{i}"))

    broker = Broker(controller, device=args.device)
    c_svc = ControllerHTTPService(controller, port=args.controller_port, task_manager=tm)
    b_svc = BrokerHTTPService(broker, port=args.broker_port)
    s_svcs = [ServerHTTPService(s, port=0) for s in servers.values()]
    controller.register_broker("broker_0", "127.0.0.1", b_svc.port)
    minion.start(poll_interval=0.5)

    sample = "SELECT league, SUM(runs) FROM baseballStats GROUP BY league ORDER BY SUM(runs) DESC LIMIT 10"
    res = broker.execute(sample)
    print(f"controller: http://127.0.0.1:{c_svc.port}")
    print(f"broker:     http://127.0.0.1:{b_svc.port}  (POST /query/sql)")
    print(f"sample query: {sample}")
    print(res, flush=True)
    handles = {
        "controller": controller,
        "broker": broker,
        "servers": servers,
        "minion": minion,
        "services": [c_svc, b_svc, *s_svcs],
        "workdir": workdir,
        "sample": res,
    }
    return handles


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="pinot-tpu-torch-admin", description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("QuickStart", help="all-in-one demo cluster")
    q.add_argument("--rows", type=int, default=1000)
    q.add_argument("--servers", type=int, default=2)
    q.add_argument("--dir", default=None)
    q.add_argument("--controller-port", type=int, default=0)
    q.add_argument("--broker-port", type=int, default=0)
    q.add_argument(
        "--device",
        default="cuda",
        help="where the servers stage and run their segments (default cuda; cpu to run without a card)",
    )
    q.add_argument("--exit", action="store_true", help="exit after sample query (tests)")
    q.set_defaults(fn=cmd_quickstart, blocking=True)

    c = sub.add_parser("StartController")
    c.add_argument("--store-dir", required=True)
    c.add_argument("--deep-store", required=True)
    c.add_argument("--port", type=int, default=0)
    c.add_argument("--controller-id", default="controller_0")
    c.add_argument(
        "--ha",
        action="store_true",
        help="join lead-controller election over the shared store; standbys "
        "503 mutating endpoints with a leaderUrl hint until they take over",
    )
    c.add_argument("--lease-ttl", type=float, default=2.0, help="lead lease TTL seconds (with --ha)")
    c.add_argument("--renew-every", type=float, default=0.4, help="lease renew period seconds (with --ha)")
    c.add_argument(
        "--cold-start",
        action="store_true",
        help="full-cluster restart recovery: clear stale external views so "
        "the reconciler re-converges every replica from the deep store",
    )
    c.add_argument(
        "--with-periodics",
        action="store_true",
        help="run the ClusterMetricsAggregator scrape loop (serves /debug/cluster)",
    )
    c.add_argument("--metrics-interval", type=float, default=10.0)
    c.add_argument(
        "--scrub-interval",
        type=float,
        default=30.0,
        help="IntegrityScrubber period in seconds (with --with-periodics)",
    )
    c.add_argument(
        "--slo-json",
        default="",
        help='SLO objectives as camelCase JSON, e.g. \'{"freshnessP99Ms": 2000}\'',
    )
    c.set_defaults(fn=cmd_start_controller, blocking=True)

    s = sub.add_parser("StartServer")
    s.add_argument(
        "--controller-url",
        required=True,
        help="controller URL(s); comma-separate HA candidates for failover",
    )
    s.add_argument("--server-id", default="server_0")
    s.add_argument("--port", type=int, default=0)
    s.add_argument(
        "--device",
        default="cuda",
        help="where the server stages and runs its segments (default cuda; cpu to serve without a card)",
    )
    s.add_argument("--scheduler", default="", help="fcfs|priority|binary_workload (default: none)")
    s.add_argument("--runners", type=int, default=4)
    s.add_argument(
        "--data-dir",
        default="",
        help="local segment dir: download deep-store segments here, verify "
        "CRCs, self-heal corrupted copies (empty: serve deep store directly)",
    )
    s.set_defaults(fn=cmd_start_server, blocking=True)

    b = sub.add_parser("StartBroker")
    b.add_argument(
        "--controller-url",
        required=True,
        help="controller URL(s); comma-separate HA candidates for failover",
    )
    b.add_argument("--broker-id", default="broker_0")
    b.add_argument("--port", type=int, default=0)
    b.add_argument(
        "--device",
        default="cuda",
        help="where the distributed multistage route runs its root stage (default cuda; cpu without a card)",
    )
    b.add_argument(
        "--scheduler-json",
        default="",
        help='SchedulerConfig overrides as camelCase JSON, e.g. \'{"numRunners": 16}\'',
    )
    b.add_argument(
        "--resilience-json",
        default="",
        help='ResilienceConfig overrides as camelCase JSON, e.g. \'{"hedgeEnabled": true}\'',
    )
    b.add_argument(
        "--cache-json",
        default="",
        help='CacheConfig overrides as camelCase JSON, e.g. \'{"maxBytes": 134217728}\' '
        'or \'{"enabled": false}\' (cache plane defaults ON)',
    )
    b.add_argument("--scatter-threads", type=int, default=8)
    b.set_defaults(fn=cmd_start_broker, blocking=True)

    a = sub.add_parser("AddTable")
    a.add_argument("--controller-url", required=True)
    a.add_argument("--schema-file", required=True)
    a.add_argument("--config-file", required=True)
    a.set_defaults(fn=cmd_add_table, blocking=False)

    i = sub.add_parser("ImportData")
    i.add_argument("--controller-url", required=True)
    i.add_argument("--table", required=True)
    i.add_argument("--input-dir", required=True)
    i.add_argument("--pattern", default="*")
    i.add_argument("--format", default=None)
    i.add_argument("--segment-prefix", default=None)
    i.set_defaults(fn=cmd_import_data, blocking=False)

    pq = sub.add_parser("PostQuery")
    pq.add_argument("--broker-url", default=None)
    pq.add_argument("--controller-url", default=None)
    pq.add_argument("--query", required=True)
    pq.set_defaults(fn=cmd_post_query, blocking=False)

    st = sub.add_parser("ScheduleTasks")
    st.add_argument("--controller-url", required=True)
    st.add_argument("--task-type", default=None)
    st.set_defaults(fn=cmd_schedule_tasks, blocking=False)

    rb = sub.add_parser("RebalanceTable")
    rb.add_argument("--controller-url", required=True)
    rb.add_argument("--table", required=True)
    rb.add_argument("--dry-run", action="store_true")
    rb.add_argument(
        "--drain-grace-sec",
        type=float,
        default=0.0,
        help="pause after de-routing each replaced replica before removing it",
    )
    rb.add_argument(
        "--bootstrap",
        action="store_true",
        help="converge to a load-balanced placement (moves replicas off "
        "over-the-ceiling servers) instead of pure minimal movement",
    )
    rb.set_defaults(fn=cmd_rebalance_table, blocking=False)

    asch = sub.add_parser("AddSchema")
    asch.add_argument("--controller-url", required=True)
    asch.add_argument("--schema-file", required=True)
    asch.set_defaults(fn=cmd_add_schema, blocking=False)

    dt = sub.add_parser("DeleteTable")
    dt.add_argument("--controller-url", required=True)
    dt.add_argument("--table", required=True)
    dt.set_defaults(fn=cmd_delete_table, blocking=False)

    ds = sub.add_parser("DeleteSchema")
    ds.add_argument("--controller-url", required=True)
    ds.add_argument("--schema", required=True)
    ds.set_defaults(fn=cmd_delete_schema, blocking=False)

    us = sub.add_parser("UploadSegment")
    us.add_argument("--controller-url", required=True)
    us.add_argument("--table", required=True)
    us.add_argument("--segment-dir", required=True)
    us.set_defaults(fn=cmd_upload_segment, blocking=False)

    cs = sub.add_parser("CreateSegment")
    cs.add_argument("--table", required=True)
    cs.add_argument("--schema-file", required=True)
    cs.add_argument("--input-dir", required=True)
    cs.add_argument("--output-dir", required=True)
    cs.add_argument("--pattern", default="*")
    cs.add_argument("--format", default=None)
    cs.add_argument("--segment-prefix", default=None)
    cs.set_defaults(fn=cmd_create_segment, blocking=False)

    dj = sub.add_parser("LaunchDistributedDataIngestionJob")
    dj.add_argument("--controller-url", required=True)
    dj.add_argument("--table", required=True)
    dj.add_argument("--input-dir", required=True)
    dj.add_argument("--pattern", default="*")
    dj.add_argument("--format", default=None)
    dj.add_argument("--segment-prefix", default=None)
    dj.add_argument("--workers", type=int, default=2)
    dj.set_defaults(fn=cmd_launch_distributed_job, blocking=False)

    gd = sub.add_parser("GenerateData")
    gd.add_argument("--schema-file", required=True)
    gd.add_argument("--output-dir", required=True)
    gd.add_argument("--rows", type=int, default=1000)
    gd.add_argument("--files", type=int, default=1)
    gd.add_argument("--cardinality", type=int, default=50)
    gd.add_argument("--seed", type=int, default=0)
    gd.set_defaults(fn=cmd_generate_data, blocking=False)

    ci = sub.add_parser("ShowClusterInfo")
    ci.add_argument("--controller-url", required=True)
    ci.set_defaults(fn=cmd_show_cluster_info, blocking=False)

    vs = sub.add_parser("VerifySegmentState")
    vs.add_argument("--controller-url", required=True)
    vs.add_argument("--table", required=True)
    vs.set_defaults(fn=cmd_verify_segment_state, blocking=False)

    ct = sub.add_parser("ChangeTableState")
    ct.add_argument("--controller-url", required=True)
    ct.add_argument("--table", required=True)
    ct.add_argument("--state", choices=["pause", "resume"], required=True)
    ct.set_defaults(fn=cmd_change_table_state, blocking=False)

    js = sub.add_parser("JsonToPinotSchema")
    js.add_argument("--input-file", required=True)
    js.add_argument("--output-file", default=None)
    js.add_argument("--table", default=None)
    js.add_argument("--sample-rows", type=int, default=200)
    js.set_defaults(fn=cmd_json_to_schema, blocking=False)

    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    handles = args.fn(args)
    if args.blocking and not getattr(args, "exit", False):
        _block(handles.get("services") or [handles["service"]])
    elif getattr(args, "exit", False):
        for s in handles.get("services", []):
            s.stop()
        m = handles.get("minion")
        if m:
            m.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
