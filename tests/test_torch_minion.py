"""The port's minion framework, segment processing and built-in tasks
against the JAX package's.

The corpus is tests/test_minion.py's 15 cases, each run through both
packages on the same seeded inputs, plus rollup and dedup edge cases where
the reference's pandas reduce and the port's numpy one could part: a
DOUBLE dimension holding NaN, a metric group that is all NaN, an int32 SUM
that wraps, no dimensions, DEDUP's row order, float sums that Kahan
compensation changes, signed zeros, and a split over several partitions.
Every output segment must hold the reference's columns bit for bit (dtype
and bytes; NaN where the reference has NaN), in the reference's row order.
"""

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.minion as r_minion
import pinot_tpu.minion.tasks as r_tasks
import pinot_tpu.segment as r_segment
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.minion as p_minion
import pinot_tpu_torch.minion.tasks as p_tasks
import pinot_tpu_torch.segment as p_segment

REPO = Path(__file__).resolve().parents[1]

REF = SimpleNamespace(name="ref", cluster=r_cluster, common=r_common, minion=r_minion, tasks=r_tasks,
                      segment=r_segment, server=lambda sid: r_cluster.Server(sid),
                      broker=lambda c: r_cluster.Broker(c))
PORT = SimpleNamespace(name="port", cluster=p_cluster, common=p_common, minion=p_minion, tasks=p_tasks,
                       segment=p_segment, server=lambda sid: p_cluster.Server(sid, device="cpu"),
                       broker=lambda c: p_cluster.Broker(c, device="cpu"))
PKGS = (REF, PORT)


def _schema(pkg, name="events", dims=(("kind", "STRING"),), metrics=(("value", "LONG"),),
            date_times=(("ts", "LONG"),), pk=()):
    dt = pkg.common.DataType
    return pkg.common.Schema.build(
        name,
        dimensions=[(n, getattr(dt, t)) for n, t in dims],
        metrics=[(n, getattr(dt, t)) for n, t in metrics],
        date_times=[(n, getattr(dt, t)) for n, t in date_times],
        primary_key_columns=list(pk),
    )


def _events(kinds, values, ts=None):
    return {
        "kind": np.asarray(kinds, dtype=object),
        "value": np.asarray(values, dtype=np.int64),
        "ts": np.asarray(ts if ts is not None else np.zeros(len(values)), dtype=np.int64),
    }


def _seg(pkg, schema, name, data):
    return pkg.segment.SegmentBuilder(schema).build(data, name)


def _same_column(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit-equal: the same dtype and bytes; objects equal one by one, NaN
    equal to NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == object:
        return all(
            type(x) is type(y) and (x == y or (isinstance(x, float) and x != x and y != y))
            if not isinstance(x, np.ndarray) else np.array_equal(x, y)
            for x, y in zip(a, b)
        )
    return a.tobytes() == b.tobytes()


def _columns(seg) -> dict:
    return {c: ci.materialize() for c, ci in seg.columns.items()}


def assert_same_segments(ref_segs, port_segs):
    assert [(s.name, s.n_docs) for s in port_segs] == [(s.name, s.n_docs) for s in ref_segs]
    for r, p in zip(ref_segs, port_segs):
        rc, pc = _columns(r), _columns(p)
        assert list(pc) == list(rc)
        for c in rc:
            assert _same_column(rc[c], pc[c]), (r.name, c, rc[c][:8], pc[c][:8])


def _process(schema_kw, parts, **cfg):
    """process_segments through both packages over the same parts: the
    output segments of each (compared bit for bit by the caller)."""
    out = {}
    for pkg in PKGS:
        schema = _schema(pkg, **schema_kw)
        segs = [_seg(pkg, schema, f"in_{i}", d) for i, d in enumerate(parts)]
        out[pkg.name] = pkg.minion.process_segments(segs, pkg.minion.SegmentProcessorConfig(schema=schema, **cfg))
    assert_same_segments(out["ref"], out["port"])
    return out["port"]


# -- segment processing framework (tests/test_minion.py) ---------------------


def test_process_concat_and_split():
    out = _process({}, [_events(["x", "y"], [1, 2]), _events(["z"], [3])], max_rows_per_segment=2)
    assert [s.n_docs for s in out] == [2, 1]


def test_process_rollup():
    [seg] = _process({}, [_events(["x", "x", "y"], [1, 2, 5], ts=[10, 10, 10])], merge_type="ROLLUP",
                     time_column="ts")
    assert dict(zip(seg.columns["kind"].materialize(), seg.columns["value"].materialize())) == {"x": 3, "y": 5}


def test_process_rollup_min_max():
    [seg] = _process({}, [_events(["x", "x"], [4, 9], ts=[1, 1])], merge_type="ROLLUP", time_column="ts",
                     rollup_aggregates={"value": "MAX"})
    assert list(seg.columns["value"].materialize()) == [9]


def test_process_time_window_filter():
    [seg] = _process({}, [_events(["x", "y", "z"], [1, 2, 3], ts=[5, 15, 25])], time_column="ts",
                     window_start=10, window_end=20)
    assert list(seg.columns["kind"].materialize()) == ["y"]


def test_process_partition():
    out = _process({}, [_events(["x"] * 10, list(range(10)), ts=list(range(10)))], partition_column="ts",
                   num_partitions=2)
    assert len(out) == 2 and sum(s.n_docs for s in out) == 10
    for seg in out:
        assert len({t % 2 for t in seg.columns["ts"].materialize()}) == 1


def test_process_dedup():
    [seg] = _process({}, [_events(["x", "x", "y"], [7, 7, 8], ts=[1, 1, 2])], merge_type="DEDUP", time_column="ts")
    assert seg.n_docs == 2


# -- the reduce's edge cases (pandas' semantics in numpy) ---------------------

WIDE = {
    "dims": (("k", "STRING"), ("d", "DOUBLE"), ("i", "INT")),
    "metrics": (("m32", "INT"), ("f", "DOUBLE"), ("f32", "FLOAT"), ("l", "LONG")),
    "date_times": (),
}


def _wide(n, seed):
    rng = np.random.default_rng(seed)
    d = np.round(rng.normal(size=n), 1)
    d[rng.random(n) < 0.05] = np.nan  # NaN keys: pandas' dropna drops their rows
    d[rng.random(n) < 0.05] = -0.0  # -0.0 and 0.0 are one key
    f = rng.normal(size=n) * 10.0 ** rng.integers(-8, 16, n)
    f[rng.random(n) < 0.1] = np.nan
    return {
        "k": np.array(["a", "b", "c", "dd", "aé"], dtype=object)[rng.integers(0, 5, n)],
        "d": d,
        "i": rng.integers(0, 5, n).astype(np.int32),
        "m32": rng.integers(2**28, 2**31 - 1, n).astype(np.int32),  # every group's SUM wraps in int32
        "f": f,
        "f32": (rng.normal(size=n) * 10.0 ** rng.integers(-3, 6, n)).astype(np.float32),
        "l": rng.integers(-(10**15), 10**15, n),
    }


@pytest.mark.parametrize(
    "aggregates",
    [{}, {"f": "MIN", "f32": "MAX", "l": "MIN", "m32": "MAX"}, {"f": "MAX", "f32": "MIN", "l": "COUNT"}],
    ids=["sum", "min_max", "max_min_count"],
)
def test_rollup_double_dimension_with_nan(aggregates):
    """Groups in sorted order of (k, d, i), NaN keys dropped, -0.0 and 0.0
    one group shown as the first seen; int32 sums wrap; float sums are
    Kahan-compensated in row order; MIN / MAX skip NaN."""
    out = _process(WIDE, [_wide(4000, 2), _wide(3000, 3)], merge_type="ROLLUP", rollup_aggregates=aggregates)
    [seg] = out
    assert not np.isnan(seg.columns["d"].materialize()).any()


def test_rollup_all_nan_metric_group():
    """A group whose metric is all NaN: NaN for MIN and MAX, 0 for SUM."""
    data = {"k": np.array(["x", "x", "y", "y", "z"], dtype=object),
            "f": np.array([np.nan, np.nan, 1.5, np.nan, -2.0]),
            "g": np.array([np.nan, np.nan, 3.0, 4.0, np.nan]),
            "h": np.array([np.nan, np.nan, 0.0, -0.0, -0.0])}
    kw = {"dims": (("k", "STRING"),), "metrics": (("f", "DOUBLE"), ("g", "DOUBLE"), ("h", "DOUBLE")),
          "date_times": ()}
    [seg] = _process(kw, [data], merge_type="ROLLUP", rollup_aggregates={"g": "MIN", "h": "MAX"})
    assert seg.columns["f"].materialize().tolist() == [0.0, 1.5, -2.0]
    g = seg.columns["g"].materialize()
    assert np.isnan(g[0]) and g[1] == 3.0 and np.isnan(g[2])


def test_rollup_int32_sum_wraps():
    data = {"k": np.array(["a"] * 3 + ["b"], dtype=object),
            "v": np.array([2**31 - 1, 5, 7, -(2**31)], dtype=np.int32)}
    kw = {"dims": (("k", "STRING"),), "metrics": (("v", "INT"),), "date_times": ()}
    [seg] = _process(kw, [data], merge_type="ROLLUP")
    v = seg.columns["v"].materialize()
    assert v.dtype == np.int32 and v.tolist() == [np.int32(2**31 - 1 + 12 - 2**32), -(2**31)]


def test_rollup_kahan_compensated_sums():
    """pandas adds a group's floats with Kahan compensation in the column's
    own type: 1 + ten 1e-16 is not 1.0 in float64, nor 1 + ten 1e-8 in
    float32; a group of 3,000 rows takes the port's group-by-group path."""
    rng = np.random.default_rng(9)
    big = rng.normal(size=3000) * 10.0 ** rng.integers(-5, 15, 3000)
    data = {"k": np.array(["x"] * 11 + ["y"] * 3000, dtype=object),
            "f": np.r_[1.0, [1e-16] * 10, big],
            "f32": np.r_[1.0, [1e-8] * 10, big / 1e9].astype(np.float32)}
    kw = {"dims": (("k", "STRING"),), "metrics": (("f", "DOUBLE"), ("f32", "FLOAT")), "date_times": ()}
    [seg] = _process(kw, [data], merge_type="ROLLUP")
    assert seg.columns["f"].materialize()[0] != 1.0 and seg.columns["f32"].materialize()[0] != np.float32(1.0)


@pytest.mark.parametrize(
    "metrics",
    [(("m32", "INT"), ("f", "DOUBLE"), ("f32", "FLOAT"), ("l", "LONG")), (("m32", "INT"), ("f32", "FLOAT")),
     (("m32", "INT"), ("l", "LONG"))],
    ids=["mixed", "int32_float32", "ints"],
)
def test_rollup_no_dimensions(metrics):
    """No dimension: one row of whole-column reductions, brought to the
    dtype pandas' Series gives the scalars (float64 here loses int64 bits
    the reference loses too), then cast back."""
    names = [m for m, _ in metrics]
    parts = [{k: v for k, v in _wide(2000, s).items() if k in names} for s in (4, 5)]
    kw = {"dims": (), "metrics": metrics, "date_times": ()}
    with np.errstate(invalid="ignore"):
        [seg] = _process(kw, parts, merge_type="ROLLUP")
        _process(kw, parts, merge_type="ROLLUP", rollup_aggregates={"f": "MIN", "f32": "MAX", "m32": "MIN"})
    assert seg.n_docs == 1


@pytest.mark.parametrize("aggregate", ["SUM", "MIN", "MAX"])
def test_rollup_string_metric_column(aggregate):
    """A STRING date-time column that is not the time column rolls up as a
    metric: SUM concatenates in row order and the cast back to the input's
    fixed width truncates ('x1' + 'y22' -> 'x1y'), MIN / MAX compare the
    strings; the rebuilt dictionary is as wide as its longest value."""
    data = {"k": np.array(["a", "a", "b"], dtype=object), "day": np.array(["x1", "y22", "z"], dtype=object),
            "v": np.array([1, 2, 3])}
    kw = {"dims": (("k", "STRING"),), "metrics": (("v", "LONG"),), "date_times": (("day", "STRING"),)}
    [seg] = _process(kw, [data], merge_type="ROLLUP", rollup_aggregates={"day": aggregate})
    assert seg.columns["day"].materialize().tolist() == {"SUM": ["x1y", "z"], "MIN": ["x1", "z"], "MAX": ["y22", "z"]}[aggregate]
    [seg] = _process({**kw, "dims": ()}, [data], merge_type="ROLLUP", rollup_aggregates={"day": aggregate})
    assert seg.columns["v"].materialize().tolist() == [6]


def test_dedup_first_appearance_order():
    """The first row of each (k, d, i) in first-appearance order (not
    sorted), NaN equal to NaN; and with no dimension, over every column."""
    parts = [_wide(3000, 6), _wide(3000, 6)]  # the second part repeats the first
    [seg] = _process(WIDE, parts, merge_type="DEDUP")
    k = seg.columns["k"].materialize()
    assert list(k) != sorted(k)
    _process({**WIDE, "dims": ()}, parts, merge_type="DEDUP")


def test_partitions_split_into_segments():
    """num_partitions > 1 over an INT column and over a BYTES one (Python's
    hash, in this one process the same for both packages), each partition
    split at max_rows_per_segment."""
    out = _process(WIDE, [_wide(4000, 7)], merge_type="ROLLUP", partition_column="i", num_partitions=3,
                   max_rows_per_segment=150)
    assert len({s.name.split("_")[1] for s in out}) == 3 and len(out) > 3
    rng = np.random.default_rng(8)
    data = {"b": np.array([bytes([x]) * 3 for x in rng.integers(0, 50, 400)], dtype=object), "v": np.arange(400)}
    kw = {"dims": (("b", "BYTES"),), "metrics": (("v", "LONG"),), "date_times": ()}
    out = _process(kw, [data], partition_column="b", num_partitions=4)
    assert len(out) == 4


def test_partition_by_string_fails_alike():
    """A STRING column materializes as a fixed-width str array, so the
    reference casts it with astype(int64) and raises; the port keeps that."""
    errors = {}
    for pkg in PKGS:
        schema = _schema(pkg)
        seg = _seg(pkg, schema, "s0", _events(["x", "y"], [1, 2]))
        with pytest.raises(ValueError) as ei:
            pkg.minion.process_segments(
                [seg], pkg.minion.SegmentProcessorConfig(schema=schema, partition_column="kind", num_partitions=2))
        errors[pkg.name] = str(ei.value)
    assert errors["port"] == errors["ref"]


_HASH_PARTITIONS = """
import json, sys
import numpy as np
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.minion import SegmentProcessorConfig, process_segments
from pinot_tpu_torch.segment import SegmentBuilder
s = Schema.build("t", dimensions=[("b", DataType.BYTES)], metrics=[("v", DataType.LONG)])
seg = SegmentBuilder(s).build({"b": np.array([b"k%d" % i for i in range(64)], dtype=object),
                               "v": np.arange(64, dtype=np.int64)}, "s0")
out = process_segments([seg], SegmentProcessorConfig(schema=s, partition_column="b", num_partitions=4))
print(json.dumps({o.name: sorted(o.columns["v"].materialize().tolist()) for o in out}))
"""


def test_bytes_partitions_depend_on_the_process_hash_seed():
    """Python's hash() of bytes is salted per process: the same rows split
    into different partitions under two seeds (the reference's behaviour,
    kept for parity and recorded in ROADMAP Queue C)."""
    outs = []
    for seed in ("1", "2"):
        p = subprocess.run([sys.executable, "-c", _HASH_PARTITIONS], cwd=REPO, capture_output=True, text=True,
                           timeout=120, env={**__import__("os").environ, "PYTHONHASHSEED": seed})
        assert p.returncode == 0, p.stderr[-2000:]
        outs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    assert outs[0] != outs[1]
    assert sorted(v for part in outs[0].values() for v in part) == list(range(64))


# -- framework ---------------------------------------------------------------


def _cluster(pkg, root, table_cfg, schema=None):
    controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / pkg.name / "deepstore")
    server = pkg.server("server_0")
    controller.register_server("server_0", server)
    schema = schema or _schema(pkg, table_cfg.table_name)
    controller.add_schema(schema)
    controller.add_table(table_cfg)
    tm = pkg.minion.PinotTaskManager(controller)
    minion = pkg.tasks.make_minion_with_builtins("minion_0", tm, controller)
    return controller, server, tm, minion, schema


def test_task_lifecycle_and_failure(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, pkg.common.TableConfig("events", time_column="ts"))

        class BoomExecutor:
            task_type = "BoomTask"

            def execute(self, task, controller):
                raise RuntimeError("boom")

        minion.register_executor(BoomExecutor())
        t = tm.submit(pkg.minion.TaskConfig("BoomTask", "events"))
        before = tm.task_state(t.task_id).value
        ran = minion.run_pending()
        out[pkg.name] = (t.task_id, before, ran, tm.task_state(t.task_id).value, "boom" in t.error,
                         t.error.strip().splitlines()[-1])
    assert out["port"] == out["ref"]
    assert out["port"][1:5] == ("WAITING", 1, "FAILED", True)


def test_minion_background_thread(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, pkg.common.TableConfig("events", time_column="ts"))

        class OkExecutor:
            task_type = "OkTask"

            def execute(self, task, controller):
                return 42

        minion.register_executor(OkExecutor())
        minion.start(poll_interval=0.01)
        try:
            t = tm.submit(pkg.minion.TaskConfig("OkTask", "events"))
            for _ in range(200):
                if tm.task_state(t.task_id) == pkg.minion.TaskState.COMPLETED:
                    break
                time.sleep(0.01)
            out[pkg.name] = (tm.task_state(t.task_id).value, t.result)
        finally:
            minion.stop()
    assert out["port"] == out["ref"] == ("COMPLETED", 42)


def test_minion_meters_count_tasks(tmp_path):
    """The minion's meters (common/metrics.py's MinionMeter) count executed
    and failed tasks as the reference's do."""
    from pinot_tpu.common import metrics as r_metrics
    from pinot_tpu_torch.common import metrics as p_metrics

    out = {}
    for pkg, metrics in ((REF, r_metrics), (PORT, p_metrics)):
        metrics.reset_registries()
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, pkg.common.TableConfig("events", time_column="ts"))

        class Ok:
            task_type = "OkTask"

            def execute(self, task, controller):
                return 1

        class Boom:
            task_type = "BoomTask"

            def execute(self, task, controller):
                raise ValueError("no")

        minion.register_executor(Ok())
        minion.register_executor(Boom())
        for kind in ("OkTask", "OkTask", "BoomTask"):
            tm.submit(pkg.minion.TaskConfig(kind, "events"))
        minion.run_pending()
        reg = metrics.minion_metrics()
        out[pkg.name] = (reg.meter(metrics.MinionMeter.TASKS_EXECUTED).count,
                         reg.meter(metrics.MinionMeter.TASKS_FAILED).count,
                         [m.value for m in metrics.MinionMeter])
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (2, 1)


# -- built-in tasks ----------------------------------------------------------


def _rows(pkg, controller, sql):
    return pkg.broker(controller).execute(sql).rows


def test_merge_rollup_task(tmp_path):
    out = {}
    for pkg in PKGS:
        tc = pkg.common.TableConfig("events", time_column="ts")
        tc.extra = {"mergeRollup": {"mergeType": "ROLLUP", "minNumSegments": 2}}
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, tc)
        controller.upload_segment("events", _seg(pkg, schema, "s0", _events(["x", "y"], [1, 2], ts=[1, 1])))
        controller.upload_segment("events", _seg(pkg, schema, "s1", _events(["x"], [10], ts=[1])))
        tasks = tm.schedule_tasks()
        ran = minion.run_pending()
        merged = [server.get_segment_object("events", n) for n in sorted(controller.ideal_state("events"))]
        out[pkg.name] = {
            "tasks": [(t.task_type, t.task_id, t.state.value, t.configs) for t in tasks],
            "ran": ran,
            "result": tasks[0].result,
            "rows": _rows(pkg, controller, "SELECT kind, SUM(value) FROM events GROUP BY kind ORDER BY kind"),
            "ideal": sorted(controller.ideal_state("events")),
            "segments": merged,
        }
    assert_same_segments(out["ref"].pop("segments"), out["port"].pop("segments"))
    assert out["port"] == out["ref"]
    assert [list(r) for r in out["port"]["rows"]] == [["x", 11.0], ["y", 2.0]]
    assert all(not n.startswith("s") for n in out["port"]["ideal"])


def test_purge_task(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, pkg.common.TableConfig("events", time_column="ts"))
        controller.upload_segment("events", _seg(pkg, schema, "s0", _events(["keep", "drop", "keep"], [1, 2, 3], ts=[1, 2, 3])))
        pkg.tasks.RECORD_PURGER_REGISTRY["events"] = lambda cols: cols["kind"] == "drop"
        try:
            tasks = tm.schedule_tasks("PurgeTask")
            minion.run_pending()
            out[pkg.name] = ([(t.task_id, t.state.value, t.result) for t in tasks],
                             _rows(pkg, controller, "SELECT kind, COUNT(*) FROM events GROUP BY kind ORDER BY kind"))
        finally:
            del pkg.tasks.RECORD_PURGER_REGISTRY["events"]
    assert out["port"] == out["ref"]
    assert out["port"][1] == [["keep", 2]]


def test_realtime_to_offline_task(tmp_path):
    out = {}
    for pkg in PKGS:
        rt = pkg.common.TableConfig("events_rt", table_type=pkg.common.TableType.REALTIME, time_column="ts")
        rt.extra = {"realtimeToOffline": {"bucketTimeMs": 100, "startTimeMs": 0, "offlineTable": "events"}}
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, rt, schema=_schema(pkg, "events_rt"))
        controller.add_schema(_schema(pkg, "events"))
        controller.add_table(pkg.common.TableConfig("events", time_column="ts"))
        # window [0,100) is complete because a row exists at ts=150
        controller.upload_segment("events_rt", _seg(pkg, schema, "r0", _events(["x", "y"], [1, 2], ts=[10, 150])))
        tasks = tm.schedule_tasks("RealtimeToOfflineSegmentsTask")
        minion.run_pending()
        out[pkg.name] = (
            [(t.task_id, t.state.value, t.configs, t.result) for t in tasks],
            _rows(pkg, controller, "SELECT kind, value, ts FROM events LIMIT 10"),
            controller.store.get("/tables/events_rt/r2o_watermark"),
            tm.schedule_tasks("RealtimeToOfflineSegmentsTask"),
        )
    assert out["port"] == out["ref"]
    assert out["port"][1] == [["x", 1, 10]] and out["port"][2] == {"ts": 100} and out["port"][3] == []


def test_refresh_segment_task(tmp_path):
    out = {}
    for pkg in PKGS:
        tc = pkg.common.TableConfig("events", time_column="ts")
        tc.extra = {"refreshEpoch": 1}
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, tc)
        controller.upload_segment("events", _seg(pkg, schema, "s0", _events(["x"], [1], ts=[1])))
        tasks = tm.schedule_tasks("RefreshSegmentTask")
        minion.run_pending()
        out[pkg.name] = (
            [(t.task_id, t.state.value, t.result) for t in tasks],
            controller.segment_metadata("events", "s0")["refreshEpoch"],
            tm.schedule_tasks("RefreshSegmentTask"),
            _rows(pkg, controller, "SELECT COUNT(*) FROM events"),
        )
    assert out["port"] == out["ref"]
    assert out["port"][1:] == (1, [], [[1]])


def test_upsert_compaction_task(tmp_path):
    out = {}
    for pkg in PKGS:
        schema = _schema(pkg, "ups", dims=(("pk", "STRING"),), pk=("pk",))
        tc = pkg.common.TableConfig("ups", time_column="ts", upsert=pkg.common.UpsertConfig())
        tc.extra = {"upsertCompaction": {"invalidRecordsThresholdPercent": 30.0}}
        controller, server, tm, minion, _ = _cluster(pkg, tmp_path, tc, schema=schema)
        seg = _seg(pkg, schema, "u0", {"pk": np.asarray(["a", "a", "a", "b"], dtype=object),
                                        "value": np.asarray([1, 2, 3, 9], dtype=np.int64),
                                        "ts": np.asarray([1, 2, 3, 1], dtype=np.int64)})
        controller.upload_segment("ups", seg)
        # only the latest doc of each key valid (2 of 4), on the server's live object
        server.get_segment_object("ups", "u0").extras["valid_docs"] = lambda n: np.asarray([False, False, True, True])
        tasks = tm.schedule_tasks("UpsertCompactionTask")
        minion.run_pending()
        out[pkg.name] = ([(t.task_id, t.state.value, t.result) for t in tasks],
                         _rows(pkg, controller, "SELECT pk, value FROM ups ORDER BY pk LIMIT 10"))
    assert out["port"] == out["ref"]
    assert out["port"][0][0][2]["keptDocs"] == 2 and [list(r) for r in out["port"][1]] == [["a", 3], ["b", 9]]


def test_segment_generation_and_push_task(tmp_path):
    out = {}
    for pkg in PKGS:
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, pkg.common.TableConfig("events", time_column="ts"))
        inputs = tmp_path / pkg.name / "in"
        inputs.mkdir(parents=True)
        (inputs / "in.csv").write_text("kind,value,ts\nk0,1,5\nk1,2,6\n")
        t = tm.submit(pkg.minion.TaskConfig("SegmentGenerationAndPushTask", "events",
                                            {"inputDirURI": str(inputs), "includeFileNamePattern": "*.csv"}))
        minion.run_pending()
        out[pkg.name] = (t.state.value, t.result, _rows(pkg, controller, "SELECT kind, value, ts FROM events ORDER BY ts LIMIT 5"),
                         server.get_segment_object("events", "events_0"))
    assert_same_segments([out["ref"][3]], [out["port"][3]])
    assert out["port"][:3] == out["ref"][:3]
    assert out["port"][0] == "COMPLETED" and out["port"][2] == [["k0", 1, 5], ["k1", 2, 6]]


def test_table_task_type_gating(tmp_path):
    """A table restricting taskTypes only gets those tasks."""
    out = {}
    for pkg in PKGS:
        tc = pkg.common.TableConfig("events", time_column="ts")
        tc.extra = {"mergeRollup": {"minNumSegments": 1}, "refreshEpoch": 1, "taskTypes": ["RefreshSegmentTask"]}
        controller, server, tm, minion, schema = _cluster(pkg, tmp_path, tc)
        controller.upload_segment("events", _seg(pkg, schema, "s0", _events(["x"], [1], ts=[1])))
        out[pkg.name] = sorted((t.task_type, t.task_id, t.configs) for t in tm.schedule_tasks())
    assert out["port"] == out["ref"]
    assert {t[0] for t in out["port"]} == {"RefreshSegmentTask"}
