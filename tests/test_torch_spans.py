"""The port's spans (common/trace.py) and the counts beside them, on the
CPU: the span tree of one query through the query scheduler and the engine,
under one query id; the off path (no trace, no profiler) logging nothing,
taking no lock and entering no record_function; the profiler's ranges on
the log's clock; a span open across the profiler's start or stop logged
whole; EXPLAIN ANALYZE's rows beside the reference's; the scheduler's wait
exported for untraced queries; the graph table's meters and gauges; each
segment's card time where the heat and the span read it."""

import json
import subprocess
import sys
import threading
import time

import pytest
import torch

from pinot_tpu_torch.common import trace
from pinot_tpu_torch.common.kernel_obs import KERNELS, _Pending, timed_ms
from pinot_tpu_torch.common.metrics import server_metrics
from pinot_tpu_torch.common.segment_heat import HEAT
from pinot_tpu_torch.common.trace import SPANS, InvocationScope, span_attr, start_trace
from pinot_tpu_torch.query import engine as engine_mod
from pinot_tpu_torch.query.graphs import GraphTable
from pinot_tpu_torch.query.scheduler import FCFSScheduler
from test_torch_explain import mask_times
from test_torch_pruner import pair, time_columns, time_partitioned

SQL = "SELECT region, COUNT(*), SUM(revenue) FROM t WHERE year >= 1996 GROUP BY region ORDER BY region"
SPAN_NAMES = [
    "scheduler.wait",
    "engine.submit",
    "engine.parse",
    "segment.dispatch",
    "segment.enqueue",
    "engine.resolve",
    "segment.resolve",
    "segment.sync",
    "engine.reduce",
]


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


def cpu_profiler(**kw):
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU], **kw)


def logged_since(t0: float) -> list:
    return [r for r in SPANS.records() if r.end >= t0]


def live_segments(eng) -> list[str]:
    return [s.name for s in eng.segments if s.columns["year"].stats.max_value >= 1996]


def test_query_through_the_scheduler_logs_the_span_tree(tp):
    _, ports = tp
    eng = ports["built"]
    s = FCFSScheduler(num_runners=2)
    s.start()
    t0 = time.perf_counter()
    try:
        with cpu_profiler():
            eng.execute(SQL)  # a query of its own, outside the scheduler, in another id
            s.submit(eng.execute, SQL).result(timeout=60)
    finally:
        s.stop()
    recs = [r for r in logged_since(t0) if r.thread != threading.get_ident()]
    assert {r.query for r in recs} == {recs[0].query}
    by = {}
    for r in recs:
        by.setdefault(r.name, []).append(r)
    assert set(by) == set(SPAN_NAMES)
    live = live_segments(eng)
    (wait,), (submit,), (parse,), (resolve,), (reduce_,) = (
        by[n] for n in ("scheduler.wait", "engine.submit", "engine.parse", "engine.resolve", "engine.reduce")
    )
    assert wait.attrs == {"scheduler": "fcfs", "queue_depth": 0} and wait.end <= submit.start
    assert parse.parent == submit.id and submit.attrs == {"segments": 6, "pruned": 6 - len(live)}
    dispatch = {r.attrs["segment"]: r for r in by["segment.dispatch"]}
    assert [r.parent for r in dispatch.values()] == [submit.id] * 6
    assert {n for n, r in dispatch.items() if r.attrs["mode"] == "device"} == set(live)
    assert {n for n, r in dispatch.items() if r.attrs["mode"] == "pruned"} == set(dispatch) - set(live)
    assert all(r.attrs["prune"] == ("value" if r.attrs["mode"] == "pruned" else None) for r in dispatch.values())
    assert sorted(dispatch[r.attrs["segment"]].id for r in by["segment.dispatch"] if r.attrs["mode"] == "device") == sorted(
        r.parent for r in by["segment.enqueue"]
    )
    seg_resolve = {r.id: r for r in by["segment.resolve"]}
    assert [r.attrs["segment"] for r in by["segment.resolve"]] == live
    assert {r.parent for r in by["segment.resolve"]} == {resolve.id} == {reduce_.parent}
    assert sorted(r.parent for r in by["segment.sync"]) == sorted(seg_resolve)
    assert reduce_.attrs == {"rows": 5} and submit.end <= resolve.start


def test_off_path_logs_nothing_locks_nothing_and_enters_no_record_function(tp, monkeypatch):
    _, ports = tp
    eng = ports["built"]

    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("the off path reached it")

        __enter__ = __call__ = __init__

    assert not trace.profiling()
    before = len(SPANS.records())
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    monkeypatch.setattr(trace, "Span", Refused)
    monkeypatch.setattr(trace, "SpanRecord", Refused)
    monkeypatch.setattr(SPANS, "_lock", Refused)
    s = FCFSScheduler(num_runners=2)
    s.start()
    try:
        got = [s.submit(eng.execute, SQL) for _ in range(3)]
        rows = [f.result(timeout=60).rows for f in got] + [eng.execute(SQL).rows]
    finally:
        s.stop()
    assert rows[0] == rows[-1]
    monkeypatch.undo()
    assert len(SPANS.records()) == before


OFF_SITES = """
import tracemalloc
import torch
from pinot_tpu_torch.common.trace import InvocationScope, profiling, span_attr


def site():
    with InvocationScope("segment.dispatch", segment="s0") as sp:
        sp.set_attr("mode", "device")
        span_attr("graph", "hit")


def nothing():
    pass


def traced(fn):
    for _ in range(100):
        fn()
    tracemalloc.start()
    try:
        base, _ = tracemalloc.get_traced_memory()
        tracemalloc.reset_peak()
        for _ in range(10_000):
            fn()
        now, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    return now - base, peak - base


assert not profiling()
print(*traced(site), *traced(nothing))
"""


def test_off_span_site_leaves_nothing_behind():
    """Off, a span site makes its scope object and nothing that outlives
    its exit: after 10,000 sites the traced memory is where an empty loop
    leaves it, and its peak does not grow with the number of sites (in a
    process of its own, with no other thread allocating)."""
    out = subprocess.run([sys.executable, "-c", OFF_SITES], capture_output=True, text=True, timeout=120, check=True)
    held, peak, held0, peak0 = map(int, out.stdout.split())
    assert held == held0
    assert peak - peak0 < 1024


def test_record_function_ranges_land_on_the_log(tp, tmp_path):
    """Each span of a query run on the profiler's own thread is a
    record_function range of its name; through one offset each range's
    start and end lie within 0.2 ms of its log record's. One clock makes it
    hold in every run; the best of three runs is taken, as the OS may
    preempt the thread between a clock read and the range's own."""
    _, ports = tp
    worst = []
    for attempt in range(3):
        t0 = time.perf_counter()
        with cpu_profiler() as prof:
            ports["built"].execute(SQL)
        prof.export_chrome_trace(str(tmp_path / f"t{attempt}.json"))
        events = json.loads((tmp_path / f"t{attempt}.json").read_text())["traceEvents"]
        ranges = sorted(
            (e for e in events if e.get("ph") == "X" and e.get("name") in SPAN_NAMES), key=lambda e: float(e["ts"])
        )
        recs = sorted(logged_since(t0), key=lambda r: r.start)
        assert [e["name"] for e in ranges] == [r.name for r in recs] and len(recs) > 10
        offset = recs[0].start - float(ranges[0]["ts"]) / 1e6
        worst.append(
            max(
                max(abs(float(e["ts"]) / 1e6 + offset - r.start), abs((float(e["ts"]) + float(e["dur"])) / 1e6 + offset - r.end))
                for e, r in zip(ranges, recs)
            )
        )
    assert min(worst) < 2e-4, worst


def test_a_span_open_at_the_profilers_start_or_stop_is_logged_whole():
    def opened(name):
        scope = InvocationScope(name)
        scope.__enter__()
        return scope

    before_start = opened("before.start")
    t_open = time.perf_counter()
    closed_before = opened("closed.before")
    closed_before.__exit__(None, None, None)
    prof = cpu_profiler()
    prof.start()
    started = time.perf_counter()
    with InvocationScope("inside"):
        pass
    across = opened("across.stop")
    before_start.__exit__(None, None, None)
    prof.stop()
    stopped = time.perf_counter()
    across.__exit__(None, None, None)
    with InvocationScope("after.stop"):
        pass
    recs = {r.name: r for r in logged_since(t_open)}
    assert set(recs) == {"before.start", "inside", "across.stop"}
    assert recs["before.start"].start < t_open < started < recs["before.start"].end
    assert started < recs["across.stop"].start < stopped < recs["across.stop"].end
    # a span open through the whole recording, logged as it closes
    # because a span site saw the profiler recording after it opened
    whole = opened("through")
    prof = cpu_profiler()
    prof.start()
    with InvocationScope("seen"):
        pass
    prof.stop()
    whole.__exit__(None, None, None)
    assert "through" in {r.name for r in logged_since(t_open)}


@pytest.mark.parametrize("profiled", [False, True])
def test_explain_analyze_segment_scan_rows_unchanged(tp, profiled):
    """The SEGMENT_SCAN rows (one a segment.resolve span) equal the
    reference's, with the profiler's log on or off."""
    ref, ports = tp
    sql = "EXPLAIN ANALYZE " + SQL
    if profiled:
        with cpu_profiler():
            got = ports["built"].execute(sql)
    else:
        got = ports["built"].execute(sql)
    want = ref.execute(sql)
    scans = [r for r in mask_times(got.rows) if r[0].startswith("SEGMENT_SCAN")]
    assert len(scans) == len(live_segments(ports["built"]))
    assert scans == [r for r in mask_times(want.rows) if r[0].startswith("SEGMENT_SCAN")]


def test_scheduler_wait_is_exported_for_untraced_queries():
    timer = server_metrics().timer("server.phase.schedulerWaitMs")
    before = timer.count
    s = FCFSScheduler(num_runners=1)
    s.start()
    try:
        for f in [s.submit(time.sleep, 0.005) for _ in range(3)]:
            f.result(timeout=30)
        with start_trace("w") as tr:
            s.submit(lambda: None).result(timeout=30)
    finally:
        s.stop()
    assert timer.count - before == 4
    assert tr.phase_ms["schedulerWait"] >= 0
    (span,) = [sp for sp in tr.to_dict()["spans"] if sp["name"] == "scheduler.wait"]
    assert span["attrs"] == {"scheduler": "fcfs", "queue_depth": 0}


def test_graph_table_exports_its_counts():
    class Held:
        def __init__(self, nbytes):
            self.nbytes = nbytes

    class Owner:
        pass

    reg = server_metrics()
    names = ("lookups", "hits", "captures", "evictions")
    before = {n: reg.meter(f"engine.graphs.{n}").count for n in names}
    table, owner = GraphTable(budget=100), Owner()
    assert table.get("a") is None
    table.put("a", owner, Held(60))
    assert table.get("a") is not None
    table.put("b", owner, Held(70))  # past the budget: "a" goes
    assert table.get("a") is None
    got = {n: reg.meter(f"engine.graphs.{n}").count - before[n] for n in names}
    assert got == {"lookups": 3, "hits": 1, "captures": 2, "evictions": 1}
    stats = table.stats()
    assert (stats["captures"], stats["evictions"]) == (2, 1)
    assert reg.gauge("engine.graphs.bytes").value == stats["bytes"] == 70
    assert reg.gauge("engine.graphs.peakBytes").value == stats["peakBytes"] == 130


def test_a_resolved_event_pair_keeps_its_ms():
    class Event:
        def elapsed_time(self, _end):
            return 2.5

    rec = _Pending("query.fused_packed", Event(), Event(), None, {"rows": 8, "cols": 1})
    in_program = _Pending("grouped_sum_count", None, None, 3, {"rows": 8}, "query.fused_packed")
    assert timed_ms([rec, in_program]) is None
    KERNELS.resolve([rec, in_program])
    assert timed_ms([rec, in_program]) == 2.5 and in_program.ms is None


def test_segment_heat_and_span_get_the_card_time(tp, monkeypatch):
    """Each resolved segment's card ms (its programs' event pairs) is its
    heat's deviceMs and its span's card_ms; on the CPU nothing is timed on a
    card, and the heat folds 0."""
    _, ports = tp
    eng = ports["built"]
    live = live_segments(eng)
    HEAT.reset()
    eng.execute(SQL)
    assert {r["segment"]: r["deviceMs"] for r in HEAT.snapshot()["segments"]} == dict.fromkeys(live, 0.0)
    HEAT.reset()
    monkeypatch.setattr(engine_mod, "timed_ms", lambda launches: 3.0)
    with start_trace("c") as tr:
        eng.execute(SQL)
    assert {r["segment"]: r["deviceMs"] for r in HEAT.snapshot()["segments"]} == dict.fromkeys(live, 3.0)
    spans = [sp for sp in tr.to_dict()["spans"] if sp["name"] == "segment.resolve"]
    assert [sp["attrs"]["card_ms"] for sp in spans] == [3.0] * len(live)
    HEAT.reset()
