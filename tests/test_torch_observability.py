"""The hooks every segment passes through in the port's engine, against the
JAX package's engine on the same tables: the `segment.execute` fault point,
the accountant's kill at the per-segment checkpoint, the deadline, the
per-segment trace spans, the accountant's samples, the server meters, and
the server half (`partials`, `partials_iter`, `add_segment`). Also the
ported metrics, trace and fault-injector modules beside the reference's."""

import time

import numpy as np
import pytest

from pinot_tpu.common import faults as jfaults
from pinot_tpu.common import metrics as jmetrics
from pinot_tpu.common.faults import FAULTS as JFAULTS
from pinot_tpu.query.context import Deadline as JDeadline
from pinot_tpu.query.context import QueryTimeoutError as JQueryTimeoutError
from pinot_tpu_torch.common import faults, metrics
from pinot_tpu_torch.common.accounting import QueryKilledError, ResourceAccountant, default_accountant
from pinot_tpu_torch.common.faults import FAULTS, FaultRule, InjectedFault
from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics
from pinot_tpu_torch.common.trace import InvocationScope, ServerQueryPhase, phase_timer, start_trace, trace_event
from pinot_tpu_torch.query.context import Deadline, QueryCancelledError, QueryTimeoutError
from test_torch_pruner import pair, time_columns, time_partitioned


@pytest.fixture(autouse=True)
def _clean_faults():
    FAULTS.reset()
    JFAULTS.reset()
    yield
    FAULTS.reset()
    JFAULTS.reset()


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


# -- faults -------------------------------------------------------------------


def test_fault_points_are_the_references():
    assert faults.FAULT_POINTS == jfaults.FAULT_POINTS
    assert issubclass(InjectedFault, ConnectionError)


def test_injector_replays_the_references_draws():
    """The same rules and seed fire at the same calls in both packages."""
    rules = {"segment.execute": {"prob": 0.3, "maxCount": 5}, "mailbox.send": {"mode": "delay", "delayS": 0.0}}
    FAULTS.configure(rules, seed=11)
    JFAULTS.configure(rules, seed=11)
    fired = []
    for inj, exc in ((FAULTS, InjectedFault), (JFAULTS, jfaults.InjectedFault)):
        out = []
        for _ in range(40):
            try:
                inj.maybe_fail("segment.execute")
                out.append(0)
            except exc:
                out.append(1)
            inj.maybe_fail("mailbox.send")
        fired.append(out)
    assert fired[0] == fired[1] and sum(fired[0]) == 5
    assert FAULTS.counts() == JFAULTS.counts()


def test_injector_data_modes_match_reference():
    data = bytes(range(64))
    for mode in ("bitflip", "truncate"):
        FAULTS.configure({"storage.read": FaultRule(mode=mode, offset=10)})
        JFAULTS.configure({"storage.read": jfaults.FaultRule(mode=mode, offset=10)})
        assert FAULTS.maybe_fail("storage.read", data=data) == JFAULTS.maybe_fail("storage.read", data=data)


@pytest.mark.parametrize("mode", ["built", "carried"])
def test_segment_execute_fault_reaches_the_caller(tp, mode):
    """An error rule on segment.execute: the query raises InjectedFault in
    both packages, and the fault leaves an event on the active trace."""
    ref, ports = tp
    sql = "SELECT COUNT(*) FROM t"
    FAULTS.configure({"segment.execute": FaultRule(mode="error", max_count=1)})
    JFAULTS.configure({"segment.execute": jfaults.FaultRule(mode="error", max_count=1)})
    with pytest.raises(jfaults.InjectedFault):
        ref.execute(sql)
    with start_trace("f") as tr:
        with pytest.raises(InjectedFault):
            ports[mode].execute(sql)
    (ev,) = [e for e in tr.to_dict()["events"] if e["name"] == "fault.injected"]
    assert ev["attrs"]["point"] == "segment.execute"
    # the rule is spent: the next query runs, as the reference's does
    assert ports[mode].execute(sql).rows == ref.execute(sql).rows == [[6000]]


def test_fault_point_fires_once_a_segment(tp):
    ref, ports = tp
    FAULTS.configure({"segment.execute": FaultRule(mode="delay", delay_s=0.0)})
    JFAULTS.configure({"segment.execute": jfaults.FaultRule(mode="delay", delay_s=0.0)})
    sql = "SELECT COUNT(*) FROM t WHERE year = 1995"
    ports["built"].execute(sql)
    ref.execute(sql)
    assert FAULTS.counts() == JFAULTS.counts() == {"segment.execute": len(ref.segments)}


# -- deadline -----------------------------------------------------------------


def test_deadline_at_dispatch(tp):
    """An expired deadline stops the query at its first segment, with the
    reference's error class and message."""
    ref, ports = tp
    sql = "SELECT COUNT(*) FROM t"
    jctx, ctx = ref.make_context(sql), ports["built"].make_context(sql)
    jctx.deadline, ctx.deadline = JDeadline(time.time() - 1), Deadline(time.time() - 1)
    with pytest.raises(JQueryTimeoutError) as jerr:
        ref.partials(jctx)
    with start_trace("d") as tr:
        with pytest.raises(QueryTimeoutError) as err:
            ports["built"].partials(ctx)
    assert str(err.value) == str(jerr.value)
    assert [e["name"] for e in tr.to_dict()["events"]] == ["deadline.expired"]


def test_deadline_during_resolve(tp):
    """A delay fault at each segment's dispatch outlasts the deadline: the
    query raises the timeout (at a later segment's dispatch or at resolve)."""
    _, ports = tp
    FAULTS.configure({"segment.execute": FaultRule(mode="delay", delay_s=0.05)})
    ctx = ports["built"].make_context("SELECT COUNT(*) FROM t")
    ctx.deadline = Deadline.from_timeout_ms(120)
    with pytest.raises(QueryTimeoutError):
        ports["built"].partials(ctx)


def test_cancel(tp):
    _, ports = tp
    ctx = ports["built"].make_context("SELECT COUNT(*) FROM t")
    ctx.deadline = Deadline(None)
    ctx.deadline.cancel()
    with pytest.raises(QueryCancelledError):
        ports["built"].partials(ctx)


# -- accountant ---------------------------------------------------------------


def test_killed_query_stops_at_the_checkpoint(tp):
    _, ports = tp
    with default_accountant.scope("obs-kill", table="t"):
        default_accountant.kill("obs-kill", "over budget")
        with start_trace("k") as tr:
            with pytest.raises(QueryKilledError) as err:
                ports["built"].execute("SELECT COUNT(*) FROM t")
    assert err.value.kill_reason == "over budget"
    assert any(e["name"] == "accountant.kill" for e in tr.to_dict()["events"])


def test_accountant_samples_each_executed_segment(tp):
    """One sample a resolved segment (pruned ones none): segments executed
    and their bytes, in the query's tracker."""
    _, ports = tp
    eng = ports["built"]
    default_accountant.reset_rollups()
    with default_accountant.scope("obs-sample", table="t_obs", tenant="x"):
        eng.execute("SELECT COUNT(*) FROM t WHERE year >= 1997")
    (roll,) = [w for w in default_accountant.workload_rollups() if w["table"] == "t_obs"]
    live = [s for s in eng.segments if s.columns["year"].stats.max_value >= 1997]
    assert roll["segmentsExecuted"] == len(live)
    assert roll["allocatedBytes"] == sum(s.size_bytes for s in live)


def test_heap_watermark_kills_the_largest():
    acct = ResourceAccountant(heap_limit_bytes=1000)
    acct.register("a")
    acct.register("b")
    acct.sample("a", allocated_bytes=300)
    acct.sample("b", allocated_bytes=800)
    with pytest.raises(QueryKilledError):
        acct.checkpoint("b")
    acct.checkpoint("a")


# -- trace and metrics --------------------------------------------------------


def test_segment_spans_under_a_trace(tp):
    """Each executed segment gets a `segment:<name>` span with its matched
    docs; a pruned segment none."""
    _, ports = tp
    eng = ports["built"]
    with start_trace("s") as tr:
        res = eng.execute("SELECT COUNT(*) FROM t WHERE year = 1995")
    spans = tr.to_dict()["spans"]
    live = [s.name for s in eng.segments if s.columns["year"].stats.min_value <= 1995 <= s.columns["year"].stats.max_value]
    assert [sp["name"] for sp in spans] == [f"segment:{n}" for n in live]
    assert sum(sp["attrs"]["numDocsMatched"] for sp in spans) == res.rows[0][0]


def test_trace_primitives():
    trace_event("nobody.listens")  # no trace: a no-op
    with start_trace("p", service="server") as tr:
        with InvocationScope("op", kind="x") as sc:
            sc.set_attr("n", 3)
        with phase_timer(ServerQueryPhase.BUILD_QUERY_PLAN, role="server"):
            pass
        trace_event("e", a=1)
    d = tr.to_dict()
    assert tr.root.name == "server"
    assert d["spans"][0]["name"] == "op" and d["spans"][0]["attrs"] == {"kind": "x", "n": 3}
    assert "buildQueryPlan" in d["phaseTimesMs"]
    assert d["events"][0]["name"] == "e" and d["events"][0]["attrs"] == {"a": 1}
    assert server_metrics().timer("server.phase.buildQueryPlanMs").count >= 1


def test_histogram_quantiles_match_reference():
    rng = np.random.default_rng(4)
    h, jh = metrics.Histogram(), jmetrics.Histogram()
    for v in rng.lognormal(0, 2, 2000):
        h.update_ms(v)
        jh.update_ms(v)
    for q in (0.5, 0.9, 0.95, 0.99, 1.0):
        assert h.quantile_ms(q) == jh.quantile_ms(q)
    assert h.bucket_counts() == jh.bucket_counts() and h.mean_ms() == jh.mean_ms()


def test_registry_snapshot_matches_reference():
    reg, jreg = metrics.MetricsRegistry("server"), jmetrics.MetricsRegistry("server")
    for r in (reg, jreg):
        r.meter("m", table="t").mark(3)
        r.gauge("g").set(7)
        r.timer("tm").update_ms(2.5)
        r.histogram("h", index="SORTED_INDEX").update_ms(0.3)
    assert reg.snapshot() == jreg.snapshot()
    with pytest.raises(TypeError):
        reg.gauge("m", table="t")
    assert metrics.series_key("x", {"b": 1, "a": "q\""}) == jmetrics.series_key("x", {"b": 1, "a": "q\""})


def test_server_meters_count_queries_and_pruning(tp):
    _, ports = tp
    eng = ports["built"]
    reg = server_metrics()
    q0, p0 = reg.meter(ServerMeter.NUM_SEGMENTS_QUERIED).count, reg.meter(ServerMeter.NUM_SEGMENTS_PRUNED).count
    res = eng.execute("SELECT COUNT(*) FROM t WHERE year = 2005")
    assert res.num_segments_pruned == len(eng.segments)
    assert reg.meter(ServerMeter.NUM_SEGMENTS_QUERIED).count == q0
    assert reg.meter(ServerMeter.NUM_SEGMENTS_PRUNED).count - p0 == len(eng.segments)


# -- the server half ----------------------------------------------------------


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT COUNT(*), SUM(revenue) FROM t WHERE year BETWEEN 1994 AND 1996",
        "SELECT region, SUM(revenue) FROM t WHERE year > 1996 GROUP BY region",
        "SELECT year, revenue FROM t WHERE year = 1993 ORDER BY revenue LIMIT 3",
    ],
)
def test_partials_and_partials_iter_match_reference(tp, sql):
    """partials(): the matched docs and the scan summary equal the
    reference's, and its partials reduce to the reference's rows;
    partials_iter() yields the unpruned segments, each with the reference's
    matched count and scan stats."""
    ref, ports = tp
    eng = ports["built"]
    ctx, jctx = eng.make_context(sql), ref.make_context(sql)
    out, scanned, summary = eng.partials(ctx)
    jout, jscanned, jsummary = ref.partials(jctx)
    assert scanned == jscanned and summary == jsummary and len(out) == len(jout)
    assert eng.reduce(ctx, out) == ref.reduce(jctx, jout)
    got = [(s.name, m, st) for s, _, m, st in eng.partials_iter(eng.make_context(sql))]
    want = [(s.name, m, st) for s, _, m, st in ref.partials_iter(ref.make_context(sql))]
    assert got == want


def test_add_segment(tp):
    ref, ports = tp
    from pinot_tpu_torch.query import QueryEngine

    eng = QueryEngine(ports["built"].segments[:2], device="cpu")
    for seg in ports["built"].segments[2:]:
        eng.add_segment(seg)
    sql = "SELECT COUNT(*) FROM t WHERE year >= 1995"
    assert eng.execute(sql).rows == ref.execute(sql).rows
