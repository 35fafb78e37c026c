"""Scan-path attribution, the pruning funnel and the segment-heat registry
through the port and the JAX package: the cases of tests/test_scan_obs.py
that need no aux index (tests/test_torch_indexes.py holds the index paths), on
a time-partitioned table whose sorted year column takes SORTED_INDEX, a
table with null vectors (NULL_INDEX) and a star-tree table
(STARTREE_INDEX). The scan profile, the entry counts and the funnel must be
equal, exactly."""

import numpy as np
import pytest

from pinot_tpu.common.segment_heat import SegmentHeatRegistry as JSegmentHeatRegistry
from pinot_tpu.query import scan_stats as jscan_stats
from pinot_tpu.query.context import QueryContext as JQueryContext
from pinot_tpu_torch.common.metrics import ScanMeter, ServerMeter, server_metrics
from pinot_tpu_torch.common.segment_heat import HEAT, SegmentHeatRegistry
from pinot_tpu_torch.query import scan_stats
from pinot_tpu_torch.query.context import QueryContext
from test_torch_pruner import assert_same_result, pair, time_columns, time_partitioned


@pytest.fixture(autouse=True)
def _clean():
    HEAT.reset()
    scan_stats.configure(True)
    jscan_stats.configure(True)
    yield
    HEAT.reset()
    scan_stats.configure(True)
    jscan_stats.configure(True)


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


BATTERY = [
    "SELECT COUNT(*) FROM t WHERE year = 1995",
    "SELECT COUNT(*) FROM t WHERE year > 1996 AND qty < 10",
    "SELECT region, SUM(revenue) FROM t WHERE year BETWEEN 1993 AND 1995 AND region IN ('ASIA', 'EUROPE') GROUP BY region",
    "SELECT city, revenue FROM t WHERE qty > 45 ORDER BY revenue DESC LIMIT 10",
    "SELECT COUNT(*) FROM t WHERE NOT year = 1994 OR city LIKE 'c1%'",
    "SELECT MODE(qty) FROM t WHERE year = 1997",
    "SELECT PERCENTILE(revenue, 50) FROM t WHERE year >= 1996 AND region = 'ASIA'",
    "SELECT custkey, COUNT(*) FROM t WHERE year <> 1995 GROUP BY custkey ORDER BY COUNT(*) DESC, custkey LIMIT 5",
    "SELECT DISTINCT region FROM t WHERE year IN (1992, 1998)",
    "SELECT COUNT(*) FROM t WHERE year = 2005",
    "SELECT COUNT(*) FROM t",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", BATTERY)
def test_scan_profile_matches_reference(tp, sql, mode):
    ref, ports = tp
    assert_same_result(ports[mode].execute(sql), ref.execute(sql), sql)


def test_sorted_index_attribution(tp):
    """The time-partitioned segments' year is sorted: an index-served
    predicate examines no entry; the post-filter entries are the matched
    docs times the projected columns."""
    _, ports = tp
    res = ports["built"].execute("SELECT region, COUNT(*) FROM t WHERE year = 1995 GROUP BY region")
    prof = res.scan_profile
    assert set(prof["predicates"]) == {"year:SORTED_INDEX"}
    assert res.num_entries_scanned_in_filter == 0
    assert res.num_entries_scanned_post_filter == res.num_docs_scanned * 1
    assert all(s.columns["year"].stats.is_sorted for s in ports["built"].segments)


def test_full_scan_fallback_on_the_host(tp):
    """MODE() runs on the host executor, which scans the sorted column: a
    full-scan fallback, the offender signal."""
    _, ports = tp
    res = ports["built"].execute("SELECT MODE(qty) FROM t WHERE year = 1997")
    prof = res.scan_profile
    assert prof["predicates"] == {"year:FULL_SCAN": res.num_segments_queried - res.num_segments_pruned}
    assert prof["fullScanFallbacks"]["year"] >= 1
    assert res.num_entries_scanned_in_filter > 0


@pytest.mark.parametrize("exec_mode", ["device", "host", "startree"])
@pytest.mark.parametrize(
    "sql",
    [
        "SELECT COUNT(*) FROM t WHERE year = 1995 AND region = 'ASIA'",
        "SELECT COUNT(*) FROM t WHERE year > 1993 OR qty BETWEEN 3 AND 9",
        "SELECT COUNT(*) FROM t WHERE city LIKE 'c%' AND custkey IN (1, 2)",
        "SELECT COUNT(*) FROM t WHERE year IS NULL",
        "SELECT COUNT(*) FROM t",
    ],
)
def test_segment_scan_stats_matches_reference(tp, sql, exec_mode):
    ref, ports = tp
    jctx, ctx = JQueryContext.from_sql(sql), QueryContext.from_sql(sql)
    for jseg, seg in zip(ref.segments, ports["built"].segments):
        got = scan_stats.segment_scan_stats(ctx, seg, exec_mode, matched=17, n_post_cols=2)
        assert got == jscan_stats.segment_scan_stats(jctx, jseg, exec_mode, matched=17, n_post_cols=2)


def test_null_index_attribution():
    """IS NULL over a column with a null vector: NULL_INDEX, as the
    reference's."""
    from test_torch_nulls import _nulls_data, _pair

    cols = lambda DT: dict(dimensions=[("g", DT.STRING)], metrics=[("v", DT.LONG), ("x", DT.DOUBLE)])  # noqa: E731
    ref, ports = _pair("n", cols, _nulls_data(), null_handling=True)
    for sql in ("SELECT COUNT(*) FROM n WHERE v IS NULL", "SELECT g, COUNT(*) FROM n WHERE x IS NOT NULL GROUP BY g ORDER BY g"):
        want = ref.execute(sql)
        for port in ports.values():
            assert_same_result(port.execute(sql), want, sql)
        assert any(k.endswith(":NULL_INDEX") for k in want.scan_profile["predicates"])


def test_startree_attribution():
    from test_torch_explain import _dv, _star
    from pinot_tpu.query import QueryEngine as JEngine
    from pinot_tpu_torch.query import QueryEngine

    jseg, built = _star("s", _dv(67), (["d"], ["SUM__v"]))
    sql = "SELECT d, SUM(v) FROM s WHERE d = 'a' GROUP BY d"
    got, want = QueryEngine([built], device="cpu").execute(sql), JEngine([jseg]).execute(sql)
    assert_same_result(got, want, sql)
    assert got.scan_profile["predicates"] == {"d:STARTREE_INDEX": 1}


def test_scan_obs_disabled_guard(tp):
    _, ports = tp
    eng = ports["built"]
    scan_stats.configure(False)
    res = eng.execute("SELECT COUNT(*) FROM t WHERE year > 1995")
    assert res.scan_profile["predicates"] == {}
    assert res.num_entries_scanned_in_filter == res.num_entries_scanned_post_filter == 0
    assert HEAT.snapshot()["count"] == 0
    scan_stats.configure(True)
    eng.scan_obs_enabled = False
    try:
        assert eng.execute("SELECT COUNT(*) FROM t WHERE year > 1995").scan_profile["predicates"] == {}
    finally:
        eng.scan_obs_enabled = True
    assert eng.execute("SELECT COUNT(*) FROM t WHERE year > 1995").scan_profile["predicates"] == {"year:SORTED_INDEX": 3}


def test_engine_folds_segment_heat_and_meters(tp):
    """Each executed segment folds one heat record (docs scanned, bytes of
    its host arrays); a pruned one none. The scan meters count the
    predicates by path and the segments queried and pruned."""
    _, ports = tp
    eng = ports["built"]
    reg = server_metrics()
    before_q = reg.meter(ServerMeter.NUM_SEGMENTS_QUERIED).count
    before_p = reg.meter(ServerMeter.NUM_SEGMENTS_PRUNED).count
    before_s = reg.meter(ScanMeter.PREDICATES, table="t", index="SORTED_INDEX").count
    res = eng.execute("SELECT COUNT(*) FROM t WHERE year = 1998")
    live = [s for s in eng.segments if s.columns["year"].stats.max_value >= 1998]
    snap = HEAT.snapshot()
    assert {r["segment"] for r in snap["segments"]} == {s.name for s in live}
    assert sum(r["docsScanned"] for r in snap["segments"]) == res.rows[0][0]
    assert {r["segment"]: r["bytesTouched"] for r in snap["segments"]} == {s.name: s.size_bytes for s in live}
    assert reg.meter(ServerMeter.NUM_SEGMENTS_QUERIED).count - before_q == len(live)
    assert reg.meter(ServerMeter.NUM_SEGMENTS_PRUNED).count - before_p == len(eng.segments) - len(live)
    assert reg.meter(ScanMeter.PREDICATES, table="t", index="SORTED_INDEX").count - before_s == len(live)


def test_segment_size_bytes_matches_reference(tp):
    ref, ports = tp
    for jseg, seg in zip(ref.segments, ports["built"].segments):
        assert seg.size_bytes == jseg.size_bytes


def test_summary_folds_match_reference():
    """fold_segment_stats / fold_prune / merge_probe_sink /
    merge_scan_summaries give the reference's wire form."""
    recs = [
        {"segment": "a", "mode": "device", "predicates": [{"column": "x", "path": "SORTED_INDEX", "entries": 0},
                                                          {"column": "y", "path": "FULL_SCAN", "entries": 10}],
         "entriesInFilter": 10, "entriesPostFilter": 6, "docsMatched": 3,
         "fullScanFallbacks": [{"column": "y", "missedIndex": "RANGE_INDEX"}]},
        {"segment": "b", "mode": "host", "predicates": [{"column": "x", "path": "FULL_SCAN", "entries": 7}],
         "entriesInFilter": 7, "entriesPostFilter": 2, "docsMatched": 1, "fullScanFallbacks": []},
    ]
    out = []
    for mod in (scan_stats, jscan_stats):
        s = mod.new_scan_summary()
        for r in recs:
            mod.fold_segment_stats(s, r)
        mod.fold_prune(s, "value")
        mod.fold_prune(s, "bloom")
        mod.merge_probe_sink(s, {"bloom": 4})
        other = mod.new_scan_summary()
        mod.fold_segment_stats(other, recs[0])
        mod.merge_scan_summaries(s, other)
        mod.merge_scan_summaries(s, None)
        out.append(s)
    assert out[0] == out[1]


# -- the heat registry --------------------------------------------------------


class _Clock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def _both(**kw):
    clock = _Clock()
    return clock, SegmentHeatRegistry(now_fn=clock, **kw), JSegmentHeatRegistry(now_fn=clock, **kw)


def test_heat_fold_and_halflife_decay():
    clock, reg, jreg = _both(halflife_s=10.0)
    for r in (reg, jreg):
        r.record("t", "s0", docs_scanned=100, bytes_touched=4096, device_ms=1.5)
    assert reg.snapshot() == jreg.snapshot()
    row = reg.snapshot()["segments"][0]
    assert row["heat"] == pytest.approx(1.0) and row["docsScanned"] == 100 and row["bytesTouched"] == 4096
    clock.t += 10.0
    assert reg.snapshot()["segments"][0]["heat"] == pytest.approx(0.5, rel=1e-6)
    for r in (reg, jreg):
        r.record("t", "s0")
    assert reg.snapshot() == jreg.snapshot()
    assert reg.snapshot()["segments"][0]["heat"] == pytest.approx(1.5, rel=1e-6)


def test_heat_ranking_and_cold_inversion():
    clock, reg, jreg = _both()
    for r in (reg, jreg):
        for name, q in (("hot", 5), ("warm", 2), ("cold", 1)):
            r.record("t", name, queries=q)
    assert reg.snapshot() == jreg.snapshot()
    assert [x["segment"] for x in reg.snapshot()["segments"]] == ["hot", "warm", "cold"]
    assert reg.snapshot(cold=True) == jreg.snapshot(cold=True)
    assert reg.snapshot(top=1) == jreg.snapshot(top=1)
    assert reg.snapshot(top=1)["count"] == 3


def test_heat_bound_evicts_coldest():
    clock, reg, jreg = _both(max_entries=3)
    for r in (reg, jreg):
        r.record("t", "a", queries=1)
        r.record("t", "b", queries=3)
        r.record("t", "c", queries=2)
        r.record("t", "d", queries=5)
    assert {x["segment"] for x in reg.snapshot()["segments"]} == {"b", "c", "d"}
    assert reg.snapshot() == jreg.snapshot()
