"""Segment pruning through the port and the JAX package: a time-partitioned
table (rows sorted by year, cut into segments, as ingestion by time lays
them out) queried with predicates the min/max pruner can and cannot decide.
Rows, numDocsScanned, the pruning funnel and the scan-path counts must be
equal, exactly; a pruned segment is never planned or staged. The port runs
on device="cpu" over its own segments built from the same arrays ("built")
and over the reference's carried across with segment_from_numpy
("carried")."""

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import pruner as jpruner
from pinot_tpu.query.context import QueryContext as JQueryContext
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import pruner
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_segment import describe

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]


def time_columns(DT):
    return dict(
        dimensions=[("year", DT.INT), ("region", DT.STRING), ("city", DT.STRING), ("custkey", DT.INT)],
        metrics=[("revenue", DT.LONG), ("qty", DT.INT)],
    )


def time_partitioned(seed: int = 5, n: int = 6000, n_segments: int = 6) -> list[dict]:
    """Rows sorted by year (1992-1998), cut into n_segments equal chunks:
    each segment holds one or two years, its year column sorted."""
    rng = np.random.default_rng(seed)
    data = {
        "year": np.sort(rng.integers(1992, 1999, n)).astype(np.int32),
        "region": np.asarray(REGIONS, dtype=object)[rng.integers(0, 5, n)],
        "city": np.asarray([f"c{i:02d}" for i in range(40)], dtype=object)[rng.integers(0, 40, n)],
        "custkey": rng.integers(1, 500, n).astype(np.int32),
        "revenue": rng.integers(0, 10**6, n).astype(np.int64),
        "qty": rng.integers(1, 51, n).astype(np.int32),
    }
    cut = np.linspace(0, n, n_segments + 1).astype(int)
    return [{k: v[a:b] for k, v in data.items()} for a, b in zip(cut[:-1], cut[1:])]


def pair(name: str, cols, datas: list[dict]):
    """(reference engine, {"built": port engine, "carried": port engine})."""
    jsegs = [JBuilder(JSchema.build(name, **cols(JDT))).build(d, f"{name}{i}") for i, d in enumerate(datas)]
    built = [SegmentBuilder(Schema.build(name, **cols(DataType))).build(d, f"{name}{i}") for i, d in enumerate(datas)]
    carried = [segment_from_numpy(describe(s)) for s in jsegs]
    return JEngine(jsegs), {"built": QueryEngine(built, device="cpu"), "carried": QueryEngine(carried, device="cpu")}


STATS = (
    "num_docs_scanned",
    "total_docs",
    "num_segments_queried",
    "num_segments_pruned",
    "num_segments_pruned_by_value",
    "num_segments_pruned_by_bloom",
    "num_segments_pruned_by_geo",
    "num_entries_scanned_in_filter",
    "num_entries_scanned_post_filter",
    "scan_profile",
)


def assert_same_result(got, want, sql: str) -> None:
    """Rows (values and Python types), columns and every stats field equal."""
    assert got.columns == want.columns, sql
    assert got.rows == want.rows, sql
    assert [[type(v) for v in r] for r in got.rows] == [[type(v) for v in r] for r in want.rows], sql
    for f in STATS:
        assert getattr(got, f) == getattr(want, f), (sql, f)


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


QUERIES = [
    "SELECT COUNT(*) FROM t WHERE year = 1995",
    "SELECT region, SUM(revenue), COUNT(*), MIN(qty), MAX(qty) FROM t WHERE year = 1996 "
    "GROUP BY region ORDER BY SUM(revenue) DESC LIMIT 10",
    "SELECT custkey, SUM(revenue) FROM t WHERE year BETWEEN 1993 AND 1994 GROUP BY custkey "
    "ORDER BY SUM(revenue) DESC, custkey LIMIT 20",
    "SELECT COUNT(*), SUM(qty) FROM t WHERE year IN (1992, 1998)",
    "SELECT COUNT(*) FROM t WHERE year > 1996",
    "SELECT COUNT(*) FROM t WHERE year <= 1993",
    "SELECT region, COUNT(*) FROM t WHERE year >= 1997 AND region = 'ASIA' GROUP BY region",
    "SELECT COUNT(*) FROM t WHERE year < 1993 OR year > 1997",
    "SELECT COUNT(*) FROM t WHERE 1995 = year",
    "SELECT COUNT(*) FROM t WHERE 1996 < year",
    "SELECT COUNT(*) FROM t WHERE year <> 1995",
    "SELECT COUNT(*) FROM t WHERE NOT year = 1995",
    "SELECT COUNT(*) FROM t WHERE year = 2005",
    "SELECT COUNT(*) FROM t WHERE region = 'ZZZ'",
    "SELECT COUNT(*) FROM t WHERE region > 'EUROPE'",
    "SELECT COUNT(*) FROM t WHERE year BETWEEN 2001 AND 2003 OR region = 'ASIA'",
    "SELECT AVG(revenue), MINMAXRANGE(qty), DISTINCTCOUNT(city) FROM t WHERE year = 1994",
    "SELECT year, region FROM t WHERE year = 1994 LIMIT 5",
    "SELECT year, revenue FROM t WHERE year >= 1997 ORDER BY revenue DESC LIMIT 5",
    "SELECT DISTINCT region FROM t WHERE year = 1998 ORDER BY region",
    # every segment pruned, for every query type
    "SELECT region, SUM(revenue) FROM t WHERE year = 2005 GROUP BY region",
    "SELECT year, region FROM t WHERE year = 2005 LIMIT 5",
    "SELECT year, revenue FROM t WHERE year = 2005 ORDER BY revenue DESC LIMIT 5",
    "SELECT DISTINCT region FROM t WHERE year = 2005",
    "SELECT COUNT(*), SUM(revenue), MIN(qty), MAX(qty), AVG(qty), DISTINCTCOUNT(city), "
    "DISTINCTCOUNTHLL(city), PERCENTILEEST(revenue, 50) FROM t WHERE year = 2005",
    # the null-handling identities of an all-pruned query: NULL, not 0
    "SET enableNullHandling = true; SELECT COUNT(*), SUM(revenue) FROM t WHERE year = 2005",
    "SET enableNullHandling = true; SELECT COUNT(*), SUM(revenue), AVG(revenue), MIN(qty) FROM t WHERE year = 1900",
    "SET enableNullHandling = true; SELECT SUM(revenue) FROM t WHERE year = 1997",
    "SET enableNullHandling = true; SELECT region, SUM(revenue) FROM t WHERE year = 1997 GROUP BY region ORDER BY region",
    "SELECT GAPFILL(year, 1990, 2000, 1, FILL(r, 'FILL_PREVIOUS_VALUE')), SUM(revenue) AS r FROM t "
    "WHERE year <> 1995 GROUP BY year ORDER BY year LIMIT 100",
    "SELECT GAPFILL(year, 1990, 2000, 1), COUNT(*) FROM t WHERE year >= 1997 GROUP BY year ORDER BY year LIMIT 100",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", QUERIES)
def test_pruned_queries_match_reference(tp, sql, mode):
    ref, ports = tp
    assert_same_result(ports[mode].execute(sql), ref.execute(sql), sql)


def test_pruned_counts_follow_the_min_max(tp):
    """The pruned count is the numpy count of segments whose [min, max] of
    year excludes the predicate, and segment_modes agrees."""
    _, ports = tp
    eng = ports["built"]
    for year in (1992, 1995, 1998, 2005):
        eng.segment_modes.clear()
        res = eng.execute(f"SELECT COUNT(*) FROM t WHERE year = {year}")
        want = sum(
            1 for s in eng.segments if not (s.columns["year"].stats.min_value <= year <= s.columns["year"].stats.max_value)
        )
        assert res.num_segments_pruned == res.num_segments_pruned_by_value == want
        assert eng.segment_modes["pruned"] == want
        assert sum(eng.segment_modes.values()) == len(eng.segments)


def test_pruned_segments_are_never_planned_or_staged(monkeypatch):
    """A pruned segment reaches neither plan_segment nor to_device_cached."""
    _, ports = pair("t", time_columns, time_partitioned(seed=9))
    eng = ports["built"]
    planned = []
    real_plan = __import__("pinot_tpu_torch.query.engine", fromlist=["plan_segment"]).plan_segment

    def spy(seg, ctx, valid_mask=None):
        planned.append(seg.name)
        return real_plan(seg, ctx, valid_mask=valid_mask)

    monkeypatch.setattr("pinot_tpu_torch.query.engine.plan_segment", spy)
    res = eng.execute("SELECT COUNT(*) FROM t WHERE year = 1998")
    live = [s.name for s in eng.segments if s.columns["year"].stats.max_value >= 1998]
    assert planned == live
    assert res.num_segments_pruned == len(eng.segments) - len(live)
    staged = [s.name for s in eng.segments if s._device_cache]
    assert staged == live


@pytest.mark.parametrize(
    "where",
    [
        "year = 1995",
        "1995 = year",
        "year <> 1995",
        "year > 1998",
        "year >= 1998",
        "year < 1992",
        "year <= 1992",
        "year BETWEEN 1990 AND 1991",
        "year NOT BETWEEN 1990 AND 1991",
        "year IN (1990, 2001)",
        "year NOT IN (1990, 2001)",
        "year = 1995 AND region = 'ASIA'",
        "year = 2001 OR region = 'ZZZ'",
        "region = 'AFRICA'",
        "region < 'AFRICA'",
        "region = 5",
        "city LIKE 'c1%'",
        "year + 0 = 1900",
        "year IS NULL",
        "NOT (year = 1995)",
        None,
    ],
)
def test_prune_reason_matches_reference(tp, where):
    """filter_prune_reason segment by segment, and filter_can_match, equal
    the reference's (the port's own copy of its routing helpers)."""
    ref, ports = tp
    sql = "SELECT COUNT(*) FROM t" + (f" WHERE {where}" if where else "")
    jctx, ctx = JQueryContext.from_sql(sql), QueryContext.from_sql(sql)
    for jseg, seg in zip(ref.segments, ports["built"].segments):
        assert pruner.prune_reason(seg, ctx) == jpruner.prune_reason(jseg, jctx), (where, seg.name)
        assert pruner.can_match(seg, ctx) == jpruner.can_match(jseg, jctx)


def test_empty_segment_prunes_by_value():
    ref, ports = pair("e", time_columns, [{k: v[:0] for k, v in time_partitioned()[0].items()}])
    for port in ports.values():
        assert pruner.prune_reason(port.segments[0], QueryContext.from_sql("SELECT COUNT(*) FROM e")) == "value"
    sql = "SELECT COUNT(*), SUM(revenue) FROM e"
    assert_same_result(ports["built"].execute(sql), ref.execute(sql), sql)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT COUNT(*), SUM(revenue), MIN(qty), MAX(qty), AVG(qty), MINMAXRANGE(qty) FROM t",
        "SELECT DISTINCTCOUNT(city), DISTINCTCOUNTHLL(city), PERCENTILEEST(revenue, 50), PERCENTILE(revenue, 90) FROM t",
        "SET enableNullHandling = true; SELECT SUM(revenue), COUNT(*), SUMMV(revenue) FROM t",
        "SELECT region, year, SUM(revenue), AVG(qty), COUNT(*) FROM t GROUP BY region, year",
        "SELECT DISTINCT region, year FROM t",
        "SELECT region, revenue FROM t ORDER BY revenue DESC, region LIMIT 3",
        "SELECT region, revenue, year FROM t LIMIT 3",
    ],
)
def test_empty_partial_matches_reference(tp, sql):
    """empty_partial of each query type: the aggregation identities equal the
    reference's, a frame has the reference's DataFrame's columns and no row."""
    ref, ports = tp
    ctx, jctx = ports["built"].make_context(sql), ref.make_context(sql)
    got, want = pruner.empty_partial(ctx), jpruner.empty_partial(jctx)
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            if isinstance(w, np.ndarray):
                assert isinstance(g, np.ndarray) and g.dtype == w.dtype and np.array_equal(g, w)
            elif isinstance(w, tuple) and isinstance(w[0], np.ndarray):
                assert np.array_equal(g[0], w[0]) and g[0].dtype == w[0].dtype and g[1:] == w[1:]
            else:
                assert type(g) is type(w) and g == w
    else:
        assert list(got) == list(want.columns)
        assert all(len(v) == 0 for v in got.values())
