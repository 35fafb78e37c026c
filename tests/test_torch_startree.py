"""The port's star tree (pinot_tpu_torch/segment/startree.py and
query/startree_exec.py) against the JAX package's, drawn from
tests/test_startree.py: the star tables the builders make, the `matches`
verdicts, and star-routed and non-matching queries through both engines
(rows and numDocsScanned), with segments built by the port and segments
carried across from the reference with their star tables.

Tolerance: dict ids, row order, __count and sums of integer-valued metrics
exactly equal; sums of a DOUBLE metric with fractional values within rtol
1e-12 (pandas' groupby sum in the reference is compensated, the port's adds
in row order). Query rows exactly equal, with the reference's Python types."""

import math

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import IndexingConfig as JIndexingConfig
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common import TableConfig as JTableConfig
from pinot_tpu.common.config import StarTreeIndexConfig as JStarTreeIndexConfig
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import startree_exec as jstartree_exec
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, IndexingConfig, Schema, StarTreeIndexConfig, TableConfig
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import startree_exec
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_segment import describe

PAIRS = [
    ["SUM__impressions", "SUM__clicks", "MIN__clicks", "MAX__impressions", "sum__score", "AVG__score", "COUNT__*"],
    ["SUM__impressions", "COUNT__*"],
]
SPLITS = [["country", "device", "year"], ["country", "device"]]


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "country": np.array([f"C{i:02d}" for i in range(20)], dtype=object)[rng.integers(0, 20, n)],
        "device": np.array(["phone", "desktop", "tablet"], dtype=object)[rng.integers(0, 3, n)],
        "year": rng.integers(2018, 2024, n).astype(np.int32),
        "impressions": rng.integers(1, 1000, n).astype(np.int64),
        "clicks": rng.integers(0, 50, n).astype(np.int64),
        "score": np.round(rng.normal(0, 100, n), 3),
    }


def _schema(DT, S):
    return S.build(
        "sales",
        dimensions=[("country", DT.STRING), ("device", DT.STRING), ("year", DT.INT)],
        metrics=[("impressions", DT.LONG), ("clicks", DT.LONG), ("score", DT.DOUBLE)],
    )


def _configs(IC, TC, SC):
    return TC("sales", indexing=IC(star_tree_configs=[SC(list(d), list(p)) for d, p in zip(SPLITS, PAIRS)]))


@pytest.fixture(scope="module")
def setup():
    datas = [_data(21 + i, n) for i, n in enumerate([12_000, 1, 7_000])]
    jcfg = _configs(JIndexingConfig, JTableConfig, JStarTreeIndexConfig)
    cfg = _configs(IndexingConfig, TableConfig, StarTreeIndexConfig)
    jsegs = [JBuilder(_schema(JDT, JSchema), jcfg).build(d, f"s{i}") for i, d in enumerate(datas)]
    built = [SegmentBuilder(_schema(DataType, Schema), cfg).build(d, f"s{i}") for i, d in enumerate(datas)]
    carried = [segment_from_numpy(describe(s)) for s in jsegs]
    plain = [JBuilder(_schema(JDT, JSchema)).build(d, f"p{i}") for i, d in enumerate(datas)]
    return {
        "ref": JEngine(jsegs),
        "plain": JEngine(plain),
        "built": QueryEngine(built, device="cpu"),
        "carried": QueryEngine(carried, device="cpu"),
    }


def test_star_tables_match_reference(setup):
    for jseg, seg in zip(setup["ref"].segments, setup["built"].segments):
        jtabs, tabs = jseg.extras["startree"], seg.extras["startree"]
        assert len(tabs) == len(jtabs) == 2
        for jst, st in zip(jtabs, tabs):
            assert st.dimensions == jst.dimensions
            assert st.function_column_pairs == jst.function_column_pairs
            assert st.n_rows == jst.n_rows
            assert sorted(st.arrays) == sorted(jst.arrays)
            for name, want in jst.arrays.items():
                got = st.arrays[name]
                assert got.dtype == want.dtype and got.shape == want.shape, name
                if name.endswith("__score"):
                    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
                else:
                    np.testing.assert_array_equal(got, want, err_msg=name)


def test_star_table_compacts(setup):
    seg = setup["built"].segments[0]
    assert seg.extras["startree"][0].n_rows <= 20 * 3 * 6
    assert seg.extras["startree"][1].n_rows == 20 * 3


MATCH_QUERIES = [
    "SELECT COUNT(*) FROM sales",
    "SELECT SUM(impressions) FROM sales WHERE country = 'C03'",
    "SELECT device, SUM(clicks), COUNT(*) FROM sales WHERE year >= 2020 GROUP BY device",
    "SELECT country, AVG(impressions) FROM sales GROUP BY country",
    "SELECT MIN(clicks), MAX(impressions) FROM sales",
    "SELECT MIN(impressions) FROM sales",  # no MIN pair for impressions
    "SELECT year, MINMAXRANGE(impressions) FROM sales GROUP BY year",
    "SELECT DISTINCTCOUNT(country), DISTINCTCOUNTHLL(device) FROM sales",
    "SELECT DISTINCTCOUNTHLL(clicks) FROM sales",  # not a split dimension
    "SELECT COUNT(*) FROM sales WHERE clicks > 25",  # filter outside the dims
    "SELECT SUM(impressions + 1) FROM sales",  # an expression argument
    "SELECT COUNT(*) FILTER (WHERE year = 2020) FROM sales",
    "SELECT country FROM sales LIMIT 3",  # selection
    "SELECT DISTINCT country FROM sales",
    "SELECT SUM(score), AVG(score) FROM sales WHERE device <> 'phone'",
    "SELECT COUNT(*) FROM sales WHERE country IS NOT NULL",
]


@pytest.mark.parametrize("sql", MATCH_QUERIES)
def test_matches_gives_the_reference_verdicts(setup, sql):
    jseg, seg = setup["ref"].segments[0], setup["built"].segments[0]
    jctx, ctx = setup["ref"].make_context(sql), setup["built"].make_context(sql)
    want = [jstartree_exec.matches(jctx, st) for st in jseg.extras["startree"]]
    assert [startree_exec.matches(ctx, st) for st in seg.extras["startree"]] == want


STAR_QUERIES = [
    "SELECT COUNT(*) FROM sales",
    "SELECT SUM(impressions) FROM sales WHERE country = 'C03'",
    "SELECT device, SUM(clicks), COUNT(*) FROM sales WHERE year >= 2020 GROUP BY device ORDER BY device LIMIT 10",
    "SELECT country, AVG(impressions) FROM sales GROUP BY country ORDER BY AVG(impressions) DESC LIMIT 5",
    "SELECT MIN(clicks), MAX(impressions) FROM sales WHERE device IN ('phone','tablet')",
    "SELECT year, MINMAXRANGE(impressions) FROM sales GROUP BY year ORDER BY year LIMIT 10",
    "SELECT DISTINCTCOUNT(country) FROM sales WHERE device = 'phone'",
    "SELECT device, DISTINCTCOUNTHLL(country), COUNT(*) FROM sales GROUP BY device ORDER BY device",
    "SELECT DISTINCTCOUNTHLL(year) FROM sales WHERE country BETWEEN 'C05' AND 'C12'",
    "SELECT country, device, SUM(impressions) FROM sales GROUP BY country, device "
    "ORDER BY SUM(impressions) DESC LIMIT 7",
    # BASELINE config 5's star query (the first table that matches answers)
    "SELECT country, SUM(impressions) FROM sales GROUP BY country ORDER BY SUM(impressions) DESC LIMIT 5",
    "SELECT country, COUNT(*) FROM sales WHERE country = 'nowhere' GROUP BY country",
    # non-matching: the per-doc path
    "SELECT COUNT(*) FROM sales WHERE clicks > 25",
    "SELECT MIN(impressions), COUNT(*) FROM sales WHERE year = 2019",
    "SELECT device, DISTINCTCOUNTHLL(clicks) FROM sales GROUP BY device ORDER BY device",
]
#: queries whose rows hold sums of the DOUBLE metric (rtol 1e-12)
DOUBLE_QUERIES = [
    "SELECT SUM(score), AVG(score), COUNT(*) FROM sales WHERE device <> 'phone'",
    "SELECT year, AVG(score) FROM sales GROUP BY year ORDER BY year LIMIT 10",
]


def _assert_rows(got, want, approx):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [type(v) for v in g] == [type(v) for v in w]
        for a, b in zip(g, w):
            assert math.isclose(a, b, rel_tol=1e-12) if approx and isinstance(a, float) else a == b, (g, w)


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", STAR_QUERIES + DOUBLE_QUERIES)
def test_queries_match_reference(setup, sql, mode):
    want = setup["ref"].execute(sql)
    got = setup[mode].execute(sql)
    assert got.columns == want.columns
    _assert_rows(got.rows, want.rows, sql in DOUBLE_QUERIES)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.total_docs == want.total_docs


def test_star_route_scans_star_rows(setup):
    """A matching query scans the star tables' rows, a non-matching one the
    segments' docs, and both give the raw scan's answer."""
    port, plain = setup["built"], setup["plain"]
    sql = "SELECT country, SUM(impressions) FROM sales GROUP BY country ORDER BY SUM(impressions) DESC LIMIT 5"
    res = port.execute(sql)
    assert res.rows == plain.execute(sql).rows
    assert res.num_docs_scanned == sum(seg.extras["startree"][0].n_rows for seg in port.segments)
    sql = "SELECT COUNT(*) FROM sales WHERE clicks > 25"
    res = port.execute(sql)
    assert res.rows == plain.execute(sql).rows
    assert res.num_docs_scanned == res.rows[0][0]
    # the star segment is built once and kept on its parent
    assert all("startree_seg:0" in seg.extras for seg in port.segments)


def test_star_tree_config_round_trips_as_the_reference_writes_it():
    ref = JStarTreeIndexConfig(["country", "device"], ["SUM__impressions", "COUNT__*"], 500)
    port = StarTreeIndexConfig.from_dict(ref.to_dict())
    assert port.to_dict() == ref.to_dict()
    assert JStarTreeIndexConfig.from_dict(port.to_dict()) == ref
