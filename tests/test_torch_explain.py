"""EXPLAIN PLAN FOR and EXPLAIN ANALYZE through the port and the JAX package:
the single-stage cases of tests/test_explain.py and more (its multistage
cases are in tests/test_torch_multistage_nulls.py). The operator rows must be
equal letter for letter; under EXPLAIN ANALYZE the measured `timeMs` and
`wallMs` are masked, every other figure (rows, docsScanned, segmentsPruned,
entries) must be equal."""

import re

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
from pinot_tpu.common.config import StarTreeIndexConfig as JStarTreeIndexConfig
from pinot_tpu.common.config import TableConfig as JTableConfig
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, IndexingConfig, Schema, StarTreeIndexConfig, TableConfig
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query.sql import SqlParseError, parse_sql
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_pruner import pair, time_columns, time_partitioned
from test_torch_segment import describe

COLUMNS = ["Operator", "Operator_Id", "Parent_Id"]


def _dv(seed: int = 61, n: int = 1000) -> dict:
    """tests/test_explain.py's fixture: d (two strings) and v (LONG)."""
    rng = np.random.default_rng(seed)
    return {
        "d": np.asarray(["a", "b"], dtype=object)[rng.integers(0, 2, n)],
        "v": rng.integers(0, 100, n).astype(np.int64),
    }


def dv_columns(DT):
    return dict(dimensions=[("d", DT.STRING)], metrics=[("v", DT.LONG)])


@pytest.fixture(scope="module")
def dv():
    return pair("t", dv_columns, [_dv()])


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


def mask_times(rows: list[list]) -> list[list]:
    return [[re.sub(r"(timeMs|wallMs)=[0-9.]+", r"\1=*", r[0]), r[1], r[2]] for r in rows]


def assert_same_explain(got, want, sql: str) -> None:
    assert got.columns == want.columns == COLUMNS, sql
    assert mask_times(got.rows) == mask_times(want.rows), sql
    assert got.column_types == want.column_types, sql
    ids = {r[1] for r in got.rows}
    assert all(r[2] in ids or r[2] == -1 for r in got.rows), sql


DV_QUERIES = [
    "EXPLAIN PLAN FOR SELECT d, SUM(v), COUNT(*) FROM t WHERE v > 10 GROUP BY d",
    "EXPLAIN PLAN FOR SELECT MODE(v) FROM t",
    "EXPLAIN PLAN FOR SELECT d, v FROM t WHERE d = 'a' LIMIT 5",
    "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t",
    "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t WHERE d = 'a' AND v > 10",
    "EXPLAIN PLAN FOR SELECT d, v FROM t WHERE v < 50 ORDER BY v DESC, d LIMIT 7",
    "EXPLAIN PLAN FOR SELECT DISTINCT d FROM t WHERE v BETWEEN 3 AND 40",
    "EXPLAIN PLAN FOR SELECT d, MIN(v), MAX(v), AVG(v), DISTINCTCOUNT(v) FROM t WHERE NOT d = 'b' OR v IN (1, 2, 3) GROUP BY d",
    "EXPLAIN PLAN FOR SELECT SUM(v) FILTER (WHERE d = 'a'), COUNT(*) FROM t",
    "EXPLAIN PLAN FOR SELECT SUM(v) FROM t WHERE v > 1000",
    "SET enableNullHandling = true; EXPLAIN PLAN FOR SELECT SUM(v), MIN(v) FROM t WHERE v > 5",
    "EXPLAIN PLAN FOR SELECT d, PERCENTILE(v, 90) FROM t GROUP BY d",
    "EXPLAIN PLAN FOR SELECT d, DISTINCTCOUNTHLL(v) FROM t WHERE d LIKE 'a%' GROUP BY d",
    "EXPLAIN ANALYZE SELECT d, SUM(v) FROM t WHERE v > 10 GROUP BY d",
    "EXPLAIN ANALYZE SELECT COUNT(*) FROM t WHERE d = 'a' AND v > 10",
    "EXPLAIN ANALYZE SELECT MODE(v) FROM t WHERE v > 3",
    "EXPLAIN ANALYZE SELECT d, v FROM t WHERE v > 90 ORDER BY v LIMIT 4",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", DV_QUERIES)
def test_explain_matches_reference(dv, sql, mode):
    ref, ports = dv
    assert_same_explain(ports[mode].execute(sql), ref.execute(sql), sql)


TP_QUERIES = [
    "EXPLAIN PLAN FOR SELECT region, city, SUM(revenue), COUNT(*), MIN(qty), MAX(qty) FROM t WHERE year = 1997 "
    "GROUP BY region, city ORDER BY SUM(revenue) DESC LIMIT 1000",
    "EXPLAIN ANALYZE SELECT region, city, SUM(revenue), COUNT(*), MIN(qty), MAX(qty) FROM t WHERE year = 1997 "
    "GROUP BY region, city ORDER BY SUM(revenue) DESC LIMIT 1000",
    "EXPLAIN ANALYZE SELECT COUNT(*), SUM(revenue) FROM t WHERE year = 2005",
    "EXPLAIN ANALYZE SELECT custkey, SUM(revenue) FROM t WHERE year BETWEEN 1997 AND 1998 AND qty > 10 "
    "GROUP BY custkey ORDER BY SUM(revenue) DESC LIMIT 10",
    "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t WHERE year IN (1993, 1994) AND region <> 'ASIA'",
    "EXPLAIN ANALYZE SELECT year, COUNT(*) FROM t WHERE year <> 1995 GROUP BY year ORDER BY year",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", TP_QUERIES)
def test_explain_time_partitioned_matches_reference(tp, sql, mode):
    """The sorted year column: FILTER_SORTED_INDEX(year) rows, its entries,
    and the pruned segments' count, equal."""
    ref, ports = tp
    got = ports[mode].execute(sql)
    assert_same_explain(got, ref.execute(sql), sql)
    ops = [r[0] for r in got.rows]
    assert any(o.startswith("FILTER_SORTED_INDEX(year)") for o in ops)


def test_explain_does_not_execute(dv):
    """EXPLAIN PLAN FOR plans the first segment and runs nothing."""
    _, ports = dv
    eng = ports["built"]
    eng.segment_modes.clear()
    res = eng.execute("EXPLAIN PLAN FOR SELECT COUNT(*) FROM t")
    assert all(isinstance(r[0], str) for r in res.rows)
    assert not eng.segment_modes


def test_explain_analyze_segment_scan_rows(tp):
    """One SEGMENT_SCAN row per executed (unpruned) segment, with its matched
    docs, and the root's counts, against the reference's."""
    ref, ports = tp
    sql = "EXPLAIN ANALYZE SELECT COUNT(*) FROM t WHERE year = 1997"
    got, want = ports["built"].execute(sql), ref.execute(sql)
    scans = [r[0] for r in got.rows if r[0].startswith("SEGMENT_SCAN(")]
    live = [s for s in ports["built"].segments if s.columns["year"].stats.min_value <= 1997 <= s.columns["year"].stats.max_value]
    assert len(scans) == len(live) >= 1
    assert f"segmentsPruned={len(ports['built'].segments) - len(live)}" in got.rows[0][0]
    assert mask_times(got.rows) == mask_times(want.rows)


def _star(name, data, star):
    jcfg = JTableConfig(name, indexing=JIndexingConfig(star_tree_configs=[JStarTreeIndexConfig(*star)]))
    cfg = TableConfig(name, IndexingConfig(star_tree_configs=[StarTreeIndexConfig(*star)]))
    jseg = JBuilder(JSchema.build(name, **dv_columns(JDT)), jcfg).build(data, "st0")
    built = SegmentBuilder(Schema.build(name, **dv_columns(DataType)), cfg).build(data, "st0")
    return jseg, built


@pytest.mark.parametrize(
    "sql",
    [
        "EXPLAIN PLAN FOR SELECT d, SUM(v) FROM s GROUP BY d",
        "EXPLAIN PLAN FOR SELECT d, SUM(v) FROM s WHERE d = 'a' GROUP BY d",
        "EXPLAIN PLAN FOR SELECT d, MAX(v) FROM s GROUP BY d",
        "EXPLAIN ANALYZE SELECT d, SUM(v) FROM s GROUP BY d",
    ],
)
def test_explain_startree_swap(sql):
    """tests/test_explain.py's star-tree case: STARTREE_SWAP where a star
    table matches, the device program where none does."""
    jseg, built = _star("s", _dv(67), (["d"], ["SUM__v"]))
    want = JEngine([jseg]).execute(sql)
    for seg in (built, segment_from_numpy(describe(jseg))):
        assert_same_explain(QueryEngine([seg], device="cpu").execute(sql), want, sql)


def test_explain_upsert_validity_skips_the_star_tree():
    """A segment with a validity: no STARTREE_SWAP, and the validity is a
    FILTER_DOCMASK under the program's AND."""
    jseg, built = _star("s", _dv(67), (["d"], ["SUM__v"]))
    live = np.arange(1000) % 3 == 0
    for s in (jseg, built):
        s.extras["valid_docs"] = lambda nd: live[:nd]
    sql = "EXPLAIN PLAN FOR SELECT d, SUM(v) FROM s GROUP BY d"
    got, want = QueryEngine([built], device="cpu").execute(sql), JEngine([jseg]).execute(sql)
    assert_same_explain(got, want, sql)
    ops = [r[0] for r in got.rows]
    assert "FILTER_DOCMASK" in ops and not any(o.startswith("STARTREE_SWAP") for o in ops)


def test_explain_parse():
    stmt = parse_sql("EXPLAIN ANALYZE SELECT COUNT(*) FROM t")
    assert stmt.explain_analyze and not stmt.explain
    assert parse_sql("EXPLAIN PLAN FOR SELECT COUNT(*) FROM t").explain
    with pytest.raises(SqlParseError):
        parse_sql("EXPLAIN SELECT 1 FROM t")


def test_explain_of_no_segment():
    sql = "EXPLAIN PLAN FOR SELECT COUNT(*) FROM t"
    assert QueryEngine([], device="cpu").execute(sql).rows == JEngine([]).execute(sql).rows
