"""The multistage cases of tests/test_null_handling.py, test_case_filter.py
and test_explain.py through the port's engine and the JAX package's.

Null handling reaches every operator of the port's numpy runtime: the leaf
Scan puts None in an object column where a null vector says so, the Kleene
WHERE runs as the leaf's `mask` program, COUNT(col) skips None, an all-null
SUM is NULL through the partial, final and plain aggregates, HAVING and
post-aggregation arithmetic see NULL cells, and IS DISTINCT FROM compares
across a join. Rows are held to the reference's as in
tests/test_torch_multistage.py (Python type and value, a float at rtol
1e-12, in order where ORDER BY defines one); EXPLAIN rows are equal, and
EXPLAIN ANALYZE's with the measured milliseconds masked.
"""

import re

import numpy as np
import pytest

from pinot_tpu.common.config import IndexingConfig as JIC
from pinot_tpu.common.config import TableConfig as JTC
from pinot_tpu.multistage import MultistageEngine as JEngine
from pinot_tpu_torch.common.config import IndexingConfig, TableConfig
from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics
from test_torch_multistage import both_segments, check, port_engine

SET_ON = "SET enableNullHandling = true; "


def _null_cfg(name):
    return JTC(name, indexing=JIC(null_handling=True)), TableConfig(name, indexing=IndexingConfig(null_handling=True))


def _gv_schema(name, x=False):
    def schema(DT, S):
        metrics = [("v", DT.LONG)] + ([("x", DT.DOUBLE)] if x else [])
        return S.build(name, dimensions=[("g", DT.STRING)], metrics=metrics)

    return schema


@pytest.fixture(scope="module")
def nulls():
    """tests/test_null_handling.py's table: 3,000 rows, v and x null on a
    seeded 20%, in two segments with null vectors."""
    rng = np.random.default_rng(29)
    n = 3000
    v = rng.integers(1, 100, n).astype(object)
    x = np.round(rng.normal(10, 3, n), 3).astype(object)
    null = rng.random(n) < 0.2
    v[null] = None
    x[null] = None
    data = {"g": np.asarray(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)], "v": v, "x": x}
    half = n // 2
    segs = [
        both_segments(_gv_schema("t", x=True), {k: a[s] for k, a in data.items()}, f"n{i}", _null_cfg("t"))
        for i, s in enumerate((slice(0, half), slice(half, n)))
    ]
    return JEngine({"t": [s[0] for s in segs]}, n_workers=2), port_engine({"t": [s[1] for s in segs]}, n_workers=2)


@pytest.mark.parametrize(
    "sql,ordered",
    [
        (SET_ON + "SELECT v FROM t LIMIT 5000", False),
        (SET_ON + "SELECT SUM(v) FROM t", True),
        (SET_ON + "SELECT g, AVG(v) FROM t GROUP BY g ORDER BY g LIMIT 10", True),
        ("SELECT COUNT(*) FROM t a JOIN t b ON a.g = b.g WHERE a.v IS DISTINCT FROM b.v LIMIT 5", True),
        (SET_ON + "SELECT COUNT(*) FROM t WHERE v < 1000", True),
        (SET_ON + "SELECT COUNT(*) FROM t WHERE NOT (v > 50)", True),
        (SET_ON + "SELECT v FROM t WHERE v < 1000 LIMIT 10000", False),
        (SET_ON + "SELECT g, COUNT(v), MODE(v) FROM t GROUP BY g ORDER BY g LIMIT 10", True),
        (SET_ON + "SELECT COUNT(v), MODE(v) FROM t", True),
        (SET_ON + "SELECT g, SUM(x), MIN(x), MAX(v) FROM t GROUP BY g ORDER BY g LIMIT 10", True),
    ],
)
def test_null_handling_queries_match_reference(nulls, sql, ordered):
    check(nulls, sql, ordered)


def test_kleene_leaf_filter_stays_on_the_device(nulls):
    """A selection's leaf Scan runs the Kleene WHERE as the `mask` program:
    the leaf device-scan meter ticks, the fallback meter does not."""
    dev = server_metrics().meter(ServerMeter.MULTISTAGE_LEAF_DEVICE_SCANS)
    fb = server_metrics().meter(ServerMeter.DEVICE_FALLBACKS)
    before_dev, before_fb = dev.count, fb.count
    check(nulls, SET_ON + "SELECT v FROM t WHERE v < 1000 LIMIT 10000", False)
    assert dev.count > before_dev and fb.count == before_fb


def test_count_col_filter_counts_rows():
    """The plain grouped path's COUNT(col) FILTER (...) counts rows."""
    rng = np.random.default_rng(31)
    n = 500
    data = {
        "g": np.asarray(["a", "b"], dtype=object)[rng.integers(0, 2, n)],
        "v": rng.integers(10, 100, n).astype(np.int64),
        "x": rng.integers(0, 2, n).astype(np.int64),
    }
    schema = lambda DT, S: S.build("p", dimensions=[("g", DT.STRING)], metrics=[("v", DT.LONG), ("x", DT.LONG)])  # noqa: E731
    s = both_segments(schema, data, "p0")
    engines = (JEngine({"p": [s[0]]}, n_workers=2), port_engine({"p": [s[1]]}, n_workers=2))
    check(engines, "SELECT g, COUNT(v) FILTER (WHERE x = 1), MODE(v) FROM p GROUP BY g ORDER BY g LIMIT 10", True)


def _small(name, g, v):
    s = both_segments(_gv_schema(name), {"g": np.asarray(g, dtype=object), "v": np.asarray(v, dtype=object)}, "s0", _null_cfg(name))
    return JEngine({name: [s[0]]}, n_workers=2), port_engine({name: [s[1]]}, n_workers=2)


@pytest.mark.parametrize(
    "sql",
    [
        SET_ON + "SELECT SUM(v) FROM t5 WHERE g = 'zzz'",
        SET_ON + "SELECT SUM(v) FROM t5 WHERE v IS NULL",
        SET_ON + "SELECT g, COUNT(v + 0), SUM(v + 0) FROM t5 GROUP BY g ORDER BY g LIMIT 10",
    ],
)
def test_final_aggregate_null_partials(sql):
    engines = _small("t5", ["a", "a", "a", "b", "b", "b"], [1, 2, None, None, None, None])
    got = check(engines, sql, True)
    if "COUNT(v + 0)" in sql:
        assert got.rows == [["a", 2, 3.0], ["b", 0, None]]
    else:
        assert got.rows == [[None]]


@pytest.mark.parametrize(
    "sql",
    [
        SET_ON + "SELECT g, SUM(v) FROM t6 GROUP BY g HAVING SUM(v) > 0 ORDER BY g LIMIT 10",
        SET_ON + "SELECT g, SUM(v) + 1 FROM t6 GROUP BY g ORDER BY g LIMIT 10",
        SET_ON + "SELECT SUM(v), MODE(v) FROM t6 WHERE v IS NULL",
    ],
)
def test_having_and_postagg_over_null_aggregate(sql):
    check(_small("t6", ["a", "a", "b"], [1, 2, None]), sql, True)


@pytest.fixture(scope="module")
def case_table():
    """tests/test_case_filter.py's table (20,000 rows, seed 11)."""
    rng = np.random.default_rng(11)
    n = 20_000
    data = {
        "cat": np.array(["a", "b", "c", "d"], dtype=object)[rng.integers(0, 4, n)],
        "year": rng.integers(2018, 2024, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.int64),
        "w": rng.random(n).astype(np.float64) * 100,
    }
    schema = lambda DT, S: S.build(  # noqa: E731
        "t", dimensions=[("cat", DT.STRING), ("year", DT.INT)], metrics=[("v", DT.LONG), ("w", DT.DOUBLE)]
    )
    s = both_segments(schema, data, "s0")
    return JEngine({"t": [s[0]]}), port_engine({"t": [s[1]]})


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT t1.cat, SUM(CASE WHEN t1.year >= 2021 THEN t1.v ELSE 0 END) FROM t t1 GROUP BY t1.cat ORDER BY t1.cat LIMIT 10",
        "SELECT t1.year, COUNT(*) FILTER (WHERE t1.cat = 'a'), SUM(t1.v) FROM t t1 GROUP BY t1.year ORDER BY t1.year LIMIT 10",
        "SELECT t1.cat, MIN(t1.v) FILTER (WHERE t1.year >= 2030), MAX(t1.v) FILTER (WHERE t1.year >= 2030) "
        "FROM t t1 GROUP BY t1.cat ORDER BY t1.cat LIMIT 10",
        "SELECT t1.cat, SUM((CASE WHEN t1.year >= 2021 THEN t1.v ELSE 0 END) + t1.v) "
        "FILTER (WHERE t1.v > 100) FROM t t1 GROUP BY t1.cat ORDER BY t1.cat LIMIT 10",
        "SELECT t1.cat, AVG(t1.w), COUNT(*) FROM t t1 WHERE t1.w > 50 GROUP BY t1.cat ORDER BY t1.cat LIMIT 10",
    ],
)
def test_case_and_filter_queries_match_reference(case_table, sql):
    got = check(case_table, sql, True)
    if "2030" in sql:
        assert all(lo == float("inf") and hi == float("-inf") for _, lo, hi in got.rows)


@pytest.fixture(scope="module")
def explain_table():
    """tests/test_explain.py's table (1,000 rows, seed 61)."""
    rng = np.random.default_rng(61)
    n = 1000
    data = {"d": np.asarray(["a", "b"], dtype=object)[rng.integers(0, 2, n)], "v": rng.integers(0, 100, n).astype(np.int64)}
    schema = lambda DT, S: S.build("t", dimensions=[("d", DT.STRING)], metrics=[("v", DT.LONG)])  # noqa: E731
    s = both_segments(schema, data, "s0")
    return JEngine({"t": [s[0]]}, n_workers=2), port_engine({"t": [s[1]]}, n_workers=2)


@pytest.mark.parametrize("kind", ["EXPLAIN PLAN FOR", "EXPLAIN ANALYZE"])
def test_explain_multistage_matches_reference(explain_table, kind):
    ref, port = explain_table
    sql = f"{kind} SELECT d, SUM(v) FROM t GROUP BY d ORDER BY d LIMIT 10"

    def masked(rows):
        return [[re.sub(r"(wallMs|deviceMs)=[0-9.e+-]+", r"\1=_", r[0]), *r[1:]] for r in rows]

    want, got = ref.execute(sql), port.execute(sql)
    assert got.columns == want.columns == ["Operator", "Operator_Id", "Parent_Id"]
    assert masked(got.rows) == masked(want.rows)
    banner = "[stage 0 root x1] " if kind == "EXPLAIN ANALYZE" else "[root x1] "
    assert got.rows[0][0].startswith(banner)
