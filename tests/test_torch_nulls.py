"""enableNullHandling, CASE and FILTER (WHERE) through the port and the JAX
package: the single-stage cases of tests/test_null_handling.py and
tests/test_case_filter.py (their multistage `test_v2_*` / `test_multistage_*`
cases are in tests/test_torch_multistage_nulls.py). The port runs on
device="cpu", over its own segments built from the same arrays ("built") and
over the reference's carried across with segment_from_numpy ("carried"),
each by its own executor choice, and again with every segment forced onto
its host executor. Rows must be equal, with the reference's Python types and
row order, and so must numDocsScanned; only float values may differ, within
rtol 1e-12 (DOUBLE sums add in another order)."""

import math

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
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_segment import describe

SET_ON = "SET enableNullHandling = true; "


def _pair(name, cols, datas, null_handling=False, star=None):
    """(reference engine, {"built": port engine, "carried": port engine}) over
    one segment a data dict."""
    jcfg = JTableConfig(name, indexing=JIndexingConfig(
        null_handling=null_handling, star_tree_configs=[JStarTreeIndexConfig(*star)] if star else []))
    cfg = TableConfig(name, IndexingConfig(
        null_handling=null_handling, star_tree_configs=[StarTreeIndexConfig(*star)] if star else []))
    jsegs = [JBuilder(JSchema.build(name, **cols(JDT)), jcfg).build(d, f"{name}{i}") for i, d in enumerate(datas)]
    built = [SegmentBuilder(Schema.build(name, **cols(DataType)), cfg).build(d, f"{name}{i}") for i, d in enumerate(datas)]
    carried = [segment_from_numpy(describe(s)) for s in jsegs]
    return JEngine(jsegs), {"built": QueryEngine(built, device="cpu"), "carried": QueryEngine(carried, device="cpu")}


def _nulls_data():
    """test_null_handling.py's fixture: v (LONG) and x (DOUBLE) null on the
    same seeded 20% of 3000 rows, in two segments."""
    rng = np.random.default_rng(29)
    n = 3000
    v = rng.integers(1, 100, n).astype(object)
    x = np.round(rng.normal(10, 3, n), 3).astype(object)
    null = rng.random(n) < 0.2
    v[null] = None
    x[null] = None
    data = {"g": np.asarray(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)], "v": v, "x": x}
    return [{k: a[: n // 2] for k, a in data.items()}, {k: a[n // 2 :] for k, a in data.items()}]


def _case_data():
    """test_case_filter.py's fixture: 20,000 rows, one segment."""
    rng = np.random.default_rng(11)
    n = 20_000
    return [{
        "cat": np.array(["a", "b", "c", "d"], dtype=object)[rng.integers(0, 4, n)],
        "year": rng.integers(2018, 2024, n).astype(np.int32),
        "v": rng.integers(0, 1000, n).astype(np.int64),
        "w": rng.random(n).astype(np.float64) * 100,
    }]


def _small(name, g, v, extra=None):
    cols = lambda DT: dict(dimensions=[("g", DT.STRING)], metrics=[("v", DT.LONG)])  # noqa: E731
    return cols, [{"g": np.asarray(g, dtype=object), "v": np.asarray(v, dtype=object), **(extra or {})}]


@pytest.fixture(scope="module")
def tables():
    nulls = lambda DT: dict(dimensions=[("g", DT.STRING)], metrics=[("v", DT.LONG), ("x", DT.DOUBLE)])  # noqa: E731
    case = lambda DT: dict(  # noqa: E731
        dimensions=[("cat", DT.STRING), ("year", DT.INT)], metrics=[("v", DT.LONG), ("w", DT.DOUBLE)]
    )
    big = 1 << 53
    out = {
        "t": _pair("t", nulls, _nulls_data(), null_handling=True),
        "c": _pair("c", case, _case_data()),
        # an all-null group; a segment all null beside one with values; big ints
        "t2": _pair("t2", *_small("t2", ["a", "a", "b", "b", "a", "b"], [1, 2, None, None, 5, None]), null_handling=True),
        "t4": _pair("t4", *_small("t4", ["a", "a", "b"], [1, 2, None]), null_handling=True),
        "b": _pair("b", *_small("b", ["a", "a", "a", "a", "b", "b"], [big, big + 1, big + 1, None, big + 2, None]),
                   null_handling=True),
    }
    cols3, d_null = _small("t3", ["a", "a"], [None, None])
    _, d_vals = _small("t3", ["a", "b"], [3, 4])
    out["t3"] = _pair("t3", cols3, d_null + d_vals, null_handling=True)
    xcols = lambda DT: dict(dimensions=[("g", DT.STRING)], metrics=[("x", DT.DOUBLE)])  # noqa: E731
    out["t7"] = _pair("t7", xcols, [{"g": np.asarray(["a"], dtype=object), "x": np.asarray([np.nan])},
                                    {"g": np.asarray(["a"], dtype=object), "x": np.asarray([5.0])}])
    return out, {}


def _same(a, b) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (a != a and b != b) or math.isclose(a, b, rel_tol=1e-12)
    return a == b


def _assert_same(got, want, sql):
    assert got.columns == want.columns, sql
    assert len(got.rows) == len(want.rows), (sql, got.rows[:3], want.rows[:3])
    for g, w in zip(got.rows, want.rows):
        assert len(g) == len(w) and all(_same(a, b) for a, b in zip(g, w)), (sql, g, w)
    assert got.num_docs_scanned == want.num_docs_scanned, sql


def _forced_host(monkeypatch):
    def no_device(*a, **k):
        raise plan_mod.DeviceFallback("forced host")

    monkeypatch.setattr("pinot_tpu_torch.query.engine.plan_segment", no_device)


QUERIES = [
    # test_null_handling.py
    ("t", SET_ON + "SELECT SUM(v), MIN(v), MAX(v), AVG(v) FROM t"),
    ("t", "SELECT SUM(v), MIN(v) FROM t"),  # null handling off: the placeholder takes part
    ("t", SET_ON + "SELECT g, SUM(v), AVG(v), COUNT(*) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT g, DISTINCTCOUNT(v) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT g, SUM(x), MIN(v), AVG(x) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT COUNT(v), COUNT(*) FROM t"),
    ("t", SET_ON + "SELECT g, COUNT(v) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("t", "SELECT COUNT(v) FROM t"),
    ("t", SET_ON + "SELECT g, AVG(v) FILTER (WHERE x > 10) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("b", SET_ON + "SELECT g, DISTINCTCOUNT(v) FROM b GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT v, x FROM t LIMIT 3000"),
    ("t", "SELECT v FROM t LIMIT 3000"),
    ("t", SET_ON + "SELECT v FROM t ORDER BY g LIMIT 3000"),
    ("t", SET_ON + "SELECT v + 1 FROM t LIMIT 3000"),
    ("t", SET_ON + "SELECT v FROM t ORDER BY v LIMIT 3000"),
    ("t", SET_ON + "SELECT v FROM t ORDER BY v DESC LIMIT 3000"),
    ("t", "SELECT COUNT(*) FROM t WHERE v IS DISTINCT FROM 60"),
    ("t", "SELECT COUNT(*) FROM t WHERE v IS NOT DISTINCT FROM 60"),
    ("t", "SELECT COUNT(*) FROM t WHERE v IS DISTINCT FROM x"),
    ("t", "SELECT g, COUNT(*) FROM t GROUP BY g HAVING COUNT(*) IS DISTINCT FROM 0 ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v < 1000"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v > 50"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE NOT (v > 50)"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v > 50 OR g = 'a'"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v IS NULL OR v > 50"),
    ("t", "SELECT COUNT(*) FROM t WHERE v < 1000"),
    ("t", SET_ON + "SELECT COUNT(*) FILTER (WHERE v < 0) FROM t"),
    ("t", SET_ON + "SELECT g, SUM(x) FILTER (WHERE v > 50) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT VAR_POP(x) FROM t"),
    ("t", SET_ON + "SELECT g, VAR_POP(x) FROM t GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT v, COUNT(*) FROM t GROUP BY v LIMIT 200"),
    ("t", SET_ON + "SELECT SUM(v), MIN(v), MAX(v), AVG(v), MINMAXRANGE(v) FROM t WHERE v IS NULL"),
    ("t2", SET_ON + "SELECT g, SUM(v), AVG(v), MIN(v) FROM t2 GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT SUM(v) FILTER (WHERE g = 'nomatch') FROM t"),
    ("t", SET_ON + "SELECT SUM(x) FROM t WHERE g = 'nomatch'"),
    ("t", "SELECT SUM(x) FROM t WHERE g = 'nomatch'"),
    ("t3", SET_ON + "SELECT SUM(v) FROM t3"),
    ("t3", SET_ON + "SELECT g, SUM(v) FROM t3 GROUP BY g ORDER BY g LIMIT 10"),
    ("t4", SET_ON + "SELECT g, SUM(v) FROM t4 GROUP BY g HAVING SUM(v) > 0 LIMIT 10"),
    ("t4", SET_ON + "SELECT g, SUM(v) FROM t4 GROUP BY g HAVING NOT (SUM(v) > 0) LIMIT 10"),
    ("t4", SET_ON + "SELECT g, SUM(v) + 1 FROM t4 GROUP BY g ORDER BY g LIMIT 10"),
    ("t7", "SELECT SUM(x) FROM t7"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v > 10 OR x > 1000000"),
    ("t", SET_ON + "SELECT COUNT(*), SUM(x) FROM t WHERE v > 10 AND x < 1000000"),
    ("t", SET_ON + "SELECT g, COUNT(*) FROM t WHERE v < 1000 GROUP BY g ORDER BY g LIMIT 10"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v = 50"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v != 50"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v BETWEEN 10 AND 60"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v IN (1, 2, 3, 50)"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE NOT (v IN (1, 2, 3))"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v > 20 AND g = 'a'"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v > 90 OR g = 'b'"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v IS NULL OR v > 95"),
    ("t", SET_ON + "SELECT COUNT(*) FROM t WHERE v IS NOT NULL AND x > 10"),
    # test_case_filter.py
    ("c", "SELECT SUM(CASE WHEN year >= 2021 THEN v ELSE 0 END) FROM c"),
    ("c", "SELECT SUM(CASE WHEN v > 900 THEN 3 WHEN v > 500 THEN 2 WHEN v > 500 THEN 99 ELSE 1 END) FROM c"),
    ("c", "SELECT SUM(CASE WHEN cat = 'a' THEN v END) FROM c"),
    ("c", "SELECT cat, SUM(CASE WHEN year = 2020 THEN v ELSE 0 END) FROM c GROUP BY cat ORDER BY cat LIMIT 10"),
    ("c", "SELECT CASE WHEN v > 500 THEN 'high' ELSE 'low' END, v FROM c LIMIT 5"),
    ("c", "SELECT SUM(CASE cat WHEN 'a' THEN 1 WHEN 'b' THEN 1 ELSE 0 END) FROM c"),
    ("c", "SELECT COUNT(*) FILTER (WHERE cat = 'a'), SUM(v) FILTER (WHERE year > 2020), COUNT(*) FROM c"),
    ("c", "SELECT AVG(w) FILTER (WHERE cat = 'b'), MIN(v) FILTER (WHERE year = 2019), "
          "MAX(v) FILTER (WHERE cat = 'c') FROM c"),
    ("c", "SELECT year, COUNT(*) FILTER (WHERE cat = 'a'), SUM(v) FILTER (WHERE cat = 'b'), COUNT(*) "
          "FROM c GROUP BY year ORDER BY year LIMIT 10"),
    ("c", "SELECT SUM(v) FILTER (WHERE cat = 'a') FROM c WHERE year >= 2021"),
    ("c", "SELECT SUM(v) FILTER (WHERE cat = 'a'), SUM(v) FILTER (WHERE cat = 'b') FROM c"),
    ("c", "SELECT CASE WHEN v > 500 THEN cat ELSE 'low' END AS cc, COUNT(*) FROM c GROUP BY cc ORDER BY cc LIMIT 10"),
]


@pytest.mark.parametrize("mode", ["built", "carried", "host"])
@pytest.mark.parametrize("table,sql", QUERIES)
def test_query_matches_reference(tables, table, sql, mode, monkeypatch):
    by_table, memo = tables
    ref, ports = by_table[table]
    if sql not in memo:
        memo[sql] = ref.execute(sql)
    if mode == "host":
        _forced_host(monkeypatch)
    _assert_same(ports["carried" if mode == "host" else mode].execute(sql), memo[sql], sql)


def test_kleene_where_and_filters_stay_on_the_device(tables):
    """A nullable WHERE, a FILTER over a nullable column and a null-handling
    aggregation run on the device program (every segment "device")."""
    by_table, _ = tables
    port = by_table["t"][1]["built"]
    for sql in (
        SET_ON + "SELECT COUNT(*) FROM t WHERE NOT (v > 50)",
        SET_ON + "SELECT g, SUM(x) FILTER (WHERE v > 50), COUNT(v), MIN(v) FROM t WHERE v < 90 OR g = 'a' "
                 "GROUP BY g ORDER BY g LIMIT 10",
        SET_ON + "SELECT SUM(v), AVG(x) FROM t WHERE v IS NULL OR x > 10",
    ):
        port.segment_modes.clear()
        port.execute(sql)
        assert port.segment_modes == {"device": 2}, sql


def test_null_sites_go_to_the_host(tables):
    """A nullable GROUP BY key and a nullable selection fall back to the host
    executor, with the reference's words."""
    by_table, _ = tables
    port = by_table["t"][1]["built"]
    for sql, why in (
        (SET_ON + "SELECT v, COUNT(*) FROM t GROUP BY v LIMIT 5", "null-handling group-by key runs host-side"),
        (SET_ON + "SELECT v FROM t LIMIT 5", "null-handling selection runs host-side"),
    ):
        with pytest.raises(plan_mod.DeviceFallback, match=why):
            plan_mod.plan_segment(port.segments[0], port.make_context(sql))


def test_null_masks_are_staged_once():
    """The planner takes a segment's null masks from its memo: every query
    and every aggregation over the same columns gets the same array."""
    cols, datas = _small("m", ["a", "b", "a"], [1, None, 3])
    seg = SegmentBuilder(Schema.build("m", **cols(DataType)), TableConfig("m", IndexingConfig(null_handling=True))).build(
        datas[0], "m0")
    port = QueryEngine([seg], device="cpu")
    sql = SET_ON + "SELECT SUM(v), MIN(v), COUNT(v) FROM m WHERE v > 0"
    a = plan_mod.plan_segment(seg, port.make_context(sql))
    b = plan_mod.plan_segment(seg, port.make_context(sql))
    masks = [o for o in a.operands if isinstance(o, np.ndarray) and o.dtype == bool]
    # the WHERE's null mask, then the non-null mask of each aggregation
    assert len(masks) == 4 and masks[1] is masks[2] is masks[3] and np.array_equal(masks[0][:3], [False, True, False])
    assert np.array_equal(masks[1][:3], [True, False, True]) and not masks[1][3:].any()
    assert all(x is y for x, y in zip(masks, [o for o in b.operands if isinstance(o, np.ndarray) and o.dtype == bool]))


@pytest.mark.parametrize("mode", ["built", "carried"])
def test_startree_bypassed_under_null_handling(mode):
    """A star-tree segment with null vectors answers a null-handling query by
    the per-doc path (its star table holds the placeholders), and the star
    tree still serves it with null handling off; a filter that reads the null
    vectors (IS NULL, IS DISTINCT FROM) and an aggregate FILTER never take the
    star tree (startree_exec._null_dependent)."""
    rng = np.random.default_rng(33)
    n = 2000
    v = rng.integers(1, 50, n).astype(object)
    v[rng.random(n) < 0.3] = None
    d = np.asarray(["x", "y"], dtype=object)[rng.integers(0, 2, n)]
    d[rng.random(n) < 0.2] = None
    cols = lambda DT: dict(dimensions=[("d", DT.STRING)], metrics=[("v", DT.LONG)])  # noqa: E731
    ref, ports = _pair("s", cols, [{"d": d, "v": v}], null_handling=True, star=(["d"], ["SUM__v", "COUNT__*"]))
    port = ports[mode]
    assert port.segments[0].extras.get("startree") and port.segments[0].extras.get("null")
    for sql, where in (
        (SET_ON + "SELECT SUM(v) FROM s", "device"),
        (SET_ON + "SELECT d, SUM(v), COUNT(*) FROM s GROUP BY d ORDER BY d LIMIT 5", "host"),
        ("SELECT SUM(v) FROM s", "startree"),
        ("SELECT d, SUM(v) FROM s GROUP BY d ORDER BY d LIMIT 5", "startree"),
        ("SELECT SUM(v) FROM s WHERE d IS NULL", "device"),
        ("SELECT SUM(v) FROM s WHERE d IS DISTINCT FROM 'x'", "device"),
        ("SELECT SUM(v) FILTER (WHERE d = 'x') FROM s", "device"),
    ):
        port.segment_modes.clear()
        _assert_same(port.execute(sql), ref.execute(sql), sql)
        assert port.segment_modes == {where: 1}, sql
