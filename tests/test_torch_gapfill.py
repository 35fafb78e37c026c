"""GAPFILL through the port and the JAX package: every case of
tests/test_gapfill.py, and the same over a time-partitioned table whose
pruned segments leave the gaps. Rows must be equal, exactly."""

import numpy as np
import pytest

from pinot_tpu.query.context import QueryContext as JQueryContext
from pinot_tpu_torch.query.context import QueryContext
from test_torch_pruner import assert_same_result, pair, time_columns, time_partitioned


def ts_columns(DT):
    return dict(dimensions=[("ts", DT.LONG)], metrics=[("v", DT.LONG)])


@pytest.fixture(scope="module")
def ts():
    # time buckets 0, 10, 30, 40 present; 20 and 50 missing in [0, 60)
    data = {"ts": np.array([0, 0, 10, 30, 30, 40], dtype=np.int64), "v": np.array([1, 2, 3, 4, 5, 6], dtype=np.int64)}
    return pair("t", ts_columns, [data])


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


TS_QUERIES = [
    "SELECT GAPFILL(ts, 0, 60, 10), SUM(v) FROM t GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 0, 60, 10, FILL(s, 'FILL_PREVIOUS_VALUE')), SUM(v) AS s FROM t GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 0, 60, 10, FILL(s, 'FILL_DEFAULT_VALUE')), SUM(v) AS s FROM t GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 10, 40, 10), SUM(v) FROM t GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 0, 60, 5), COUNT(*), MAX(v) FROM t GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 0, 25, 2.5), SUM(v) FROM t GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 0, 60, 10, FILL(s, 'FILL_PREVIOUS_VALUE'), FILL(c, 'FILL_DEFAULT_VALUE')), SUM(v) AS s, "
    "COUNT(*) AS c FROM t WHERE v > 2 GROUP BY ts ORDER BY ts LIMIT 100",
    "SELECT GAPFILL(ts, 0, 60, 10), SUM(v) FROM t WHERE ts > 100 GROUP BY ts ORDER BY ts LIMIT 100",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", TS_QUERIES)
def test_gapfill_matches_reference(ts, sql, mode):
    ref, ports = ts
    assert_same_result(ports[mode].execute(sql), ref.execute(sql), sql)


def test_gapfill_rows(ts):
    """tests/test_gapfill.py's expectations, on the port."""
    _, ports = ts
    eng = ports["built"]
    res = eng.execute(TS_QUERIES[0])
    assert [r[0] for r in res.rows] == [0, 10, 20, 30, 40, 50]
    assert [r[1] for r in res.rows] == [3, 3, None, 9, 6, None]
    assert [r[1] for r in eng.execute(TS_QUERIES[1]).rows] == [3, 3, 3, 9, 6, 6]
    assert [r[1] for r in eng.execute(TS_QUERIES[2]).rows] == [3, 3, 0, 9, 6, 0]
    assert [r[0] for r in eng.execute(TS_QUERIES[3]).rows] == [10, 20, 30]


TP_QUERIES = [
    "SELECT GAPFILL(year, 1990, 2002, 1, FILL(r, 'FILL_PREVIOUS_VALUE')), SUM(revenue) AS r FROM t "
    "WHERE year <> 1995 GROUP BY year ORDER BY year LIMIT 100",
    "SELECT GAPFILL(year, 1990, 2002, 2), COUNT(*), MIN(qty) FROM t WHERE year >= 1996 GROUP BY year ORDER BY year LIMIT 100",
    "SELECT GAPFILL(year, 1992, 1999, 1, FILL(c, 'FILL_DEFAULT_VALUE')), COUNT(*) AS c FROM t "
    "WHERE year IN (1993, 1997) GROUP BY year ORDER BY year LIMIT 100",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", TP_QUERIES)
def test_gapfill_over_pruned_segments(tp, sql, mode):
    ref, ports = tp
    assert_same_result(ports[mode].execute(sql), ref.execute(sql), sql)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT ts, SUM(v) FROM t GROUP BY ts",
        "SELECT GAPFILL(ts, 0, 100, 5, FILL(s, 'FILL_DEFAULT_VALUE')), SUM(v) AS s FROM t GROUP BY ts",
        "SELECT GAPFILL(ts, 3, 9, 0.5, FILL(s, 'FILL_PREVIOUS_VALUE')), SUM(v) AS s, COUNT(*) FROM t GROUP BY ts",
    ],
)
def test_gapfill_spec_matches_reference(sql):
    got, want = QueryContext.from_sql(sql), JQueryContext.from_sql(sql)
    if want.gapfill is None:
        assert got.gapfill is None
        return
    g, w = got.gapfill, want.gapfill
    assert (g.col_index, g.start, g.end, g.step, g.fills) == (w.col_index, w.start, w.end, w.step, w.fills)
    assert got.output_name(got.select_items[0]) == want.output_name(want.select_items[0])


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT GAPFILL(ts, 0, 60) FROM t GROUP BY ts",
        "SELECT GAPFILL(ts, 0, 60, 10, FILL(nope, 'FILL_DEFAULT_VALUE')) FROM t GROUP BY ts",
    ],
)
def test_gapfill_bad_args_raise(sql):
    with pytest.raises(ValueError):
        JQueryContext.from_sql(sql)
    with pytest.raises(ValueError):
        QueryContext.from_sql(sql)
