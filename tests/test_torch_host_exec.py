"""The port's host executor (pinot_tpu_torch/query/host_exec.py) against the
JAX package's, both forced to the host: each engine's `plan_segment` raises
DeviceFallback, as tests/test_query_fuzz.py::test_fuzz_device_host_parity
forces the reference. Rows must be equal, with the reference's Python types
and row order, and so must numDocsScanned; floats within rel 1e-9, the
tolerance of the reference's own device/host test (the reference's pandas
sums add in another order).

* the random queries of tests/test_torch_fuzz.py (filters, aggregations,
  group-bys with HAVING and ORDER BY, SELECTION, SELECTION ORDER BY,
  DISTINCT);
* one case per aggregation of `aggregates.EXT_AGGS` that applies to
  single-value columns (SQL after tests/test_aggregates.py and
  test_aggregates2.py), plus PERCENTILE, PERCENTILETDIGEST, PERCENTILEEST,
  MODE and the funnels, scalar and grouped, some under FILTER (WHERE);
* keys that hold NaN, which form a group of their own;
* the port's device path against its own host path on the same queries.
"""

import math

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import plan as jplan
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.query.aggregates import EXT_AGGS
from pinot_tpu_torch.segment import SegmentBuilder
from test_torch_fuzz import engines  # noqa: F401  (the fuzz corpus's engines)
from test_torch_fuzz import _query
from test_query_fuzz import AGGS, _gen_filter


def _forced_host(monkeypatch):
    def no_device(*a, **k):
        raise jplan.DeviceFallback("forced host")

    def no_device_port(*a, **k):
        raise plan_mod.DeviceFallback("forced host")

    monkeypatch.setattr("pinot_tpu.query.engine.plan_segment", no_device)
    monkeypatch.setattr("pinot_tpu_torch.query.engine.plan_segment", no_device_port)


def _same(a, b, rel=1e-9) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (a != a and b != b) or math.isclose(a, b, rel_tol=rel)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y, rel) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k], rel) for k in a)
    return a == b


def _assert_same(got, want, sql):
    assert got.columns == want.columns, sql
    assert len(got.rows) == len(want.rows), (sql, got.rows[:3], want.rows[:3])
    for g, w in zip(got.rows, want.rows):
        assert all(_same(a, b) for a, b in zip(g, w)), (sql, g, w)
    assert got.num_docs_scanned == want.num_docs_scanned, sql


# -- the fuzz corpus, both packages on the host -------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_fuzz_queries_on_the_host(engines, monkeypatch, seed):  # noqa: F811
    ref, port = engines
    _forced_host(monkeypatch)
    rng = np.random.default_rng(2000 + seed)
    port.segment_modes.clear()
    for _ in range(30):
        sql = _query(rng)
        _assert_same(port.execute(sql), ref.execute(sql), sql)
    assert set(port.segment_modes) - {"pruned"} == {"host"}


def _parity_query(rng) -> str:
    """tests/test_query_fuzz.py::test_fuzz_device_host_parity's shapes: each
    one's row order is defined, so both executors must give the same rows."""
    fsql = _gen_filter(rng)[0]
    kind = rng.integers(0, 4)
    if kind == 0:
        picks = rng.choice(len(PARITY_AGGS), size=2, replace=False)
        return f"SELECT {', '.join(PARITY_AGGS[i] for i in picks)} FROM f WHERE {fsql}"
    if kind == 1:
        keys = [["d1"], ["d2", "k"], ["k", "d1"]][rng.integers(0, 3)]
        agg = PARITY_AGGS[rng.integers(1, len(PARITY_AGGS))]
        return (
            f"SELECT {', '.join(keys)}, {agg} FROM f WHERE {fsql} "
            f"GROUP BY {', '.join(keys)} ORDER BY {', '.join(keys)} LIMIT 300"
        )
    if kind == 2:
        return f"SELECT DISTINCT d1, k FROM f WHERE {fsql} ORDER BY k DESC, d1 LIMIT 40"
    return f"SELECT m1 FROM f WHERE {fsql} ORDER BY m1 LIMIT 25"


PARITY_AGGS = [a for a, _ in AGGS] + ["MINMAXRANGE(k)", "DISTINCTCOUNT(d1)", "DISTINCTCOUNTHLL(m1)"]


@pytest.mark.parametrize("seed", range(3))
def test_fuzz_device_host_parity(engines, monkeypatch, seed):  # noqa: F811
    """The port's device path against its host path: the same rows and
    Python types, floats within rel 1e-9 (the reference's own test compares
    the values)."""
    _, port = engines
    host = QueryEngine(port.segments, device="cpu")
    rng = np.random.default_rng(3000 + seed)
    queries = [_parity_query(rng) for _ in range(25)]
    port.segment_modes.clear()
    device_rows = [port.execute(q) for q in queries]
    assert set(port.segment_modes) - {"pruned"} == {"device"}
    monkeypatch.setattr(
        "pinot_tpu_torch.query.engine.plan_segment",
        lambda *a, **k: (_ for _ in ()).throw(plan_mod.DeviceFallback("forced host")),
    )
    for q, want in zip(queries, device_rows):
        _assert_same(host.execute(q), want, q)
    assert set(host.segment_modes) - {"pruned"} == {"host"}


# -- every host-only aggregation ----------------------------------------------


def _m_data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "g": np.asarray(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
        "active": rng.integers(0, 2, n).astype(np.int32),
        "k": rng.integers(0, 500, n).astype(np.int32),
        "x": np.round(rng.normal(50, 12, n), 4),
        "y": np.round(rng.normal(-3, 5, n), 4),
        "v": rng.integers(1, 20, n).astype(np.int64),
        "ts": rng.integers(0, 1_000_000, n).astype(np.int64),
        "q": rng.integers(1, 51, n).astype(np.int32),
    }


def _m_schema(DT, S):
    return S.build(
        "m",
        dimensions=[("g", DT.STRING), ("active", DT.INT), ("k", DT.INT)],
        metrics=[("x", DT.DOUBLE), ("y", DT.DOUBLE), ("v", DT.LONG), ("q", DT.INT)],
        date_times=[("ts", DT.LONG)],
    )


@pytest.fixture(scope="module")
def m_engines():
    datas = [_m_data(3 + i, n) for i, n in enumerate([900, 1100, 1, 700])]
    ref = JEngine([JBuilder(_m_schema(JDT, JSchema)).build(d, f"m_{i}") for i, d in enumerate(datas)])
    port = QueryEngine(
        [SegmentBuilder(_m_schema(DataType, Schema)).build(d, f"m_{i}") for i, d in enumerate(datas)], device="cpu"
    )
    return ref, port


#: one call per EXT_AGGS function over single-value columns
EXT_CALLS = {
    "arrayagg": "ARRAYAGG(g, 'STRING', true)",
    "avgvalueintegersumtuplesketch": "AVGVALUEINTEGERSUMTUPLESKETCH(k, v)",
    "bool_and": "BOOL_AND(active)",
    "bool_or": "BOOL_OR(active)",
    "covar_pop": "COVAR_POP(x, y)",
    "covar_samp": "COVAR_SAMP(x, y)",
    "distinctavg": "DISTINCTAVG(x)",
    "distinctcountcpc": "DISTINCTCOUNTCPC(ts)",
    "distinctcountcpcsketch": "DISTINCTCOUNTCPCSKETCH(k)",
    "distinctcounthllplus": "DISTINCTCOUNTHLLPLUS(ts)",
    "distinctcountrawcpcsketch": "DISTINCTCOUNTRAWCPCSKETCH(k)",
    "distinctcountrawhll": "DISTINCTCOUNTRAWHLL(k)",
    "distinctcountrawhllplus": "DISTINCTCOUNTRAWHLLPLUS(k)",
    "distinctcountrawintegersumtuplesketch": "DISTINCTCOUNTRAWINTEGERSUMTUPLESKETCH(k, v)",
    "distinctcountrawthetasketch": "DISTINCTCOUNTRAWTHETASKETCH(k)",
    "distinctcountrawull": "DISTINCTCOUNTRAWULL(k)",
    "distinctcountsmarthll": "DISTINCTCOUNTSMARTHLL(k)",
    "distinctcounttheta": "DISTINCTCOUNTTHETA(ts)",
    "distinctcounttuplesketch": "DISTINCTCOUNTTUPLESKETCH(k, v)",
    "distinctcountull": "DISTINCTCOUNTULL(ts)",
    "distinctsum": "DISTINCTSUM(x)",
    "exprmax": "EXPRMAX(x, v)",
    "exprmin": "EXPRMIN(g, ts)",
    "fasthll": "FASTHLL(k)",
    "firstwithtime": "FIRSTWITHTIME(x, ts, 'DOUBLE')",
    "fourthmoment": "FOURTHMOMENT(x)",
    "frequentlongssketch": "FREQUENTLONGSSKETCH(q)",
    "frequentstringssketch": "FREQUENTSTRINGSSKETCH(g)",
    "histogram": "HISTOGRAM(x, 0, 100, 10)",
    "idset": "IDSET(k)",
    "kurtosis": "KURTOSIS(x)",
    "lastwithtime": "LASTWITHTIME(y, ts, 'DOUBLE')",
    "listagg": "LISTAGG(g, '|')",
    "percentilekll": "PERCENTILEKLL(x, 90)",
    "percentilerawest": "PERCENTILERAWEST(x, 50)",
    "percentilerawkll": "PERCENTILERAWKLL(x, 50)",
    "percentilerawtdigest": "PERCENTILERAWTDIGEST(x, 50)",
    "percentilesmarttdigest": "PERCENTILESMARTTDIGEST(x, 50)",
    "segmentpartitioneddistinctcount": "SEGMENTPARTITIONEDDISTINCTCOUNT(g)",
    "skewness": "SKEWNESS(x)",
    "stddev_pop": "STDDEV_POP(x)",
    "stddev_samp": "STDDEV_SAMP(x)",
    "stunion": "STUNION(g)",
    "sum0": "SUM0(v)",
    "sumprecision": "SUMPRECISION(v)",
    "sumvaluesintegersumtuplesketch": "SUMVALUESINTEGERSUMTUPLESKETCH(k, v)",
    "var_pop": "VAR_POP(x)",
    "var_samp": "VAR_SAMP(x)",
    "variance": "VARIANCE(x)",
}
#: EXT_AGGS functions over multi-value arrays only (ROADMAP A4)
MV_ONLY = {"sumarraylong", "sumarraydouble"}

#: the host-only aggregations outside EXT_AGGS
OTHER_CALLS = {
    "percentile": "PERCENTILE(x, 95)",
    "percentile_int": "PERCENTILE(v, 50)",
    "percentiletdigest": "PERCENTILETDIGEST(x, 50)",
    "percentileest": "PERCENTILEEST(x, 50)",
    "mode": "MODE(q)",
    "mode_double": "MODE(x)",
    "distinctcount_raw": "DISTINCTCOUNT(v)",
    "funnelcount": "FUNNELCOUNT(STEPS(k < 250, v > 10), CORRELATE_BY(g))",
    "funnelcompletecount": "FUNNELCOMPLETECOUNT(STEPS(k < 250, v > 10, q > 25), CORRELATE_BY(k))",
    "funnelmaxstep": "FUNNELMAXSTEP(ts, 400000, STEPS(k < 250, v > 10), CORRELATE_BY(g))",
    "funnelmatchstep": "FUNNELMATCHSTEP(ts, 300000, STEPS(k < 250, v > 10), CORRELATE_BY(k))",
    "funnelstepdurationstats": "FUNNELSTEPDURATIONSTATS(ts, 500000, STEPS(q < 30, v > 5), CORRELATE_BY(g))",
}


def test_ext_calls_cover_ext_aggs():
    assert set(EXT_CALLS) | MV_ONLY == set(EXT_AGGS)


CALLS = sorted(EXT_CALLS.items()) + sorted(OTHER_CALLS.items())


#: aggregations whose GROUP BY the reference's host executor cannot answer
#: under pandas 3: its per-group reducer returns a dict, which pandas'
#: `groupby(...).apply` expands into rows (ValueError: "Length of values
#: ... does not match length of index"). Their grouped rows are held against
#: the reference's scalar query of each group instead.
REF_GROUPED_FAILS = {"mode", "mode_double", "funnelmaxstep", "funnelmatchstep", "funnelstepdurationstats"}


def _per_group(ref, call, key, where):
    """The rows of `SELECT key, call ... GROUP BY key ORDER BY key` from the
    reference's scalar query of each group."""
    keys = [r[0] for r in ref.execute(f"SELECT {key}, COUNT(*) FROM m WHERE {where} GROUP BY {key} ORDER BY {key} "
                                      "LIMIT 100").rows]
    lit = (lambda v: f"'{v}'") if key == "g" else str
    return [[kv, ref.execute(f"SELECT {call} FROM m WHERE {where} AND {key} = {lit(kv)}").rows[0][0]] for kv in keys]


@pytest.mark.parametrize("name,call", CALLS, ids=[n for n, _ in CALLS])
def test_aggregation_on_the_host(m_engines, monkeypatch, name, call):
    """Scalar, grouped (a dictionary key and a raw key) and filtered forms of
    one aggregation, both packages on the host."""
    ref, port = m_engines
    _forced_host(monkeypatch)
    for sql in (f"SELECT {call} FROM m", f"SELECT {call} FROM m WHERE k < 400"):
        _assert_same(port.execute(sql), ref.execute(sql), sql)
    for key, where in (("g", "v > 0"), ("q", "active = 1")):
        sql = f"SELECT {key}, {call} FROM m WHERE {where} GROUP BY {key} ORDER BY {key} LIMIT 100"
        got = port.execute(sql)
        if name in REF_GROUPED_FAILS:
            with pytest.raises(ValueError, match="does not match length of index"):
                ref.execute(sql)
            want = _per_group(ref, call, key, where)
            assert len(got.rows) == len(want) and all(_same(g, w) for g, w in zip(got.rows, want)), sql
        else:
            _assert_same(got, ref.execute(sql), sql)


FILTERED = [
    # FILTER (WHERE) on the core and the non-core aggregations inside GROUP BY
    "SELECT g, DISTINCTCOUNT(k) FILTER (WHERE v > 10), VAR_POP(x) FILTER (WHERE v <= 10), "
    "PERCENTILE(x, 50) FILTER (WHERE k < 250) FROM m GROUP BY g ORDER BY g LIMIT 10",
    "SELECT g, DISTINCTCOUNTTHETASKETCH(k, 'v > 10', 'v <= 10', 'SET_UNION($1,$2)') FILTER (WHERE k < 400) "
    "FROM m GROUP BY g ORDER BY g LIMIT 10",
    "SELECT q, COUNT(*) FILTER (WHERE k < 100), SUM(v) FILTER (WHERE x > 50), MIN(x) FILTER (WHERE v > 18), "
    "MAX(k) FILTER (WHERE v > 18), AVG(y) FILTER (WHERE k > 450), MINMAXRANGE(x) FILTER (WHERE v = 1) "
    "FROM m GROUP BY q ORDER BY q LIMIT 60",
    "SELECT g, DISTINCTCOUNTHLL(k) FILTER (WHERE q < 5), "
    "IDSET(k) FILTER (WHERE v > 18), COVAR_POP(x, y) FILTER (WHERE k < 10), "
    "PERCENTILETDIGEST(x, 90) FILTER (WHERE k < 300), PERCENTILEEST(x, 90) FILTER (WHERE k < 300) "
    "FROM m GROUP BY g ORDER BY g LIMIT 10",
    "SELECT COUNT(*) FILTER (WHERE k < 100), PERCENTILE(x, 10) FILTER (WHERE v > 10), "
    "DISTINCTCOUNT(g) FILTER (WHERE q = 3), MODE(k) FILTER (WHERE v > 15) FROM m",
]


@pytest.mark.parametrize("i", range(len(FILTERED)))
def test_filtered_aggregations_on_the_host(m_engines, monkeypatch, i):
    ref, port = m_engines
    _forced_host(monkeypatch)
    _assert_same(port.execute(FILTERED[i]), ref.execute(FILTERED[i]), FILTERED[i])


EXPRESSIONS = [
    # transforms, CASE, string functions, CAST to a string, IS TRUE, virtual
    # columns, IS DISTINCT FROM: each runs on the host in both packages
    "SELECT g, SUM(ABS(y)), MAX(ROUND(x)), MIN(LN(x + 100)) FROM m GROUP BY g ORDER BY g LIMIT 5",
    "SELECT CASE WHEN k < 100 THEN 'low' WHEN k < 300 THEN 'mid' ELSE 'high' END, COUNT(*) FROM m "
    "GROUP BY CASE WHEN k < 100 THEN 'low' WHEN k < 300 THEN 'mid' ELSE 'high' END ORDER BY COUNT(*) DESC LIMIT 5",
    "SELECT UPPER(g), COUNT(*) FROM m WHERE LOWER(g) <> 'b' GROUP BY UPPER(g) ORDER BY UPPER(g) LIMIT 5",
    "SELECT CAST(k AS STRING), COUNT(*) FROM m WHERE k < 5 GROUP BY CAST(k AS STRING) ORDER BY COUNT(*) DESC, "
    "CAST(k AS STRING) LIMIT 5",
    "SELECT COUNT(*), SUM(v) FROM m WHERE active IS TRUE AND active IS NOT FALSE",
    "SELECT $docId, $segmentName, g FROM m WHERE k < 3 LIMIT 8",
    "SELECT COUNT(*) FROM m WHERE g IS DISTINCT FROM 'a'",
    "SELECT g, k, x FROM m WHERE g LIKE 'a%' AND REGEXP_LIKE(g, '^[ab]') ORDER BY x DESC, k LIMIT 7",
    "SELECT DISTINCT q % 7, g FROM m WHERE q BETWEEN 10 AND 20 ORDER BY g, q % 7 LIMIT 20",
    "SELECT x - y, COUNT(*) FROM m WHERE k IN (1, 2, 3, 400) GROUP BY x - y ORDER BY x - y LIMIT 30",
    "SELECT YEAR(ts * 1000000), SUM(v) FROM m GROUP BY YEAR(ts * 1000000) ORDER BY SUM(v) DESC LIMIT 5",
    "SELECT STRLEN(g), COUNT(*) FROM m GROUP BY STRLEN(g) ORDER BY STRLEN(g) LIMIT 5",
]


@pytest.mark.parametrize("i", range(len(EXPRESSIONS)))
def test_expressions_on_the_host(m_engines, monkeypatch, i):
    ref, port = m_engines
    _forced_host(monkeypatch)
    _assert_same(port.execute(EXPRESSIONS[i]), ref.execute(EXPRESSIONS[i]), EXPRESSIONS[i])


@pytest.mark.parametrize("i", range(len(EXPRESSIONS)))
def test_expressions_unforced(m_engines, i):
    """The same queries with each engine choosing its executor per segment:
    the port lowers each where the reference does (the `fn`, `case`, `cmp2`
    and `in_sorted` tags on the device), with the reference's rows."""
    ref, port = m_engines
    _assert_same(port.execute(EXPRESSIONS[i]), ref.execute(EXPRESSIONS[i]), EXPRESSIONS[i])


# -- NaN keys -----------------------------------------------------------------


def test_nan_keys_form_a_group(monkeypatch):
    """GROUP BY and DISTINCT over a raw DOUBLE column holding NaN: NaN is one
    group of its own, in first-appearance order across segments."""
    rng = np.random.default_rng(5)
    datas = []
    for n in (300, 200):
        w = np.round(rng.normal(0, 2, n)).astype(np.float64)
        w[rng.random(n) < 0.2] = np.nan
        datas.append({"d": np.asarray(["u", "v"], dtype=object)[rng.integers(0, 2, n)], "w": w,
                      "c": rng.integers(0, 9, n).astype(np.int64)})

    def schema(DT, S):
        return S.build("n", dimensions=[("d", DT.STRING)], metrics=[("w", DT.DOUBLE), ("c", DT.LONG)])

    ref = JEngine([JBuilder(schema(JDT, JSchema)).build(d, f"n{i}") for i, d in enumerate(datas)])
    port = QueryEngine([SegmentBuilder(schema(DataType, Schema)).build(d, f"n{i}") for i, d in enumerate(datas)],
                       device="cpu")
    for sql in (
        "SELECT w, COUNT(*), SUM(c), DISTINCTCOUNT(c) FROM n GROUP BY w LIMIT 100",
        "SELECT d, w, MAX(c) FROM n GROUP BY d, w LIMIT 100",
        "SELECT w / c, COUNT(*) FROM n GROUP BY w / c ORDER BY COUNT(*) DESC LIMIT 100",
        "SELECT DISTINCT w, d FROM n LIMIT 100",
        "SELECT w, c FROM n ORDER BY w DESC, c LIMIT 30",
    ):
        got, want = port.execute(sql), ref.execute(sql)
        _assert_same(got, want, sql)
        assert any(isinstance(x, float) and x != x for r in got.rows for x in r), sql


# -- the planner's DeviceFallback sites ---------------------------------------


PLAN_SHAPES = [
    "SELECT q, COUNT(*) FROM m GROUP BY q",  # raw key
    "SELECT k + 1, COUNT(*) FROM m GROUP BY k + 1",  # expression key
    "SELECT $segmentName, COUNT(*) FROM m GROUP BY $segmentName",  # virtual key
    "SELECT DISTINCTCOUNT(v) FROM m",  # raw DISTINCTCOUNT
    "SELECT PERCENTILE(x, 50), SUM(v) FROM m",
    "SELECT SUM(v), PERCENTILETDIGEST(x, 50) FROM m",
    "SELECT g, MODE(k) FROM m GROUP BY g",
    "SELECT VAR_POP(x) FROM m",  # EXT_AGGS
    "SELECT g, FUNNELCOUNT(STEPS(k < 5, v > 3), CORRELATE_BY(g)) FROM m GROUP BY g",  # funnel in a GROUP BY
    "SELECT FUNNELCOUNT(STEPS(k < 5, v > 3), CORRELATE_BY(x)) FROM m",  # raw correlation column
    "SELECT FUNNELCOUNT(STEPS(k < 5, v > 3), CORRELATE_BY(g)) FROM m",  # funnel_steps
    "SELECT PERCENTILEEST(x, 50) FROM m",  # hist
    "SELECT g, PERCENTILEEST(x, 50) FROM m GROUP BY g",
    "SELECT SUM(CAST(k AS STRING)) FROM m",  # CAST to a string
    "SELECT COUNT(*) FROM m WHERE active IS TRUE",
    "SELECT SUM(ABS(y)) FROM m",  # fn
    "SELECT SUM(STRLEN(g)) FROM m",  # derived dictval
    "SELECT COUNT(*) FROM m WHERE UPPER(g) = 'A'",  # string-function LUT
    "SELECT COUNT(*) FROM m WHERE LOWER(g) IN ('a', 'c')",
    "SELECT COUNT(*) FROM m WHERE REVERSE(g) LIKE 'b%'",
    "SELECT COUNT(*) FROM m WHERE UPPER(CAST(k AS STRING)) = '5'",  # string function over an expression
    "SELECT MAX(STRLEN(CAST(q AS STRING))) FROM m",
    "SELECT UPPER(g) FROM m LIMIT 3",  # string-valued projection
    "SELECT SUM(STRPOS(g, 'a')) FROM m",
    "SELECT COUNT(*) FROM m WHERE g IS DISTINCT FROM 'a'",
    "SELECT COUNT(*) FROM m WHERE k IS NOT DISTINCT FROM q",
    "SELECT SUM(TIMECONVERT(ts, 'MILLISECONDS', 'SECONDS')) FROM m",
    "SELECT COUNT(*) FROM m WHERE ST_WITHIN_DISTANCE(x, y, 50.0, 0.0, 1000.0)",
    "SELECT MAP_VALUE(g, 'a') FROM m LIMIT 2",
    "SELECT g, k FROM m ORDER BY x, k LIMIT 5",  # float key among several
    "SELECT g, k FROM m ORDER BY g, k + 1 LIMIT 5",  # expression key among several
    "SELECT COUNT(*) FILTER (WHERE k < 5), PERCENTILE(x, 5) FROM m",  # masked, then a fallback
    "SELECT PERCENTILE(x, 5), COUNT(*) FILTER (WHERE k < 5) FROM m",
]


@pytest.mark.parametrize("sql", PLAN_SHAPES)
def test_plan_sites_match_reference(m_engines, sql):
    """Where the reference's planner raises DeviceFallback the port's raises
    it with the same words; where the reference plans, the port emits the
    same spec."""
    from pinot_tpu.query.plan import plan_segment as jplan_segment

    ref, port = m_engines
    jctx, ctx = ref.make_context(sql), port.make_context(sql)
    try:
        want = jplan_segment(ref.segments[0], jctx).spec
    except jplan.DeviceFallback as e:
        with pytest.raises(plan_mod.DeviceFallback) as got:
            plan_mod.plan_segment(port.segments[0], ctx)
        assert str(got.value) == str(e)
        return
    assert plan_mod.plan_segment(port.segments[0], ctx).spec == want


def test_only_device_fallback_goes_to_the_host(m_engines, monkeypatch):
    """DeviceFallback is no NotImplementedError, and a dispatch error (a
    CUDA error, a failed build) reaches the caller."""
    assert not issubclass(plan_mod.DeviceFallback, NotImplementedError)
    _, port = m_engines

    def broken(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr("pinot_tpu_torch.query.engine.dispatch_plan_packed", broken)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        port.execute("SELECT g, COUNT(*) FROM m GROUP BY g")
    # a segment whose planning falls back never reaches the dispatch
    assert port.execute("SELECT q, COUNT(*) FROM m GROUP BY q ORDER BY q LIMIT 1").rows[0][0] == 1
