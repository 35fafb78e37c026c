"""The program's spec tags for transforms, CASE, the compare / IN / doc-mask
filters, null handling, FILTER (WHERE), funnels and histograms, against
the JAX package's own program on the CPU: the `fn` and `case` value tags, the
`cmp2`, `in_vals`, `in_sorted`, `docmask` and Kleene (`k3root`, `k3_*`)
filters, and the `masked`, `masked_nan_empty`, `funnel_steps` and `hist`
aggregates, scalar, grouped and sparse. Where a query lowers them, both
planners must emit the same spec tuple and the same operands; then the
reference's `build_fn(spec)` (jitted, on the CPU) and the port's (torch, on
the CPU) run on the same carried-over segment.

Tolerances: counts, integers, extremes, histograms, presence rows and masks
exactly equal; float64 sums rtol 1e-12 (they add in another order); the float
values of a transform rtol FN_RTOL, a few ulp, since XLA's CPU math
functions and torch's are different implementations of the same functions
(`cbrt`, which torch lacks, is held to CBRT_RTOL).

The coverage test reads the tags the reference's program dispatches on and
checks that each is handled here or named in NOT_YET with its ROADMAP item.
"""

import ast as pyast
import inspect

import numpy as np
import pytest

import pinot_tpu.query.kernels as JK
from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
from pinot_tpu.common.config import TableConfig as JTableConfig
from pinot_tpu.query import plan as jplan_mod
from pinot_tpu.query.context import QueryContext as JContext
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.transforms import DEVICE_FUNCS
from pinot_tpu_torch.segment import segment_from_numpy
from test_torch_kernels import _run_jax, _run_port
from test_torch_segment import describe

N = 4000
#: relative tolerance of a transform's float values (see the module docstring;
#: the largest difference seen here is 1.4e-15, ST_DISTANCE's)
FN_RTOL = 4e-15
#: cbrt = sign(x) * |x|^(1/3) against XLA's cbrt
CBRT_RTOL = 4.5e-16
SET_ON = "SET enableNullHandling = true; "

#: reference tags this package's program does not handle yet, by ROADMAP item
#: (none: the last, the multistage `mask` program, is ported)
NOT_YET: dict[str, str] = {}


@pytest.fixture(scope="module")
def segs():
    """(reference segment, the port's carried copy) of a table with every
    column kind the tags read; "nv", "nx" and "ns" are null on a seeded 25%
    of the docs (null vectors kept)."""
    rng = np.random.default_rng(41)
    regions = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"], dtype=object)
    data = {
        "region": regions[rng.integers(0, 5, N)],
        "year": rng.integers(1992, 1999, N).astype(np.int32),
        "q": rng.integers(-50, 51, N).astype(np.int32),
        "k": rng.integers(1, 10, N).astype(np.int32),
        "x": np.round(rng.normal(0, 3, N), 3),
        "p": np.round(rng.uniform(0.1, 100, N), 1),
        "u": rng.uniform(-1, 1, N),
        "big": rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
        "ts": rng.integers(-(1 << 41), 1 << 41, N).astype(np.int64),  # epoch ms, 1900-2039
        "lat": rng.uniform(-80, 80, N),
        "lng": rng.uniform(-170, 170, N),
    }
    nulls = rng.random(N) < 0.25
    for c, src in (("nv", rng.integers(0, 100, N)), ("nx", np.round(rng.normal(5, 2, N), 2)),
                   ("ns", regions[rng.integers(0, 5, N)])):
        v = src.astype(object)
        v[nulls if c != "ns" else rng.random(N) < 0.25] = None
        data[c] = v
    schema = JSchema.build(
        "t",
        dimensions=[("region", JDT.STRING), ("year", JDT.INT), ("ns", JDT.STRING)],
        metrics=[("q", JDT.INT), ("k", JDT.INT), ("x", JDT.DOUBLE), ("p", JDT.DOUBLE), ("u", JDT.DOUBLE),
                 ("big", JDT.LONG), ("ts", JDT.LONG), ("lat", JDT.DOUBLE), ("lng", JDT.DOUBLE),
                 ("nv", JDT.LONG), ("nx", JDT.DOUBLE)],
    )
    ref = JBuilder(schema, JTableConfig("t", indexing=JIndexingConfig(null_handling=True))).build(data, "t0")
    return ref, segment_from_numpy(describe(ref))


def _assert_close(got, want, rtol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        if rtol == 0 or g.dtype.kind != "f":
            assert np.array_equal(g, w, equal_nan=True)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=0, equal_nan=True)


# -- fn: every DEVICE_FUNCS name ---------------------------------------------


def _fn_args(name):
    """(value specs, operands) of one call of DEVICE_FUNCS[name]."""
    raw = lambda c: ("raw", c)  # noqa: E731
    arity, _ = DEVICE_FUNCS[name]
    if name in ("year", "month", "dayofmonth", "hour", "minute", "second", "millissinceepoch", "millisecond",
                "dayofweek", "dayofyear", "quarter", "week", "weekofyear") or name.startswith("datetrunc_"):
        return (raw("ts"),), ()
    if name in ("asin", "acos", "atan"):
        return (raw("u"),), ()
    if name in ("log", "ln", "log2", "log10", "sqrt"):
        return (raw("p"),), ()
    if name in ("rounddecimal", "truncate"):
        return (raw("x"), ("lit", 0)), (np.float64(2),)
    if name == "st_distance":
        return (raw("lat"), raw("lng"), ("lit", 0), ("lit", 1)), (np.float64(40.7), np.float64(-74.0))
    if name in ("power", "pow"):
        return (raw("p"), raw("u")), ()
    if name == "atan2":
        return (raw("x"), raw("u")), ()
    if name in ("mod", "add", "sub", "mult", "div"):
        return (raw("q"), raw("k")), ()
    if name in ("least", "greatest"):
        return (raw("q"), raw("x")), ()
    assert arity == 1, name
    return (raw("x"),), ()


@pytest.mark.parametrize("name", sorted(DEVICE_FUNCS))
def test_device_function_matches_reference(segs, name):
    ref, port = segs
    args, operands = _fn_args(name)
    spec = ("select", ("const", True), (("fn", name, args),), N)
    cols = tuple(sorted({a[1] for a in args if a[0] == "raw"}))
    _assert_close(_run_port(port, spec, cols, operands), _run_jax(ref, spec, cols, operands),
                  CBRT_RTOL if name == "cbrt" else FN_RTOL)


@pytest.mark.parametrize(
    "name,col",
    [("abs", "q"), ("sign", "q"), ("abs", "big"), ("round", "q"), ("floor", "k"), ("mod", "big"), ("year", "q"),
     ("datetrunc_month", "big"), ("least", "big"), ("cbrt", "q")],
)
def test_device_function_of_integers_matches_reference(segs, name, col):
    """Integer inputs: the result dtypes follow jnp's (an int stays an int
    where jnp keeps it one)."""
    ref, port = segs
    args = (("raw", col),) * DEVICE_FUNCS[name][0]
    spec = ("select", ("const", True), (("fn", name, args),), N)
    _assert_close(_run_port(port, spec, (col,), ()), _run_jax(ref, spec, (col,), ()),
                  CBRT_RTOL if name == "cbrt" else FN_RTOL)


# -- the tags a query lowers to, through both planners -----------------------

#: (sql, rtol of float outputs); comments name the tags
CORPUS = [
    ("SELECT SUM(CASE WHEN q < 0 THEN q WHEN q < 20 THEN x ELSE 1 END), "
     "MAX(CASE WHEN region = 'ASIA' THEN p END), MIN(CASE WHEN k > 5 THEN big ELSE ts END) FROM t", 1e-12),  # case
    ("SELECT region, SUM(CASE WHEN year = 1995 THEN 1 ELSE 0 END), MAX(CASE WHEN q > 0 THEN q END) "
     "FROM t GROUP BY region", 0),
    ("SELECT COUNT(*), SUM(q) FROM t WHERE q > k", 0),  # cmp2
    ("SELECT COUNT(*) FROM t WHERE x < p - 50 OR big >= ts", 0),
    ("SELECT year, COUNT(*) FROM t WHERE k * 3 = year - 1990 GROUP BY year", 0),
    ("SELECT COUNT(*), MIN(x) FROM t WHERE q IN (1, 5, 7, 50)", 0),  # in_sorted: int
    ("SELECT COUNT(*) FROM t WHERE p IN (0.5, 12.3, 99.9)", 0),  # float
    ("SELECT COUNT(*) FROM t WHERE q IN (1, 2.5, -3)", 0),  # a fractional literal: float64
    ("SELECT COUNT(*) FROM t WHERE q IN (3, 10000000000)", 0),  # an out-of-range literal
    ("SELECT COUNT(*) FROM t WHERE q NOT IN (10000000000)", 0),
    ("SELECT COUNT(*) FROM t WHERE q + 1 IN (2, 4, 8)", 0),  # over an expression
    ("SELECT COUNT(*) FROM t WHERE big IN (0, 1, 2)", 0),
    ("SELECT COUNT(*) FILTER (WHERE year = 1995), SUM(q) FILTER (WHERE k > 4), MIN(x) FILTER (WHERE q < 0), "
     "AVG(p) FILTER (WHERE region = 'ASIA'), DISTINCTCOUNT(region) FILTER (WHERE q > 40), COUNT(*) FROM t", 1e-12),
    ("SELECT region, COUNT(*) FILTER (WHERE year = 1995), SUM(q) FILTER (WHERE k > 4), "
     "MAX(x) FILTER (WHERE year = 1995), MINMAXRANGE(q) FILTER (WHERE k > 4), "
     "DISTINCTCOUNT(year) FILTER (WHERE q > 0), AVG(p) FILTER (WHERE p > 50), COUNT(*) FROM t "
     "WHERE q <> 0 GROUP BY region", 1e-12),  # masked, grouped
    ("SELECT region, SUM(q) FILTER (WHERE year = 1800), COUNT(*) FILTER (WHERE year = 1800) FROM t "
     "GROUP BY region", 0),  # an empty mask
    ("SELECT FUNNELCOUNT(STEPS(year = 1995, q > 10, k = 3), CORRELATE_BY(region)) FROM t WHERE p > 20", 0),
    ("SELECT FUNNELCOUNT(STEPS(year = 1995, year = 1996), CORRELATE_BY(year)) FROM t", 0),  # funnel_steps
    ("SELECT SUM(ABS(q)), MAX(SQRT(p)), MIN(YEAR(ts)), SUM(DATETRUNC_MONTH(ts)) FROM t", 1e-12),  # fn
    ("SELECT region, MAX(SQRT(p)), SUM(MOD(q, k)) FROM t WHERE ROUND(x) > 1 GROUP BY region", 0),
]
#: the same with null handling over the nullable columns: docmask, k3_*,
#: masked_nan_empty
NULL_CORPUS = [
    ("SELECT COUNT(*) FROM t WHERE nv IS NULL", 0),  # docmask
    ("SELECT COUNT(*) FROM t WHERE nv IS NOT NULL AND q > 0", 0),
    ("SELECT COUNT(*) FROM t WHERE nv IS DISTINCT FROM nx", 0),
    (SET_ON + "SELECT COUNT(*) FROM t WHERE nv > 50", 0),  # k3root, k3_leaf
    (SET_ON + "SELECT COUNT(*) FROM t WHERE NOT (nv > 50) OR ns = 'ASIA'", 0),  # k3_not, k3_or
    (SET_ON + "SELECT COUNT(*) FROM t WHERE nv < 90 AND (nx > 5 OR q > 10) AND nv IS NOT NULL", 0),  # k3_and, k3_exact
    (SET_ON + "SELECT SUM(nv), MIN(nx), AVG(nv), COUNT(nv), MINMAXRANGE(nx), COUNT(*) FROM t WHERE nv > 10 OR q < 0",
     1e-12),  # masked_nan_empty, masked
    (SET_ON + "SELECT SUM(nx) FILTER (WHERE q > 20), SUM(nv) FILTER (WHERE nx > 100) FROM t", 1e-12),  # nested, empty
    (SET_ON + "SELECT region, SUM(nv), SUM(nx) FILTER (WHERE nv > 50), MIN(nv), AVG(nx), COUNT(nx), COUNT(*) FROM t "
              "WHERE nx > 3 OR ns = 'EUROPE' GROUP BY region", 1e-12),
    (SET_ON + "SELECT year, SUM(nv) FROM t WHERE nv IS NULL GROUP BY year", 0),  # every group empty: NaN
]


def _plans(segs, sql, hints=None):
    ref, port = segs
    jctx, ctx = JContext.from_sql(sql), QueryContext.from_sql(sql)
    for c in (jctx, ctx):
        c.hints.update(hints or {})
    return jplan_mod.plan_segment(ref, jctx), plan_mod.plan_segment(port, ctx)


def _check_plans_and_outputs(segs, sql, rtol, hints=None):
    ref, port = segs
    jplan, plan = _plans(segs, sql, hints)
    assert plan.spec == jplan.spec
    assert plan.columns == jplan.columns
    assert len(plan.operands) == len(jplan.operands)
    for o, jo in zip(plan.operands, jplan.operands):
        assert np.asarray(o).dtype == np.asarray(jo).dtype and np.array_equal(o, jo)
    _assert_close(_run_port(port, plan.spec, plan.columns, plan.operands),
                  _run_jax(ref, jplan.spec, jplan.columns, jplan.operands), rtol)
    return plan.spec


@pytest.mark.parametrize("sql,rtol", CORPUS + NULL_CORPUS)
def test_lowered_tags_match_reference(segs, sql, rtol):
    _check_plans_and_outputs(segs, sql, rtol)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT PERCENTILEEST(x, 50), PERCENTILEEST(q, 90) FROM t WHERE k > 2",
        "SELECT region, PERCENTILEEST(x, 50), PERCENTILEEST(big, 10) FROM t GROUP BY region",
        "SELECT region, year, PERCENTILEEST(p, 50) FILTER (WHERE q > 0) FROM t GROUP BY region, year",
    ],
)
def test_hist_matches_reference(segs, sql):
    """`hist`, scalar and grouped, over the global bounds the engine would
    give (here: narrower than the data, so bins clamp at both ends)."""
    hints = {"est_bounds": {a.name: (-2.0, 40.0) for a in QueryContext.from_sql(sql).aggregations}}
    spec = _check_plans_and_outputs(segs, sql, 0, hints)
    assert "hist" in repr(spec)


@pytest.mark.parametrize("lo,inv_w", [(-2.0, 4096 / 7.0), (0.0, 1e300), (-1e300, 1e-300)])
def test_hist_bins_nan_and_overflow_like_xla(segs, lo, inv_w):
    """NaN values and bins past int32: the port clamps in float64 before the
    conversion, the reference's conversion saturates; NaN bins at 0 in both."""
    ref, port = segs
    operands = (np.float64(lo), np.float64(inv_w))
    for gspec, ops in ((None, operands), (("groups", ("region",), 256, 2), operands + (np.ones(1, np.int32),))):
        spec = ("agg", ("const", True), gspec, (("hist", ("bin", "/", ("raw", "x"), ("raw", "q")), 0, 1, 4096),))
        _assert_close(_run_port(port, spec, ("x", "q", "region"), ops), _run_jax(ref, spec, ("x", "q", "region"), ops), 0)


def test_masked_sparse_matches_reference(segs, monkeypatch):
    """`masked` under the sort-compaction group path (`groups_sparse`): both
    planners' MAX_DENSE_GROUPS lowered so a three-key GROUP BY takes it."""
    monkeypatch.setattr(plan_mod, "MAX_DENSE_GROUPS", 64)
    monkeypatch.setattr(jplan_mod, "MAX_DENSE_GROUPS", 64)
    spec = _check_plans_and_outputs(
        segs, "SELECT region, year, ns, COUNT(*) FILTER (WHERE q > 0), SUM(q) FILTER (WHERE q > 0), "
              "MAX(x) FILTER (WHERE p < 50), COUNT(*) FROM t GROUP BY region, year, ns", 1e-12)
    assert spec[2][0] == "groups_sparse"


@pytest.mark.parametrize("nested", [False, True])
def test_nested_masked_matches_reference(segs, nested):
    """A `masked` inside a `masked`, and both inside `masked_nan_empty`, as
    null handling wraps a FILTERed aggregation."""
    ref, port = segs
    f1 = ("cmp_raw", "GT", "q", 0)
    f2 = ("range_ids", "year", 1, 2)
    sum_q = ("sum", ("raw", "q"))
    inner = ("masked", f1, ("masked", f2, sum_q))
    aggs = (("masked_nan_empty", f1, inner), ("masked", f2, ("count",))) if nested else (inner, ("masked", f1, ("min", ("raw", "x"))))
    operands = (np.int32(0), np.int32(2), np.int32(4))
    for gspec in (None, ("groups", ("region",), 256, 0)):
        ops = operands if gspec is None else (np.ones(1, np.int32),) + operands[1:]
        spec = ("agg", ("const", True), gspec, aggs)
        _assert_close(_run_port(port, spec, ("q", "year", "x", "region"), ops),
                      _run_jax(ref, spec, ("q", "year", "x", "region"), ops), 0)


@pytest.mark.parametrize(
    "vals,col",
    [
        (np.asarray([-3, 0, 7, 7], dtype=np.int64), "q"),  # int32 column, int64 list: the column widens
        (np.asarray([-7, 1, 9, 9], dtype=np.int32), "big"),  # int64 column, int32 list: the list widens
        (np.asarray([-1.5, 2.0, 7.0, 7.0]), "q"),  # a float list: float64
        (np.asarray([1, 2, 3, 3], dtype=np.int32), "x"),  # a float column: float64
    ],
)
def test_in_sorted_widening_matches_reference(segs, vals, col):
    ref, port = segs
    spec = ("select", ("in_sorted", ("raw", col), 0), (("docid",),), N)
    _assert_close(_run_port(port, spec, (col,), (vals,)), _run_jax(ref, spec, (col,), (vals,)), 0)


def test_in_vals_matches_reference(segs):
    """`in_vals`: no planner emits it, both programs dispatch on it."""
    ref, port = segs
    vals = np.asarray([1.0, -3.0, 50.0, 2.5])
    for col in ("q", "x"):
        spec = ("select", ("in_vals", ("raw", col), 0), (("docid",),), N)
        _assert_close(_run_port(port, spec, (col,), (vals,)), _run_jax(ref, spec, (col,), (vals,)), 0)


@pytest.mark.parametrize("sql", [s for s, _ in NULL_CORPUS if " WHERE " in s])
def test_kleene_masks_match_reference(segs, sql):
    """The WHERE's doc mask itself, exactly: the first N matching docs."""
    ref, port = segs
    jplan, plan = _plans(segs, sql)
    for s in (jplan, plan):
        s.spec = ("select", s.spec[1], (("docid",),), N)
    _assert_close(_run_port(port, plan.spec, plan.columns, plan.operands),
                  _run_jax(ref, jplan.spec, jplan.columns, jplan.operands), 0)


# -- coverage -----------------------------------------------------------------


def _dispatched_tags(fns) -> set[str]:
    """The string constants compared against a tag (`kind == "x"`,
    `kind in ("x", ...)`, `spec[0] != "x"`, ...) in the given functions."""
    tags = set()
    for fn in fns:
        tree = pyast.parse(inspect.getsource(fn).strip() if not isinstance(fn, str) else fn)
        for node in pyast.walk(tree):
            if not isinstance(node, pyast.Compare):
                continue
            left = node.left
            is_tag = (isinstance(left, pyast.Name) and left.id == "kind") or (
                isinstance(left, pyast.Subscript) and isinstance(left.slice, pyast.Constant) and left.slice.value == 0
            )
            if not is_tag:
                continue
            for comp in node.comparators:
                for c in pyast.walk(comp):
                    if isinstance(c, pyast.Constant) and isinstance(c.value, str):
                        tags.add(c.value)
    return tags


def test_every_reference_tag_is_handled_or_named():
    """Every tag the reference's program dispatches on (`_value`, `_filter`,
    `_filter_k3`, `_agg_scalar`, `_agg_grouped`, `_agg_eval`, `build_fn`) is
    handled by this package's program, or named in NOT_YET with its ROADMAP
    item, and none named there is handled."""
    ref_tags = _dispatched_tags(
        [JK._value, JK._filter, JK._filter_k3, JK._agg_scalar, JK._agg_grouped, JK._agg_eval, JK.build_fn.__wrapped__]
    )
    port_tags = _dispatched_tags([inspect.getsource(K)])
    assert {"fn", "case", "cmp2", "in_vals", "in_sorted", "docmask", "k3root", "k3_leaf", "masked",
            "masked_nan_empty", "funnel_steps", "hist"} <= ref_tags & port_tags
    assert ref_tags - port_tags == set(NOT_YET), ref_tags - port_tags
    assert not set(NOT_YET) & port_tags
    assert not NOT_YET and "mask" in port_tags
