"""The port's per-segment program (pinot_tpu_torch/query/kernels.py) against
the JAX package's `build_fn(spec)` on the same carried-over segment, for each
spec tag the port covers. Plans must match (same spec tuple, same operands);
program outputs must be exactly equal, except float64 sums over non-integer
values, which sum in another order (rtol 1e-12)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.query.context import QueryContext as JContext
from pinot_tpu.query.kernels import get_kernel
from pinot_tpu.query.plan import plan_segment as jplan_segment
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.query.plan import plan_segment
from pinot_tpu_torch.segment import segment_from_numpy
from test_torch_segment import describe

N = 5000


@pytest.fixture(scope="module")
def segs():
    rng = np.random.default_rng(21)
    regions = np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"], dtype=object)
    data = {
        "region": regions[rng.integers(0, 5, N)],
        "year": rng.integers(1992, 1999, N).astype(np.int32),
        "day": np.sort(rng.integers(0, 31, N)).astype(np.int32),  # sorted dict column
        "quantity": rng.integers(-50, 51, N).astype(np.int32),
        "revenue": rng.integers(100, 600_000, N).astype(np.int64),
        "bigval": rng.integers(-(1 << 40), 1 << 40, N).astype(np.int64),
        "discount": np.round(rng.uniform(0, 0.1, N), 3),
        "weight": rng.uniform(0, 10, N).astype(np.float32),
        "ts": np.sort(rng.integers(0, 1 << 40, N)).astype(np.int64),  # sorted raw column
    }
    schema = JSchema.build(
        "t",
        dimensions=[("region", JDT.STRING), ("year", JDT.INT), ("day", JDT.INT)],
        metrics=[
            ("quantity", JDT.INT),
            ("revenue", JDT.LONG),
            ("bigval", JDT.LONG),
            ("discount", JDT.DOUBLE),
            ("weight", JDT.FLOAT),
            ("ts", JDT.TIMESTAMP),
        ],
    )
    ref = JBuilder(schema).build(data, "t0")
    port = segment_from_numpy(describe(ref))
    return ref, port, int(np.median(data["ts"]))


def _run_jax(seg, spec, columns, operands):
    dev = seg.to_device_cached()
    cols = {c: dev.arrays[c] for c in columns} or {"__shape__": next(iter(dev.arrays.values()))}
    ops = tuple(jnp.asarray(o) for o in operands)
    return [np.asarray(l) for l in jax.tree.leaves(get_kernel(spec)(cols, ops, np.int32(seg.n_docs), dev.padded))]


def _run_port(seg, spec, columns, operands):
    dev = seg.to_device_cached("cpu")
    cols = {c: dev.arrays[c] for c in columns} or {"__shape__": next(iter(dev.arrays.values()))}
    ops = tuple(K.stage_operand(o, "cpu") for o in operands)
    leaves, _ = K._flatten(K.build_fn(spec)(cols, ops, seg.n_docs, dev.padded))
    return [l.numpy() for l in leaves]


def _assert_leaves(got, want, exact):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        if exact or g.dtype.kind != "f":
            assert np.array_equal(g, w, equal_nan=True)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


# (sql, whether every output must be exactly equal); comments name the tags
CORPUS = [
    ("SELECT COUNT(*) FROM t", True),  # const
    ("SELECT COUNT(*), SUM(quantity) FROM t WHERE NOT (region = 'ASIA' OR year != 1995)", True),  # not/or/range_ids
    ("SELECT COUNT(*) FROM t WHERE region IN ('ASIA','EUROPE') AND year NOT IN (1992, 1998)", True),  # and/in_lut
    ("SELECT COUNT(*) FROM t WHERE region LIKE 'A%' OR region = 'EUROPE'", True),  # in_lut from LIKE
    ("SELECT SUM(revenue), MIN(discount), MAX(discount) FROM t WHERE quantity > 25 AND discount <= 0.05", True),  # cmp_raw
    ("SELECT COUNT(*) FROM t WHERE quantity * 2 + 1 > 60", True),  # cmp_lit/bin/lit
    ("SELECT COUNT(*), SUM(revenue) FROM t WHERE day BETWEEN 3 AND 17", True),  # doc_range (sorted dict)
    ("SELECT COUNT(*), AVG(quantity) FROM t WHERE ts < {ts_mid}", True),  # doc_range (sorted raw)
    ("SELECT SUM(year), MIN(year), MAX(year), AVG(year), MINMAXRANGE(year) FROM t WHERE quantity < 0", True),  # dictval
    ("SELECT SUM(revenue - quantity), SUM(revenue * 3), SUM(quantity % year), SUM(quantity + 0.5) FROM t", True),  # bin
    ("SELECT SUM(revenue / 7), AVG(discount), SUM(weight) FROM t WHERE region = 'EUROPE'", False),  # '/', f64 sums
    ("SELECT SUM(CAST(discount * 1000 AS INT)), SUM(CAST(quantity AS DOUBLE)), AVG(bigval), MIN(bigval), MAX(bigval) FROM t", True),
    ("SELECT MINMAXRANGE(revenue), MINMAXRANGE(discount), MIN(quantity), MAX(quantity), MIN(weight) FROM t WHERE year = 1800", True),
    ("SELECT region, COUNT(*), SUM(revenue), AVG(quantity), MIN(discount), MAX(revenue), MINMAXRANGE(quantity) "
     "FROM t WHERE year >= 1995 GROUP BY region", True),  # groups
    ("SELECT year, region, SUM(revenue - quantity), SUM(bigval), MAX(weight), MIN(year) FROM t GROUP BY year, region", True),
    ("SELECT day, region, AVG(discount), SUM(discount), MINMAXRANGE(discount), AVG(bigval) FROM t GROUP BY day, region", False),
    ("SELECT region, COUNT(*) FROM t WHERE year = 1800 GROUP BY region", True),  # const False
    ("SELECT day, SUM(quantity % year), SUM(quantity - 2 * year) FROM t WHERE quantity <> 0 GROUP BY day", True),
    ("SELECT DISTINCTCOUNT(region), COUNT(DISTINCT year), MIN(quantity) FROM t WHERE quantity > 40", True),  # distinct_ids
    ("SELECT year, DISTINCTCOUNT(region), DISTINCTCOUNTBITMAP(day), MAX(discount) FROM t "
     "WHERE quantity BETWEEN 0 AND 3 GROUP BY year", True),  # grouped distinct_ids
]


@pytest.mark.parametrize("sql,exact", CORPUS)
def test_program_matches_reference(segs, sql, exact):
    ref, port, ts_mid = segs
    sql = sql.format(ts_mid=ts_mid)
    jplan = jplan_segment(ref, JContext.from_sql(sql))
    plan = plan_segment(port, QueryContext.from_sql(sql))
    assert plan.spec == jplan.spec
    assert plan.columns == jplan.columns
    assert len(plan.operands) == len(jplan.operands)
    for o, jo in zip(plan.operands, jplan.operands):
        assert np.asarray(o).dtype == np.asarray(jo).dtype and np.array_equal(o, jo)
    _assert_leaves(
        _run_port(port, plan.spec, plan.columns, plan.operands),
        _run_jax(ref, jplan.spec, jplan.columns, jplan.operands),
        exact,
    )


def test_corpus_reaches_every_covered_tag(segs):
    _, port, ts_mid = segs
    seen = set()

    def walk(x):
        if isinstance(x, tuple):
            if x and isinstance(x[0], str):
                seen.add(x[0])
            for y in x:
                walk(y)

    for sql, _ in CORPUS:
        walk(plan_segment(port, QueryContext.from_sql(sql.format(ts_mid=ts_mid))).spec)
    covered = {
        "const", "and", "or", "not", "range_ids", "in_lut", "cmp_raw", "cmp_lit", "doc_range",
        "raw", "dictval", "lit", "bin", "cast_int", "cast_float",
        "count", "sum", "min", "max", "avg", "minmaxrange", "distinct_ids", "groups",
    }
    assert covered <= seen, covered - seen


@pytest.mark.parametrize(
    "aggs",
    [
        (("sum", ("ids", "year")), ("max", ("ids", "region")), ("min", ("ids", "day"))),
        (("avg", ("bin", "+", ("ids", "region"), ("raw", "quantity"))),),
    ],
)
def test_ids_value_matches_reference(segs, aggs):
    ref, port, _ = segs
    for gspec in (None, ("groups", ("region",), 256, 0)):
        spec = ("agg", ("const", True), gspec, aggs)
        columns = ("year", "region", "day", "quantity")
        operands = (np.ones(1, dtype=np.int32),)
        _assert_leaves(_run_port(port, spec, columns, operands), _run_jax(ref, spec, columns, operands), True)


@pytest.mark.parametrize(
    "spec",
    [
        # a group tag the program does not know (the MV tags are held
        # against the reference in test_torch_mv.py)
        ("agg", ("const", True), ("groups_hashed", ("region",), 256, 0), (("count",),)),
        # a program kind neither package has (the multistage `mask` is
        # ported: test_mask_program_matches_reference)
        ("scan", ("const", True)),
    ],
)
def test_unsupported_tags_raise(segs, spec):
    _, port, _ = segs
    with pytest.raises(NotImplementedError, match="not ported"):
        _run_port(port, spec, ("quantity", "region"), (np.ones(1, dtype=np.int32),))


@pytest.mark.parametrize(
    "where",
    ["region = 'ASIA'", "year >= 1995 AND quantity < 0", "NOT (day BETWEEN 3 AND 20) OR revenue > 500000", "ts > 0"],
)
def test_mask_program_matches_reference(segs, where):
    """The multistage leaf's filter-only program: plan_filter_mask's plan
    equal to the reference's, its doc mask equal over every padded doc."""
    from pinot_tpu.query import plan as jplan
    from pinot_tpu.query.sql import parse_sql as jparse
    from pinot_tpu_torch.query.plan import plan_filter_mask
    from pinot_tpu_torch.query.sql import parse_sql

    ref, port, _ = segs
    sql = f"SELECT COUNT(*) FROM t WHERE {where}"
    want = jplan.plan_filter_mask(ref, jparse(sql).where)
    got = plan_filter_mask(port, parse_sql(sql).where)
    assert got.spec == want.spec and got.spec[0] == "mask" and got.columns == want.columns
    _assert_leaves(
        _run_port(port, got.spec, got.columns, got.operands), _run_jax(ref, want.spec, want.columns, want.operands), True
    )


@pytest.mark.parametrize(
    "spec",
    [
        ("agg", ("const", True), None, (("sum", ("docid",)),)),
        ("agg", ("const", True), ("groups", ("region",), 256, 0), (("hll", ("gather", "region", 1), 8),)),
        ("select", ("const", True), (("raw", "quantity"),), 10),
        ("agg", ("in_sorted", ("raw", "quantity"), 0), None, (("count",),)),
        ("agg", ("const", True), None, (("sum", ("fn", "abs", (("raw", "quantity"),))),)),
        ("agg", ("const", True), None, (("funnel_steps", "region", 8, (("const", True),)),)),
        ("agg", ("const", True), None, (("masked", ("const", True), ("count",)),)),
        ("agg", ("const", True), ("groups", ("region",), 256, 0), (("hist", ("raw", "quantity"), 0, 0, 16),)),
    ],
)
def test_once_unported_tags_match_reference(segs, spec):
    """Tags this test file once listed among the unported ones: the `docid`
    and `fn` value tags, the `in_sorted` filter, the grouped `hll`, `masked`,
    `funnel_steps` and grouped `hist` aggregates and the `select` program."""
    ref, port, _ = segs
    operands = (np.ones(1, dtype=np.int32), ref.columns["region"].dictionary.hll_hash_pad())
    columns = ("quantity", "region")
    _assert_leaves(_run_port(port, spec, columns, operands), _run_jax(ref, spec, columns, operands), True)


def test_pack_roundtrip_keeps_int64_exact():
    big = torch.tensor([(1 << 62) + 1, -(1 << 53) - 3, 0, -1], dtype=torch.int64)
    leaves = [big, torch.tensor(7, dtype=torch.int64), torch.tensor([0.25, -3.5], dtype=torch.float64),
              torch.tensor([True, False]), torch.zeros(0, dtype=torch.int64)]
    out = K.unpack(K.pack(leaves).numpy(), K.leaf_meta(leaves))
    for l, o in zip(leaves, out):
        assert o.shape == tuple(l.shape)
        assert np.array_equal(o, l.numpy()) and o.dtype == l.numpy().dtype


def test_gathers_clip_like_jax():
    table = torch.tensor([10, 20, 30], dtype=torch.int32)
    idx = torch.tensor([-4, 0, 2, 9], dtype=torch.int32)
    assert K._gather(table, idx).tolist() == np.asarray(jnp.asarray([10, 20, 30])[jnp.asarray([-4, 0, 2, 9])]).tolist()


def test_binary_ops_promote_like_jax():
    i32 = torch.arange(-5, 5, dtype=torch.int32)
    for r in (torch.tensor(3, dtype=torch.int64), torch.tensor(-3.0, dtype=torch.float64), torch.tensor(4, dtype=torch.int32)):
        for op in ("+", "-", "*", "%"):
            spec = ("bin", op, ("raw", "a"), ("lit", 0))
            got = K._value(spec, {"a": i32}, (r,), 10)
            ja = jnp.asarray(i32.numpy())
            jr = jnp.asarray(r.numpy())
            want = {"+": ja + jr, "-": ja - jr, "*": ja * jr, "%": jnp.mod(ja, jr)}[op]
            assert got.numpy().dtype == np.asarray(want).dtype, (op, r.dtype)
            assert np.array_equal(got.numpy(), np.asarray(want)), (op, r.dtype)
