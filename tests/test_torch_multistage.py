"""The port's multistage engine (pinot_tpu_torch/multistage/) against the JAX
package's.

Every query of tests/test_multistage.py and tests/test_multistage_fuzz.py
runs on the same seeded numpy tables through both engines: the reference's
`MultistageEngine` over its segments (its equi-joins' mesh exchange over the
conftest's 8 virtual CPU devices) and the port's `MultistageEngine(...,
device="cpu")` over the port's own segments of the same rows, its exchange
over `make_mesh(("cpu",) * 8)`. Both plan the query into the same StagePlan
(its repr, the rule hits and the EXPLAIN rows are equal).

Tolerance: the rows are equal, in order wherever the query's ORDER BY
defines one and as a multiset elsewhere (the two engines route rows to
workers by different hashes, so an undefined order differs). A cell
equals the reference's in its Python type and value; a float cell (which
may merge per-worker partials in another order) is held to rtol 1e-12.
"""

import math
import random

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.multistage import MultistageEngine as JEngine
from pinot_tpu.multistage import logical as JL
from pinot_tpu.query.sql import parse_sql as jparse
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.multistage import MultistageEngine, logical as L
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.query.sql import parse_sql
from test_torch_fuzz import engines, null_engines  # noqa: F401  (the fuzz corpus's engines)

RTOL = 1e-12
N_ORDERS = 3000
N_CUST = 120


def port_engine(catalog, **kw) -> MultistageEngine:
    """The port's engine on the CPU, its exchange over 8 CPU slots (the
    reference's default mesh in these tests)."""
    return MultistageEngine(catalog, device="cpu", mesh=make_mesh(("cpu",) * 8), **kw)


def both_segments(schema_of, data, name, table_config=None):
    """(reference segment, port segment) of the same rows."""
    from pinot_tpu_torch.segment import SegmentBuilder

    copy = lambda: {k: v.copy() for k, v in data.items()}  # noqa: E731
    jb = JBuilder(schema_of(JDT, JSchema), table_config[0]) if table_config else JBuilder(schema_of(JDT, JSchema))
    pb = SegmentBuilder(schema_of(DataType, Schema), table_config[1]) if table_config else SegmentBuilder(schema_of(DataType, Schema))
    return jb.build(copy(), name), pb.build(copy(), name)


def _num(x) -> bool:
    return isinstance(x, (int, float, np.integer, np.floating)) and not isinstance(x, (bool, np.bool_))


def same_cell(a, b, rel=RTOL) -> bool:
    if type(a) is not type(b):
        return False
    if isinstance(a, (float, np.floating)):
        return a == b or (a != a and b != b) or math.isclose(a, b, rel_tol=rel)
    return a == b


def _key(row):
    return tuple((0, "") if c is None else (1, float(c)) if _num(c) else (2, str(c)) for c in row)


def assert_rows(got, want, ordered: bool, ctx=""):
    assert len(got) == len(want), (ctx, got[:3], want[:3])
    if not ordered:
        got, want = sorted(got, key=_key), sorted(want, key=_key)
    for g, w in zip(got, want):
        assert len(g) == len(w) and all(same_cell(a, b) for a, b in zip(g, w)), (ctx, g, w)


def check(engines, sql, ordered):
    ref, port = engines
    want = ref.execute(sql)
    got = port.execute(sql)
    assert got.columns == want.columns, sql
    assert_rows(got.rows, want.rows, ordered, sql)
    return got


# -- tests/test_multistage.py's tables ------------------------------------------


def _cust_schema(DT, S):
    return S.build(
        "customers",
        dimensions=[("cid", DT.INT), ("cname", DT.STRING), ("cnation", DT.STRING)],
        metrics=[("credit", DT.LONG)],
    )


def _order_schema(DT, S):
    return S.build(
        "orders",
        dimensions=[("oid", DT.INT), ("ocid", DT.INT), ("status", DT.STRING)],
        metrics=[("amount", DT.LONG), ("qty", DT.INT)],
    )


@pytest.fixture(scope="module")
def shop():
    rng = np.random.default_rng(7)
    cust = {
        "cid": np.arange(N_CUST, dtype=np.int32),
        "cname": np.asarray([f"cust_{i:03d}" for i in range(N_CUST)], dtype=object),
        "cnation": np.asarray([f"NATION_{i % 7}" for i in range(N_CUST)], dtype=object),
        "credit": rng.integers(0, 10_000, N_CUST).astype(np.int64),
    }
    orders = {
        "oid": np.arange(N_ORDERS, dtype=np.int32),
        "ocid": rng.integers(0, N_CUST + 30, N_ORDERS).astype(np.int32),
        "status": np.asarray(["OPEN", "SHIPPED", "CANCELLED"], dtype=object)[rng.integers(0, 3, N_ORDERS)],
        "amount": rng.integers(10, 5000, N_ORDERS).astype(np.int64),
        "qty": rng.integers(1, 20, N_ORDERS).astype(np.int32),
    }
    jc, pc = both_segments(_cust_schema, cust, "customers_0")
    halves = [{k: v[:1500] for k, v in orders.items()}, {k: v[1500:] for k, v in orders.items()}]
    o = [both_segments(_order_schema, h, f"orders_{i}") for i, h in enumerate(halves)]
    ref = JEngine({"customers": [jc], "orders": [a for a, _ in o]}, n_workers=3)
    port = port_engine({"customers": [pc], "orders": [b for _, b in o]}, n_workers=3)
    return ref, port


# (sql, ordered): every query of tests/test_multistage.py
SHOP_QUERIES = [
    (
        "SELECT c.cnation, SUM(o.amount), COUNT(*) FROM orders o JOIN customers c "
        "ON o.ocid = c.cid WHERE o.status = 'SHIPPED' GROUP BY c.cnation ORDER BY c.cnation LIMIT 100",
        True,
    ),
    (
        "SELECT o.oid, c.cname FROM orders o LEFT JOIN customers c ON o.ocid = c.cid "
        "WHERE o.oid < 50 ORDER BY o.oid LIMIT 100",
        True,
    ),
    ("SELECT COUNT(*) FROM orders o RIGHT JOIN customers c ON o.ocid = c.cid", True),
    ("SELECT COUNT(*) FROM orders o FULL JOIN customers c ON o.ocid = c.cid", True),
    ("SELECT COUNT(*) FROM orders o JOIN customers c ON o.ocid = c.cid AND o.amount > c.credit", True),
    (
        "SELECT status, total FROM (SELECT status, SUM(amount) AS total FROM orders "
        "GROUP BY status) t WHERE total > 0 ORDER BY total DESC LIMIT 10",
        True,
    ),
    ("SELECT status FROM orders WHERE amount > 4000 UNION SELECT status FROM orders WHERE qty > 15", False),
    ("SELECT oid FROM orders WHERE amount > 4500 UNION ALL SELECT oid FROM orders WHERE amount > 4500", False),
    (
        "SELECT ocid FROM orders WHERE status = 'OPEN' INTERSECT SELECT ocid FROM orders WHERE status = 'SHIPPED'",
        False,
    ),
    (
        "SELECT ocid FROM orders WHERE status = 'OPEN' EXCEPT SELECT ocid FROM orders WHERE status = 'SHIPPED'",
        False,
    ),
    (
        "SELECT oid, status, ROW_NUMBER() OVER (PARTITION BY status ORDER BY amount DESC) AS rn "
        "FROM orders WHERE oid < 200 ORDER BY oid LIMIT 300",
        True,
    ),
    (
        "SELECT oid, SUM(amount) OVER (PARTITION BY status) AS t FROM orders WHERE oid < 100 ORDER BY oid LIMIT 200",
        True,
    ),
    (
        "SELECT oid, RANK() OVER (PARTITION BY status ORDER BY qty) AS r, "
        "DENSE_RANK() OVER (PARTITION BY status ORDER BY qty) AS d "
        "FROM orders WHERE oid < 60 ORDER BY oid LIMIT 100",
        True,
    ),
    (
        "SELECT oid, SUM(amount) OVER (PARTITION BY status ORDER BY oid) AS rs "
        "FROM orders WHERE oid < 80 ORDER BY oid LIMIT 100",
        True,
    ),
    ("SELECT COUNT(*) FROM customers a JOIN customers b ON a.cnation = b.cnation", True),
    (
        "SELECT COUNT(*) FROM orders o JOIN customers c ON o.ocid = c.cid "
        "WHERE o.status = 'OPEN' AND c.credit > 5000",
        True,
    ),
    ("SELECT status, COUNT(*), AVG(amount) FROM orders GROUP BY status ORDER BY status LIMIT 10", True),
    ("SELECT DISTINCT status FROM orders ORDER BY status LIMIT 10", True),
    (
        "SELECT COUNT(*) FROM (SELECT DISTINCT status FROM orders) s CROSS JOIN "
        "(SELECT DISTINCT cnation FROM customers) n",
        True,
    ),
    ("SELECT ocid, COUNT(*) AS c FROM orders GROUP BY ocid HAVING COUNT(*) > 25 ORDER BY ocid LIMIT 500", True),
    (
        "SELECT COUNT(*) FROM orders o LEFT JOIN customers c "
        "ON o.ocid = c.cid AND c.credit > 5000 WHERE o.oid < 200",
        True,
    ),
    (
        "SELECT o.oid, c.cname FROM orders o LEFT JOIN customers c "
        "ON o.ocid = c.cid AND c.credit > 5000 WHERE o.oid < 200 ORDER BY o.oid LIMIT 300",
        True,
    ),
    ("SELECT * FROM orders o JOIN customers c ON o.ocid = c.cid WHERE o.oid < 5 ORDER BY o.oid LIMIT 10", True),
    ("SELECT c.cname FROM customers c WHERE c.cid = 7", True),
    (
        "SELECT oid, SUM(amount) OVER (PARTITION BY status) a, "
        "SUM(amount) OVER (PARTITION BY ocid) b FROM orders ORDER BY oid LIMIT 4000",
        True,
    ),
    ("SELECT COUNT(*) FROM orders o JOIN customers c ON o.ocid = c.credit", True),
    (
        "SELECT status FROM orders WHERE oid < 100 INTERSECT ALL "
        "SELECT status FROM orders WHERE oid >= 100 AND oid < 150",
        False,
    ),
    (
        "SELECT status FROM orders WHERE oid < 100 EXCEPT ALL "
        "SELECT status FROM orders WHERE oid >= 100 AND oid < 150",
        False,
    ),
    ("SELECT COUNT(*) FROM orders o JOIN customers c ON o.ocid = c.cname", True),
]


@pytest.mark.parametrize("sql,ordered", SHOP_QUERIES)
def test_shop_queries_match_reference(shop, sql, ordered):
    check(shop, sql, ordered)


@pytest.mark.parametrize(
    "sql",
    [SHOP_QUERIES[0][0], SHOP_QUERIES[10][0], SHOP_QUERIES[15][0], SHOP_QUERIES[18][0], SHOP_QUERIES[26][0]],
)
def test_stage_plan_and_explain_match_reference(shop, sql):
    """The same StagePlan (repr, rule hits) and EXPLAIN rows."""
    ref, port = shop
    cols = {"orders": ["oid", "ocid", "status", "amount", "qty"], "customers": ["cid", "cname", "cnation", "credit"]}
    for workers in (1, 2, 3):
        jp = JL.build_stage_plan(jparse(sql), JL.Catalog(cols), workers)
        pp = L.build_stage_plan(parse_sql(sql), L.Catalog(cols), workers)
        assert repr(pp) == repr(jp)
        assert pp.rule_stats == jp.rule_stats
        assert pp.visible_names == jp.visible_names
    want = ref.execute("EXPLAIN PLAN FOR " + sql)
    got = port.execute("EXPLAIN PLAN FOR " + sql)
    assert got.columns == want.columns and got.rows == want.rows


def test_filter_pushdown_plan_text():
    sql = (
        "SELECT COUNT(*) FROM orders o JOIN customers c ON o.ocid = c.cid "
        "WHERE o.status = 'OPEN' AND c.credit > 5000"
    )
    cat = L.Catalog({"orders": ["oid", "ocid", "status", "amount", "qty"], "customers": ["cid", "cname", "cnation", "credit"]})
    txt = repr(L.build_stage_plan(parse_sql(sql), cat, 2))
    assert "Scan(orders|status = 'OPEN')" in txt and "Scan(customers|credit > 5000)" in txt


def test_mixed_type_join_key_hash_hash_fails_loudly(shop):
    ref, port = shop
    sql = "SELECT COUNT(*) FROM orders a JOIN orders b ON a.ocid = b.status"
    with pytest.raises(Exception, match="type mismatch"):
        ref.execute(sql)
    with pytest.raises(Exception, match="type mismatch"):
        port.execute(sql)


def test_empty_table():
    ref = JEngine({"empty_t": []}, n_workers=2, schemas={"empty_t": ["a", "b"]})
    port = port_engine({"empty_t": []}, n_workers=2, schemas={"empty_t": ["a", "b"]})
    for sql in ("SELECT a, COUNT(*) FROM empty_t GROUP BY a", "SELECT COUNT(*) FROM empty_t"):
        assert_rows(port.execute(sql).rows, ref.execute(sql).rows, True, sql)


def test_leaf_scan_filter_runs_the_mask_program():
    """A join's leaf Scan filter runs the `mask` program (server metric),
    and the rows equal the reference's."""
    from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics
    from pinot_tpu_torch.query import kernels as K

    rng = np.random.default_rng(5)
    n = 5000
    facts = {"k": rng.integers(0, 50, n).astype(np.int32), "v": rng.integers(0, 1000, n).astype(np.int64)}
    dims = {"k": np.arange(50, dtype=np.int32), "label": np.array([f"L{i % 5}" for i in range(50)], dtype=object)}
    f = both_segments(lambda DT, S: S.build("facts", dimensions=[("k", DT.INT)], metrics=[("v", DT.LONG)]), facts, "f0")
    d = both_segments(
        lambda DT, S: S.build("dims", dimensions=[("k", DT.INT), ("label", DT.STRING)], metrics=[]), dims, "d0"
    )
    ref = JEngine({"facts": [f[0]], "dims": [d[0]]})
    port = port_engine({"facts": [f[1]], "dims": [d[1]]})
    kinds = []
    reals = {name: getattr(K, name) for name in ("get_kernel", "get_packed_kernel")}

    def spy(name):
        # the compiled programs are cached by spec: every lookup is a run
        def lookup(spec):
            kinds.append(spec[0])
            return reals[name](spec)

        return lookup

    meter = server_metrics().meter(ServerMeter.MULTISTAGE_LEAF_DEVICE_SCANS)
    for sql, leaf, ordered in (
        # the reference test's query: the partial aggregate moves to the leaf
        (
            "SELECT d.label, SUM(f.v) FROM facts f JOIN dims d ON f.k = d.k "
            "WHERE f.v > 500 GROUP BY d.label ORDER BY d.label LIMIT 10",
            "agg",
            True,
        ),
        # rows leave the leaf: its Scan filter is the mask program
        ("SELECT f.v, d.label FROM facts f JOIN dims d ON f.k = d.k WHERE f.v > 990", "mask", False),
    ):
        before = meter.count
        kinds.clear()
        with pytest.MonkeyPatch.context() as mp:
            for name in reals:
                mp.setattr(K, name, spy(name))
            got = port.execute(sql)
        assert meter.count > before and leaf in kinds, (sql, kinds)
        assert_rows(got.rows, ref.execute(sql).rows, ordered, sql)


@pytest.fixture(scope="module")
def two_phase():
    rng = np.random.default_rng(21)
    n = 30_000
    data = {
        "cat": np.asarray([f"c{i % 7}" for i in range(n)], dtype=object),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    }
    schema = lambda DT, S: S.build("t", dimensions=[("cat", DT.STRING)], metrics=[("v", DT.LONG)])  # noqa: E731
    segs = [both_segments(schema, {k: x[a:b] for k, x in data.items()}, f"s{i}") for i, (a, b) in enumerate(((0, n // 2), (n // 2, n)))]
    return JEngine({"t": [s[0] for s in segs]}), port_engine({"t": [s[1] for s in segs]})


def test_two_phase_aggregate_runs_the_leaf_engine(two_phase):
    from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics

    meter = server_metrics().meter(ServerMeter.MULTISTAGE_LEAF_DEVICE_SCANS)
    before = meter.count
    sql = (
        "SELECT t1.cat, SUM(t1.v), COUNT(*), AVG(t1.v), MIN(t1.v) FROM t t1 "
        "WHERE t1.v > 100 GROUP BY t1.cat ORDER BY t1.cat LIMIT 20"
    )
    check(two_phase, sql, True)
    assert meter.count > before


def test_leaf_kernel_failure_fails_the_query(two_phase, monkeypatch):
    """A kernel wrapper that raises at the leaf fails the query: only the
    planner's declines send the leaf to the host partial aggregate."""
    from pinot_tpu_torch.query import kernels as K

    calls = []

    def broken(*a, **k):
        calls.append(a)
        raise RuntimeError("grouped_sum_count launch failed")

    monkeypatch.setattr(K, "grouped_multi_sum", broken)
    sql = "SELECT t1.cat, SUM(t1.v), COUNT(*) FROM t t1 WHERE t1.v > 100 GROUP BY t1.cat ORDER BY t1.cat LIMIT 20"
    with pytest.raises(Exception, match="grouped_sum_count launch failed"):
        two_phase[1].execute(sql)
    assert calls


@pytest.fixture(scope="module")
def small_kv():
    rng = np.random.default_rng(22)
    n = 8000
    data = {"k": np.asarray([f"k{i % 30}" for i in range(n)], dtype=object), "v": rng.integers(0, 50, n).astype(np.int64)}
    s = both_segments(lambda DT, S: S.build("t", dimensions=[("k", DT.STRING)], metrics=[("v", DT.LONG)]), data, "s0")
    return JEngine({"t": [s[0]]}), port_engine({"t": [s[1]]})


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT COUNT(*), SUM(t1.v), DISTINCTCOUNT(t1.v) FROM t t1",
        "SELECT a.k, COUNT(*) FROM t a JOIN t b ON a.k = b.k WHERE a.v = 0 AND b.v = 1 GROUP BY a.k ORDER BY a.k LIMIT 5",
    ],
)
def test_two_phase_scalar_and_distinct(small_kv, sql):
    check(small_kv, sql, True)


@pytest.fixture(scope="module")
def three_keys():
    rng = np.random.default_rng(23)
    n = 20_000
    data = {"k": np.asarray([f"k{i % 3}" for i in range(n)], dtype=object), "v": rng.integers(0, 1000, n).astype(np.int64)}
    s = both_segments(lambda DT, S: S.build("t", dimensions=[("k", DT.STRING)], metrics=[("v", DT.LONG)]), data, "s0")
    return JEngine({"t": [s[0]]}), port_engine({"t": [s[1]]})


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT DISTINCTCOUNTHLL(t1.v) FROM t t1",
        "SELECT a.k, b.k, COUNT(*) FROM t a JOIN t b ON a.k = b.k WHERE a.v = 1 AND b.v = 2 "
        "GROUP BY a.k, b.k ORDER BY a.k LIMIT 5",
    ],
)
def test_two_phase_hll_and_dual_key(three_keys, sql):
    check(three_keys, sql, True)


# -- tests/test_multistage_fuzz.py ----------------------------------------------

FUZZ_N = 8000
NATIONS = [f"N{i:02d}" for i in range(12)]


@pytest.fixture(scope="module")
def fuzz():
    rng = np.random.default_rng(181)
    fdata = {
        "nation": np.asarray(NATIONS + ["N99"], dtype=object)[rng.integers(0, len(NATIONS) + 1, FUZZ_N)],
        "year": (2000 + rng.integers(0, 6, FUZZ_N)).astype(np.int32),
        "rev": rng.integers(-500, 5000, FUZZ_N).astype(np.int64),
        "qty": rng.integers(1, 100, FUZZ_N).astype(np.int64),
        "oid": np.arange(FUZZ_N, dtype=np.int64),
    }
    ddata = {
        "dnation": np.asarray(NATIONS + ["N05"], dtype=object),
        "region": np.asarray([f"R{i % 4}" for i in range(len(NATIONS))] + ["R9"], dtype=object),
        "pop": np.arange(len(NATIONS) + 1, dtype=np.int64) * 7 + 3,
    }
    fs = lambda DT, S: S.build(  # noqa: E731
        "f",
        dimensions=[("nation", DT.STRING), ("year", DT.INT)],
        metrics=[("rev", DT.LONG), ("qty", DT.LONG), ("oid", DT.LONG)],
    )
    ds = lambda DT, S: S.build(  # noqa: E731
        "d", dimensions=[("dnation", DT.STRING), ("region", DT.STRING)], metrics=[("pop", DT.LONG)]
    )
    f = [both_segments(fs, {c: a[i * 4000 : (i + 1) * 4000] for c, a in fdata.items()}, f"f{i}") for i in range(2)]
    d = both_segments(ds, ddata, "d0")
    return (
        JEngine({"f": [x[0] for x in f], "d": [d[0]]}, n_workers=2),
        port_engine({"f": [x[1] for x in f], "d": [d[1]]}, n_workers=2),
    )


FUZZ_AGGS = ["SUM(f.rev)", "COUNT(*)", "MIN(f.qty)", "MAX(f.rev)", "AVG(f.qty)", "SUM(d.pop)"]


def _join_fuzz_queries():
    rng = random.Random(7)
    out = []
    for _ in range(20):
        kind = rng.choice(["JOIN", "LEFT JOIN"])
        keys = rng.choice([["d.region"], ["f.year"], ["f.year", "d.region"]])
        aggs = rng.sample(FUZZ_AGGS, rng.randint(1, 3))
        out.append(
            f"SELECT {', '.join(keys + aggs)} FROM f {kind} d ON f.nation = d.dnation "
            f"GROUP BY {', '.join(keys)} ORDER BY {', '.join(keys)} LIMIT 500"
        )
    return out


def _window_fuzz_queries():
    rng = random.Random(11)
    out = []
    for _ in range(10):
        fn = rng.choice(["SUM(f.rev)", "MIN(f.rev)", "MAX(f.rev)", "COUNT(*)"])
        part = rng.choice(["f.nation", "f.year"])
        out.append(
            f"SELECT f.oid, {fn} OVER (PARTITION BY {part} ORDER BY f.rev, f.oid) AS w "
            f"FROM f ORDER BY f.oid LIMIT {FUZZ_N}"
        )
    return out


@pytest.mark.parametrize("sql", _join_fuzz_queries())
def test_random_join_aggregates_match_reference(fuzz, sql):
    # ORDER BY the group keys: a NULL key (LEFT JOIN's N99 rows) sorts last
    # in both, so the order is defined
    check(fuzz, sql, True)


@pytest.mark.parametrize("sql", _window_fuzz_queries())
def test_random_window_functions_match_reference(fuzz, sql):
    check(fuzz, sql, True)


def test_fuzz_null_group_keys_come_out_as_none(fuzz):
    """LEFT JOIN's unmatched N99 rows form a NULL region group."""
    sql = "SELECT d.region, COUNT(*) FROM f LEFT JOIN d ON f.nation = d.dnation GROUP BY d.region ORDER BY d.region LIMIT 20"
    rows = check(fuzz, sql, True).rows
    assert rows[-1][0] is None and rows[-1][1] > 0


# -- the leaf's `mask` program against the reference's plan_filter_mask ----------


def _same_operand(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.mark.parametrize("nulls", [False, True], ids=["plain", "kleene"])
@pytest.mark.parametrize("seed", range(3))
def test_plan_filter_mask_matches_reference(seed, nulls, request):  # noqa: F811
    """Random filters of tests/test_query_fuzz.py lowered by both packages'
    plan_filter_mask over each segment of the fuzz corpus (under null
    handling the Kleene lowering over its null table): the same spec, the
    same operands and columns, or the same refusal; the port's `mask`
    program gives the reference host executor's mask."""
    from pinot_tpu.query import host_exec as jhost
    from pinot_tpu.query import plan as jplan
    from pinot_tpu_torch.query import kernels as K
    from pinot_tpu_torch.query import plan as plan_mod
    from test_query_fuzz import _gen_filter

    ref, port = request.getfixturevalue("null_engines" if nulls else "engines")
    rng = np.random.default_rng(500 + seed + 10 * nulls)
    checked = 0
    for _ in range(15):
        fsql, _ = _gen_filter(rng)
        sql = f"SELECT COUNT(*) FROM f WHERE {fsql}"
        jf, pf = jparse(sql).where, parse_sql(sql).where
        for jseg, seg in zip(ref.segments, port.segments):
            try:
                want = jplan.plan_filter_mask(jseg, jf, kleene=nulls)
            except (jplan.DeviceFallback, jplan.PlanError) as e:
                with pytest.raises((plan_mod.DeviceFallback, plan_mod.PlanError)):
                    plan_mod.plan_filter_mask(seg, pf, kleene=nulls)
                assert type(e).__name__ in ("DeviceFallback", "PlanError")
                continue
            got = plan_mod.plan_filter_mask(seg, pf, kleene=nulls)
            assert got.spec == want.spec and got.columns == want.columns, fsql
            assert len(got.operands) == len(want.operands)
            assert all(_same_operand(a, b) for a, b in zip(got.operands, want.operands)), fsql
            ds = seg.to_device_cached("cpu")
            cols, ops = K.plan_inputs(got, ds)
            mask = K.build_fn(got.spec)(cols, ops, ds.n_docs, ds.padded)[: seg.n_docs].numpy()
            host = jhost.filter_mask_null_aware(jseg, jf) if nulls else jhost.filter_mask(jseg, jf)
            np.testing.assert_array_equal(mask, host, err_msg=fsql)
            checked += 1
    assert checked > 20


def test_explain_analyze_and_stage_stats_match_reference(shop):
    """EXPLAIN ANALYZE gives the reference's operator tree with the same
    rows, blocks and workers a stage (the measured milliseconds masked), and
    `SET trace = true` attaches the merged stage stats."""
    import re

    ref, port = shop
    sql = (
        "EXPLAIN ANALYZE SELECT c.cnation, SUM(o.amount) FROM orders o JOIN customers c "
        "ON o.ocid = c.cid GROUP BY c.cnation ORDER BY c.cnation"
    )

    def masked(rows):
        return [[re.sub(r"(wallMs|deviceMs)=[0-9.e+-]+", r"\1=_", r[0]), *r[1:]] for r in rows]

    want, got = ref.execute(sql), port.execute(sql)
    assert got.columns == want.columns and masked(got.rows) == masked(want.rows)
    res = port.execute("SET trace = true; SELECT COUNT(*) FROM orders")
    ops = [op["operator"] for st in res.stage_stats for op in st["operators"]]
    assert res.rows == [[N_ORDERS]] and "Aggregate(final)" in ops
