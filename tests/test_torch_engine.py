"""The port's QueryEngine (device="cpu") against the JAX package's QueryEngine
over the same data: BASELINE configs 1-4, the __graft_entry__ Q4 query and
slice-shaped queries from tests/test_queries.py. Segments reach the port two
ways — its own SegmentBuilder on the same arrays, and the reference's
segments carried across with segment_from_numpy. ResultTable rows must be
equal — values, Python types and row order — and so must numDocsScanned;
only float64 sums over DOUBLE columns may differ, within rtol 1e-12, since
they sum in another order."""

import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as graft
from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_segment import describe

REPO = Path(__file__).resolve().parents[1]
REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [f"NATION_{i:02d}" for i in range(25)]
CATEGORIES = [f"MFGR#{i // 10 + 1}{i % 10 + 1}" for i in range(25)]


def _lineorder(seed, n):
    """tests/test_queries.py's generator: each seed draws its own value pools,
    so the segments' dictionaries differ."""
    rng = np.random.default_rng(seed)
    region_pool = rng.permutation(REGIONS)[: rng.integers(3, 6)]
    nation_pool = rng.permutation(NATIONS)[: rng.integers(10, 25)]
    return {
        "region": np.asarray(region_pool, dtype=object)[rng.integers(0, len(region_pool), n)],
        "nation": np.asarray(nation_pool, dtype=object)[rng.integers(0, len(nation_pool), n)],
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "quantity": rng.integers(1, 51, n).astype(np.int32),
        "revenue": rng.integers(100, 600_000, n).astype(np.int64),
        "discount": np.round(rng.uniform(0, 0.1, n), 3),
    }


def _ssb(seed, n):
    """bench.py's SSB-flavoured lineorder generator."""
    rng = np.random.default_rng(seed)
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "c_nation": np.array(NATIONS, dtype=object)[rng.integers(0, 25, n)],
        "p_category": np.array(CATEGORIES, dtype=object)[rng.integers(0, 25, n)],
        "lo_revenue": rng.integers(100, 600_000, n).astype(np.int64),
        "lo_supplycost": rng.integers(50, 100_000, n).astype(np.int64),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
    }


def _doubles(seed, n):
    """A DOUBLE column with NaN, +-0.0 and +-inf among its values: group "a"
    holds a NaN in every segment, "b" in some, "z" holds only zeros."""
    rng = np.random.default_rng(seed)
    g = np.array(["a", "b", "c", "z"], dtype=object)[rng.integers(0, 4, n)]
    x = np.round(rng.normal(0, 100, n), 2)
    x[g == "z"] = rng.choice([0.0, -0.0], int((g == "z").sum()))
    x[np.flatnonzero(g == "a")[:2]] = np.nan
    if seed % 2:
        x[np.flatnonzero(g == "b")[:1]] = np.nan
    x[np.flatnonzero(g == "c")[:1]] = np.inf
    x[np.flatnonzero(g == "c")[1:2]] = -np.inf
    return {"g": g, "x": x, "y": rng.integers(-5, 6, n).astype(np.int32)}


TABLES = {
    "lineorder": (
        lambda DT: dict(
            dimensions=[("region", DT.STRING), ("nation", DT.STRING), ("year", DT.INT)],
            metrics=[("quantity", DT.INT), ("revenue", DT.LONG), ("discount", DT.DOUBLE)],
        ),
        [_lineorder(100 + i, n) for i, n in enumerate([4000, 2500, 3300])],
    ),
    "ssb": (
        lambda DT: dict(
            dimensions=[("d_year", DT.INT), ("c_nation", DT.STRING), ("p_category", DT.STRING)],
            metrics=[("lo_revenue", DT.LONG), ("lo_supplycost", DT.LONG), ("lo_quantity", DT.INT)],
        ),
        [_ssb(i, 5000) for i in range(3)],
    ),
    "graft": (
        lambda DT: dict(
            dimensions=[("d_year", DT.INT), ("c_nation", DT.STRING)],
            metrics=[("lo_revenue", DT.LONG), ("lo_quantity", DT.INT)],
        ),
        [graft._toy_table(4096)[1]],
    ),
    "doubles": (
        lambda DT: dict(dimensions=[("g", DT.STRING)], metrics=[("x", DT.DOUBLE), ("y", DT.INT)]),
        [_doubles(200 + i, n) for i, n in enumerate([700, 900])],
    ),
}


@pytest.fixture(scope="module")
def engines():
    """{table: (reference engine, {mode: port engine})}, plus a memo of the
    reference's results."""
    out = {}
    for table, (cols, datas) in TABLES.items():
        name = "lineorder"
        jsegs = [JBuilder(JSchema.build(name, **cols(JDT))).build(d, f"{table}_{i}") for i, d in enumerate(datas)]
        built = [SegmentBuilder(Schema.build(name, **cols(DataType))).build(d, f"{table}_{i}") for i, d in enumerate(datas)]
        carried = [segment_from_numpy(describe(s)) for s in jsegs]
        out[table] = (
            JEngine(jsegs),
            {"built": QueryEngine(built, device="cpu"), "carried": QueryEngine(carried, device="cpu")},
        )
    return out, {}


def _assert_rows(got, want, approx=()):
    assert len(got) == len(want), (got, want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w)
        for c, (a, b) in enumerate(zip(g, w)):
            assert type(a) is type(b), (r, c, a, b)
            if c in approx:
                assert math.isclose(a, b, rel_tol=1e-12), (r, c, a, b)
            else:
                assert a == b or (a != a and b != b), (r, c, a, b)


CONFIG_5 = (
    "SELECT d_year, c_nation, COUNT(*), MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost), "
    "MAX(lo_revenue / lo_quantity) FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
    "GROUP BY d_year, c_nation ORDER BY d_year, c_nation LIMIT 200"
)
CONFIG_6 = (
    "SELECT d_year, p_category, COUNT(*), DISTINCTCOUNT(c_nation) FROM lineorder "
    "WHERE lo_quantity = 1 AND lo_revenue < 20000 GROUP BY d_year, p_category ORDER BY d_year, p_category LIMIT 200"
)
CONFIG_7 = (
    "SELECT COUNT(DISTINCT c_nation), DISTINCTCOUNT(p_category), MIN(lo_revenue) FROM lineorder "
    "WHERE lo_quantity = 1 AND lo_revenue < 20000"
)
EMPTY_IN_ONE_SEGMENT = (
    "SELECT nation, MIN(quantity), MAX(revenue), MIN(discount), DISTINCTCOUNT(region), COUNT(*) FROM lineorder "
    "WHERE year = 1995 AND quantity < 3 GROUP BY nation ORDER BY nation LIMIT 30"
)

# (table, sql, columns holding DOUBLE-column sums)
QUERIES = [
    # BASELINE configs 1-4 (bench.py's SQL)
    ("ssb", "SELECT COUNT(*) FROM lineorder WHERE c_nation = 'NATION_07'", ()),
    ("ssb", "SELECT SUM(lo_revenue), MIN(lo_quantity), MAX(lo_revenue), AVG(lo_supplycost) "
            "FROM lineorder WHERE d_year BETWEEN 1994 AND 1996 AND c_nation = 'NATION_03'", ()),
    ("ssb", "SELECT d_year, SUM(lo_revenue) FROM lineorder "
            "WHERE (c_nation = 'NATION_01' OR c_nation = 'NATION_02') AND lo_quantity < 25 "
            "GROUP BY d_year ORDER BY d_year LIMIT 20", ()),
    ("ssb", "SELECT d_year, c_nation, p_category, SUM(lo_revenue - lo_supplycost) "
            "FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
            "GROUP BY d_year, c_nation, p_category ORDER BY SUM(lo_revenue - lo_supplycost) DESC LIMIT 10", ()),
    ("ssb", "SELECT p_category, COUNT(*), MIN(lo_supplycost), MINMAXRANGE(lo_revenue) FROM lineorder "
            "WHERE lo_quantity = 7 GROUP BY p_category ORDER BY COUNT(*) DESC LIMIT 12", ()),
    # the __graft_entry__ Q4 query
    ("graft", graft._SQL, ()),
    # slice-shaped queries of tests/test_queries.py
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE region = 'ASIA'", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder", ()),
    ("lineorder", "SELECT SUM(revenue), MIN(quantity), MAX(discount), AVG(revenue) FROM lineorder "
                  "WHERE region = 'EUROPE' AND year BETWEEN 1994 AND 1997", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE NOT (region = 'ASIA' OR year != 1995)", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE region IN ('ASIA','EUROPE') AND year NOT IN (1992, 1998)", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE quantity > 25 AND discount <= 0.05", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE quantity * 2 + 1 > 60", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE nation LIKE 'NATION_0_'", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE REGEXP_LIKE(nation, '_1')", ()),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE region = 'ATLANTIS'", ()),
    ("lineorder", "SELECT SUM(revenue) / COUNT(*) FROM lineorder", ()),
    ("lineorder", "SELECT MINMAXRANGE(revenue) FROM lineorder", ()),
    ("lineorder", "SELECT region, COUNT(*) FROM lineorder GROUP BY region LIMIT 100", ()),
    ("lineorder", "SELECT region, SUM(revenue) FROM lineorder WHERE year >= 1995 GROUP BY region LIMIT 100", ()),
    ("lineorder", "SELECT year, region, SUM(revenue) FROM lineorder GROUP BY year, region "
                  "ORDER BY SUM(revenue) DESC LIMIT 5", ()),
    ("lineorder", "SELECT nation, AVG(quantity) FROM lineorder GROUP BY nation HAVING COUNT(*) > 300 LIMIT 100", ()),
    ("lineorder", "SELECT year, COUNT(*) FROM lineorder GROUP BY year ORDER BY year LIMIT 3", ()),
    ("lineorder", "SELECT region, COUNT(*) FROM lineorder WHERE year = 1800 GROUP BY region", ()),
    # ties under ORDER BY: row order follows the reference's merge order
    ("lineorder", "SELECT region, year, COUNT(*) FROM lineorder WHERE quantity = 7 "
                  "GROUP BY region, year ORDER BY COUNT(*) DESC LIMIT 20", ()),
    ("lineorder", "SELECT nation, region, MAX(revenue), MIN(revenue), MINMAXRANGE(quantity) FROM lineorder "
                  "WHERE quantity BETWEEN 10 AND 40 GROUP BY nation, region ORDER BY region, MAX(revenue) DESC LIMIT 15", ()),
    ("lineorder", "SELECT year, COUNT(*) AS n, SUM(quantity) FROM lineorder GROUP BY year "
                  "HAVING SUM(quantity) > 1000 ORDER BY n DESC LIMIT 4 OFFSET 1", ()),
    # DOUBLE-column sums
    ("lineorder", "SELECT SUM(discount), MIN(discount), MAX(discount), AVG(discount) FROM lineorder", (0, 3)),
    ("lineorder", "SELECT region, SUM(discount), AVG(discount), COUNT(*) FROM lineorder "
                  "GROUP BY region ORDER BY region LIMIT 10", (1, 2)),
    # chip_smoke configs 5-7: grouped MIN/MAX (int32 and float64 values),
    # grouped and scalar DISTINCTCOUNT
    ("ssb", CONFIG_5, ()),
    ("ssb", CONFIG_6, ()),
    ("ssb", CONFIG_7, ()),
    # DISTINCTCOUNT and COUNT(DISTINCT ...), grouped and scalar
    ("ssb", "SELECT d_year, DISTINCTCOUNT(c_nation), COUNT(DISTINCT p_category), COUNT(*) FROM lineorder "
            "WHERE lo_quantity < 3 GROUP BY d_year ORDER BY d_year LIMIT 10", ()),
    ("lineorder", "SELECT DISTINCTCOUNT(nation), COUNT(DISTINCT region), DISTINCTCOUNTBITMAP(year) "
                  "FROM lineorder WHERE quantity > 20", ()),
    ("lineorder", "SELECT region, DISTINCTCOUNT(nation), COUNT(*) FROM lineorder GROUP BY region "
                  "ORDER BY DISTINCTCOUNT(nation) DESC, region LIMIT 10", ()),
    ("lineorder", "SELECT year, region, COUNT(DISTINCT nation) AS dn FROM lineorder WHERE quantity BETWEEN 5 AND 9 "
                  "GROUP BY year, region HAVING COUNT(DISTINCT nation) > 3 ORDER BY dn DESC LIMIT 12", ()),
    ("lineorder", "SELECT DISTINCTCOUNT(nation) FROM lineorder WHERE region = 'ATLANTIS'", ()),
    # MIN/MAX/MINMAXRANGE over a DOUBLE column and over a quotient
    ("lineorder", "SELECT region, MIN(discount), MAX(discount), MINMAXRANGE(discount) FROM lineorder "
                  "GROUP BY region ORDER BY region LIMIT 10", ()),
    ("lineorder", "SELECT year, MIN(revenue / quantity), MAX(revenue / quantity), MINMAXRANGE(revenue / quantity) "
                  "FROM lineorder WHERE region != 'ASIA' GROUP BY year ORDER BY year LIMIT 10", ()),
    # NaN, +-0.0 and +-inf in a DOUBLE column
    ("doubles", "SELECT g, MIN(x), MAX(x), MINMAXRANGE(x), MIN(y), MAX(y), COUNT(*) FROM lineorder "
                "GROUP BY g ORDER BY g LIMIT 10", ()),
    ("doubles", "SELECT g, MIN(x), MAX(x) FROM lineorder WHERE y > 2 GROUP BY g ORDER BY g LIMIT 10", ()),
    # groups that the filter leaves empty in some segment (see
    # test_filter_empties_a_group_in_one_segment)
    ("lineorder", EMPTY_IN_ONE_SEGMENT, ()),
    # DISTINCTCOUNTHLL, SELECTION and DISTINCT (once shapes the port raised on)
    ("lineorder", "SELECT DISTINCTCOUNTHLL(nation) FROM lineorder", ()),
    ("lineorder", "SELECT region, year FROM lineorder LIMIT 3", ()),
    ("lineorder", "SELECT DISTINCT region FROM lineorder", ()),
    # the host executor (once shapes the port raised on): a raw column, an
    # expression key
    ("lineorder", "SELECT DISTINCTCOUNT(quantity) FROM lineorder", ()),
    ("lineorder", "SELECT region, DISTINCTCOUNT(quantity + 1) FROM lineorder GROUP BY region", ()),
    ("lineorder", "SELECT year - 1990, COUNT(*) FROM lineorder GROUP BY year - 1990", ()),
    # the single-value spec tags and null handling (once shapes the port
    # raised on)
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE quantity IN (1, 2, 3)", ()),  # in_sorted
    ("lineorder", "SELECT PERCENTILEEST(quantity, 50) FROM lineorder", ()),  # hist
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE quantity > year", ()),  # cmp2
    ("lineorder", "SELECT SUM(CASE WHEN year = 1995 THEN 1 ELSE 0 END) FROM lineorder", ()),  # case
    ("lineorder", "SELECT COUNT(*) FILTER (WHERE year = 1995) FROM lineorder", ()),  # masked
    ("lineorder", "SELECT FUNNELCOUNT(STEPS(year = 1995, year = 1996), CORRELATE_BY(nation)) FROM lineorder", ()),
    ("lineorder", "SELECT region FROM lineorder ORDER BY ABS(quantity) LIMIT 3", ()),  # fn as a sort key
    ("lineorder", "SELECT SUM(ABS(quantity)) FROM lineorder", ()),  # fn
    ("lineorder", "SET enableNullHandling = true; SELECT SUM(quantity) FROM lineorder", ()),  # masked_nan_empty
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("table,sql,approx", QUERIES)
def test_engine_matches_reference(engines, table, sql, approx, mode):
    by_table, memo = engines
    ref, ports = by_table[table]
    if sql not in memo:
        memo[sql] = ref.execute(sql)
    want = memo[sql]
    got = ports[mode].execute(sql)
    assert got.columns == want.columns
    _assert_rows(got.rows, want.rows, approx)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.total_docs == want.total_docs


@pytest.mark.parametrize(
    "sql",
    [
        "EXPLAIN PLAN FOR SELECT region, year FROM lineorder LIMIT 3",  # answered since A5, see below
        "SELECT COUNT(*) FROM lineorder WHERE TEXT_MATCH(region, 'ASIA')",  # answered with a text index, see below
        "SELECT COUNT(*) FROM tagged WHERE tags = 'a'",  # an MV column: answered, see below
    ],
)
def test_unported_query_shapes_raise(engines, sql):
    """The shapes the port did not answer in its first slices: an MV column,
    EXPLAIN and TEXT_MATCH, which it answers now, give the reference's
    result (the MV column built by either package's builder; TEXT_MATCH over
    a text index each package builds, and without one the reference's
    PlanError in both)."""
    by_table, _ = engines
    if sql.startswith("EXPLAIN"):
        ref, ports = by_table["lineorder"]
        want = ref.execute(sql)
        for port in ports.values():
            got = port.execute(sql)
            assert got.columns == want.columns and got.rows == want.rows
        return
    if "FROM tagged" in sql:
        from pinot_tpu.common import FieldSpec as JFieldSpec
        from pinot_tpu_torch.common import FieldSpec

        data = {"tags": np.empty(3, dtype=object)}
        data["tags"][:] = [["a", "b"], ["c"], []]
        ref = JBuilder(JSchema("tagged").add(JFieldSpec("tags", JDT.STRING, single_value=False))).build(data, "t0")
        built = SegmentBuilder(Schema("tagged").add(FieldSpec("tags", DataType.STRING, single_value=False))).build(data, "t0")
        want = JEngine([ref]).execute(sql)
        for seg in (built, segment_from_numpy(describe(ref))):
            got = QueryEngine([seg], device="cpu").execute(sql)
            assert got.rows == want.rows == [[1]] and got.num_docs_scanned == want.num_docs_scanned
        return
    from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
    from pinot_tpu.common.config import TableConfig as JTableConfig
    from pinot_tpu.query.plan import PlanError as JPlanError
    from pinot_tpu_torch.common import IndexingConfig, TableConfig
    from pinot_tpu_torch.query.plan import PlanError

    with pytest.raises(JPlanError, match="text index") as want:
        by_table["lineorder"][0].execute(sql)
    with pytest.raises(PlanError, match="text index") as got:
        by_table["lineorder"][1]["built"].execute(sql)
    assert str(got.value) == str(want.value)
    cols, datas = TABLES["lineorder"]
    jcfg = JTableConfig("lineorder", indexing=JIndexingConfig(text_index_columns=["region"]))
    cfg = TableConfig("lineorder", IndexingConfig(text_index_columns=["region"]))
    ref = JEngine([JBuilder(JSchema.build("lineorder", **cols(JDT)), jcfg).build(d, f"s{i}") for i, d in enumerate(datas)])
    port = QueryEngine(
        [SegmentBuilder(Schema.build("lineorder", **cols(DataType)), cfg).build(d, f"s{i}") for i, d in enumerate(datas)],
        device="cpu",
    )
    want, got = ref.execute(sql), port.execute(sql)
    assert got.rows == want.rows and got.num_docs_scanned == want.num_docs_scanned and got.rows[0][0] > 0


def test_filter_empties_a_group_in_one_segment(engines):
    """EMPTY_IN_ONE_SEGMENT's filter leaves some nation of a segment's
    dictionary without a doc, while other segments keep that nation: its
    extreme slots stay at their start key there and must not surface."""
    by_table, _ = engines
    port = by_table["lineorder"][1]["built"]
    ctx = port.make_context(EMPTY_IN_ONE_SEGMENT)
    frames = [port._finish_segment(seg, ctx, port._dispatch_segment(seg, ctx))[0] for seg in port.segments]
    present = [set(f["k0"].tolist()) for f in frames]
    in_dict = [set(seg.columns["nation"].dictionary.values.tolist()) for seg in port.segments]
    assert any(d - p for d, p in zip(in_dict, present))
    assert any((d - p) & set().union(*present) for d, p in zip(in_dict, present))


def test_presence_budget_raises():
    """A grouped DISTINCTCOUNT whose (ng, pad) presence matrix passes 2^24
    cells: planning raises DeviceFallback, and the engine answers the segment
    on the host executor with the reference's rows."""
    from pinot_tpu_torch.query.plan import MAX_PRESENCE_CELLS, DeviceFallback, plan_segment

    rng = np.random.default_rng(11)
    n = 5000
    data = {
        "a": np.array([f"a{i:04d}" for i in rng.permutation(n)], dtype=object),
        "b": np.array([f"b{i % 400:03d}" for i in range(n)], dtype=object),
        "c": np.array([f"c{i:04d}" for i in range(n)], dtype=object),
    }
    dims = [("a", "STRING"), ("b", "STRING"), ("c", "STRING")]
    ref = JEngine([JBuilder(JSchema.build("t", dimensions=[(c, JDT[t]) for c, t in dims])).build(data, "s0")])
    schema = Schema.build("t", dimensions=[(c, DataType[t]) for c, t in dims])
    engine = QueryEngine([SegmentBuilder(schema).build(data, "s0")], device="cpu")
    # GROUP BY a: ng = 5120 (5000 keys rounded to 256) * pad 8192 (5000 ids)
    assert 5120 * 8192 > MAX_PRESENCE_CELLS
    sql = "SELECT a, DISTINCTCOUNT(c) FROM t GROUP BY a ORDER BY a DESC LIMIT 5"
    with pytest.raises(DeviceFallback, match="presence matrix"):
        plan_segment(engine.segments[0], engine.make_context(sql))
    got, want = engine.execute(sql), ref.execute(sql)
    assert got.rows == want.rows and [type(x) for x in got.rows[0]] == [type(x) for x in want.rows[0]]
    # under the budget the same shape runs on the device
    engine.segment_modes.clear()
    assert engine.execute("SELECT b, DISTINCTCOUNT(c) FROM t GROUP BY b ORDER BY b LIMIT 2").rows == [
        ["b000", 13],
        ["b001", 13],
    ]
    assert engine.segment_modes == {"device": 1}


def test_engine_defaults_to_the_card(engines):
    by_table, _ = engines
    segs = by_table["lineorder"][1]["built"].segments
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        QueryEngine(segs)


def test_submits_resolve_in_any_order(engines):
    """Several queries submitted before any resolves: each resolve makes its
    own copies and gives the reference's rows."""
    by_table, _ = engines
    ref, ports = by_table["ssb"]
    q1 = "SELECT COUNT(*) FROM lineorder WHERE c_nation = 'NATION_07'"
    q2 = "SELECT d_year, COUNT(*) FROM lineorder GROUP BY d_year ORDER BY d_year"
    resolve_1 = ports["built"].submit(q1)
    resolve_2 = ports["built"].submit(q2)
    assert resolve_2().rows == ref.execute(q2).rows
    assert resolve_1().rows == ref.execute(q1).rows


def test_import_leaves_no_jax_pandas_or_reference():
    """A fresh interpreter imports the port and runs CPU queries (the
    per-segment engine, the store, the sharded table, the multistage engine
    over two slots, a cluster over HTTP with its controller's REST service,
    distributed multistage stages over /mailbox, the client, the admin CLI,
    a realtime upsert table consumed from a stream);
    afterwards no module of jax, pandas or the JAX package is loaded."""
    code = (
        "import sys, numpy as np\n"
        "from pinot_tpu_torch.common import DataType, Schema\n"
        "from pinot_tpu_torch.segment import SegmentBuilder\n"
        "from pinot_tpu_torch.query import QueryEngine\n"
        "s = Schema.build('t', dimensions=[('g', DataType.STRING)], metrics=[('v', DataType.INT)])\n"
        "seg = SegmentBuilder(s).build({'g': np.array(['a', 'b', 'a'], dtype=object),"
        " 'v': np.array([1, 2, 3], dtype=np.int32)}, 's0')\n"
        "res = QueryEngine([seg], device='cpu').execute('SELECT g, SUM(v) FROM t GROUP BY g ORDER BY g')\n"
        "assert res.rows == [['a', 4.0], ['b', 2.0]], res.rows\n"
        "import tempfile, pinot_tpu_torch.native, pinot_tpu_torch.parallel\n"
        "from pinot_tpu_torch.parallel.mesh import execute_sharded_result\n"
        "from pinot_tpu_torch.segment import load_segment, write_segment\n"
        "seg = load_segment(write_segment(seg, tempfile.mkdtemp()))\n"
        "t = pinot_tpu_torch.parallel.build_sharded_table(s, {'g': np.array(['a', 'b', 'a'], dtype=object),"
        " 'v': np.array([1, 2, 3], dtype=np.int32)}, pinot_tpu_torch.parallel.make_mesh('cpu'))\n"
        "assert execute_sharded_result(t, 'SELECT g, SUM(v) FROM t GROUP BY g ORDER BY g').rows == res.rows\n"
        "from pinot_tpu_torch.multistage import MultistageEngine\n"
        "m = MultistageEngine({'t': [seg]}, device='cpu', mesh=pinot_tpu_torch.parallel.make_mesh(('cpu',) * 2))\n"
        "rows = m.execute('SELECT a.g, COUNT(*) FROM t a JOIN t b ON a.g = b.g GROUP BY a.g ORDER BY a.g').rows\n"
        "assert rows == [['a', 4], ['b', 1]], rows\n"
        "from pinot_tpu_torch.cluster import Broker, Controller, PropertyStore, Server\n"
        "from pinot_tpu_torch.cluster.http import BrokerHTTPService, RemoteServerClient, ServerHTTPService, query_broker_http\n"
        "from pinot_tpu_torch.common import TableConfig\n"
        "c = Controller(PropertyStore(), tempfile.mkdtemp())\n"
        "srv = Server('s0', device='cpu'); svc = ServerHTTPService(srv)\n"
        "c.register_server('s0', RemoteServerClient(f'http://127.0.0.1:{svc.port}'))\n"
        "c.add_schema(s); c.add_table(TableConfig('t')); c.upload_segment('t', seg)\n"
        "b = Broker(c, device='cpu'); bsvc = BrokerHTTPService(b)\n"
        "got = query_broker_http(f'http://127.0.0.1:{bsvc.port}', 'SELECT g, SUM(v) FROM t GROUP BY g ORDER BY g')\n"
        "assert got['resultTable']['rows'] == res.rows, got\n"
        "from pinot_tpu_torch.cluster.http import ControllerHTTPService, RemoteControllerClient\n"
        "from pinot_tpu_torch.client import connect\n"
        "import pinot_tpu_torch.tools.admin, pinot_tpu_torch.multistage.distributed\n"
        "csvc = ControllerHTTPService(c); c.register_broker('b0', '127.0.0.1', bsvc.port)\n"
        "conn = connect(controller_url=f'http://127.0.0.1:{csvc.port}')\n"
        "rows = conn.execute('SELECT a.g, COUNT(*) FROM t a JOIN t b ON a.g = b.g GROUP BY a.g ORDER BY a.g').rows\n"
        "assert rows == [['a', 4], ['b', 1]] and b._dispatcher is not None, rows\n"
        "assert RemoteControllerClient(f'http://127.0.0.1:{csvc.port}').tables() == ['t']\n"
        "csvc.stop(); bsvc.stop(); svc.stop(); b.shutdown()\n"
        "import pinot_tpu_torch.realtime.kafka, pinot_tpu_torch.realtime.pulsar, pinot_tpu_torch.realtime.kinesis\n"
        "import pinot_tpu_torch.realtime.plugins, pinot_tpu_torch.upsert\n"
        "from pinot_tpu_torch.common import TableType, UpsertConfig\n"
        "from pinot_tpu_torch.realtime import InMemoryStream, RealtimeTableManager\n"
        "us = Schema.build('u', dimensions=[('g', DataType.STRING)], metrics=[('v', DataType.INT)],"
        " date_times=[('ts', DataType.LONG)], primary_key_columns=['g'])\n"
        "uc = TableConfig('u', table_type=TableType.REALTIME, time_column='ts', upsert=UpsertConfig())\n"
        "c2 = Controller(PropertyStore(), tempfile.mkdtemp()); s2 = Server('s1', device='cpu')\n"
        "c2.register_server('s1', s2); c2.add_schema(us); c2.add_table(uc); st = InMemoryStream(1)\n"
        "[st.produce(0, {'g': 'ab'[i % 2], 'v': i, 'ts': i}) for i in range(9)]\n"
        "mgr = RealtimeTableManager(c2, s2, us, uc, st, max_rows_per_segment=4); mgr.start()\n"
        "assert mgr.wait_until_caught_up([9])\n"
        "rows = Broker(c2, device='cpu').execute('SELECT g, SUM(v) FROM u GROUP BY g ORDER BY g').rows; mgr.stop()\n"
        "assert rows == [['a', 8.0], ['b', 7.0]], rows\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pandas', 'pinot_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


FORBIDDEN = {"jax", "jaxlib", "pandas", "pinot_tpu"}
#: the one import of a forbidden package the port may make, lazily, inside
#: the named function: the client's ResultSet.to_pandas, as the reference's
LAZY_IMPORTS = {("pinot_tpu_torch/client.py", "to_pandas", "pandas")}


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(REPO)) for p in (REPO / "pinot_tpu_torch").rglob("*.py")) + ["chip_smoke.py"],
)
def test_source_imports_nothing_forbidden(path):
    """Every import in the port (its sharded executor and its native codecs
    included) and its card check names a module whose top-level package is
    not jax, pandas or the JAX package — matched on the whole first
    component, so pinot_tpu_torch itself passes."""
    import ast

    tree = ast.parse((REPO / path).read_text())
    lazy = set()
    for fn in ast.walk(tree):
        if isinstance(fn, ast.FunctionDef):
            for node in ast.walk(fn):
                if isinstance(node, ast.Import) and all((path, fn.name, a.name) in LAZY_IMPORTS for a in node.names):
                    lazy.add(id(node))
    for node in ast.walk(tree):
        if id(node) in lazy:
            continue
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}:{node.lineno} imports {name}"


def test_scan_covers_the_tools_and_the_client():
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "pinot_tpu_torch").rglob("*.py")}
    assert {"pinot_tpu_torch/client.py", "pinot_tpu_torch/tools/admin.py"} <= scanned


def test_scan_covers_the_realtime_and_upsert_modules():
    """The source scan above reaches every module of the realtime slice:
    the stream plugins, the consuming segment, the completion protocol and
    the upsert / dedup managers."""
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "pinot_tpu_torch").rglob("*.py")}
    want = {f"pinot_tpu_torch/realtime/{m}.py" for m in
            ("__init__", "stream", "mutable", "completion", "manager", "plugins", "kafka", "pulsar", "kinesis")}
    want |= {f"pinot_tpu_torch/upsert/{m}.py" for m in ("__init__", "metadata", "partial")}
    assert want <= scanned


def test_no_stop_names_a9b():
    """Every A9b stop of the port is ported: no string in the package names
    that ROADMAP item any more."""
    hits = [
        f"{p.relative_to(REPO)}:{i}"
        for p in sorted((REPO / "pinot_tpu_torch").rglob("*.py"))
        for i, line in enumerate(p.read_text().splitlines(), 1)
        if "A9b" in line
    ]
    assert hits == []


def test_no_stop_names_a10a():
    """Every A10a and A10c stop of the port is ported (realtime ingestion,
    upsert and dedup; the control plane: HA, the periodic tasks, rebalance,
    the SLO evaluator and the UI): no string in the package names those
    ROADMAP items, and each remaining stop names its own part (A10b or
    A10d)."""
    hits, bare = [], []
    for p in sorted((REPO / "pinot_tpu_torch").rglob("*.py")):
        for i, line in enumerate(p.read_text().splitlines(), 1):
            if "A10a" in line or "A10c" in line:
                hits.append(f"{p.relative_to(REPO)}:{i}")
            if re.search(r"A10(?![abd])", line):
                bare.append(f"{p.relative_to(REPO)}:{i}")
    assert hits == [] and bare == []


def test_scan_covers_the_control_plane_modules():
    """The source scan above reaches every module of the control plane: HA,
    rebalance, the periodic tasks, the UI, the SLO evaluator and the
    compatibility verifier."""
    scanned = {str(p.relative_to(REPO)) for p in (REPO / "pinot_tpu_torch").rglob("*.py")}
    want = {f"pinot_tpu_torch/cluster/{m}.py" for m in ("ha", "rebalance", "periodic", "ui")}
    want |= {"pinot_tpu_torch/common/slo.py", "pinot_tpu_torch/tools/compat_verifier.py"}
    assert want <= scanned
