"""The port's one-device sharded table and executor against the JAX package's.

Every case of tests/test_sharded.py runs on the same seeded numpy columns
through the reference's `execute_sharded_result` and the port's. The
reference runs twice: on a one-device mesh (`make_mesh(jax.devices()[:1])`,
the port's layout: same number of segments, same padded length) and on the
conftest's 8-device mesh. The port runs on the CPU (`make_mesh("cpu")`).

Tolerance: rows equal cell for cell (COUNT, integer SUM, MIN / MAX, keys,
HLL estimates), in the same order wherever ORDER BY defines one; a column
listed as approximate (AVG, a float sum, a PERCENTILEEST) at rtol 1e-12. The
layout (segments, padded length, the stacked arrays, the proto's dtypes after
narrowing) equals the one-device reference's, and HLL registers equal the
reference's bit for bit.
"""

import collections
import math

import jax
import numpy as np
import pytest
import torch

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import FieldSpec as JFS
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.parallel import build_sharded_table as jbuild
from pinot_tpu.parallel import make_mesh as jmesh
from pinot_tpu.parallel.mesh import _sharded_kernel as j_sharded_kernel
from pinot_tpu.parallel.mesh import execute_sharded as j_execute
from pinot_tpu.parallel.mesh import execute_sharded_result as jresult
from pinot_tpu.query import plan as jplan
from pinot_tpu.query.sketches import np_hll_registers as j_np_hll_registers
from pinot_tpu_torch.common import DataType, FieldSpec, Schema
from pinot_tpu_torch.common.kernel_obs import KERNELS
from pinot_tpu_torch.parallel import build_sharded_table, execute_sharded, make_mesh
from pinot_tpu_torch.parallel import mesh as mesh_mod
from pinot_tpu_torch.parallel.mesh import ShardedTable, _combine_tree, _flatten_local, execute_sharded_result
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.segment import SegmentBuilder

RTOL = 1e-12
MESHES = ("1dev", "8dev")


def _copy(data):
    return {k: v.copy() for k, v in data.items()}


def _tables(jschema, schema, data, **kw):
    """{"1dev": ref table, "8dev": ref table, "port": port table}."""
    return {
        "1dev": jbuild(jschema, _copy(data), jmesh(jax.devices()[:1]), **kw),
        "8dev": jbuild(jschema, _copy(data), jmesh(), **kw),
        "port": build_sharded_table(schema, _copy(data), make_mesh("cpu"), **kw),
    }


def _lineorder_schema(DT, S):
    return S.build(
        "lineorder",
        dimensions=[("region", DT.STRING), ("year", DT.INT)],
        metrics=[("quantity", DT.INT), ("revenue", DT.LONG)],
    )


def _mv_schema(DT, S, FS):
    schema = S.build("mvt", dimensions=[("g", DT.STRING)], metrics=[("v", DT.LONG)])
    schema.add(FS("tags", DT.INT, single_value=False))
    return schema


def _lineorder_data():
    rng = np.random.default_rng(7)
    n = 50_000
    return {
        "region": np.array(["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"], dtype=object)[
            rng.integers(0, 5, n)
        ],
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "quantity": rng.integers(1, 51, n).astype(np.int32),
        "revenue": rng.integers(100, 600_000, n).astype(np.int64),
    }


def _mv_data():
    rng = np.random.default_rng(13)
    n = 20_000
    tags = [rng.integers(0, 40, rng.integers(0, 5)).tolist() for _ in range(n)]
    data = {
        "g": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
        "v": rng.integers(1, 100, n).astype(np.int64),
        "tags": np.empty(n, dtype=object),
    }
    data["tags"][:] = tags
    return data, tags


def _highcard_data():
    rng = np.random.default_rng(23)
    n = 60_000
    users = np.array([f"u{i:06d}" for i in range(300_000)], dtype=object)
    return {
        "user": users[rng.integers(0, 300_000, n)],
        "year": rng.integers(1972, 2022, n).astype(np.int32),
        "v": rng.integers(1, 1000, n).astype(np.int64),
    }


def _highcard_schema(DT, S):
    return S.build("events", dimensions=[("user", DT.STRING), ("year", DT.INT)], metrics=[("v", DT.LONG)])


@pytest.fixture(scope="module")
def lineorder():
    data = _lineorder_data()
    return _tables(_lineorder_schema(JDT, JSchema), _lineorder_schema(DataType, Schema), data), data


@pytest.fixture(scope="module")
def mvt():
    data, tags = _mv_data()
    return _tables(_mv_schema(JDT, JSchema, JFS), _mv_schema(DataType, Schema, FieldSpec), data), (data, tags)


@pytest.fixture(scope="module")
def mvt_small_segments(mvt):
    """The MV table in segments of 700 rows: several a device."""
    _, (data, tags) = mvt
    tables = _tables(
        _mv_schema(JDT, JSchema, JFS), _mv_schema(DataType, Schema, FieldSpec), data, rows_per_segment=700
    )
    assert tables["port"].n_segments > 8
    return tables, (data, tags)


@pytest.fixture(scope="module")
def highcard():
    data = _highcard_data()
    card_product = len(np.unique(data["user"])) * len(np.unique(data["year"]))
    assert card_product > plan_mod.MAX_DENSE_GROUPS == jplan.MAX_DENSE_GROUPS
    return _tables(_highcard_schema(JDT, JSchema), _highcard_schema(DataType, Schema), data), data


def _assert_rows(got, want, approx=()):
    assert len(got) == len(want), (got, want)
    for r, (g, w) in enumerate(zip(got, want)):
        assert len(g) == len(w), (g, w)
        for c, (a, b) in enumerate(zip(g, w)):
            assert type(a) is type(b), (r, c, a, b)
            if c in approx:
                assert math.isclose(a, b, rel_tol=RTOL), (r, c, a, b)
            else:
                assert a == b, (r, c, a, b)


def _check(tables, sql, mesh, approx=()):
    want = jresult(tables[mesh], sql)
    got = execute_sharded_result(tables["port"], sql)
    assert got.columns == want.columns
    _assert_rows(got.rows, want.rows, approx)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.total_docs == want.total_docs
    return got


# -- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("fixture", ["lineorder", "mvt", "mvt_small_segments", "highcard"])
def test_sharding_layout(fixture, request):
    """Segments, padded length, the stacked arrays and the proto's forward
    dtypes (after the int64 -> int32 narrowing) equal the one-device
    reference's; the 8-device reference pads its segment count to a
    multiple of 8."""
    tables = request.getfixturevalue(fixture)[0]
    ref, port, ref8 = tables["1dev"], tables["port"], tables["8dev"]
    assert isinstance(port, ShardedTable)
    assert (port.n_segments, port.padded, port.total_docs) == (ref.n_segments, ref.padded, ref.total_docs)
    assert ref8.n_segments % 8 == 0 and ref8.total_docs == port.total_docs
    assert set(port.arrays) == set(ref.arrays)
    for c, t in port.arrays.items():
        want = np.asarray(ref.arrays[c])
        assert t.dtype == torch.from_numpy(np.empty(0, want.dtype)).dtype, c
        np.testing.assert_array_equal(t.numpy(), want, err_msg=c)
    for c, ci in port.proto.columns.items():
        assert ci.forward.dtype == ref.proto.columns[c].forward.dtype, c
    np.testing.assert_array_equal(port.n_docs.numpy(), np.asarray(ref.n_docs))
    assert port.n_docs.dtype == torch.int32


# -- the cases of tests/test_sharded.py -----------------------------------------

LINEORDER_CASES = [
    ("SELECT COUNT(*) FROM lineorder WHERE region = 'ASIA'", ()),
    (
        "SELECT SUM(revenue), MIN(quantity), MAX(revenue), AVG(quantity) FROM lineorder "
        "WHERE year >= 1994 AND quantity > 10",
        (3,),
    ),
    (
        "SELECT year, region, SUM(revenue) FROM lineorder GROUP BY year, region "
        "ORDER BY SUM(revenue) DESC LIMIT 6",
        (),
    ),
    ("SELECT DISTINCTCOUNT(region) FROM lineorder WHERE year = 1995", ()),
    ("SELECT region, SUM(revenue), COUNT(*) FROM lineorder GROUP BY region ORDER BY region LIMIT 10", ()),
    ("SELECT MINMAXRANGE(revenue) FROM lineorder WHERE quantity < 20", ()),
    (
        "SELECT year, MIN(revenue), MAX(revenue), COUNT(*) FROM lineorder GROUP BY year ORDER BY year LIMIT 10",
        (),
    ),
    ("SELECT DISTINCTCOUNTHLL(revenue) FROM lineorder", ()),
    ("SELECT PERCENTILEEST(revenue, 90) FROM lineorder", (0,)),
    (
        "SELECT region, DISTINCTCOUNTHLL(revenue) FROM lineorder GROUP BY region ORDER BY region LIMIT 10",
        (),
    ),
    (
        "SELECT SUM(revenue) FILTER (WHERE region = 'ASIA'), "
        "COUNT(*) FILTER (WHERE quantity > 25) FROM lineorder",
        (),
    ),
    (
        "SELECT year, AVG(revenue), SUM(quantity) FILTER (WHERE region = 'EUROPE'), PERCENTILEEST(quantity, 50) "
        "FROM lineorder WHERE quantity BETWEEN 3 AND 40 GROUP BY year ORDER BY year",
        (1, 3),
    ),
]

MV_CASES = [
    ("SELECT COUNTMV(tags), SUMMV(tags), MINMV(tags), MAXMV(tags) FROM mvt", ()),
    ("SELECT DISTINCTCOUNTMV(tags) FROM mvt", ()),
    ("SELECT COUNT(*) FROM mvt WHERE tags = 7", ()),
    ("SELECT SUM(v) FROM mvt WHERE tags = 7", ()),
    ("SELECT g, COUNTMV(tags) FROM mvt GROUP BY g ORDER BY g LIMIT 10", ()),
    ("SELECT tags, COUNT(*), SUM(v) FROM mvt GROUP BY tags ORDER BY tags LIMIT 50", ()),
    ("SELECT g, AVGMV(tags), MAXMV(tags) FROM mvt WHERE v > 20 GROUP BY g ORDER BY g", (1,)),
]

MV_SMALL_SEGMENT_CASES = [
    ("SELECT COUNTMV(tags), SUMMV(tags) FROM mvt", ()),
    ("SELECT COUNT(*) FROM mvt WHERE tags = 7", ()),
    ("SELECT tags, COUNT(*) FROM mvt GROUP BY tags ORDER BY tags LIMIT 50", ()),
]

# (sql, approximate columns, the planned group spec: a (user, year) product
# past MAX_DENSE_GROUPS goes sparse, ~50k users alone stay dense)
HIGHCARD_CASES = [
    (
        "SELECT user, year, SUM(v), COUNT(*) FROM events "
        "GROUP BY user, year ORDER BY SUM(v) DESC LIMIT 10",
        (),
        "groups_sparse",
    ),
    (
        "SELECT user, MIN(v), MAX(v) FROM events WHERE year >= 1995 GROUP BY user ORDER BY user LIMIT 7",
        (),
        "groups",
    ),
    (
        "SELECT user, year, MIN(v), AVG(v) FROM events WHERE year >= 1995 "
        "GROUP BY user, year ORDER BY user, year LIMIT 7",
        (3,),
        "groups_sparse",
    ),
]


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("sql,approx", LINEORDER_CASES)
def test_lineorder_queries(lineorder, sql, approx, mesh):
    _check(lineorder[0], sql, mesh, approx)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("sql,approx", MV_CASES)
def test_mv_queries(mvt, sql, approx, mesh):
    _check(mvt[0], sql, mesh, approx)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("sql,approx", MV_SMALL_SEGMENT_CASES)
def test_mv_queries_several_segments_per_device(mvt_small_segments, sql, approx, mesh):
    _check(mvt_small_segments[0], sql, mesh, approx)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("sql,approx,gkind", HIGHCARD_CASES)
def test_sparse_group_by(highcard, sql, approx, gkind, mesh):
    tables = highcard[0]
    assert plan_mod.plan_segment(tables["port"].proto, _ctx(sql)).spec[2][0] == gkind
    _check(tables, sql, mesh, approx)


def _ctx(sql):
    from pinot_tpu_torch.query.context import QueryContext

    return QueryContext.from_sql(sql)


def test_rows_against_numpy(lineorder, mvt):
    """The oracles of tests/test_sharded.py, on the port alone."""
    tables, data = lineorder
    t = tables["port"]
    res = execute_sharded_result(t, "SELECT COUNT(*) FROM lineorder WHERE region = 'ASIA'")
    assert res.rows == [[int((data["region"] == "ASIA").sum())]]
    m = (data["year"] >= 1994) & (data["quantity"] > 10)
    r = execute_sharded_result(
        t,
        "SELECT SUM(revenue), MIN(quantity), MAX(revenue), AVG(quantity) FROM lineorder "
        "WHERE year >= 1994 AND quantity > 10",
    ).rows[0]
    assert r[:3] == [float(data["revenue"][m].sum()), float(data["quantity"][m].min()), float(data["revenue"][m].max())]
    assert math.isclose(r[3], data["quantity"][m].mean(), rel_tol=RTOL)
    mtables, (mdata, tags) = mvt
    cnt = collections.Counter(int(x) for ts in tags for x in ts)
    res = execute_sharded_result(mtables["port"], "SELECT tags, COUNT(*) FROM mvt GROUP BY tags ORDER BY tags LIMIT 50")
    assert [(r[0], r[1]) for r in res.rows] == [(k, cnt[k]) for k in sorted(cnt)]


def test_matches_per_segment_engine(lineorder):
    """The sharded path's rows equal the per-segment engine's over 3 uneven
    segments of the same rows, and the reference's."""
    tables, data = lineorder
    n = len(data["year"])
    cuts = [0, n // 3, 2 * n // 3, n]
    b = SegmentBuilder(_lineorder_schema(DataType, Schema))
    segs = [b.build({c: v[cuts[i] : cuts[i + 1]] for c, v in data.items()}, f"s{i}") for i in range(3)]
    q = "SELECT region, SUM(revenue), COUNT(*) FROM lineorder GROUP BY region ORDER BY region LIMIT 10"
    got = execute_sharded_result(tables["port"], q)
    assert got.rows == QueryEngine(segs, device="cpu").execute(q).rows == jresult(tables["1dev"], q).rows


@pytest.mark.parametrize("mesh", MESHES)
def test_narrowed_i64_literal_out_of_i32_range(mesh):
    """A LONG column narrowed to int32 narrows the proto too, so a literal
    outside int32 is decided at plan time instead of wrapping."""
    n = 64
    data = {"k": np.array(["a", "b"] * (n // 2), dtype=object), "x": np.arange(n, dtype=np.int64) * 1_000_000}
    jschema = JSchema.build("t", dimensions=[("k", JDT.STRING)], metrics=[("x", JDT.LONG)])
    schema = Schema.build("t", dimensions=[("k", DataType.STRING)], metrics=[("x", DataType.LONG)])
    ref = jbuild(jschema, _copy(data), jmesh(jax.devices()[:1] if mesh == "1dev" else jax.devices()[:2]))
    port = build_sharded_table(schema, _copy(data), make_mesh("cpu"))
    assert port.proto.columns["x"].forward.dtype == np.int32
    for sql, want in (
        ("SELECT COUNT(*) FROM t WHERE x < 5000000000", n),
        ("SELECT COUNT(*) FROM t WHERE x > 5000000000", 0),
        ("SELECT COUNT(*) FROM t WHERE x >= -5000000000", n),
    ):
        assert execute_sharded_result(port, sql).rows == jresult(ref, sql).rows == [[want]]


@pytest.mark.parametrize("mesh", MESHES)
def test_mv2_falls_back_to_proto(mesh, monkeypatch):
    """A two-MV-key cartesian GROUP BY reruns on the proto in both packages."""
    rng = np.random.default_rng(5)
    n = 2_000
    a = [rng.integers(0, 5, rng.integers(1, 4)).tolist() for _ in range(n)]
    b = [rng.integers(0, 5, rng.integers(1, 4)).tolist() for _ in range(n)]
    data = {"v": rng.integers(1, 100, n).astype(np.int64), "a": np.empty(n, dtype=object), "b": np.empty(n, dtype=object)}
    data["a"][:], data["b"][:] = a, b

    def schema(DT, S, FS):
        s = S.build("mv2t", dimensions=[], metrics=[("v", DT.LONG)])
        s.add(FS("a", DT.INT, single_value=False))
        s.add(FS("b", DT.INT, single_value=False))
        return s

    ref = jbuild(schema(JDT, JSchema, JFS), _copy(data), jmesh(jax.devices()[:1]) if mesh == "1dev" else jmesh())
    port = build_sharded_table(schema(DataType, Schema, FieldSpec), _copy(data), make_mesh("cpu"))
    fired = []
    monkeypatch.setattr(mesh_mod, "_run_on_proto", lambda t, s, f=mesh_mod._run_on_proto: fired.append(s) or f(t, s))
    sql = "SELECT a, b, COUNT(*) FROM mv2t GROUP BY a, b ORDER BY COUNT(*) DESC LIMIT 5"
    got, want = execute_sharded_result(port, sql), jresult(ref, sql)
    assert fired == [sql]
    _assert_rows(got.rows, want.rows)
    cnt = collections.Counter((int(x), int(y)) for av, bv in zip(a, b) for x in av for y in bv)
    assert [r[2] for r in got.rows] == [c for _, c in cnt.most_common(5)]
    with pytest.raises(mesh_mod.ProtoFallback):
        execute_sharded(port, sql)


@pytest.mark.parametrize("mesh", MESHES)
def test_sparse_overflow_reruns_on_the_proto(highcard, mesh, monkeypatch):
    """A sparse group-by with more present groups than its U slots (U cut to
    1024 by MAX_DENSE_GROUPS in both planners): both packages see
    n_unique > U and rerun the query on the proto."""
    tables = highcard[0]
    monkeypatch.setattr(plan_mod, "MAX_DENSE_GROUPS", 1024)
    monkeypatch.setattr(jplan, "MAX_DENSE_GROUPS", 1024)
    sql = "SELECT user, year, SUM(v), COUNT(*) FROM events GROUP BY user, year ORDER BY SUM(v) DESC, user LIMIT 10"
    plan = plan_mod.plan_segment(tables["port"].proto, _ctx(sql))
    assert plan.spec[2][0] == "groups_sparse" and plan.spec[2][2] == 1024
    ctx, plan, vec, rebuild = execute_sharded(tables["port"], sql)
    n_unique = rebuild(vec.numpy())[4]
    assert int(np.max(n_unique)) > 1024
    fired = []
    monkeypatch.setattr(mesh_mod, "_run_on_proto", lambda t, s, f=mesh_mod._run_on_proto: fired.append(s) or f(t, s))
    _check(tables, sql, mesh)
    assert fired == [sql]


def test_hll_registers_bit_for_bit(lineorder):
    """The packed vector's HLL registers (scalar and by region) equal the
    reference's own host registers (`np_hll_registers`) bit for bit; the
    reference's device registers equal them except where XLA's CPU log2
    rounds below an exact power of two, where the reference's register is
    one more (a reference fault, ROADMAP Queue C)."""
    tables, data = lineorder
    regions = sorted(set(data["region"]))
    for sql, groups in (
        ("SELECT DISTINCTCOUNTHLL(revenue) FROM lineorder", [np.ones(len(data["region"]), bool)]),
        (
            "SELECT region, DISTINCTCOUNTHLL(revenue) FROM lineorder GROUP BY region",
            [data["region"] == r for r in regions],
        ),
    ):
        _, jplan_, jout = j_execute(tables["1dev"], sql)
        dev = np.asarray(j_sharded_kernel(jplan_.spec, tables["1dev"].mesh, "seg", tables["1dev"].padded)[1](
            np.asarray(jout)
        )[-1][0])
        _, _, vec, rebuild = execute_sharded(tables["port"], sql)
        got = np.asarray(rebuild(vec.numpy())[-1][0])
        host = np.stack([j_np_hll_registers(data["revenue"][m]) for m in groups])
        # group ids follow the proto's dictionary order (sorted regions); the
        # padded groups past them hold no register
        got, dev = got.reshape(-1, host.shape[1]), dev.reshape(-1, host.shape[1])
        assert not got[len(groups) :].any() and not dev[len(groups) :].any()
        got, dev = got[: len(groups)], dev[: len(groups)]
        np.testing.assert_array_equal(got, host)
        off = dev != host
        np.testing.assert_array_equal(dev[off], host[off] + 1)


def test_packed_int64_round_trip_past_2_53():
    """The packed vector splits int64 leaves into hi / lo halves, so values
    past 2^53 (a sparse slot table's dense gids, its 2^62 sentinel) come back
    exactly; a float64 cast would round them."""
    vals = torch.tensor([(1 << 62), (1 << 53) + 1, -(1 << 60) - 3, 0, -1, 123456789012345678], dtype=torch.int64)
    leaves = [torch.tensor(7, dtype=torch.int64), vals, torch.tensor([1.5, -2.25], dtype=torch.float64)]
    vec = K.pack(leaves)
    assert vec.dtype == torch.float64
    out = K.unpack(vec.numpy(), K.leaf_meta(leaves))
    assert out[0] == 7 and out[0].dtype == np.int64
    np.testing.assert_array_equal(out[1], vals.numpy())
    np.testing.assert_array_equal(out[2], [1.5, -2.25])
    assert float(np.float64((1 << 53) + 1)) != (1 << 53) + 1


def test_flatten_local_shifts_mv_docids_and_masks_padding():
    cols = {
        "x": torch.arange(8, dtype=torch.int32).reshape(2, 4),
        "m!docs": torch.tensor([[0, 3, 3], [1, 3, 3]], dtype=torch.int32),
    }
    flat, valid = _flatten_local(cols, torch.tensor([2, 3], dtype=torch.int32), 4)
    assert flat["x"].tolist() == list(range(8))
    assert flat["m!docs"].tolist() == [0, 3, 3, 5, 7, 7]
    assert valid.tolist() == [True, True, False, False, True, True, True, False]


def test_combine_tree_on_one_rank_is_the_identity():
    """On one rank each merge rule returns its partial (a null-handling SUM
    keeps NaN); a process group is ROADMAP A7b."""
    spec = ("agg", ("const", True), None, (("count",), ("masked_nan_empty", ("const", True), ("sum", None)), ("min", None), ("distinct_ids", "c", 4)))
    matched = torch.tensor(5)
    parts = (torch.tensor(5), torch.tensor(float("nan")), torch.tensor(2.0), torch.tensor([True, False, True, False]))
    m, c, p = _combine_tree(spec, matched, None, parts)
    assert m is matched and c is None
    assert p[0] is parts[0] and torch.isnan(p[1]) and p[2] is parts[2] and p[3].tolist() == parts[3].tolist()
    with pytest.raises(NotImplementedError, match="A7b"):
        _combine_tree(spec, matched, None, parts, group=object())


@pytest.mark.parametrize(
    "sql",
    ["SELECT COUNT(*), SUM(revenue) FROM lineorder", "SELECT region, SUM(revenue) FROM lineorder GROUP BY region"],
)
def test_sharded_program_merges_only_across_ranks(lineorder, sql):
    """On one rank the flat program's partials are the table's and no merge
    runs; a program given a process group reaches the merge, ROADMAP A7b."""
    from pinot_tpu_torch.parallel import mesh as mesh_mod

    table = lineorder[0]["port"]
    _, plan, program = mesh_mod._prepare(table, sql)
    cols = {c: table.arrays[c] for c in plan.columns}
    ops = K.stage_operands(list(plan.operands), table.mesh.device)
    vec, _ = program()
    one_rank, _ = mesh_mod._sharded_kernel(plan.spec, table.padded)(cols, ops, table.n_docs)
    assert torch.equal(vec, one_rank)
    with pytest.raises(NotImplementedError, match="A7b"):
        mesh_mod._sharded_kernel(plan.spec, table.padded, group=object())(cols, ops, table.n_docs)


def test_make_mesh_devices():
    mesh = make_mesh("cpu")
    assert mesh.device == torch.device("cpu")
    assert make_mesh([torch.device("cpu")]).device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="A7b"):
        make_mesh(["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()


def test_exchange_is_registered_and_recorded(lineorder):
    """Each sharded query records one "exchange.sharded" call in the kernel
    registry, priced by the reference's cost model at one segment's padded
    rows."""
    tables = lineorder[0]
    assert KERNELS.is_registered("exchange.sharded")
    KERNELS.reset_stats()
    execute_sharded_result(tables["port"], "SELECT COUNT(*) FROM lineorder WHERE region = 'ASIA'")
    execute_sharded_result(tables["port"], "SELECT region, SUM(revenue) FROM lineorder GROUP BY region")
    stats = {k: v for k, v in KERNELS.stats_snapshot().items() if k[0] == "exchange.sharded"}
    assert sum(s["calls"] for s in stats.values()) == 2
    rows = tables["port"].padded
    assert sum(s["bytesMoved"] for s in stats.values()) == rows * (1 * 8 + 1) + rows * (2 * 8 + 1)
    KERNELS.reset_stats()


def test_masked_fn_refuses_two_mv_keys():
    with pytest.raises(AssertionError):
        K.build_masked_fn(("agg", ("const", True), ("groups_mv2",), ()))
    with pytest.raises(AssertionError):
        K.build_masked_fn(("select", ("const", True), (), 10))
