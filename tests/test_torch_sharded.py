"""The port's sharded table and executor over a mesh of slots against the JAX
package's over a mesh of devices.

Every case of tests/test_sharded.py runs on the same seeded numpy columns
through the reference's `execute_sharded_result` and the port's, at D = 1,
2, 4 and 8: the reference over the first D of the conftest's 8 virtual CPU
devices, the port over `make_mesh(("cpu",) * D)` (the same segments, padded
length and slot shares). So do the ten query shapes of
`__graft_entry__.dryrun_multichip` at D = 2 and 4, against numpy truths.

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
MESHES = ("1dev", "2dev", "4dev", "8dev")
SLOTS = {"1dev": 1, "2dev": 2, "4dev": 4, "8dev": 8}


def _copy(data):
    return {k: v.copy() for k, v in data.items()}


def _tables(jschema, schema, data, **kw):
    """{"<D>dev": the reference's table over D devices, "port<D>": the
    port's over D CPU slots} for D in 1, 2, 4, 8; "port" is "port1"."""
    out = {}
    for name, d in SLOTS.items():
        out[name] = jbuild(jschema, _copy(data), jmesh(jax.devices()[:d]), **kw)
        out[f"port{d}"] = build_sharded_table(schema, _copy(data), make_mesh(("cpu",) * d), **kw)
    out["port"] = out["port1"]
    return out


def _host(vecs) -> list:
    return [v.cpu().numpy() for v in vecs]


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
    got = execute_sharded_result(tables[f"port{SLOTS[mesh]}"], sql)
    assert got.columns == want.columns
    _assert_rows(got.rows, want.rows, approx)
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.total_docs == want.total_docs
    return got


# -- the layout -----------------------------------------------------------------


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("fixture", ["lineorder", "mvt", "mvt_small_segments", "highcard"])
def test_sharding_layout(fixture, mesh, request):
    """Segments (rounded up to a multiple of the slots), padded length, the
    stacked arrays and the proto's forward dtypes (after the int64 -> int32
    narrowing) equal the reference's over as many devices; slot d holds
    segments [d S/D, (d + 1) S/D) on its device."""
    tables = request.getfixturevalue(fixture)[0]
    d = SLOTS[mesh]
    ref, port = tables[mesh], tables[f"port{d}"]
    assert isinstance(port, ShardedTable) and port.mesh.size == d
    assert (port.n_segments, port.padded, port.total_docs) == (ref.n_segments, ref.padded, ref.total_docs)
    assert port.n_segments % d == 0
    assert set(port.arrays) == set(ref.arrays)
    for c, slots in port.arrays.items():
        want = np.asarray(ref.arrays[c])
        assert len(slots) == d
        for t in slots:
            assert t.dtype == torch.from_numpy(np.empty(0, want.dtype)).dtype, c
            assert t.shape[0] == port.n_segments // d and t.device == torch.device("cpu")
        np.testing.assert_array_equal(np.concatenate([t.numpy() for t in slots]), want, err_msg=c)
    for c, ci in port.proto.columns.items():
        assert ci.forward.dtype == ref.proto.columns[c].forward.dtype, c
    np.testing.assert_array_equal(np.concatenate([t.numpy() for t in port.n_docs]), np.asarray(ref.n_docs))
    assert all(t.dtype == torch.int32 for t in port.n_docs)


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
    ref = jbuild(jschema, _copy(data), jmesh(jax.devices()[: SLOTS[mesh]]))
    port = build_sharded_table(schema, _copy(data), make_mesh(("cpu",) * SLOTS[mesh]))
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

    ref = jbuild(schema(JDT, JSchema, JFS), _copy(data), jmesh(jax.devices()[: SLOTS[mesh]]))
    port = build_sharded_table(schema(DataType, Schema, FieldSpec), _copy(data), make_mesh(("cpu",) * SLOTS[mesh]))
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
    ctx, plan, vecs, rebuild = execute_sharded(tables[f"port{SLOTS[mesh]}"], sql)
    assert len(vecs) == SLOTS[mesh]  # a sparse group-by's table a slot
    n_unique = rebuild(_host(vecs))[4]
    assert len(n_unique) == SLOTS[mesh] and int(np.max(n_unique)) > 1024
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
        _, _, vecs, rebuild = execute_sharded(tables["port"], sql)
        got = np.asarray(rebuild(_host(vecs))[-1][0])
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


_SPEC = (
    "agg",
    ("const", True),
    None,
    (
        ("count",),
        ("masked_nan_empty", ("const", True), ("sum", None)),
        ("min", None),
        ("distinct_ids", "c", 4),
        ("max", None),
        ("avg", None),
        ("minmaxrange", None),
        ("hll", None),
    ),
)


def test_combine_tree_on_one_rank_is_the_identity():
    """On one slot each merge rule returns its partial's values (a
    null-handling SUM keeps NaN)."""
    matched = torch.tensor(5)
    parts = (
        torch.tensor(5),
        torch.tensor(float("nan")),
        torch.tensor(2.0),
        torch.tensor([True, False, True, False]),
        torch.tensor(7.0),
        (torch.tensor(3.0), torch.tensor(2)),
        (torch.tensor(1.0), torch.tensor(4.0)),
        torch.tensor([1, 0, 3], dtype=torch.int32),
    )
    m, c, p = _combine_tree(_SPEC, [matched], None, [parts], torch.device("cpu"))
    assert int(m) == 5 and c is None and torch.isnan(p[1])
    for got, want in zip(p, parts):
        for g, w in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert g.dtype == w.dtype and torch.equal(g, w) or (torch.isnan(g) and torch.isnan(w))


def test_combine_tree_merges_slots():
    """Three slots' partials merge by each rule: sums (AVG's pair too), min
    / max (MINMAXRANGE's pair, HLL registers), OR of presences, and a
    null-handling SUM that skips the slots without a non-null row."""
    matched = [torch.tensor(5), torch.tensor(0), torch.tensor(7)]
    counts = [torch.tensor([1, 2]), torch.tensor([0, 0]), torch.tensor([3, 4])]
    parts = [
        (
            torch.tensor(5),
            torch.tensor(float("nan")),
            torch.tensor(2.0),
            torch.tensor([True, False, False, False]),
            torch.tensor(7.0),
            (torch.tensor(3.0), torch.tensor(2)),
            (torch.tensor(1.0), torch.tensor(4.0)),
            torch.tensor([1, 0, 3], dtype=torch.int32),
        ),
        (
            torch.tensor(0),
            torch.tensor(float("nan")),
            torch.tensor(float("inf")),
            torch.tensor([False, False, False, False]),
            torch.tensor(float("-inf")),
            (torch.tensor(0.0), torch.tensor(0)),
            (torch.tensor(float("inf")), torch.tensor(float("-inf"))),
            torch.tensor([0, 0, 0], dtype=torch.int32),
        ),
        (
            torch.tensor(7),
            torch.tensor(4.5),
            torch.tensor(-1.0),
            torch.tensor([False, False, True, False]),
            torch.tensor(3.0),
            (torch.tensor(10.0), torch.tensor(5)),
            (torch.tensor(-2.0), torch.tensor(3.0)),
            torch.tensor([0, 5, 2], dtype=torch.int32),
        ),
    ]
    grouped_spec = _SPEC[:2] + (("groups",),) + _SPEC[3:]
    m, c, p = _combine_tree(grouped_spec, matched, counts, parts, torch.device("cpu"))
    assert int(m) == 12 and c.tolist() == [4, 6]
    assert int(p[0]) == 12 and float(p[1]) == 4.5 and float(p[2]) == -1.0
    assert p[3].tolist() == [True, False, True, False] and float(p[4]) == 7.0
    assert (float(p[5][0]), int(p[5][1])) == (13.0, 7)
    assert (float(p[6][0]), float(p[6][1])) == (-2.0, 4.0)
    assert p[7].tolist() == [1, 5, 3]
    every_nan = [tuple(torch.tensor(float("nan")) if i == 1 else x for i, x in enumerate(sl)) for sl in parts]
    assert torch.isnan(_combine_tree(_SPEC, matched, None, every_nan, torch.device("cpu"))[2][1])


@pytest.mark.parametrize(
    "sql",
    ["SELECT COUNT(*), SUM(revenue) FROM lineorder", "SELECT region, SUM(revenue) FROM lineorder GROUP BY region"],
)
def test_sharded_program_merges_only_across_ranks(lineorder, sql, monkeypatch):
    """On one slot the flat program's partials are the table's and no merge
    runs; over four slots the merge runs once, and the answer is the same."""
    from pinot_tpu_torch.parallel import mesh as mesh_mod

    merges = []
    real = mesh_mod._combine_tree
    monkeypatch.setattr(mesh_mod, "_combine_tree", lambda *a: merges.append(len(a[1])) or real(*a))
    one = lineorder[0]["port"]
    _, plan, program = mesh_mod._prepare(one, sql)
    vecs, rebuild = program()
    assert len(vecs) == 1 and merges == []
    four = lineorder[0]["port4"]
    _, _, program4 = mesh_mod._prepare(four, sql)
    vecs4, rebuild4 = program4()
    assert len(vecs4) == 1 and merges == [4]
    for a, b in zip(K._flatten(rebuild(_host(vecs)))[0], K._flatten(rebuild4(_host(vecs4)))[0]):
        np.testing.assert_array_equal(a, b)


def test_make_mesh_devices():
    mesh = make_mesh("cpu")
    assert mesh.devices == (torch.device("cpu"),) and mesh.device == torch.device("cpu") and mesh.size == 1
    assert make_mesh([torch.device("cpu")]).devices == (torch.device("cpu"),)
    four = make_mesh(["cpu"] * 4)
    assert four.size == 4 and four.devices == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        make_mesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh(("cuda:0",) * 4)


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


# -- __graft_entry__.dryrun_multichip's ten query shapes -------------------------

_DRYRUN_SQL = (
    "SELECT d_year, c_nation, SUM(lo_revenue) FROM lineorder "
    "WHERE lo_quantity > 5 GROUP BY d_year, c_nation ORDER BY SUM(lo_revenue) DESC LIMIT 5"
)


def _toy_schema(DT, S):
    return S.build(
        "lineorder",
        dimensions=[("d_year", DT.INT), ("c_nation", DT.STRING)],
        metrics=[("lo_revenue", DT.LONG), ("lo_quantity", DT.INT)],
    )


def _toy_data(n):
    """dryrun_multichip's table (`__graft_entry__._toy_table`)."""
    rng = np.random.default_rng(0)
    return {
        "d_year": rng.integers(1992, 1999, n).astype(np.int32),
        "c_nation": np.array([f"N{i:02d}" for i in range(25)], dtype=object)[rng.integers(0, 25, n)],
        "lo_revenue": rng.integers(100, 600_000, n).astype(np.int64),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
    }


@pytest.fixture(scope="module", params=[2, 4], ids=["2slots", "4slots"])
def dryrun(request):
    d = request.param
    data = _toy_data(2048 * d)
    port = build_sharded_table(_toy_schema(DataType, Schema), _copy(data), make_mesh(("cpu",) * d))
    ref = jbuild(_toy_schema(JDT, JSchema), _copy(data), jmesh(jax.devices()[:d]))
    return d, data, port, ref


def _sums_by(keys: list, vals: np.ndarray) -> dict:
    out: dict = collections.defaultdict(int)
    for k, v in zip(zip(*keys), vals.tolist()):
        out[k] += v
    return out


@pytest.mark.parametrize("shape", range(1, 11))
def test_dryrun_multichip_shapes(dryrun, shape):
    """Each of dryrun_multichip's shapes on D slots against its numpy truth
    (and, for the queries, the reference's rows over D devices)."""
    from pinot_tpu_torch.parallel import shuffle

    d, t, table, ref = dryrun

    def run(sql, approx=()):
        got = execute_sharded_result(table, sql)
        _assert_rows(got.rows, jresult(ref, sql).rows, approx)
        return got.rows

    if shape == 1:  # flagship: multi-key group-by + ORDER BY agg DESC LIMIT
        m = t["lo_quantity"] > 5
        sums = _sums_by([t["d_year"][m], t["c_nation"][m]], t["lo_revenue"][m])
        assert run(_DRYRUN_SQL)[0][2] == float(max(sums.values()))
    elif shape == 2:  # COUNT with an equality filter
        assert run("SELECT COUNT(*) FROM lineorder WHERE c_nation = 'N07'") == [[int((t["c_nation"] == "N07").sum())]]
    elif shape == 3:  # filtered SUM / MIN / MAX / AVG / MINMAXRANGE
        m = t["d_year"] >= 1995
        r, q = t["lo_revenue"][m], t["lo_quantity"][m]
        row = run(
            "SELECT SUM(lo_revenue), MIN(lo_quantity), MAX(lo_quantity), AVG(lo_revenue), "
            "MINMAXRANGE(lo_revenue) FROM lineorder WHERE d_year >= 1995",
            approx=(3,),
        )[0]
        assert row[:3] == [float(r.sum()), float(q.min()), float(q.max())]
        assert abs(row[3] - r.mean()) < 1e-6 and row[4] == float(r.max() - r.min())
    elif shape == 4:  # DISTINCTCOUNT: presence OR
        assert run("SELECT DISTINCTCOUNT(d_year) FROM lineorder") == [[len(np.unique(t["d_year"]))]]
    elif shape == 5:  # DISTINCTCOUNTHLL: register max
        exact = len(np.unique(t["lo_revenue"]))
        assert abs(run("SELECT DISTINCTCOUNTHLL(lo_revenue) FROM lineorder")[0][0] - exact) / exact < 0.1
    elif shape == 6:  # PERCENTILEEST: histogram sum
        rev = t["lo_revenue"]
        got = run("SELECT PERCENTILEEST(lo_revenue, 50) FROM lineorder", approx=(0,))[0][0]
        assert abs(got - float(np.median(rev))) <= (float(rev.max()) - float(rev.min())) / 100
    elif shape == 7:  # single-key group-by with an OR filter
        m = np.isin(t["c_nation"], ["N01", "N02"])
        sums = _sums_by([t["d_year"][m]], t["lo_revenue"][m])
        rows = run(
            "SELECT d_year, SUM(lo_revenue) FROM lineorder "
            "WHERE c_nation = 'N01' OR c_nation = 'N02' GROUP BY d_year ORDER BY d_year LIMIT 20"
        )
        assert [r[1] for r in rows] == [float(sums[k]) for k in sorted(sums)]
    elif shape == 8:  # high-cardinality group-by: a sparse table a slot
        rng = np.random.default_rng(8)
        n8 = 1024 * d
        users = np.array([f"u{i:06d}" for i in range(400_000)], dtype=object)
        hc = {
            "user": users[rng.integers(0, 400_000, n8)],
            "year": rng.integers(0, 2000, n8).astype(np.int32),
            "v": rng.integers(1, 1000, n8).astype(np.int64),
        }
        schema = lambda DT, S: S.build(  # noqa: E731
            "events", dimensions=[("user", DT.STRING), ("year", DT.INT)], metrics=[("v", DT.LONG)]
        )
        hc_table = build_sharded_table(schema(DataType, Schema), _copy(hc), make_mesh(("cpu",) * d))
        hc_ref = jbuild(schema(JDT, JSchema), _copy(hc), jmesh(jax.devices()[:d]))
        q8 = "SELECT user, year, SUM(v) FROM events GROUP BY user, year ORDER BY SUM(v) DESC LIMIT 10"
        assert plan_mod.plan_segment(hc_table.proto, _ctx(q8)).spec[2][0] == "groups_sparse"
        got = execute_sharded_result(hc_table, q8)
        _assert_rows(got.rows, jresult(hc_ref, q8).rows)
        top = sorted(_sums_by([hc["user"], hc["year"]], hc["v"]).values(), reverse=True)[:10]
        assert [r[2] for r in got.rows] == [float(v) for v in top]
    elif shape == 9:  # dense group-partial exchange
        ng = 64 * d
        parts = np.random.default_rng(9).standard_normal((d, ng))
        out = shuffle.exchange_group_partials([torch.from_numpy(p) for p in parts], table.mesh.devices)
        np.testing.assert_allclose(out[0].numpy(), parts.sum(axis=0), rtol=1e-10)
        assert all(np.allclose(o.numpy(), out[0].numpy()) for o in out)
    else:  # equi-join repartition (FK->PK)
        rng = np.random.default_rng(10)
        rk = rng.permutation(np.arange(0, 3000, 3, dtype=np.int64))
        lk = rng.integers(0, 3000, 8192).astype(np.int64)
        li, ri = shuffle.mesh_equi_join(lk, rk, table.mesh)
        assert np.array_equal(lk[li], rk[ri]) and len(li) == int(np.isin(lk, rk).sum())
