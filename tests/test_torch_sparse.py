"""High-cardinality GROUP BY in the port against the JAX package, on the CPU:

* the two-level exact group-by's wrapper (`ops.groupby.grouped_multi_sum_2l`,
  the counterpart of the Pallas `_planes2_impl`), which on the CPU is the
  plain version, against the reference's `pallas_grouped_multi_sum` under
  PINOT_TPU_PALLAS_V2=1 (interpret mode, as tests/test_pallas_ops.py runs
  it);
* the sort-compaction path (`groups_sparse`, a key-cardinality product past
  MAX_DENSE_GROUPS): the segment program's outputs and the engine's rows
  against the reference's, on tests/test_sparse_groupby.py's queries;
* a dense group-by whose counters pass a block's shared memory (ng > 14.5k),
  which the card runs through the two-level kernel.

Inputs come from numpy with a seed and go to both packages. Sums, counts,
keys and row order must be exactly equal; AVG is a float64 quotient of the
same exact sum and count on both sides, so it is equal too.

The CUDA kernels run only on a card; chip_smoke.py holds them against the
plain version there, the two-level one under several L.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.ops import groupby_pallas as gp
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query.context import QueryContext as JContext
from pinot_tpu.query.kernels import get_kernel
from pinot_tpu.query.plan import plan_segment as jplan_segment
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.ops import groupby as gb
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.query.context import QueryContext
from pinot_tpu_torch.segment import SegmentBuilder

I32 = np.iinfo(np.int32)

# -- the two-level exact group-by ---------------------------------------------


def _tensors(values, gid, mask):
    return [torch.from_numpy(v) for v in values], torch.from_numpy(gid), torch.from_numpy(mask)


def _inputs(seed, n, ng, k, mask_p=0.8):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, ng, n).astype(np.int32)
    values = [rng.integers(-50000, 50000, n).astype(np.int32) for _ in range(k)]
    return values, gid, rng.random(n) < mask_p


# test_two_level_planes_kernel_matches_flat's shapes, and one whose ng passes
# the default 2^L (2^13 for k = 1) without being a multiple of it
SHAPES = [(8192, 130, 2), (12288, 3125, 1), (4096, 64, 1), (8192, 20000, 1)]


def _reference_v2(monkeypatch, values, gid, mask, ng):
    """The reference's pallas_grouped_multi_sum under PINOT_TPU_PALLAS_V2=1:
    its two-level kernel (`_planes2_impl`), in interpret mode on the CPU."""
    ran = []
    planes2 = gp._planes2_impl

    def spy(*args, **kw):
        ran.append(True)
        return planes2(*args, **kw)

    monkeypatch.setattr(gp, "_planes2_impl", spy)
    monkeypatch.setenv("PINOT_TPU_PALLAS_V2", "1")
    js, jc = gp.pallas_grouped_multi_sum([jnp.asarray(v) for v in values], jnp.asarray(gid), jnp.asarray(mask), ng)
    assert ran, "the reference did not run its two-level kernel"
    return [np.asarray(x) for x in js], np.asarray(jc)


def _assert_matches_reference(out, k, ng, js, jc):
    assert out.dtype == torch.int64 and out.shape == (k + 1, ng)
    assert np.array_equal(out[-1].numpy(), jc)
    for j in range(k):
        assert np.array_equal(out[j].numpy().astype(np.float64), js[j])


@pytest.mark.parametrize("n,ng,k", SHAPES)
def test_two_level_matches_pallas_v2(monkeypatch, n, ng, k):
    """On the CPU grouped_multi_sum_2l is the plain version; the two-level
    kernel's levels exist only on the card, where chip_smoke.py holds it
    against the same plain version under several L."""
    values, gid, mask = _inputs(8 + ng, n, ng, k)
    js, jc = _reference_v2(monkeypatch, values, gid, mask, ng)
    out = gb.grouped_multi_sum_2l(*_tensors(values, gid, mask), ng)
    assert torch.equal(out, gb.grouped_multi_sum_plain(*_tensors(values, gid, mask), ng))
    _assert_matches_reference(out, k, ng, js, jc)


@pytest.mark.parametrize(
    "case",
    ["empty_mask", "one_doc", "one_bucket", "out_of_range", "int32_extremes", "k9", "k0", "ng_1"],
)
def test_two_level_edges_match_pallas_v2(monkeypatch, case):
    """The edges the card check runs, at a small size, against the
    reference's two-level kernel."""
    rng = np.random.default_rng(31)
    n, ng, k = 6000, 20000, 2
    values, gid, mask = _inputs(5, n, ng, k)
    if case == "empty_mask":
        mask[:] = False
    elif case == "one_doc":
        mask[:] = False
        mask[4321] = True
    elif case == "one_bucket":  # every doc in bucket 1 of L = 12
        gid = rng.integers(4096, 2 * 4096, n).astype(np.int32)
    elif case == "out_of_range":
        gid[::7] = -3
        gid[1::11] = ng + 9
        gid[2::13] = I32.max
        gid[3::17] = I32.min
    elif case == "int32_extremes":
        pool = np.array([I32.min, I32.max, -1, 0, 1], dtype=np.int64)
        values = [rng.choice(pool, n).astype(np.int32) for _ in range(k)]
    elif case == "k9":
        values = [rng.integers(-(1 << 20), 1 << 20, n).astype(np.int32) for _ in range(9)]
    elif case == "k0":
        values = []
    elif case == "ng_1":
        ng = 1
        gid = rng.integers(-1, 2, n).astype(np.int32)
    js, jc = _reference_v2(monkeypatch, values, gid, mask, ng)
    _assert_matches_reference(gb.grouped_multi_sum_2l(*_tensors(values, gid, mask), ng), len(values), ng, js, jc)


def test_two_level_bits():
    limit = 232_448  # an H100 block's opt-in shared memory
    assert gb.fit_bits(1, limit) == 14  # 3 x 16384 x 4 B = 192 KB
    assert gb.fit_bits(0, limit) == 15
    assert gb.fit_bits(8, limit) == 11  # 17 x 2048 x 4 B = 136 KB
    for k in range(gb.MAX_COLS + 1):
        bits = gb.fit_bits(k, limit)
        assert (2 * k + 1) * 4 << bits <= limit < (2 * k + 1) * 4 << (bits + 1)
        assert gb.two_level_bits(k, 1 << 20, limit) == min(bits, gb.MAX_BITS)
    assert gb.two_level_bits(1, 90_112, limit) == gb.MAX_BITS == 12
    assert gb.two_level_bits(1, 300, limit) == 9  # no wider than ng needs
    assert gb.two_level_bits(1, 512, limit) == 9
    assert gb.two_level_bits(1, 513, limit) == 10
    assert gb.two_level_bits(1, 1, limit) == 0
    assert gb.two_level_bits(1, 2, limit) == 1


def test_sparse_limit_needs_a_card():
    """Which hi buckets the two-level kernel calls sparse comes from its own
    plan on the card; the CPU has no stand-in."""
    with pytest.raises(ValueError, match="CUDA device"):
        gb.sparse_max(1, 4_194_304, 90_112, 12, torch.device("cpu"))


def test_shape_queries_need_a_card():
    """Which kernel a shape takes is asked of the card; the CPU has no
    stand-in limit and always takes the plain version."""
    for query in (lambda d: gb.uses_shared_counters(1, 4608, d), gb.shared_limit):
        with pytest.raises(ValueError, match="CUDA device"):
            query(torch.device("cpu"))


def test_two_level_cpu_counts_no_launch():
    before = (gb.grouped_multi_sum.launches, gb.grouped_multi_sum_2l.launches)
    values, gid, mask = _inputs(1, 1000, 1 << 16, 1)
    gb.grouped_multi_sum(*_tensors(values, gid, mask), 1 << 16)
    gb.grouped_multi_sum_2l(*_tensors(values, gid, mask), 1 << 16)
    assert (gb.grouped_multi_sum.launches, gb.grouped_multi_sum_2l.launches) == before


@pytest.mark.parametrize("bad", [dict(ng=0), dict(gid=torch.zeros(8, dtype=torch.int64)), dict(bits=-1), dict(bits=31)])
def test_two_level_rejects_bad_inputs(bad):
    """Bad inputs raise before anything is built: the wrapper checks the
    tensors, the kernel's entry checks L."""
    args = dict(values=[torch.zeros(8, dtype=torch.int32)], gid=torch.zeros(8, dtype=torch.int32),
                mask=torch.ones(8, dtype=torch.bool), ng=4)
    bits = bad.get("bits")
    args.update({k: v for k, v in bad.items() if k != "bits"})
    with pytest.raises(ValueError):
        if bits is None:
            gb.grouped_multi_sum_2l(args["values"], args["gid"], args["mask"], args["ng"])
        else:
            gb.grouped_multi_sum_2l_kernel(args["values"], args["gid"], args["mask"], args["ng"], bits)


# -- the engine: sparse and large dense group-bys ----------------------------


def _table(seed, n):
    """test_sparse_groupby.py's table, cut to size: two segments of n/2 rows,
    a, b in [0, 2000) (product 4e6 > 2^20 with any third key)."""
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(0, 2000, n).astype(np.int32),
        "b": rng.integers(0, 2000, n).astype(np.int32),
        "c": rng.integers(0, 50, n).astype(np.int32),
        "v": rng.integers(1, 100, n).astype(np.int64),
        "s": np.array(["x", "y", "z"], dtype=object)[rng.integers(0, 3, n)],
    }


def _columns(DT):
    return dict(
        dimensions=[("a", DT.INT), ("b", DT.INT), ("c", DT.INT), ("s", DT.STRING)], metrics=[("v", DT.LONG)]
    )


@pytest.fixture(scope="module")
def engines():
    data = _table(53, 20_000)
    halves = [{k: a[:10_000] for k, a in data.items()}, {k: a[10_000:] for k, a in data.items()}]
    jsegs = [JBuilder(JSchema.build("t", **_columns(JDT))).build(d, f"s{i}") for i, d in enumerate(halves)]
    psegs = [SegmentBuilder(Schema.build("t", **_columns(DataType))).build(d, f"s{i}") for i, d in enumerate(halves)]
    return JEngine(jsegs), QueryEngine(psegs, device="cpu"), jsegs, psegs


SPARSE = [
    # tests/test_sparse_groupby.py's queries
    "SELECT a, b, SUM(v), COUNT(*) FROM t GROUP BY a, b ORDER BY SUM(v) DESC LIMIT 50",
    "SELECT a, b, c, MIN(v), MAX(v), AVG(v) FROM t GROUP BY a, b, c ORDER BY a, b, c LIMIT 20",
    "SELECT a, b, SUM(v) FROM t WHERE c < 10 GROUP BY a, b ORDER BY a, b LIMIT 25",
    # ties under ORDER BY follow the merge order; a string key; MINMAXRANGE
    "SELECT a, b, COUNT(*) FROM t GROUP BY a, b ORDER BY COUNT(*) DESC LIMIT 40",
    "SELECT s, a, b, SUM(v), MINMAXRANGE(v) FROM t WHERE v > 50 GROUP BY s, a, b ORDER BY SUM(v) DESC, s LIMIT 30",
    # every present group, past the LIMIT's default
    "SELECT c, a, b, COUNT(*), SUM(v) FROM t WHERE a < 40 GROUP BY c, a, b ORDER BY c, a, b LIMIT 100000",
    # grouped DISTINCTCOUNT over the slots: U x pad = 16384 x 64 cells, under
    # the 2^24 budget
    "SELECT a, b, DISTINCTCOUNT(c), COUNT(*) FROM t GROUP BY a, b ORDER BY DISTINCTCOUNT(c) DESC, a, b LIMIT 20",
    # nothing passes the filter
    "SELECT a, b, SUM(v) FROM t WHERE c > 60 GROUP BY a, b LIMIT 10",
]

# dense group-bys whose (k+1) x ng counters pass 227 KB: the two-level form
DENSE_WIDE = [
    "SELECT a, c, SUM(v), COUNT(*) FROM t GROUP BY a, c ORDER BY SUM(v) DESC, a, c LIMIT 30",
    "SELECT b, c, MIN(v), MAX(v), AVG(v), COUNT(*) FROM t WHERE v < 70 GROUP BY b, c ORDER BY b, c LIMIT 200",
]


def _assert_same_result(got, want):
    assert got.columns == want.columns
    assert len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        assert [type(x) for x in g] == [type(x) for x in w], (g, w)
        assert g == w
    assert got.num_docs_scanned == want.num_docs_scanned
    assert got.total_docs == want.total_docs


@pytest.mark.parametrize("sql", SPARSE)
def test_sparse_groupby_matches_reference(engines, sql):
    ref, port, _, psegs = engines
    assert plan_mod.plan_segment(psegs[0], QueryContext.from_sql(sql)).spec[2][0] == "groups_sparse"
    _assert_same_result(port.execute(sql), ref.execute(sql))


@pytest.mark.parametrize("sql", DENSE_WIDE)
def test_wide_dense_groupby_matches_reference(engines, sql):
    """Dense group-bys whose flat counters (2 x 8 B x ng) pass an H100
    block's 232,448 B: the card runs them through the two-level kernel."""
    ref, port, _, psegs = engines
    gspecs = [plan_mod.plan_segment(seg, QueryContext.from_sql(sql)).spec[2] for seg in psegs]
    assert all(g[0] == "groups" and g[2] > 14_528 for g in gspecs)
    _assert_same_result(port.execute(sql), ref.execute(sql))


def _leaves_jax(seg, plan):
    import jax

    dev = seg.to_device_cached()
    cols = {c: dev.arrays[c] for c in plan.columns}
    ops = tuple(jnp.asarray(o) for o in plan.operands)
    return [np.asarray(l) for l in jax.tree.leaves(get_kernel(plan.spec)(cols, ops, np.int32(seg.n_docs), dev.padded))]


def _leaves_port(seg, plan):
    dev = seg.to_device_cached("cpu")
    cols = {c: dev.arrays[c] for c in plan.columns}
    ops = tuple(K.stage_operand(o, "cpu") for o in plan.operands)
    leaves, _ = K._flatten(K.build_fn(plan.spec)(cols, ops, seg.n_docs, dev.padded))
    return [l.numpy() for l in leaves]


@pytest.mark.parametrize("sql", SPARSE[:3] + SPARSE[-1:])
def test_sparse_program_matches_reference(engines, sql):
    """The segment program's outputs (matched, counts, partials, the slot
    table and n_unique) equal the reference's, leaf for leaf."""
    _, _, jsegs, psegs = engines
    for jseg, pseg in zip(jsegs, psegs):
        jplan = jplan_segment(jseg, JContext.from_sql(sql))
        plan = plan_mod.plan_segment(pseg, QueryContext.from_sql(sql))
        assert plan.spec == jplan.spec and plan.spec[2][0] == "groups_sparse"
        assert plan.spec[2][2] == 16384  # U = pow2(10,000 docs)
        for o, jo in zip(plan.operands, jplan.operands):
            assert np.asarray(o).dtype == np.asarray(jo).dtype and np.array_equal(o, jo)
        got, want = _leaves_port(pseg, plan), _leaves_jax(jseg, jplan)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape and np.array_equal(g, w)


def test_sparse_slot_overflow_raises(monkeypatch):
    """More present groups than slots (MAX_DENSE_GROUPS lowered to 64, as
    tests/test_sparse_groupby.py lowers it): the segment plans on the device,
    its clipped slots collide, and the engine reruns it on the host executor,
    as the reference does, with the reference's rows."""
    n = 4096
    data = {
        "a": np.arange(n, dtype=np.int32) % 3000,
        "b": np.arange(n, dtype=np.int32) // 2,
        "c": np.zeros(n, dtype=np.int32),
        "v": np.ones(n, dtype=np.int64),
        "s": np.array(["x"] * n, dtype=object),
    }
    ref = JEngine([JBuilder(JSchema.build("o", **_columns(JDT))).build(data, "o0")])
    engine = QueryEngine([SegmentBuilder(Schema.build("o", **_columns(DataType))).build(data, "o0")], device="cpu")
    monkeypatch.setattr(plan_mod, "MAX_DENSE_GROUPS", 64)
    sql = "SELECT a, b, SUM(v) FROM o GROUP BY a, b ORDER BY a, b LIMIT 5"
    ctx = engine.make_context(sql)
    assert plan_mod.plan_segment(engine.segments[0], ctx).spec[2][:3] == ("groups_sparse", ("a", "b"), 64)
    engine.segment_modes.clear()
    _assert_same_result(engine.execute(sql), ref.execute(sql))
    assert engine.segment_modes == {"host": 1}
    # 64 slots hold a filter's 40 present groups
    res = engine.execute("SELECT a, b, SUM(v) FROM o WHERE b < 20 GROUP BY a, b ORDER BY a, b LIMIT 5")
    assert res.rows == [[0, 0, 1.0], [1, 0, 1.0], [2, 1, 1.0], [3, 1, 1.0], [4, 2, 1.0]]
    assert engine.segment_modes == {"host": 1, "device": 1}


def test_sparse_distinctcount_budget_raises(engines):
    """DISTINCTCOUNT under the sparse path whose U x pad presence cells
    (16384 x 2048) pass the 2^24 budget: planning raises DeviceFallback, and
    the engine answers on the host executor with the reference's rows."""
    ref, port, _, psegs = engines
    sql = "SELECT a, b, DISTINCTCOUNT(b) FROM t GROUP BY a, b ORDER BY a, b LIMIT 5"
    with pytest.raises(plan_mod.DeviceFallback, match="presence matrix"):
        plan_mod.plan_segment(psegs[0], port.make_context(sql))
    _assert_same_result(port.execute(sql), ref.execute(sql))


def test_sparse_gid_overflow_raises():
    """A product of cardinalities past 2^62 has no int64 dense gid: planning
    raises DeviceFallback, and the host executor groups by the values."""
    n = 70_000
    keys = {f"k{i}": np.arange(n, dtype=np.int32) for i in range(4)}
    ref = JEngine([JBuilder(JSchema.build("w", dimensions=[(c, JDT.INT) for c in keys])).build(keys, "w0")])
    engine = QueryEngine([SegmentBuilder(Schema.build("w", dimensions=[(c, DataType.INT) for c in keys])).build(keys, "w0")], device="cpu")
    sql = "SELECT k0, k1, k2, k3, COUNT(*) FROM w GROUP BY k0, k1, k2, k3 ORDER BY k0 DESC LIMIT 5"
    with pytest.raises(plan_mod.DeviceFallback, match="overflows int64"):
        plan_mod.plan_segment(engine.segments[0], engine.make_context(sql))
    _assert_same_result(engine.execute(sql), ref.execute(sql))
