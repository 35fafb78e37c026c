"""The port's HyperLogLog (pinot_tpu_torch/query/sketches.py and the `hll`
aggregate of query/kernels.py) against the JAX package's query/sketches.py on
the same numpy-seeded inputs: the host and device mixers, the register index
and rank, scalar and grouped registers, hash_any over strings, ints and
floats, the estimate, and DISTINCTCOUNTHLL queries through both engines.
Everything here is integer arithmetic: the tolerance is exact equality.
Also the stable-operand cache: a dictionary's hash table is staged once per
device and dropped when the dictionary is collected."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import sketches as JS
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.query import sketches as S
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_segment import describe

M32 = 0xFFFFFFFF


def _u32(rng, n):
    edges = np.array([0, 1, 2, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, M32], dtype=np.uint32)
    return np.concatenate([edges, rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)])


def _t(a):
    """uint32 words as the int64 tensor the device side works on."""
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def test_host_mixer_matches_reference():
    x = _u32(np.random.default_rng(1), 10_000)
    np.testing.assert_array_equal(S.murmur_mix32(x), JS.murmur_mix32(x))


def test_device_mixer_matches_reference():
    x = _u32(np.random.default_rng(2), 10_000)
    want = np.asarray(JS.jnp_mix32(jnp, jnp.asarray(x)))
    np.testing.assert_array_equal(S.mix32(_t(x)).numpy(), want.astype(np.int64))


@pytest.mark.parametrize("c", [0x85EBCA6B, 0xC2B2AE35, M32, 1])
def test_mul32_wraps_like_uint32(c):
    """(h * c) mod 2^32 at h = 0xFFFFFFFF and around it, where the int64
    product of two 32-bit words would pass 2^63."""
    h = np.array([M32, M32 - 1, 1 << 31, 0, 12345], dtype=np.uint64)
    want = (h * np.uint64(c)) & np.uint64(M32)
    np.testing.assert_array_equal(S._mul32(_t(h), c).numpy(), want.astype(np.int64))


def _edge_hashes(log2m):
    """Hashes whose w (the 32 - log2m bits after the register index) is 0,
    1, 2^k - 1, 2^k or 2^k + 1 for every k, under drawn register indexes."""
    bits = 32 - log2m
    rs = {0, 1}
    for k in range(bits + 1):
        rs |= {(1 << k) - 1, 1 << k, (1 << k) + 1}
    r = np.array(sorted(v for v in rs if v < (1 << bits)), dtype=np.uint64)
    idx = np.random.default_rng(3).integers(0, 1 << log2m, len(r)).astype(np.uint64)
    return ((idx << np.uint64(bits)) | r).astype(np.uint32)


def _ref_ranks(h, mask, log2m, xp=np):
    """The reference's `_hll_ranks`, evaluated by numpy (exact log2, its
    host path's math, as in np_hll_registers) or by jnp (XLA's log2)."""
    idx, rank = JS._hll_ranks(xp, xp.asarray(h), xp.asarray(mask), log2m)
    return np.asarray(idx), np.asarray(rank)


def _ref_registers(h, mask, gid=None, ng=1, log2m=12):
    """The reference's hll_update / hll_update_grouped scatter-max over the
    reference's ranks under numpy."""
    idx, rank = _ref_ranks(h, mask, log2m)
    regs = np.zeros((ng + 1, 1 << log2m), dtype=np.int32)  # row ng: dropped ids
    g = np.zeros(len(h), np.int64) if gid is None else np.where((gid >= 0) & (gid < ng), gid, ng)
    np.maximum.at(regs, (g, idx), rank)
    return regs[0] if gid is None else regs[:ng]


@pytest.mark.parametrize("log2m", [4, 12])
def test_ranks_match_reference_at_every_bit_length(log2m):
    h = _edge_hashes(log2m)
    mask = np.ones(len(h), dtype=bool)
    mask[::7] = False
    got_idx, got_rank = S.hll_ranks(_t(h), torch.from_numpy(mask), log2m)
    want_idx, want_rank = _ref_ranks(h, mask, log2m)
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_array_equal(got_rank.numpy(), want_rank)
    assert got_rank.dtype == torch.int32


def test_reference_device_ranks_differ_only_at_inexact_log2():
    """The reference's device ranks take floor(log2(w)) from XLA's log2,
    which on the CPU falls just below k at some w = 2^k (k = 12, 13, 14, 24,
    26, 28 among the w a 12-bit index leaves); there its rank is one more
    than its own host path's (np_hll_registers) and the port's. Everywhere
    else the three agree."""
    log2m = 12
    h = _edge_hashes(log2m)
    mask = np.ones(len(h), dtype=bool)
    _, port = S.hll_ranks(_t(h), torch.from_numpy(mask), log2m)
    _, host = _ref_ranks(h, mask, log2m)
    _, dev = _ref_ranks(h, mask, log2m, jnp)
    w = (h.astype(np.uint64) << np.uint64(log2m)) & np.uint64(M32)
    exact_log2 = np.floor(np.log2(np.maximum(w, 1).astype(np.float64)))
    xla_log2 = np.asarray(jnp.floor(jnp.log2(jnp.maximum(jnp.asarray(w.astype(np.float64)), 1.0))))
    off = (w > 0) & (xla_log2 != exact_log2)
    np.testing.assert_array_equal(port.numpy(), host)
    np.testing.assert_array_equal(dev[~off], host[~off])
    np.testing.assert_array_equal(dev[off], np.minimum(host[off] + 1, 32 - log2m + 1))
    assert set(np.log2(w[off].astype(np.float64)).astype(int)) <= {12, 13, 14, 24, 26, 28}


def test_scalar_registers_match_reference():
    rng = np.random.default_rng(4)
    h = np.concatenate([_u32(rng, 50_000), _edge_hashes(12)])
    mask = rng.random(len(h)) < 0.8
    got = S.hll_update(_t(h), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _ref_registers(h, mask))


@pytest.mark.parametrize("ng", [1, 7, 256])
def test_grouped_registers_match_reference(ng):
    """Ids in [0, ng] and one past: the reference's scatter drops gid = ng,
    and so must the port."""
    rng = np.random.default_rng(5 + ng)
    h = np.concatenate([_u32(rng, 40_000), _edge_hashes(12)])
    mask = rng.random(len(h)) < 0.7
    gid = rng.integers(0, ng + 1, len(h)).astype(np.int32)
    got = S.hll_update_grouped(_t(h), torch.from_numpy(mask), torch.from_numpy(gid), ng).numpy()
    assert got.shape == (ng, S.HLL_M)
    np.testing.assert_array_equal(got, _ref_registers(h, mask, gid, ng))


def _values():
    i64 = np.iinfo(np.int64)
    i32 = np.iinfo(np.int32)
    rng = np.random.default_rng(6)
    return {
        "strings": np.array(["", "a", "NATION_07", "é-région", "x" * 300], dtype=object),
        "ints": np.concatenate(
            [np.array([0, 1, -1, i64.min, i64.max, i32.min, i32.max, 1 << 32], dtype=np.int64),
             rng.integers(-(1 << 62), 1 << 62, 1000)]
        ),
        "int32": np.array([0, -1, i32.min, i32.max, 7], dtype=np.int32),
        "floats": np.concatenate(
            [np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25, 5e-324]), rng.normal(0, 1e6, 1000)]
        ),
    }


@pytest.mark.parametrize("kind", ["strings", "ints", "int32", "floats"])
def test_hash_any_matches_reference(kind):
    v = _values()[kind]
    np.testing.assert_array_equal(S.hash_any(v), JS.hash_any(v))


@pytest.mark.parametrize("kind", ["ints", "int32", "floats"])
def test_device_hash_matches_host_hash(kind):
    """The device mixer over raw values hashes as the reference's host
    hash_any does (the contract that lets registers from either path merge)."""
    v = _values()[kind]
    np.testing.assert_array_equal(S.hash_device(torch.from_numpy(v)).numpy(), JS.hash_any(v).astype(np.int64))


def test_np_registers_and_estimate_match_reference():
    rng = np.random.default_rng(7)
    for n in (0, 1, 100, 20_000):
        v = rng.integers(0, 5_000_000, n).astype(np.int64)
        regs = S.np_hll_registers(v)
        np.testing.assert_array_equal(regs, JS.np_hll_registers(v))
        assert S.hll_estimate(regs) == JS.hll_estimate(regs)
    for fill in (0, 3, 30):
        regs = rng.integers(0, fill + 1, S.HLL_M).astype(np.int32)
        assert S.hll_estimate(regs) == JS.hll_estimate(regs)


@pytest.fixture(scope="module")
def engines():
    rng = np.random.default_rng(8)

    def data(n):
        return {
            "g": np.array(["a", "b", "c"], dtype=object)[rng.integers(0, 3, n)],
            "u": rng.integers(0, 50_000, n).astype(np.int64),
            "s": np.array([f"s{i}" for i in range(500)], dtype=object)[rng.integers(0, 500, n)],
            "q": rng.integers(-100, 100, n).astype(np.int32),
            "x": np.round(rng.normal(0, 10, n), 2),
        }

    datas = [data(n) for n in (3000, 1, 2200)]

    def schema(DT, S_):
        return S_.build("t", dimensions=[("g", DT.STRING), ("u", DT.LONG), ("s", DT.STRING)],
                        metrics=[("q", DT.INT), ("x", DT.DOUBLE)])

    jsegs = [JBuilder(schema(JDT, JSchema)).build(d, f"s{i}") for i, d in enumerate(datas)]
    built = [SegmentBuilder(schema(DataType, Schema)).build(d, f"s{i}") for i, d in enumerate(datas)]
    carried = [segment_from_numpy(describe(s)) for s in jsegs]
    return JEngine(jsegs), {"built": QueryEngine(built, device="cpu"), "carried": QueryEngine(carried, device="cpu")}


HLL_QUERIES = [
    "SELECT DISTINCTCOUNTHLL(u) FROM t",
    "SELECT DISTINCTCOUNTHLL(s), DISTINCTCOUNTHLL(g), COUNT(*) FROM t WHERE q > 0",
    "SELECT DISTINCTCOUNTHLL(q), DISTINCTCOUNTHLL(x), DISTINCTCOUNTHLL(q * 3 + 1) FROM t",
    "SELECT g, DISTINCTCOUNTHLL(u), DISTINCTCOUNTHLL(x), SUM(q) FROM t GROUP BY g ORDER BY g",
    "SELECT g, DISTINCTCOUNTHLL(s) FROM t WHERE x > 0 GROUP BY g ORDER BY DISTINCTCOUNTHLL(s) DESC, g LIMIT 2",
    "SELECT DISTINCTCOUNTHLL(u) FROM t WHERE g = 'nowhere'",
]


@pytest.mark.parametrize("mode", ["built", "carried"])
@pytest.mark.parametrize("sql", HLL_QUERIES)
def test_hll_queries_match_reference(engines, sql, mode):
    ref, ports = engines
    want, got = ref.execute(sql), ports[mode].execute(sql)
    assert got.rows == want.rows
    assert [[type(v) for v in r] for r in got.rows] == [[type(v) for v in r] for r in want.rows]
    assert got.num_docs_scanned == want.num_docs_scanned


def test_registers_of_a_query_match_the_reference_plan(engines):
    """Per segment, the port's scalar registers equal the reference's device
    registers, bit for bit."""
    from pinot_tpu.query.kernels import run_plan_packed
    from pinot_tpu.query.plan import plan_segment as jplan
    from pinot_tpu_torch.query.kernels import dispatch_plan_packed
    from pinot_tpu_torch.query.plan import plan_segment

    ref, ports = engines
    sql = "SELECT DISTINCTCOUNTHLL(u), DISTINCTCOUNTHLL(x) FROM t WHERE q < 50"
    jctx, ctx = ref.make_context(sql), ports["carried"].make_context(sql)
    for jseg, seg in zip(ref.segments, ports["carried"].segments):
        _, want = run_plan_packed(jplan(jseg, jctx), jseg.to_device_cached())
        _, got = dispatch_plan_packed(plan_segment(seg, ctx), seg.to_device_cached("cpu"))()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_hash_table_is_staged_once_and_dropped_with_its_dictionary():
    """A second DISTINCTCOUNTHLL query reuses the staged hash table (the same
    tensor object); collecting the dictionary drops the cache entry."""
    rng = np.random.default_rng(9)
    schema = Schema.build("h", dimensions=[("u", DataType.LONG)])
    seg = SegmentBuilder(schema).build({"u": rng.integers(0, 1000, 4000).astype(np.int64)}, "h0")
    engine = QueryEngine([seg], device="cpu")
    sql = "SELECT DISTINCTCOUNTHLL(u) FROM h"
    ctx = engine.make_context(sql)

    def staged_table():
        from pinot_tpu_torch.query.plan import plan_segment

        plan = plan_segment(seg, ctx)
        (table,) = [o for o in plan.operands if isinstance(o, np.ndarray) and o.dtype == np.uint32]
        return table, K.stage_operand(table, "cpu")

    first = engine.execute(sql).rows
    table, t1 = staged_table()
    again, t2 = staged_table()
    assert again is table and t1 is t2
    assert engine.execute(sql).rows == first
    key = (id(table), "cpu")
    assert key in K._OP_DEVICE_CACHE
    # a per-query operand of the same values is not cached
    assert K.stage_operand(table.copy(), "cpu") is not t1
    del table, again, t1, t2, engine, ctx, staged_table
    seg.columns["u"].dictionary = None
    del seg
    gc.collect()
    assert key not in K._OP_DEVICE_CACHE
