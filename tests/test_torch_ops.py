"""The port's ops API (pinot_tpu_torch/ops/extreme.py, ops/grouped_sum_f32.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_ops.py runs them, and the engine's forms of the same
functions (grouped_extreme, grouped_extremes, grouped presence) against the
reference engine's XLA reductions (pinot_tpu/query/kernels.py). Inputs come from numpy with a seed and go to
both packages.

Tolerances: MIN/MAX, COUNT and presence must be exactly equal (-0.0 == +0.0,
and a NaN equals a NaN); float32 sums agree within test_pallas_ops.py's
rtol 1e-4, atol 1e-2, since each side adds in its own order.

The CUDA kernels run only on a card; chip_smoke.py holds them against these
plain versions there.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pinot_tpu.ops import (
    pallas_grouped_count,
    pallas_grouped_max,
    pallas_grouped_min,
    pallas_grouped_sum,
    pallas_presence,
)
from pinot_tpu.query.kernels import _int_grouped_extreme
from pinot_tpu_torch import ops
from pinot_tpu_torch.ops import extreme, grouped_sum_f32

I32 = np.iinfo(np.int32)
N = 5000  # not a multiple of the Pallas chunk (2048)
NGS = [37, 256, 700, 1024]


def _inputs(seed, ng, n=N, mask_p=0.7, int32_extremes=False):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, ng, n).astype(np.int32)
    if int32_extremes:
        vals = rng.choice(np.array([I32.min, I32.max, -1, 0, 1], dtype=np.int64), n).astype(np.float32)
    else:
        vals = rng.uniform(-1000, 1000, n).astype(np.float32)
    mask = rng.random(n) < mask_p
    return vals, gid, mask


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _same(got: np.ndarray, want: np.ndarray) -> None:
    """Exact equality with == (so -0.0 == +0.0) and NaN equal to NaN."""
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    both_nan = np.isnan(got) & np.isnan(want) if got.dtype.kind == "f" else np.zeros(got.shape, bool)
    bad = ~((got == want) | both_nan)
    assert not bad.any(), (np.flatnonzero(bad)[:5], got[bad][:5], want[bad][:5])


# ---------------------------------------------------------------------------
# the ops API against pallas_* (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ng", NGS)
@pytest.mark.parametrize("is_min", [True, False])
def test_grouped_min_max_match_pallas(ng, is_min):
    vals, gid, mask = _inputs(ng, ng)
    pallas = pallas_grouped_min if is_min else pallas_grouped_max
    port = ops.grouped_min if is_min else ops.grouped_max
    want = np.asarray(pallas(jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), ng))
    got = port(_t(vals), _t(gid), _t(mask), ng).numpy()
    _same(got, want)
    assert np.isinf(got).any() == (np.bincount(gid[mask], minlength=ng) == 0).any()


@pytest.mark.parametrize("ng", NGS)
def test_grouped_sum_matches_pallas(ng):
    vals, gid, mask = _inputs(ng + 1, ng)
    want = np.asarray(pallas_grouped_sum(jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), ng))
    got = ops.grouped_sum(_t(vals), _t(gid), _t(mask), ng).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("ng", NGS)
def test_grouped_count_matches_pallas(ng):
    _, gid, mask = _inputs(ng + 2, ng)
    want = np.asarray(pallas_grouped_count(jnp.asarray(gid), jnp.asarray(mask), ng))
    got = ops.grouped_count(_t(gid), _t(mask), ng).numpy()
    _same(got, want)
    assert np.array_equal(got.astype(np.int64), np.bincount(gid[mask], minlength=ng))


@pytest.mark.parametrize("ng", NGS)
def test_presence_matches_pallas(ng):
    _, ids, mask = _inputs(ng + 3, ng, mask_p=0.002)  # some ids absent
    want = np.asarray(pallas_presence(jnp.asarray(ids), jnp.asarray(mask), ng))
    got = ops.presence(_t(ids), _t(mask), ng).numpy()
    assert got.dtype == np.bool_ and np.array_equal(got, want)
    assert 0 < got.sum() < ng


def test_empty_mask_matches_pallas():
    ng = 256
    vals, gid, mask = _inputs(5, ng, mask_p=0.0)
    j = (jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask))
    p = (_t(vals), _t(gid), _t(mask))
    _same(ops.grouped_min(*p, ng).numpy(), np.asarray(pallas_grouped_min(*j, ng)))
    _same(ops.grouped_max(*p, ng).numpy(), np.asarray(pallas_grouped_max(*j, ng)))
    _same(ops.grouped_sum(*p, ng).numpy(), np.asarray(pallas_grouped_sum(*j, ng)))
    _same(ops.grouped_count(*p[1:], ng).numpy(), np.asarray(pallas_grouped_count(*j[1:], ng)))
    assert np.array_equal(ops.presence(*p[1:], ng).numpy(), np.asarray(pallas_presence(*j[1:], ng)))
    assert (ops.grouped_min(*p, ng).numpy() == np.inf).all()
    assert not ops.presence(*p[1:], ng).numpy().any()


@pytest.mark.parametrize("ng", [37, 256])
def test_out_of_range_gids_match_pallas(ng):
    vals, gid, mask = _inputs(7, ng)
    gid[::7] = -3
    gid[1::11] = ng + 9
    j = (jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask))
    p = (_t(vals), _t(gid), _t(mask))
    _same(ops.grouped_min(*p, ng).numpy(), np.asarray(pallas_grouped_min(*j, ng)))
    _same(ops.grouped_max(*p, ng).numpy(), np.asarray(pallas_grouped_max(*j, ng)))
    np.testing.assert_allclose(
        ops.grouped_sum(*p, ng).numpy(), np.asarray(pallas_grouped_sum(*j, ng)), rtol=1e-4, atol=1e-2
    )
    _same(ops.grouped_count(*p[1:], ng).numpy(), np.asarray(pallas_grouped_count(*j[1:], ng)))
    assert np.array_equal(ops.presence(*p[1:], ng).numpy(), np.asarray(pallas_presence(*j[1:], ng)))
    ok = mask & (gid >= 0) & (gid < ng)
    assert np.array_equal(ops.grouped_count(*p[1:], ng).numpy().astype(np.int64), np.bincount(gid[ok], minlength=ng))


@pytest.mark.parametrize("is_min", [True, False])
def test_int32_extremes_match_pallas(is_min):
    ng = 256
    vals, gid, mask = _inputs(9, ng, int32_extremes=True)
    pallas = pallas_grouped_min if is_min else pallas_grouped_max
    port = ops.grouped_min if is_min else ops.grouped_max
    want = np.asarray(pallas(jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), ng))
    _same(port(_t(vals), _t(gid), _t(mask), ng).numpy(), want)


# ---------------------------------------------------------------------------
# the engine's forms against the reference engine's reductions
# ---------------------------------------------------------------------------


def _engine_inputs(seed, ng, n=N):
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, ng, n).astype(np.int32)
    mask = rng.random(n) < 0.5
    mask[gid == 3] = False  # group 3 is empty
    return rng, gid, mask


@pytest.mark.parametrize("ng", [37, 256])
@pytest.mark.parametrize("is_min", [True, False])
def test_int32_engine_form_matches_reference(ng, is_min):
    rng, gid, mask = _engine_inputs(ng, ng)
    pool = np.array([I32.min, I32.max, I32.min + 1, I32.max - 1, -1, 0, 1], dtype=np.int64)
    vals = rng.choice(pool, N).astype(np.int32)
    want = np.asarray(_int_grouped_extreme(jnp.asarray(vals), jnp.asarray(gid), jnp.asarray(mask), ng, is_min))
    counts = _t(np.bincount(gid[mask], minlength=ng).astype(np.int64))
    got = ops.grouped_extreme(_t(vals), _t(gid), _t(mask), ng, is_min, counts).numpy()
    _same(got, want)
    assert got[3] == (np.inf if is_min else -np.inf)


@pytest.mark.parametrize("is_min", [True, False])
def test_float64_engine_form_matches_reference(is_min):
    """NaN wins MIN and MAX alike, as XLA's segment_min/max give it on the
    CPU; +-0.0 and +-inf take part as values."""
    ng = 256
    rng, gid, mask = _engine_inputs(11, ng)
    vals = rng.normal(0, 1e6, N)
    vals[rng.random(N) < 0.003] = np.nan
    vals[rng.random(N) < 0.05] = 0.0
    vals[rng.random(N) < 0.05] = -0.0
    vals[rng.random(N) < 0.01] = np.inf
    vals[rng.random(N) < 0.01] = -np.inf
    red = jax.ops.segment_min if is_min else jax.ops.segment_max
    fill = np.inf if is_min else -np.inf
    want = np.asarray(red(jnp.where(jnp.asarray(mask), jnp.asarray(vals), fill), jnp.asarray(gid), num_segments=ng))
    got = ops.grouped_extreme(_t(vals), _t(gid), _t(mask), ng, is_min).numpy()
    _same(got, want)
    assert np.isnan(got).any() and np.isnan(got).sum() < ng // 2


@pytest.mark.parametrize("pad,ng", [(32, 256), (8, 37), (64, 1)])
def test_grouped_presence_matches_reference(pad, ng):
    """The engine's grouped presence: jnp.zeros((ng, pad)).at[gid, ids].max(mask)."""
    rng, gid, mask = _engine_inputs(pad + ng, ng)
    ids = rng.integers(0, pad - 1, N).astype(np.int32)  # id pad-1 never occurs
    want = np.asarray(
        jnp.zeros((ng, pad), dtype=bool).at[jnp.asarray(gid), jnp.asarray(ids)].max(jnp.asarray(mask))
    )
    got = ops.presence(_t(ids), _t(mask), pad, gid=_t(gid), ng=ng).numpy()
    assert got.shape == (ng, pad) and np.array_equal(got, want)
    assert not got[:, pad - 1].any()


def test_scalar_presence_matches_reference():
    rng, ids, mask = _engine_inputs(3, 30)
    want = np.asarray(jnp.zeros((32,), dtype=bool).at[jnp.asarray(ids)].max(jnp.asarray(mask)))
    got = ops.presence(_t(ids), _t(mask), 32).numpy()
    assert np.array_equal(got, want) and not got[3] and got.sum() == 29


# ---------------------------------------------------------------------------
# grouped_extremes: every MIN / MAX of a group-by in one call
# ---------------------------------------------------------------------------


def _reference_extreme(v, gid, mask, ng, is_min):
    """The reference engine's grouped MIN / MAX of one aggregate: int32
    values through `_int_grouped_extreme`, the rest as float64 through
    segment_min / segment_max (pinot_tpu/query/kernels.py)."""
    j = (jnp.asarray(gid), jnp.asarray(mask))
    if v.dtype == np.int32:
        return np.asarray(_int_grouped_extreme(jnp.asarray(v), j[0], j[1], ng, is_min))
    red = jax.ops.segment_min if is_min else jax.ops.segment_max
    fill = np.inf if is_min else -np.inf
    return np.asarray(red(jnp.where(j[1], jnp.asarray(v), fill), j[0], num_segments=ng))


def _mixed_columns(rng, n):
    """int32 extremes, a float64 column with NaN / +-0.0 / +-inf, and a plain
    int32 column."""
    pool = np.array([I32.min, I32.max, I32.min + 1, I32.max - 1, -1, 0, 1], dtype=np.int64)
    a = rng.choice(pool, n).astype(np.int32)
    x = rng.normal(0, 1e6, n)
    x[rng.random(n) < 0.003] = np.nan
    x[rng.random(n) < 0.05] = 0.0
    x[rng.random(n) < 0.05] = -0.0
    x[rng.random(n) < 0.01] = np.inf
    x[rng.random(n) < 0.01] = -np.inf
    c = rng.integers(-1000, 1000, n).astype(np.int32)
    return [a, x, c]


@pytest.mark.parametrize("ng", [37, 256])
def test_grouped_extremes_match_reference_output_by_output(ng):
    """int32 and float64 columns in one call, a column with both its MIN and
    its MAX, an empty group (3) and NaN groups: each output equals the
    reference's reduction of that aggregate."""
    rng, gid, mask = _engine_inputs(ng + 5, ng)
    columns = _mixed_columns(rng, N)
    outputs = [(0, True), (1, False), (2, True), (2, False), (1, True), (0, False)]
    counts = _t(np.bincount(gid[mask], minlength=ng).astype(np.int64))
    got = ops.grouped_extremes([_t(c) for c in columns], outputs, _t(gid), _t(mask), ng, counts)
    assert len(got) == len(outputs)
    for (c, is_min), g in zip(outputs, got):
        want = _reference_extreme(columns[c], gid, mask, ng, is_min)
        _same(g.numpy(), want)
        assert g[3] == (np.inf if is_min else -np.inf)
    assert np.isnan(got[1].numpy()).any() and np.isnan(got[4].numpy()).any()


def test_grouped_extremes_nine_outputs_and_repeats():
    """Past MAX_OUTPUTS distinct outputs, and a repeated (column, is_min):
    every output still equals the reference's, in the order asked."""
    ng = 64
    rng, gid, mask = _engine_inputs(21, ng)
    columns = _mixed_columns(rng, N) + [rng.uniform(-1, 1, N), rng.integers(-9, 9, N).astype(np.int32)]
    outputs = [(0, True), (0, False), (1, True), (1, False), (2, True), (2, False), (3, True), (3, False), (4, False),
               (1, True)]
    assert len(set(outputs)) == extreme.MAX_OUTPUTS + 1
    counts = _t(np.bincount(gid[mask], minlength=ng).astype(np.int64))
    got = ops.grouped_extremes([_t(c) for c in columns], outputs, _t(gid), _t(mask), ng, counts)
    for (c, is_min), g in zip(outputs, got):
        _same(g.numpy(), _reference_extreme(columns[c], gid, mask, ng, is_min))


def test_grouped_extremes_float32_and_single_forms_agree():
    """A float32 column keeps a float32 result, as grouped_min / grouped_max
    give it; each output of one call equals the one-output form."""
    ng = 256
    vals, gid, mask = _inputs(13, ng)
    wide = np.random.default_rng(13).normal(0, 1e6, N)
    got = ops.grouped_extremes([_t(vals), _t(wide)], [(0, False), (0, True), (1, True)], _t(gid), _t(mask), ng)
    assert [g.dtype for g in got] == [torch.float32, torch.float32, torch.float64]
    _same(got[0].numpy(), ops.grouped_max(_t(vals), _t(gid), _t(mask), ng).numpy())
    _same(got[1].numpy(), ops.grouped_min(_t(vals), _t(gid), _t(mask), ng).numpy())
    _same(got[2].numpy(), ops.grouped_extreme(_t(wide), _t(gid), _t(mask), ng, True).numpy())


def test_config5_like_query_makes_one_extremes_call_a_segment(monkeypatch):
    """Config 5's MIN, MAX, MINMAXRANGE and MAX of a quotient reach the
    extreme op as ONE grouped_extremes call per segment: four columns (the
    quotient as float64), five outputs."""
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.query import QueryEngine
    from pinot_tpu_torch.query import kernels as qk
    from pinot_tpu_torch.segment import SegmentBuilder

    schema = Schema.build(
        "lineorder",
        dimensions=[("d_year", DataType.INT), ("c_nation", DataType.STRING)],
        metrics=[("lo_revenue", DataType.LONG), ("lo_supplycost", DataType.LONG), ("lo_quantity", DataType.INT)],
    )
    segments = []
    for seed in range(3):
        rng = np.random.default_rng(seed)
        n = 3000
        data = {
            "d_year": rng.integers(1992, 1999, n).astype(np.int32),
            "c_nation": np.array([f"NATION_{i:02d}" for i in range(25)], dtype=object)[rng.integers(0, 25, n)],
            "lo_revenue": rng.integers(100, 600_000, n).astype(np.int64),
            "lo_supplycost": rng.integers(50, 100_000, n).astype(np.int64),
            "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        }
        segments.append(SegmentBuilder(schema).build(data, f"lineorder_{seed}"))
    calls = []
    real = qk.grouped_extremes

    def spy(columns, outputs, *args, **kw):
        calls.append(([c.dtype for c in columns], list(outputs)))
        return real(columns, outputs, *args, **kw)

    monkeypatch.setattr(qk, "grouped_extremes", spy)
    res = QueryEngine(segments, device="cpu").execute(
        "SELECT d_year, c_nation, COUNT(*), MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost), "
        "MAX(lo_revenue / lo_quantity) FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
        "GROUP BY d_year, c_nation ORDER BY d_year, c_nation LIMIT 200"
    )
    assert len(res.rows) == 125
    assert len(calls) == len(segments)
    for dtypes, outputs in calls:
        assert dtypes == [torch.int32, torch.int32, torch.int32, torch.float64]
        assert outputs == [(0, True), (1, False), (2, True), (2, False), (3, False)]


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def test_cpu_path_never_counts_a_launch():
    vals, gid, mask = _inputs(1, 16, n=500)
    before = (extreme.grouped_extremes.launches, grouped_sum_f32.grouped_sum.launches, grouped_sum_f32.presence.launches)
    ops.grouped_min(_t(vals), _t(gid), _t(mask), 16)
    ops.grouped_extremes([_t(vals)], [(0, True), (0, False)], _t(gid), _t(mask), 16)
    ops.grouped_sum(_t(vals), _t(gid), _t(mask), 16)
    ops.grouped_count(_t(gid), _t(mask), 16)
    ops.presence(_t(gid), _t(mask), 16)
    ops.presence(_t(gid), _t(mask), 16, gid=_t(gid), ng=16)
    after = (extreme.grouped_extremes.launches, grouped_sum_f32.grouped_sum.launches, grouped_sum_f32.presence.launches)
    assert after == before


_I = dict(dtype=torch.int32)


@pytest.mark.parametrize(
    "call",
    [
        lambda: ops.grouped_min(torch.zeros(8), torch.zeros(8, dtype=torch.int64), torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.grouped_max(torch.zeros(8), torch.zeros(8, **_I), torch.ones(8, dtype=torch.int32), 4),
        lambda: ops.grouped_min(torch.zeros(9), torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.grouped_min(torch.zeros(8), torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 0),
        # int32 values need the per-group counts
        lambda: ops.grouped_extreme(torch.zeros(8, **_I), torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4, True),
        lambda: ops.grouped_extreme(torch.zeros(8, dtype=torch.int64), torch.zeros(8, **_I),
                                    torch.ones(8, dtype=torch.bool), 4, True),
        # grouped_extremes: an output past the columns, no outputs, an int32
        # column's MIN without the counts, a float16 column
        lambda: ops.grouped_extremes([torch.zeros(8)], [(1, True)], torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.grouped_extremes([torch.zeros(8)], [], torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.grouped_extremes([torch.zeros(8), torch.zeros(8, **_I)], [(0, True), (1, True)],
                                     torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.grouped_extremes([torch.zeros(8, dtype=torch.float16)], [(0, True)], torch.zeros(8, **_I),
                                     torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.grouped_sum(torch.zeros(8), torch.zeros(8, **_I), torch.ones(7, dtype=torch.bool), 4),
        lambda: ops.grouped_count(torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), -1),
        lambda: ops.presence(torch.zeros(8, dtype=torch.int64), torch.ones(8, dtype=torch.bool), 4),
        lambda: ops.presence(torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 0),
        lambda: ops.presence(torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4, ng=3),
        lambda: ops.presence(torch.zeros(8, **_I), torch.ones(8, dtype=torch.bool), 4, gid=torch.zeros(7, **_I), ng=3),
    ],
)
def test_rejects_bad_inputs(call):
    with pytest.raises(ValueError):
        call()


def test_other_devices_raise():
    i = torch.zeros(8, dtype=torch.int32, device="meta")
    m = torch.zeros(8, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.grouped_min(torch.zeros(8, device="meta"), i, m, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.grouped_extremes([torch.zeros(8, device="meta")], [(0, False)], i, m, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.grouped_count(i, m, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.presence(i, m, 4)
