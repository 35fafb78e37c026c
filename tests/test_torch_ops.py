"""The port's ops API (pinot_tpu_torch/ops/extreme.py, ops/grouped_sum_f32.py)
against the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_pallas_ops.py runs them, and the engine's forms of the same
functions against the reference engine's XLA reductions
(pinot_tpu/query/kernels.py). Inputs come from numpy with a seed and go to
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
# wrappers
# ---------------------------------------------------------------------------


def test_cpu_path_never_counts_a_launch():
    vals, gid, mask = _inputs(1, 16, n=500)
    before = (extreme.grouped_extreme.launches, grouped_sum_f32.grouped_sum.launches, grouped_sum_f32.presence.launches)
    ops.grouped_min(_t(vals), _t(gid), _t(mask), 16)
    ops.grouped_sum(_t(vals), _t(gid), _t(mask), 16)
    ops.grouped_count(_t(gid), _t(mask), 16)
    ops.presence(_t(gid), _t(mask), 16)
    ops.presence(_t(gid), _t(mask), 16, gid=_t(gid), ng=16)
    after = (extreme.grouped_extreme.launches, grouped_sum_f32.grouped_sum.launches, grouped_sum_f32.presence.launches)
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
        ops.grouped_count(i, m, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.presence(i, m, 4)
