"""The port's exact group-by (pinot_tpu_torch/ops/groupby.py) against the JAX
package's Pallas byte-plane kernel, run in interpret mode on the CPU as
tests/test_pallas_ops.py runs it. Inputs come from numpy with a seed and go
to both packages; sums and counts must be exactly equal.

The CUDA kernel itself runs only on a card; chip_smoke.py holds it against
the plain version there.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pinot_tpu.ops.groupby_pallas import pallas_grouped_multi_sum
from pinot_tpu_torch.ops import groupby as gb

I32 = np.iinfo(np.int32)


def _inputs(seed, n, k, ng, extremes=False, mask_p=0.7):
    rng = np.random.default_rng(seed)
    if extremes:
        pool = np.array([I32.min, I32.max, -1, 0, 1], dtype=np.int64)
        values = [rng.choice(pool, n).astype(np.int32) for _ in range(k)]
    else:
        values = [rng.integers(-600_000, 600_001, n).astype(np.int32) for _ in range(k)]
    gid = rng.integers(0, ng, n).astype(np.int32)
    mask = rng.random(n) < mask_p
    return values, gid, mask


def _jax(values, gid, mask, ng):
    sums, counts = pallas_grouped_multi_sum(
        [jnp.asarray(v) for v in values], jnp.asarray(gid), jnp.asarray(mask), ng
    )
    return [np.asarray(s) for s in sums], np.asarray(counts)


def _port(values, gid, mask, ng):
    sums, counts = gb.grouped_multi_sum(
        [torch.from_numpy(v) for v in values], torch.from_numpy(gid), torch.from_numpy(mask), ng
    )
    return [s.numpy() for s in sums], counts.numpy()


def _assert_same(values, gid, mask, ng):
    js, jc = _jax(values, gid, mask, ng)
    ps, pc = _port(values, gid, mask, ng)
    assert pc.dtype == np.int64 and np.array_equal(pc, jc)
    assert len(ps) == len(js)
    for p, j in zip(ps, js):
        assert p.dtype == np.float64 and np.array_equal(p, j)


@pytest.mark.parametrize("ng", [37, 256, 4608])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_matches_pallas_kernel(k, ng):
    values, gid, mask = _inputs(10 * k + ng, 5000, k, ng)
    _assert_same(values, gid, mask, ng)


@pytest.mark.parametrize("k", [1, 3])
def test_int32_extremes(k):
    values, gid, mask = _inputs(7, 5000, k, 256, extremes=True)
    _assert_same(values, gid, mask, 256)


def test_empty_mask():
    values, gid, mask = _inputs(3, 5000, 2, 256, mask_p=0.0)
    _assert_same(values, gid, mask, 256)
    ps, pc = _port(values, gid, mask, 256)
    assert not pc.any() and not any(p.any() for p in ps)


def test_out_of_range_gids_contribute_nothing():
    values, gid, mask = _inputs(5, 5000, 2, 64)
    gid[::7] = -3
    gid[1::11] = 64 + 9
    ps, pc = _port(values, gid, mask, 64)
    ok = mask & (gid >= 0) & (gid < 64)
    assert np.array_equal(pc, np.bincount(gid[ok], minlength=64))
    for p, v in zip(ps, values):
        want = np.zeros(64, dtype=np.int64)
        np.add.at(want, gid[ok], v[ok].astype(np.int64))
        assert np.array_equal(p, want.astype(np.float64))


def test_plain_version_layout():
    values, gid, mask = _inputs(9, 1000, 2, 16)
    out = gb.grouped_multi_sum_plain(
        [torch.from_numpy(v) for v in values], torch.from_numpy(gid), torch.from_numpy(mask), 16
    )
    assert out.shape == (3, 16) and out.dtype == torch.int64
    assert out[2].sum().item() == int(mask.sum())


def test_cpu_path_never_counts_a_launch():
    before = gb.grouped_multi_sum.launches
    values, gid, mask = _inputs(1, 1000, 1, 16)
    _port(values, gid, mask, 16)
    assert gb.grouped_multi_sum.launches == before


@pytest.mark.parametrize(
    "bad",
    [
        dict(gid=torch.zeros(8, dtype=torch.int64)),
        dict(mask=torch.zeros(8, dtype=torch.int32)),
        dict(values=[torch.zeros(8, dtype=torch.int64)]),
        dict(values=[torch.zeros(9, dtype=torch.int32)]),
        dict(ng=0),
    ],
)
def test_rejects_bad_inputs(bad):
    args = dict(values=[torch.zeros(8, dtype=torch.int32)], gid=torch.zeros(8, dtype=torch.int32),
                mask=torch.ones(8, dtype=torch.bool), ng=4)
    args.update(bad)
    with pytest.raises(ValueError):
        gb.grouped_multi_sum(args["values"], args["gid"], args["mask"], args["ng"])


def test_other_devices_raise():
    t = torch.zeros(8, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        gb.grouped_multi_sum([], t, torch.zeros(8, dtype=torch.bool, device="meta"), 4)
