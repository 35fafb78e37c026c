"""The port's hash exchange across mesh slots (pinot_tpu_torch/parallel/
shuffle.py) against the JAX package's over its virtual CPU devices.

Every case of tests/test_shuffle.py runs on the same seeded numpy inputs
through both: the reference inside `shard_map` over a mesh of the first D of
the conftest's 8 CPU devices, the port over `make_mesh(("cpu",) * D)`, at
D = 2, 4 and 8. `_hash64` and `_bucket_pack` are bit-equal; every slot
receives the reference's rows in the reference's order; `mesh_equi_join`
returns the reference's pairs in the reference's order (by receiving slot,
then by the slot each row came from) and declines where it declines. The
dense group-partial exchange is held to rtol 1e-12 (a float sum in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pinot_tpu.parallel import shuffle as jshuffle
from pinot_tpu.parallel.compat import shard_map
from pinot_tpu_torch.common.kernel_obs import KERNELS
from pinot_tpu_torch.parallel import make_mesh
from pinot_tpu_torch.parallel import shuffle

SLOTS = (2, 4, 8)


def jmesh(d: int) -> Mesh:
    return Mesh(np.asarray(jax.devices()[:d]), ("shuf",))


def pmesh(d: int):
    return make_mesh(("cpu",) * d)


def mix32(h):
    h = h.astype(np.uint32)
    h ^= h >> np.uint32(16)
    h *= np.uint32(0x85EBCA6B)
    h ^= h >> np.uint32(13)
    h *= np.uint32(0xC2B2AE35)
    h ^= h >> np.uint32(16)
    return h


def host_dest(keys: np.ndarray, d: int) -> np.ndarray:
    k64 = keys.astype(np.int64)
    lo = (k64 & 0xFFFFFFFF).astype(np.uint32)
    hi = ((k64 >> 32) & 0xFFFFFFFF).astype(np.uint32)
    return (mix32(lo ^ mix32(hi)) % np.uint32(d)).astype(np.int32)


def test_hash64_is_bit_equal():
    rng = np.random.default_rng(4)
    for keys in (
        rng.integers(-(1 << 62), 1 << 62, 5000).astype(np.int64),
        rng.integers(-(1 << 31), (1 << 31) - 1, 5000).astype(np.int32),
        np.array([0, -1, 1, np.iinfo(np.int64).max, np.iinfo(np.int64).min], dtype=np.int64),
        np.arange(1.0, 1025.0).view(np.int64),
    ):
        want = np.asarray(jshuffle._hash64(jnp.asarray(keys))).astype(np.int64)
        got = shuffle._hash64(torch.from_numpy(keys)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d", SLOTS)
@pytest.mark.parametrize("capacity", [8, 64, 1024])
def test_bucket_pack_is_bit_equal(d, capacity):
    rng = np.random.default_rng(capacity + d)
    n = 700
    keys = rng.integers(0, 1 << 40, n).astype(np.int64)
    vals = rng.integers(-1000, 1000, n).astype(np.int32)
    valid = rng.random(n) < 0.9
    jp, jv, jd = jshuffle._bucket_pack((jnp.asarray(keys), jnp.asarray(vals)), jnp.asarray(keys), jnp.asarray(valid), d, capacity)
    pp, pv, pdrop = shuffle._bucket_pack(
        (torch.from_numpy(keys), torch.from_numpy(vals)), torch.from_numpy(keys), torch.from_numpy(valid), d, capacity
    )
    for a, b in zip(pp, jp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))
    assert int(pdrop) == int(jd)


def _ref_exchange(d: int, keys: np.ndarray, vals: np.ndarray, capacity: int):
    """The reference's hash_exchange inside shard_map over d devices."""
    n_local = len(keys) // d
    mesh = jmesh(d)
    sharding = NamedSharding(mesh, P("shuf", None))
    kd = jax.device_put(keys.reshape(d, n_local), sharding)
    vd = jax.device_put(vals.reshape(d, n_local), sharding)

    def per_shard(k, v):
        k, v = k.reshape(-1), v.reshape(-1)
        (k2, v2), valid, dropped = jshuffle.hash_exchange((k, v), k, jnp.ones_like(k, dtype=bool), "shuf", d, capacity)
        return k2[None], v2[None], valid[None], dropped[None]

    f = jax.jit(
        shard_map(per_shard, mesh=mesh, in_specs=(P("shuf", None), P("shuf", None)), out_specs=P("shuf"), check_vma=False)
    )
    return tuple(np.asarray(x) for x in f(kd, vd))


def _port_exchange(d: int, keys: np.ndarray, vals: np.ndarray, capacity: int):
    devices = pmesh(d).devices
    n_local = len(keys) // d
    kb = [torch.from_numpy(keys[i * n_local : (i + 1) * n_local]) for i in range(d)]
    vb = [torch.from_numpy(vals[i * n_local : (i + 1) * n_local]) for i in range(d)]
    cols, valid, dropped = shuffle.hash_exchange(
        [(k, v) for k, v in zip(kb, vb)], kb, [torch.ones_like(k, dtype=torch.bool) for k in kb], devices, capacity
    )
    return cols, valid, int(dropped)


@pytest.mark.parametrize("d", SLOTS)
def test_hash_exchange_delivers_every_row(d):
    """Every valid row arrives exactly once, at the slot its key hashes to,
    in the reference's position."""
    n_local = 128
    rng = np.random.default_rng(0)
    keys = rng.integers(0, 1 << 30, d * n_local).astype(np.int32)
    vals = np.arange(d * n_local, dtype=np.int32)
    cols, valid, dropped = _port_exchange(d, keys, vals, n_local)
    assert dropped == 0
    got = sorted(v for (k2, v2), m in zip(cols, valid) for v in v2[m].tolist())
    assert got == vals.tolist()
    want_dest = host_dest(keys, d)
    for s in range(d):
        assert set(cols[s][1][valid[s]].tolist()) == set(vals[want_dest == s].tolist())
    jk, jv, jvalid, jdrop = _ref_exchange(d, keys, vals, n_local)
    assert int(np.max(jdrop)) == dropped
    for s in range(d):
        np.testing.assert_array_equal(cols[s][0].numpy(), jk[s])
        np.testing.assert_array_equal(cols[s][1].numpy(), jv[s])
        np.testing.assert_array_equal(valid[s].numpy(), jvalid[s])


@pytest.mark.parametrize("d", SLOTS)
def test_hash_exchange_overflow_detected(d):
    """All keys equal: every row targets ONE slot; a small capacity reports
    the drops, as the reference's psum'd count does."""
    n_local = 64
    keys = np.zeros(d * n_local, dtype=np.int32)
    _, _, dropped = _port_exchange(d, keys, keys.copy(), 8)
    assert dropped == d * (n_local - 8)
    assert int(np.max(_ref_exchange(d, keys, keys.copy(), 8)[3])) == dropped


@pytest.mark.parametrize("d", SLOTS)
def test_exchange_group_partials_matches_sum(d):
    ng = 256
    rng = np.random.default_rng(3)
    parts = rng.standard_normal((d, ng))
    devices = pmesh(d).devices
    out = shuffle.exchange_group_partials([torch.from_numpy(parts[i]) for i in range(d)], devices)
    mesh = jmesh(d)
    f = jax.jit(
        shard_map(
            lambda p: jshuffle.exchange_group_partials(p.reshape(-1), "shuf", d)[None],
            mesh=mesh,
            in_specs=(P("shuf", None),),
            out_specs=P("shuf"),
            check_vma=False,
        )
    )
    ref = np.asarray(f(jax.device_put(parts, NamedSharding(mesh, P("shuf", None)))))
    for s in range(d):
        np.testing.assert_allclose(out[s].numpy(), parts.sum(axis=0), rtol=1e-12)
        np.testing.assert_allclose(out[s].numpy(), ref[s], rtol=1e-12)
    with pytest.raises(ValueError):
        shuffle.exchange_group_partials([torch.zeros(ng + 1)] * d, devices)


def _same_pairs(got, want):
    assert (got is None) == (want is None)
    if got is not None:
        np.testing.assert_array_equal(got[0], np.asarray(want[0]))
        np.testing.assert_array_equal(got[1], np.asarray(want[1]))


@pytest.mark.parametrize("d", SLOTS)
def test_mesh_equi_join_fk_pk(d):
    """FK->PK join repartitioned over the slots: the reference's pairs in
    the reference's order, and the numpy join's pairs as a set."""
    rng = np.random.default_rng(11)
    n_r, n_l = 5_000, 40_000
    rk = rng.permutation(np.arange(0, 4 * n_r, 4, dtype=np.int64))
    lk = rng.integers(0, 4 * n_r, n_l).astype(np.int64)
    out = shuffle.mesh_equi_join(lk, rk, pmesh(d))
    _same_pairs(out, jshuffle.mesh_equi_join(lk, rk, jmesh(d)))
    li, ri = out
    assert np.array_equal(lk[li], rk[ri])
    assert len(li) == int(np.isin(lk, rk).sum()) == len(np.unique(li))


@pytest.mark.parametrize("d", SLOTS)
def test_mesh_equi_join_declines(d):
    """A duplicate right key (found on the device), a one-slot mesh and
    non-integer keys decline, as the reference's do."""
    lk = np.arange(100, dtype=np.int64)
    rk = np.array([1, 1, 2], dtype=np.int64)
    assert shuffle.mesh_equi_join(lk, rk, pmesh(d)) is None is jshuffle.mesh_equi_join(lk, rk, jmesh(d))
    assert shuffle.mesh_equi_join(lk, np.array([1, 2]), pmesh(1)) is None
    assert shuffle.mesh_equi_join(lk.astype(np.float64), np.array([1.0, 2.0]), pmesh(d)) is None


@pytest.mark.parametrize("d", SLOTS)
def test_mesh_equi_join_skewed_keys(d):
    """All left keys hash to one slot: the retry at the safe capacity still
    delivers the whole join."""
    rk = np.arange(64, dtype=np.int64)
    lk = np.full(10_000, 7, dtype=np.int64)
    out = shuffle.mesh_equi_join(lk, rk, pmesh(d))
    _same_pairs(out, jshuffle.mesh_equi_join(lk, rk, jmesh(d)))
    assert len(out[0]) == 10_000 and np.all(rk[out[1]] == 7)


def test_mesh_equi_join_retries_after_an_overflow(monkeypatch):
    """The first capacity overflows and is counted; the retry succeeds."""
    calls = []
    real = shuffle._join_kernel
    monkeypatch.setattr(
        shuffle, "_join_kernel", lambda dev, lc, rc, cap, dt: calls.append(cap) or real(dev, lc, rc, cap, dt)
    )
    lk = np.full(10_000, 7, dtype=np.int64)
    out = shuffle.mesh_equi_join(lk, np.arange(64, dtype=np.int64), pmesh(4))
    assert out is not None and len(out[0]) == 10_000
    assert len(calls) == 2 and calls[1] > calls[0]


def test_join_kernel_cache_hits_and_misses_as_the_reference():
    """One sequence of joins through both packages: three left lengths in
    one pow-2 block bucket share a builder, one in another bucket and the
    skewed join's retry at the safe capacity add builders, and a repeat of
    the sequence hits every time; both caches count alike."""
    rng = np.random.default_rng(21)
    rk = rng.permutation(np.arange(0, 1024, 4, dtype=np.int64))
    joins = [rng.integers(0, 1024, n).astype(np.int64) for n in (3000, 3500, 4000, 9000)]
    joins.append(np.full(4000, 8, dtype=np.int64))  # every row to one slot: a retry
    shuffle._join_kernel.cache_clear()
    jshuffle._join_kernel.cache_clear()
    seen = []
    for lk in joins + joins:
        _same_pairs(shuffle.mesh_equi_join(lk, rk, pmesh(4)), jshuffle.mesh_equi_join(lk, rk, jmesh(4)))
        mine, ref = shuffle._join_kernel.cache_info(), jshuffle._join_kernel.cache_info()
        assert (mine.hits, mine.misses, mine.currsize) == (ref.hits, ref.misses, ref.currsize)
        seen.append((mine.hits, mine.misses))
    # the bucket's three joins: one miss, two hits; 9000 and the retry miss
    assert seen[:5] == [(0, 1), (1, 1), (2, 1), (2, 2), (3, 3)]
    assert seen[-1] == (9, 3)


@pytest.mark.parametrize("d", SLOTS)
@pytest.mark.parametrize("kdt", [np.int32, np.int64])
def test_captured_body_over_a_cpu_slab_equals_eager_and_reference(d, kdt):
    """The body a card's graph captures, run on the CPU over the operand
    slab an OperandBinding lays out: its compacted pairs and stats equal the
    eager join's and the reference's pairs, in order."""
    from pinot_tpu_torch.query.kernels import OperandBinding

    rng = np.random.default_rng(d * 10 + np.dtype(kdt).itemsize)
    rk = rng.permutation(np.arange(0, 12_000, 3)).astype(kdt)
    lk = rng.integers(0, 12_000, 30_000).astype(kdt)
    devices = pmesh(d).devices
    tdt = torch.from_numpy(np.empty(0, kdt)).dtype
    lkp, lip, lc = shuffle._shardify(lk, np.dtype(kdt), d)
    rkp, rip, rc = shuffle._shardify(rk, np.dtype(kdt), d)
    host = (lkp, lip, rkp, rip)
    cap = max(lc, rc)
    binding = OperandBinding(host, "cpu")
    slab, ops = binding.bind("cpu")
    binding.fill(slab.numpy())
    run = shuffle._join_kernel(devices, lc, rc, cap, tdt)
    outs, info = shuffle._join_body(run, devices, lc, rc)(ops)
    assert info == {}
    stats, li, ri = shuffle._compact(outs)
    eager = shuffle._exchange_join(host, devices, lc, rc, cap, tdt)
    assert stats.tolist() == eager[0].tolist() == [0.0, 0.0]
    np.testing.assert_array_equal(li.numpy(), eager[1])
    np.testing.assert_array_equal(ri.numpy(), eager[2])
    _same_pairs((li.numpy(), ri.numpy()), jshuffle.mesh_equi_join(lk, rk, jmesh(d)))
    assert np.array_equal(lk[li.numpy()], rk[ri.numpy()]) and len(li) == int(np.isin(lk, rk).sum())


@pytest.mark.parametrize("d", SLOTS)
def test_mesh_equi_join_sentinel_key(d):
    """A left key at the padding sentinel (INT64_MAX) matches nothing; a
    right side holding it declines, and the runtime's one-device probe then
    answers."""
    from pinot_tpu_torch.multistage.runtime import _device_equi_join

    big = np.iinfo(np.int64).max
    lk = np.array([big, 1, 2, big, 5], dtype=np.int64)
    rk = np.array([1, 2, 3], dtype=np.int64)
    out = shuffle.mesh_equi_join(lk, rk, pmesh(d))
    _same_pairs(out, jshuffle.mesh_equi_join(lk, rk, jmesh(d)))
    assert np.array_equal(lk[out[0]], rk[out[1]]) and len(out[0]) == 2
    rk2 = np.array([1, big, 3], dtype=np.int64)
    assert shuffle.mesh_equi_join(lk, rk2, pmesh(d)) is None
    li2, ri2 = _device_equi_join(lk, rk2, force=True, device="cpu", mesh=pmesh(d))
    assert np.array_equal(lk[li2], rk2[ri2]) and int((lk[li2] == big).sum()) == 2


@pytest.mark.parametrize("d", SLOTS)
def test_hash_exchange_balances_f64_bitcast_keys(d):
    """Integer-valued doubles bitcast to int64 carry their entropy in the
    high word; the full-width hash still spreads them over every slot."""
    vals = np.arange(1.0, 4097.0, dtype=np.float64).view(np.int64)
    out = shuffle.mesh_equi_join(vals, vals[:256], pmesh(d))
    _same_pairs(out, jshuffle.mesh_equi_join(vals, vals[:256], jmesh(d)))
    assert len(out[0]) == 256
    assert len(np.unique(host_dest(vals, d))) == d


def test_multistage_join_rides_the_exchange(monkeypatch):
    """A multistage SQL equi-join above the device threshold goes through
    the exchange (float64 block keys bitcast to int64), in both packages."""
    from pinot_tpu.common import DataType as JDT
    from pinot_tpu.common import Schema as JSchema
    from pinot_tpu.multistage import MultistageEngine as JEngine
    from pinot_tpu.multistage import runtime as jrt
    from pinot_tpu.segment import SegmentBuilder as JBuilder
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.multistage import MultistageEngine
    from pinot_tpu_torch.multistage import runtime as rt
    from pinot_tpu_torch.segment import SegmentBuilder

    monkeypatch.setattr(rt, "DEVICE_JOIN_MIN", 1)
    monkeypatch.setattr(jrt, "DEVICE_JOIN_MIN", 1)
    rng = np.random.default_rng(1)
    fk = rng.integers(0, 200, 5_000).astype(np.int32)
    fm = rng.integers(1, 10, 5_000).astype(np.int64)
    dk = np.arange(200, dtype=np.int32)
    dw = rng.integers(1, 5, 200).astype(np.int64)

    def tables(DT, S, B):
        fact = B(S.build("fact", dimensions=[("k", DT.INT)], metrics=[("m", DT.LONG)])).build({"k": fk.copy(), "m": fm.copy()}, "f0")
        dim = B(S.build("dim", dimensions=[("k", DT.INT)], metrics=[("w", DT.LONG)])).build({"k": dk.copy(), "w": dw.copy()}, "d0")
        return {"fact": [fact], "dim": [dim]}

    ref = JEngine(tables(JDT, JSchema, JBuilder), n_workers=2)
    port = MultistageEngine(tables(DataType, Schema, SegmentBuilder), n_workers=2, device="cpu", mesh=pmesh(8))
    sql = "SELECT SUM(fact.m + dim.w) FROM fact JOIN dim ON fact.k = dim.k LIMIT 10"
    before = rt.DEVICE_OP_STATS.get("mesh_join", 0)
    got = port.execute(sql).rows
    assert rt.DEVICE_OP_STATS.get("mesh_join", 0) > before, "join skipped the exchange"
    assert got == ref.execute(sql).rows == [[float((fm + dw[fk]).sum())]]


def test_exchange_join_is_registered_and_recorded():
    """Each exchange attempt records one "exchange.join" call, priced by the
    reference's cost model at its buffer slots."""
    assert KERNELS.is_registered("exchange.join")
    KERNELS.reset_stats()
    lk = np.arange(1000, dtype=np.int64)
    shuffle.mesh_equi_join(lk, lk[:100], pmesh(4))
    stats = {k: v for k, v in KERNELS.stats_snapshot().items() if k[0] == "exchange.join"}
    assert sum(s["calls"] for s in stats.values()) == 1
    rows = 4 * 128  # 4 slots x cap0 = 2 x 256-row blocks / 4
    assert sum(s["bytesMoved"] for s in stats.values()) == shuffle._join_cost({"rows": rows})[0]
    KERNELS.reset_stats()
