"""Device-side shuffle: the HASH_DISTRIBUTED exchange tier across a mesh's
slots.

Reference parity: Pinot's multistage exchange strategies
(pinot-query-runtime/.../runtime/operator/exchange/BlockExchange.java:41,50-59
— SINGLETON / HASH_DISTRIBUTED / RANDOM_DISTRIBUTED / BROADCAST_DISTRIBUTED)
move DataBlock pages between workers over gRPC mailboxes. For stages on the
same mesh the JAX package's `parallel/shuffle.py` redesigns that hop as
`lax.all_to_all` inside `shard_map`; this is its port over the slots of
`parallel.mesh.Mesh`, one process driving every slot (single-controller, as
the reference). Each slot buckets its rows by destination = hash(key) mod D
into equal-capacity send buffers (the reference's one-hot-cumsum rank, so a
row lands in the same slot and position as there), and the all-to-all is
slot d's bucket d' copied to devices[d'] (a no-op copy where two slots share
a device). Three exchange shapes:

- `hash_exchange`: row-level HASH exchange of column payloads (the
  BlockExchange HASH_DISTRIBUTED analog for join repartition).
- `exchange_group_partials`: dense group-partial repartition: each slot owns
  one contiguous range of the group space, reduces it, and the ranges are
  gathered back to every slot.
- `mesh_equi_join`: repartition both join sides by key, per-slot stable sort
  + searchsorted probe (LookupJoinOperator-style FK->PK join,
  pinot-query-runtime/.../runtime/operator/LookupJoinOperator.java).

Static-shape discipline as the reference's: per-destination capacity bounds
the send buffers; overflow is counted on the device and surfaces to the
caller, which retries at the safe capacity (the local row count) or declines.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from pinot_tpu_torch.common.kernel_obs import KERNELS
from pinot_tpu_torch.query.sketches import mix32

# One exchange at a time: the multistage engine's stage workers call
# mesh_equi_join concurrently (one hash partition a worker), and the
# reference serialises every collective launch across its mesh. Here it also
# keeps the registry's event pair over one exchange.
_COLLECTIVE_LAUNCH_LOCK = threading.Lock()

_M32 = 0xFFFFFFFF


def _hash64(x: torch.Tensor) -> torch.Tensor:
    """Full-width key hash (the reference's `_hash64` over `jnp_mix32`, bit
    for bit): mix32(lo32 ^ mix32(hi32)) as an int64 tensor of uint32 words.
    Hashing both halves matters: float64-bitcast integer keys carry all their
    entropy in the high word."""
    xi = x.to(torch.int64)
    return mix32((xi & _M32) ^ mix32((xi >> 32) & _M32))


def _bucket_pack(cols: tuple, key: torch.Tensor, valid: torch.Tensor, n_dest: int, capacity: int):
    """Pack rows into (n_dest * capacity) send slots by destination slot.
    Returns (packed_cols, packed_valid, n_dropped). Rows overflowing a
    destination's capacity are dropped and counted. The rank within a bucket
    is the reference's one-hot cumsum over the destination matrix: a row's
    position is the count of earlier rows bound for its destination."""
    dev = key.device
    dest = torch.remainder(_hash64(key), n_dest)
    dest = torch.where(valid, dest, n_dest)
    # (D, n), rows scanned along the contiguous axis: a scan down the rows of
    # an (n, D) matrix runs one thread a column on the card
    onehot = (dest[None, :] == torch.arange(n_dest, device=dev)[:, None]).to(torch.int32)
    rank = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1  # rank within each bucket
    posn = torch.where(onehot > 0, rank, 0).sum(dim=0)
    live = dest < n_dest
    ok = live & (posn < capacity)
    # dropped rows scatter to one spare slot past the buffer, cut off after
    slot = torch.where(ok, dest * capacity + posn, n_dest * capacity)
    dropped = (live & (posn >= capacity)).sum(dtype=torch.int64)
    size = n_dest * capacity + 1
    packed = tuple(torch.zeros(size, dtype=c.dtype, device=dev).scatter_(0, slot, c)[:-1] for c in cols)
    pvalid = torch.zeros(size, dtype=torch.bool, device=dev).scatter_(0, slot, ok)[:-1]
    return packed, pvalid, dropped


def hash_exchange(cols: list, keys: list, valid: list, devices: tuple, capacity: int):
    """Row-level HASH_DISTRIBUTED exchange across the D slots: `cols[d]` is
    slot d's tuple of columns, `keys[d]` and `valid[d]` its key and row
    validity. Each slot sends every row to slot hash(key) % D. Returns
    (received cols, received valid, total dropped): slot d's received arrays
    are (D * capacity,), capacity rows from each peer in peer order, on
    devices[d]; the dropped count (on devices[0]) sums every slot's."""
    n_dest = len(devices)
    packs = [_bucket_pack(c, k, v, n_dest, capacity) for c, k, v in zip(cols, keys, valid)]
    recv_cols, recv_valid = [], []
    for d, dev in enumerate(devices):
        own = slice(d * capacity, (d + 1) * capacity)
        recv_cols.append(
            tuple(torch.cat([p[0][i][own].to(dev) for p in packs]) for i in range(len(packs[0][0])))
        )
        recv_valid.append(torch.cat([p[1][own].to(dev) for p in packs]))
    dropped = packs[0][2].to(devices[0])
    for p in packs[1:]:
        dropped = dropped + p[2].to(devices[0])
    return recv_cols, recv_valid, dropped


def exchange_group_partials(partials: list, devices: tuple) -> list:
    """Dense group-partial HASH exchange: split the group space into D
    contiguous ranges, send slot d every peer's block of range d, reduce it
    there, then gather the owned ranges back to every slot. Equal to the sum
    of the partials, but the reduction and the copies follow the exchange
    pattern (each slot owns a group range: the multistage partial-aggregate
    repartition). `partials[d]` is slot d's (ng,) vector, ng % D == 0;
    returns each slot's full (ng,) vector on its device."""
    n_dest = len(devices)
    ng = partials[0].shape[0]
    if ng % n_dest:
        raise ValueError(f"exchange_group_partials: {ng} groups over {n_dest} slots")
    blocks = [p.reshape(n_dest, ng // n_dest) for p in partials]
    owned = [torch.stack([b[d].to(dev) for b in blocks]).sum(dim=0) for d, dev in enumerate(devices)]
    return [torch.cat([o.to(dev) for o in owned]) for dev in devices]


def _join_kernel(devices: tuple, capacity: int, kdt: torch.dtype):
    """The mesh equi-join: hash-repartition both sides, then per slot a
    stable sort of the received right keys and a searchsorted probe. Right
    keys must be unique (FK->PK lookup join). run(lk, lidx, rk, ridx), each a
    list of the slots' tensors, returns (left idx, right idx, hit) over every
    slot's received left rows, concatenated in slot order on devices[0], and
    (dropped, duplicate right keys) as a 2-vector there."""
    n_dest = len(devices)
    big = torch.iinfo(kdt).max

    def run(lk, lidx, rk, ridx):
        lcols, lvalid, ldrop = hash_exchange(
            [(k, i) for k, i in zip(lk, lidx)], lk, [i >= 0 for i in lidx], devices, capacity
        )
        rcols, rvalid, rdrop = hash_exchange(
            [(k, i) for k, i in zip(rk, ridx)], rk, [i >= 0 for i in ridx], devices, capacity
        )
        lis, ris, hits, dups = [], [], [], []
        for d in range(n_dest):
            lk2, lidx2 = lcols[d]
            rk2, ridx2 = rcols[d]
            rv0 = rvalid[d]
            # empty receive slots carry the sentinel key (the host wrapper
            # declines a right side holding it), so ONE stable sort puts them
            # last; hits still check slot validity, so a sentinel LEFT key
            # never matches padding
            rkey_s = torch.where(rv0, rk2, big)
            order = torch.argsort(rkey_s, stable=True)
            rs = rkey_s[order]
            rv = rv0[order]
            # equal keys hash to one slot, so a local adjacency check sees
            # every duplicate pair
            dups.append(((rs[1:] == rs[:-1]) & rv[1:] & rv[:-1]).sum(dtype=torch.int64))
            pos = torch.clamp(torch.searchsorted(rs, lk2), 0, rs.shape[0] - 1)
            hit = (rs[pos] == lk2) & lvalid[d] & rv[pos]
            lis.append(lidx2)
            ris.append(torch.where(hit, ridx2[order][pos], -1))
            hits.append(hit)
        dest = devices[0]
        dup = dups[0].to(dest)
        for x in dups[1:]:
            dup = dup + x.to(dest)
        cat = lambda xs: torch.cat([x.to(dest) for x in xs])  # noqa: E731
        return cat(lis), cat(ris), cat(hits), torch.stack([ldrop + rdrop, dup])

    return run


def _shardify(keys: np.ndarray, kdt: np.dtype, devices: tuple):
    """A join side as D equal slot blocks: the keys (padded with the
    sentinel, the kdt maximum) and their row indices (padding -1), slot d's
    block on devices[d], and the block length (a power of two, at least 64:
    the reference's bucket, which bounds its compiled shapes)."""
    n_dest = len(devices)
    n = len(keys)
    per = 1 << max(6, int(np.ceil(np.log2(-(-max(n, 1) // n_dest))))) if n else 64
    kp = np.full(n_dest * per, np.iinfo(kdt).max, dtype=kdt)
    ip = np.full(n_dest * per, -1, dtype=np.int32)
    kp[:n] = keys.astype(kdt)
    ip[:n] = np.arange(n, dtype=np.int32)
    kb = [torch.from_numpy(kp[d * per : (d + 1) * per]).to(dev) for d, dev in enumerate(devices)]
    ib = [torch.from_numpy(ip[d * per : (d + 1) * per]).to(dev) for d, dev in enumerate(devices)]
    return kb, ib, per


def mesh_equi_join(lk: np.ndarray, rk: np.ndarray, mesh=None) -> "tuple[np.ndarray, np.ndarray] | None":
    """Inner equi-join of two integer key arrays through the slots' hash
    exchange. Returns (l_idx, r_idx) matched-pair index arrays, by receiving
    slot and then by the slot each row came from (the reference's order), or
    None when the shape can't ride this path: a one-slot mesh, non-integer
    keys, a right key equal to the padding sentinel, duplicate right keys
    (detected on the device), or a capacity overflow after the retry at the
    safe capacity. Contract of multistage.runtime._device_equi_join."""
    if mesh is None:
        from pinot_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh()
    devices = mesh.devices
    n_dest = len(devices)
    if n_dest < 2:
        return None
    if not (np.issubdtype(lk.dtype, np.integer) and np.issubdtype(rk.dtype, np.integer)):
        return None
    kdt = np.promote_types(lk.dtype, rk.dtype)
    if kdt not in (np.dtype(np.int32), np.dtype(np.int64)):
        kdt = np.dtype(np.int64)
    if len(rk) and bool((rk.astype(kdt) == np.iinfo(kdt).max).any()):
        # a build key at the padding sentinel after the kdt cast would be
        # indistinguishable from empty receive slots in the sorted probe
        return None
    tdt = torch.from_numpy(np.empty(0, kdt)).dtype

    with _COLLECTIVE_LAUNCH_LOCK:
        lkd, lid, lc = _shardify(lk, kdt, devices)
        rkd, rid, rc = _shardify(rk, kdt, devices)
        # worst case one slot receives everything both sides hold for one
        # destination: start at balanced x2, retry once at the safe bound
        cap0 = 1 << max(6, int(np.ceil(np.log2(max(1, -(-2 * max(lc, rc) // n_dest))))))
        for capacity in (cap0, max(lc, rc)):
            run = _join_kernel(devices, int(capacity), tdt)

            def program(run=run):
                li, ri, hit, stats = run(lkd, lid, rkd, rid)
                # the pairs leave the device compacted: only hits are copied
                return [stats.to(torch.float64), li[hit], ri[hit]]

            stats, li, ri = KERNELS.timed_sync("exchange.join", program, devices[0], rows=n_dest * int(capacity))
            drops, dups = int(stats[0]), int(stats[1])
            if dups > 0:
                return None  # many-to-many: the single-device range probe handles it
            if drops == 0:
                return li, ri
    return None


# -- kernel registry: cost model for the roofline report ---------------------
#
# rows = the exchanged buffer slots (n_dest * capacity). Both sides' key + idx
# columns cross twice (send + receive), and the per-slot probe is
# sort-dominated: ~2 * rows * log2(rows) compares / moves.


def _join_cost(shape: dict) -> tuple[float, float]:
    rows = max(float(shape.get("rows", 0)), 1.0)
    return rows * (8.0 + 4.0) * 2.0 * 2.0, rows * 2.0 * max(float(np.log2(rows)), 1.0)


KERNELS.register(
    "exchange.join",
    _join_kernel,
    cost_model=_join_cost,
    description="mesh equi-join: hash exchange across the slots + sorted probe",
)
