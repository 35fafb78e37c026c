"""The sharded table and executor over a mesh of device slots: a whole table
stacked as (n_segments, padded_docs) tensors, split over the slots, and one
program a slot a query.

Reference parity: the JAX package's `parallel/mesh.py`, which replaces both of
Pinot's data-parallel tiers at once: the intra-server combine
(BaseCombineOperator.java:92-119, segment plans fanned across executor
threads) and the broker scatter/gather across servers (QueryRouter.submitQuery,
pinot-core/.../transport/QueryRouter.java:89). Unlike the per-segment engine
(per-segment dictionaries), a ShardedTable keeps TABLE-LEVEL dictionaries, so
group ids and LUT indices agree across segments and partials combine by plain
reductions, the analog of Pinot's partition-aware replica groups.

The mesh is single-controller, as the reference's is: a tuple of
`torch.device` slots in one process (the reference's `make_mesh` spans one
process's devices and `shard_map` runs every shard from it). A device may
hold several slots: the reference's tests run 8 virtual CPU devices, the port
runs `("cpu",) * 8`, and one card can hold `("cuda:0",) * 4`. Slot d holds
segments [d * S/D, (d + 1) * S/D) staged on its device. `_sharded_kernel`
flattens a slot's stacked segments into ONE doc vector with a validity mask
(aggregates are order-independent) and runs `build_masked_fn`'s program over
it once a slot (the exact group-by, extreme and presence kernels launch once a
slot; on a card the slot's program is a CUDA graph per table, slot and
operand signature, captured at its first call, as the reference jits
`_sharded_kernel`); `_combine_tree`, eager, then merges the slots' partials on the first slot's
device by each aggregate's rule, and every output goes into ONE float64
vector: a dense query makes one device->host copy, timed with its programs by
`KERNELS.timed_sync` under "exchange.sharded". A sparse group-by's slot
tables are each slot's own, so each slot packs and copies its table, and the
reduce merges them, as the reference's per-shard out_specs do. The query
plans once, on the proto segment (the whole table's dictionaries and stats).

A query shape the flat layout cannot carry (a GROUP BY over two MV keys,
whose per-doc tables index the proto's doc space, or any shape the planner
sends to the host) raises ProtoFallback or DeviceFallback, and
`execute_sharded_result` reruns it through the per-segment engine over the
proto, which holds the whole table (staged on the first slot's device as one
segment); so does a sparse group-by whose present groups overflow its U slots.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from pinot_tpu_torch.common.kernel_obs import KERNELS
from pinot_tpu_torch.common.types import Schema
from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.context import QueryContext, QueryType
from pinot_tpu_torch.query.kernels import (
    OperandBinding,
    _flatten,
    _unflatten,
    build_masked_fn,
    capture_counts,
    columns_key,
    compiled_graph,
    leaf_meta,
    pack,
    read_cloned,
    replay,
    stage_operands,
    unpack,
)
from pinot_tpu_torch.query.plan import DeviceFallback, SegmentPlan, plan_segment
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.segment import ImmutableSegment, padded_len


@dataclass(frozen=True)
class Mesh:
    """The device slots a sharded table spans, in one process; a device may
    hold several slots."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        """The first slot's device: the merge, the packed copy and the proto
        rerun run there."""
        return self.devices[0]


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices`: every visible CUDA device by default (the
    reference's `jax.devices()`), raising when there is no card; a list,
    which may repeat a device, gives the slots; one device is a one-slot
    mesh."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(): no CUDA device is available; pass the slots' devices, e.g. ('cpu',) * 4, to run on the CPU"
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
        raise ValueError("make_mesh: no devices")
    if any(d.type == "cuda" for d in devs) and not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device is available; pass device 'cpu' to run on the CPU")
    return Mesh(devs)


@dataclass
class ShardedTable:
    """A logical table stacked as (n_segments, padded_docs) tensors, slot d
    holding segments [d * S/D, (d + 1) * S/D) on its device. `proto` is a
    host-side segment of the whole table carrying the table-level
    dictionaries and stats the planner lowers against."""

    proto: ImmutableSegment
    mesh: Mesh
    #: col -> each slot's (S/D, P) stack; an MV column's flats (S/D, F_pad)
    arrays: dict[str, tuple[torch.Tensor, ...]]
    n_docs: tuple[torch.Tensor, ...]  # each slot's (S/D,) int32
    n_segments: int
    padded: int
    total_docs: int


def build_sharded_table(
    schema: Schema,
    data: dict[str, np.ndarray],
    mesh: Mesh,
    rows_per_segment: int | None = None,
    table_config=None,
) -> ShardedTable:
    """Split columnar data into equal segments (one a slot by default; their
    count rounded up to a multiple of the slots), build ONE table-level
    dictionary set, stack the forward arrays and stage each slot's share on
    its device."""
    n = len(next(iter(data.values())))
    n_dev = mesh.size
    if rows_per_segment is None:
        rows_per_segment = -(-n // n_dev)
    n_seg = max(1, -(-n // max(rows_per_segment, 1)))
    if n_seg % n_dev:
        n_seg += n_dev - n_seg % n_dev
    rows_per_segment = -(-n // n_seg)
    per_slot = n_seg // n_dev

    proto = SegmentBuilder(schema, table_config).build(data, "proto")
    pad = padded_len(rows_per_segment)
    if any(ci.is_mv for ci in proto.columns.values()) and pad == rows_per_segment:
        # an MV flat's padding carries docid pad - 1, which must be a doc slot
        # invalid in every segment
        pad = padded_len(rows_per_segment + 1)

    def stage(a: np.ndarray) -> tuple[torch.Tensor, ...]:
        return tuple(
            torch.from_numpy(a[d * per_slot : (d + 1) * per_slot]).to(dev) for d, dev in enumerate(mesh.devices)
        )

    arrays: dict[str, tuple[torch.Tensor, ...]] = {}
    for col, ci in proto.columns.items():
        if ci.is_mv:
            # each segment's flat id slice and its LOCAL owning-doc ids, both
            # padded to one F_pad; padding docids point at slot pad - 1, so a
            # padding value never reaches a doc mask or an aggregate
            off = ci.offsets()
            fdoc = ci.flat_docids()
            ids = ci.forward
            bounds = [
                (int(off[min(s * rows_per_segment, n)]), int(off[min((s + 1) * rows_per_segment, n)]))
                for s in range(n_seg)
            ]
            f_pad = padded_len(max(1, max(b - a for a, b in bounds)))
            st_ids = np.zeros((n_seg, f_pad), dtype=ids.dtype)
            st_docs = np.full((n_seg, f_pad), pad - 1, dtype=np.int32)
            for s, (a, b) in enumerate(bounds):
                st_ids[s, : b - a] = ids[a:b]
                st_docs[s, : b - a] = fdoc[a:b] - s * rows_per_segment
            arrays[col] = stage(st_ids)
            arrays[f"{col}!docs"] = stage(st_docs)
            continue
        fwd = ci.forward
        if fwd.dtype == np.int64 and len(fwd):
            # lossless narrowing (DeviceSegment staging parity), written back
            # to the proto: the planner's literal range checks read its dtype,
            # so an int64 literal outside int32 is decided at plan time, not
            # wrapped by the program's cast
            lo, hi = int(fwd.min()), int(fwd.max())
            if np.iinfo(np.int32).min <= lo and hi <= np.iinfo(np.int32).max:
                fwd = fwd.astype(np.int32)
                ci.forward = fwd
        stacked = np.zeros((n_seg, pad), dtype=fwd.dtype)
        for s in range(n_seg):
            chunk = fwd[s * rows_per_segment : (s + 1) * rows_per_segment]
            stacked[s, : len(chunk)] = chunk
        arrays[col] = stage(stacked)
    n_docs = np.asarray(
        [max(0, min(rows_per_segment, n - s * rows_per_segment)) for s in range(n_seg)], dtype=np.int32
    )
    return ShardedTable(
        proto=proto,
        mesh=mesh,
        arrays=arrays,
        n_docs=stage(n_docs),
        n_segments=n_seg,
        padded=pad,
        total_docs=n,
    )


# ---------------------------------------------------------------------------
# partial combination rules
# ---------------------------------------------------------------------------


def _tree_map(fn, x):
    return tuple(_tree_map(fn, y) for y in x) if isinstance(x, tuple) else fn(x)


def _tree_zip(fn, xs: list):
    """fn over the lists of corresponding leaves of equal-shaped trees."""
    if isinstance(xs[0], tuple):
        return tuple(_tree_zip(fn, [x[i] for x in xs]) for i in range(len(xs[0])))
    return fn(xs)


def _combine_tree(spec: tuple, matched: list, counts: list | None, parts: list, dest: torch.device):
    """Merge the slots' partials (one list entry a slot) on `dest` by each
    aggregate's rule: sums for counts, sums, averages and histograms; min /
    max for extremes and HLL registers, gathered then reduced, as the
    reference's all_gather + local reduce; OR for presence vectors; a
    null-handling SUM skips the slots that saw no non-null row."""

    def gather(xs):
        return torch.stack([x.to(dest) for x in xs])

    def red_sum(xs):
        out = xs[0].to(dest)
        for x in xs[1:]:
            out = out + x.to(dest)
        return out

    def red_min(xs):
        return gather(xs).amin(0)

    def red_max(xs):
        return gather(xs).amax(0)

    def red_or(xs):
        return gather([x.to(torch.int32) for x in xs]).amax(0).to(torch.bool)

    def red_nansum(xs):
        # NaN = no non-null row on that slot: skipped, and kept NaN where
        # every slot's is (NULL at the reduce)
        seen = red_sum([(~torch.isnan(x)).to(torch.int32) for x in xs])
        s = red_sum([torch.where(torch.isnan(x), 0.0, x) for x in xs])
        return torch.where(seen == 0, float("nan"), s)

    out_parts = []
    for i, a in enumerate(spec[3]):
        p = [slot[i] for slot in parts]
        kind = a[0]
        nan_empty = False
        while kind in ("masked", "masked_nan_empty"):  # combine by the inner kind
            nan_empty = nan_empty or kind == "masked_nan_empty"
            a = a[2]
            kind = a[0]
        if kind == "sum" and nan_empty:
            out_parts.append(red_nansum(p))
        elif kind in ("count", "sum", "avg", "mv_count", "mv_sum", "mv_avg", "hist"):
            out_parts.append(_tree_zip(red_sum, p))
        elif kind in ("min", "mv_min"):
            out_parts.append(red_min(p))
        elif kind in ("max", "mv_max", "hll"):
            out_parts.append(red_max(p))
        elif kind == "minmaxrange":
            out_parts.append((red_min([x[0] for x in p]), red_max([x[1] for x in p])))
        elif kind in ("distinct_ids", "mv_distinct_ids"):
            out_parts.append(red_or(p))
        else:
            raise AssertionError(kind)
    return red_sum(matched), None if counts is None else red_sum(counts), tuple(out_parts)


def _flatten_local(cols: dict, n_docs: torch.Tensor, doc_pad: int):
    """A slot's stacked (S/D, P) columns (and MV (S/D, F_pad) flats) as one
    doc vector, with the validity mask of each segment's docs; each MV
    owning-doc id shifts by its segment's offset into the flat doc space."""
    s_local = next(iter(cols.values())).shape[0]
    flat = {}
    for k, v in cols.items():
        if k.endswith("!docs"):
            offs = (torch.arange(s_local, dtype=v.dtype, device=v.device) * doc_pad)[:, None]
            flat[k] = (v + offs).reshape(-1)
        else:
            flat[k] = v.reshape(-1)
    valid = torch.arange(doc_pad, dtype=torch.int32, device=n_docs.device)[None, :] < n_docs[:, None]
    return flat, valid.reshape(-1)


def _stack_trees(trees: list):
    """Equal-shaped host trees as one, each leaf gaining a leading slot axis."""
    if isinstance(trees[0], tuple):
        return tuple(_stack_trees([t[i] for t in trees]) for i in range(len(trees[0])))
    return np.stack(trees)


@lru_cache(maxsize=256)
def _sharded_kernel(spec: tuple, doc_pad: int, devices: tuple):
    """run(table, slot_cols, operands, n_docs) -> (the packed float64
    vectors on the device, rebuild): the flat program once a slot over its
    segments (on a card the slot's CUDA graph, one per table, slot and
    operand signature, captured at its first call and replayed), then for a
    dense query the merge across the slots, eager (none on one slot, whose
    partials are already the table's) and every output leaf in ONE vector
    (int64 leaves as hi / lo halves, see kernels.pack): a list of one. A
    sparse group-by gives one vector a slot. rebuild(host vectors) restores
    the output tree: (matched, parts), (matched, counts, parts), or for a
    sparse group-by the slots' (matched, counts, parts, uniq, n_unique),
    each leaf with a leading slot axis (its slots are the slot's own).
    `operands` are the plan's host operands; `table` owns the graphs."""
    base = build_masked_fn(spec)
    gspec = spec[2]
    grouped = gspec is not None
    sparse = grouped and gspec[0] == "groups_sparse"

    def slot(table, cols, operands, nd, bound: dict):
        dev = nd.device
        if dev.type != "cuda":
            if dev not in bound:
                bound[dev] = stage_operands(operands, dev)
            flat, valid = _flatten_local(cols, nd, doc_pad)
            return base(flat, bound[dev], valid)
        if dev not in bound:
            bound[dev] = OperandBinding(operands, dev)
        binding = bound[dev]
        key = ("slot", spec, doc_pad, id(table), columns_key(cols), nd.data_ptr(), binding.signature)

        def body(ops):
            flat, valid = _flatten_local(cols, nd, doc_pad)
            leaves, defs = _flatten(base(flat, ops, valid))
            return (*leaves, capture_counts(dev)), {"defs": defs}

        g = compiled_graph(key, table, dev, binding, body)
        leaves, _, _ = replay(g, binding, "exchange.sharded", read_cloned)
        return _unflatten(g.info["defs"], iter(leaves))

    def run(table, slot_cols, operands, n_docs):
        bound: dict = {}
        outs = [slot(table, cols, operands, nd, bound) for cols, nd in zip(slot_cols, n_docs)]
        if sparse:
            vecs = []
            for out in outs:
                leaves, defs = _flatten(out)
                vecs.append(pack(leaves))
            meta = leaf_meta(leaves)
            return vecs, lambda vs: _stack_trees([_unflatten(defs, iter(unpack(v, meta))) for v in vs])
        out = outs[0]
        if len(outs) > 1:
            m, c, p = _combine_tree(
                spec,
                [o[0] for o in outs],
                [o[1] for o in outs] if grouped else None,
                [o[-1] for o in outs],
                devices[0],
            )
            out = (m, c, p) if grouped else (m, p)
        leaves, defs = _flatten(out)
        meta = leaf_meta(leaves)
        return [pack(leaves)], lambda vs: _unflatten(defs, iter(unpack(vs[0], meta)))

    return run


def _collect_mv_nv_indices(node, out: set) -> None:
    """Operand indices holding MV flat-value counts. In the flat layout those
    counts (the whole table's, from the proto) mean nothing: the padding
    docids carry the validity, so the caller sets them to 'every position'."""
    if not isinstance(node, tuple) or not node:
        return
    k = node[0]
    if k == "mv_any":
        out.add(node[3])
    elif k == "mv_count":
        out.add(node[2])
    elif k in ("mv_sum", "mv_min", "mv_max", "mv_avg", "mv_distinct_ids"):
        out.add(node[3])
    elif k == "groups_mv":
        out.add(node[5])
    for c in node:
        if isinstance(c, tuple):
            _collect_mv_nv_indices(c, out)


def _prepare(table: ShardedTable, sql: str):
    """(ctx, plan, program): the query planned once on the proto; program()
    runs `_sharded_kernel` over the table's slots, the operands bound once a
    device."""
    ctx = QueryContext.from_sql(sql)
    if ctx.query_type not in (QueryType.AGGREGATION, QueryType.GROUP_BY):
        raise ValueError("sharded execution covers aggregation / group-by queries")
    # whole-table [min, max] bounds for PERCENTILEEST, from the proto's stats
    for a in ctx.aggregations:
        if a.func == "percentileest" and isinstance(a.arg, ast.Identifier):
            ci = table.proto.columns.get(a.arg.name)
            if ci is not None and isinstance(ci.stats.min_value, (int, float)):
                ctx.hints.setdefault("est_bounds", {})[a.name] = (
                    float(ci.stats.min_value),
                    float(ci.stats.max_value),
                )
    plan: SegmentPlan = plan_segment(table.proto, ctx)
    gspec = plan.spec[2]
    if gspec is not None and gspec[0] == "groups_mv2":
        raise ProtoFallback("two-MV-key cartesian GROUP BY runs on the proto segment")
    slot_cols = [
        {c: table.arrays[c][d] for c in plan.columns} or {"__shape__": next(iter(table.arrays.values()))[d]}
        for d in range(table.mesh.size)
    ]
    operands = list(plan.operands)
    nv_idx: set = set()
    _collect_mv_nv_indices(plan.spec, nv_idx)
    for i in nv_idx:
        # flat positions pass the proto's table-level flat count once a shard
        # holds more than one segment; the padding docids exclude the padding
        operands[i] = np.int32(np.iinfo(np.int32).max)
    kernel = _sharded_kernel(plan.spec, table.padded, table.mesh.devices)
    return ctx, plan, lambda: kernel(table, slot_cols, operands, table.n_docs)


def execute_sharded(table: ShardedTable, sql: str):
    """Run an aggregation / group-by query over the sharded table: (ctx,
    plan, the packed output vectors on the device, rebuild), the partials
    merged across every segment and slot (a sparse group-by: a vector a
    slot)."""
    ctx, plan, program = _prepare(table, sql)
    vecs, rebuild = program()
    return ctx, plan, vecs, rebuild


class ProtoFallback(Exception):
    """A query shape the sharded program cannot carry; the caller reruns it
    over the proto segment, which holds the whole table."""


def _run_on_proto(table: ShardedTable, sql: str):
    from pinot_tpu_torch.query.engine import QueryEngine

    return QueryEngine([table.proto], device=table.mesh.device).execute(sql)


def execute_sharded_result(table: ShardedTable, sql: str):
    """The sharded program + the broker-style reduce, to a ResultTable.

    A sparse (high-cardinality) group-by comes back as the shard's compacted
    table (counts, parts, slot -> dense gid), merged by the reduce that
    merges per-server partials; when its present groups overflow the U
    slots the device result is unusable and the query reruns on the proto."""
    from pinot_tpu_torch.query import reduce as reduce_mod
    from pinot_tpu_torch.query.engine import QueryEngine

    try:
        ctx, plan, program = _prepare(table, sql)
    except (ProtoFallback, DeviceFallback):
        # the proto answers any shape the flat program cannot express through
        # the per-segment engine's own paths
        return _run_on_proto(table, sql)
    rebuild = []

    def run():
        vecs, fn = program()
        rebuild.append(fn)
        return vecs

    # the device->host copies (one; a sparse group-by one a slot), timed
    # with the programs (and the launches they made resolved) by the registry
    vecs = KERNELS.timed_sync(
        "exchange.sharded", run, table.mesh.device, rows=table.padded, cols=max(len(plan.columns), 1)
    )
    host = rebuild[0](vecs)
    gspec = plan.spec[2]
    if ctx.query_type == QueryType.AGGREGATION:
        matched, parts = host
        partial = QueryEngine._convert_agg(table.proto, ctx, plan, parts)
        rows = reduce_mod.reduce_aggregation(ctx, [partial])
        matched = int(matched)
    elif gspec is not None and gspec[0] == "groups_sparse":
        matched_s, counts_s, parts_s, uniq_s, n_unique_s = host
        if int(np.max(n_unique_s)) > gspec[2]:
            # a shard's clipped slots collided: its partial is unusable
            return _run_on_proto(table, sql)
        frames = [
            QueryEngine._convert_groups(
                table.proto, ctx, plan, counts_s[d], _tree_map(lambda x: x[d], parts_s), dense_gids=uniq_s[d]
            )
            for d in range(len(n_unique_s))
        ]
        rows = reduce_mod.reduce_group_by(ctx, frames)
        matched = int(np.sum(matched_s))
    else:
        matched, counts, parts = host
        frame = QueryEngine._convert_groups(table.proto, ctx, plan, counts, parts)
        rows = reduce_mod.reduce_group_by(ctx, [frame])
        matched = int(matched)
    return reduce_mod.build_result(
        ctx,
        rows,
        num_docs_scanned=matched,
        total_docs=table.total_docs,
        num_segments_queried=table.n_segments,
    )


# -- kernel registry: the cost model of the roofline report -------------------


def _sharded_cost(shape: dict) -> tuple[float, float]:
    """The reference's streaming model: each staged column read once at
    accumulator width, over `rows` docs. Its caller passes one segment's
    padded length as `rows` (the reference's argument, kept so both
    registries agree), which undercounts the table's bytes by S."""
    rows = max(float(shape.get("rows", 0)), 0.0)
    cols = max(float(shape.get("cols", 1)), 1.0)
    return rows * (cols * 8.0 + 1.0), rows * cols * 4.0


KERNELS.register(
    "exchange.sharded",
    _sharded_kernel,
    cost_model=_sharded_cost,
    description="sharded whole-table program (one flat program + the merge) and its one device->host copy",
)
