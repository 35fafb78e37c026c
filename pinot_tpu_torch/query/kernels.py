"""Spec -> eager torch program for per-segment query execution.

Reference parity: the per-segment operator chain DocIdSetOperator ->
ProjectionOperator -> TransformOperator -> AggregationOperator/GroupByOperator
(core/operator/DocIdSetOperator.java:59, core/operator/ProjectionOperator.java:68,
core/query/aggregation/groupby/DefaultGroupByExecutor.java:191). This is the
JAX package's `query/kernels.py` evaluator carried over: the whole segment
evaluates as one program — filter mask (vector compares + LUT gathers over dict
ids), projection (dictionary-value gathers), dense group ids, aggregation — over
the spec tuples `plan.py` emits. PyTorch runs it eagerly: each op is one
launch on the tensors' device, and nothing syncs with the host until
`dispatch_plan_packed`'s unpack makes the one device->host copy per segment.

Every grouped COUNT and every int32 SUM/AVG goes through one exact group-by
kernel (`ops.groupby.grouped_multi_sum`: the flat kernel, or the two-level one
when the counters pass a block's shared memory), as the reference routes them
through its Pallas byte-plane kernels. A group-key product past
MAX_DENSE_GROUPS takes the sort-compaction path (`groups_sparse`), and the
aggregation runs over U compact slots. Every grouped MIN/MAX/MINMAXRANGE of a
group-by goes through one call of the extreme kernel
(`ops.extreme.grouped_extremes`, the counterpart of the Pallas
`_make_extreme_kernel`), one pass over the docs for all of them, where the
reference makes one XLA segment_min/max per aggregate (which XLA fuses;
eager torch would not), and DISTINCTCOUNT's presence vectors through the presence
entry of the one-hot-sum counterpart (`ops.grouped_sum_f32.presence`), where
the reference scatters with `.at[...].max(mask)`. The tensors' device decides
what runs: on a CUDA device the hand-written kernels, on the CPU their plain
torch versions.

Accumulator dtype policy (Pinot parity: SUM/MIN/MAX/AVG return DOUBLE, COUNT
returns LONG): float64 value accumulators, int64 counts. Integer sums are
exact: int32 values accumulate in int64 and convert to float64 once, the same
value the reference's exact 16-bit-half sums produce while |sum| < 2^53.

JAX semantics the evaluator reproduces where torch's differ:
 * type promotion — a 0-d operand takes part in promotion like any array
   (torch would let the dimensioned side win within a category), so binary
   ops promote both sides explicitly with torch.promote_types;
 * gathers clip out-of-range indices (torch raises), see `_gather`;
 * scatters drop out-of-range group ids, see `_in_range`;
 * `jnp.mod` is floor-mod: torch.remainder, not fmod.

Spec tags outside this module's set raise NotImplementedError naming the tag.
"""

from __future__ import annotations

import numpy as np
import torch

from pinot_tpu_torch.ops.extreme import grouped_extremes
from pinot_tpu_torch.ops.groupby import grouped_multi_sum
from pinot_tpu_torch.ops.grouped_sum_f32 import presence

_F = torch.float64
_I = torch.int64

_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)


def _unsupported(kind: str, what: str):
    return NotImplementedError(f"{what} spec tag {kind!r} is not ported to pinot_tpu_torch yet")


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with JAX's gather semantics: indices clip into range."""
    return torch.index_select(table, 0, idx.clamp(0, table.shape[0] - 1))


def _promote(l: torch.Tensor, r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    dt = torch.promote_types(l.dtype, r.dtype)
    return l.to(dt), r.to(dt)


# ---------------------------------------------------------------------------
# evaluation of value / filter specs
# ---------------------------------------------------------------------------


def _value(vspec, cols, ops, n_padded):
    """Evaluate a value spec over doc-aligned tensors of length n_padded."""
    kind = vspec[0]
    if kind in ("raw", "ids"):
        return cols[vspec[1]]
    if kind == "dictval":
        return _gather(ops[vspec[2]], cols[vspec[1]])
    if kind == "lit":
        return ops[vspec[1]]
    if kind == "cast_int":
        v = _value(vspec[1], cols, ops, n_padded)
        # truncate toward zero (Pinot CAST AS INT/LONG semantics)
        return torch.trunc(v.to(_F)).to(_I) if v.dtype.is_floating_point else v
    if kind == "cast_float":
        return _value(vspec[1], cols, ops, n_padded).to(_F)
    if kind == "bin":
        op = vspec[1]
        l = _value(vspec[2], cols, ops, n_padded)
        r = _value(vspec[3], cols, ops, n_padded)
        if op == "/":
            # Pinot DIVIDE always returns DOUBLE
            return l.to(_F) / r.to(_F)
        l, r = _promote(l, r)
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "%":
            return torch.remainder(l, r)
        raise AssertionError(op)
    raise _unsupported(kind, "value")


_CMPS = {
    "EQ": torch.eq,
    "NEQ": torch.ne,
    "LT": torch.lt,
    "LTE": torch.le,
    "GT": torch.gt,
    "GTE": torch.ge,
}


def _filter(fspec, cols, ops, n_padded, device):
    kind = fspec[0]
    if kind == "const":
        return torch.full((n_padded,), bool(fspec[1]), dtype=torch.bool, device=device)
    if kind in ("and", "or"):
        m = _filter(fspec[1][0], cols, ops, n_padded, device)
        for c in fspec[1][1:]:
            other = _filter(c, cols, ops, n_padded, device)
            m = m & other if kind == "and" else m | other
        return m
    if kind == "not":
        return ~_filter(fspec[1], cols, ops, n_padded, device)
    if kind == "range_ids":
        ids = cols[fspec[1]]
        return (ids >= ops[fspec[2]]) & (ids <= ops[fspec[3]])
    if kind == "doc_range":
        # sorted-column predicate: [start, end) doc interval, no column read
        i = torch.arange(n_padded, dtype=torch.int32, device=device)
        return (i >= ops[fspec[1]]) & (i < ops[fspec[2]])
    if kind == "in_lut":
        return _gather(ops[fspec[2]], cols[fspec[1]])
    if kind == "cmp_raw":
        v = cols[fspec[2]]
        o = ops[fspec[3]]
        if not v.dtype.is_floating_point and not o.dtype.is_floating_point:
            # native integer compare: no 64-bit float copy of the column
            return _CMPS[fspec[1]](v, o.to(v.dtype))
        return _CMPS[fspec[1]](v.to(_F), o)
    if kind == "cmp_lit":
        v = _value(fspec[2], cols, ops, n_padded)
        return _CMPS[fspec[1]](v.to(_F), ops[fspec[3]])
    raise _unsupported(kind, "filter")


# ---------------------------------------------------------------------------
# aggregation partials
# ---------------------------------------------------------------------------


def _exact_int_sum(v, mask):
    """Exact masked sum of int32 values as float64 (int64 accumulation)."""
    return torch.where(mask, v, 0).sum(dtype=_I).to(_F)


def _int_scalar_extreme(v, mask, is_min):
    sentinel = _I32_MAX if is_min else _I32_MIN
    masked = torch.where(mask, v, sentinel)
    r = masked.min() if is_min else masked.max()
    empty = float("inf") if is_min else float("-inf")
    return torch.where(mask.any(), r.to(_F), empty)


def _agg_scalar(aspec, cols, ops, mask):
    kind = aspec[0]
    if kind == "count":
        return mask.sum(dtype=_I)
    if kind == "distinct_ids":
        # DISTINCTCOUNT: presence over the column's dict-id space
        return presence(cols[aspec[1]].contiguous(), mask, aspec[2])
    if kind not in ("sum", "min", "max", "avg", "minmaxrange"):
        raise _unsupported(kind, "aggregation")
    v_raw = _value(aspec[1], cols, ops, mask.shape[0])
    is_i32 = v_raw.dtype == torch.int32
    # the float64 copy only where a branch reads it (eager torch would pay
    # a full pass for an unused one)
    v = None if is_i32 else v_raw.to(_F)
    if kind == "sum":
        if is_i32:
            return _exact_int_sum(v_raw, mask)
        return torch.where(mask, v, 0.0).sum()
    if kind == "min":
        if is_i32:
            return _int_scalar_extreme(v_raw, mask, True)
        return torch.where(mask, v, float("inf")).min()
    if kind == "max":
        if is_i32:
            return _int_scalar_extreme(v_raw, mask, False)
        return torch.where(mask, v, float("-inf")).max()
    if kind == "avg":
        cnt = mask.sum(dtype=_I)
        if is_i32:
            return (_exact_int_sum(v_raw, mask), cnt)
        return (torch.where(mask, v, 0.0).sum(), cnt)
    # minmaxrange
    if is_i32:
        return (_int_scalar_extreme(v_raw, mask, True), _int_scalar_extreme(v_raw, mask, False))
    return (torch.where(mask, v, float("inf")).min(), torch.where(mask, v, float("-inf")).max())


def _in_range(gid, ng):
    """(clipped int64 gid, in-range mask): JAX scatters drop ids outside
    [0, ng); torch's raise, so out-of-range docs are masked off instead."""
    ok = (gid >= 0) & (gid < ng)
    return torch.where(ok, gid, 0).to(_I), ok


def _f64_grouped_sum(v, gid, mask, ng):
    idx, ok = _in_range(gid, ng)
    src = torch.where(mask & ok, v, 0.0)
    return torch.zeros(ng, dtype=_F, device=v.device).index_add_(0, idx, src)


def _grouped_extremes(aggs, values, mask, gid, ng, counts):
    """{agg index: its MIN / MAX / (MIN, MAX) partial} for every grouped
    MIN/MAX/MINMAXRANGE, from ONE grouped_extremes call: one column per
    distinct value spec, one output per distinct (column, MIN or MAX).
    MIN/MAX of int32 values stay int32 (an empty group is one with count 0);
    every other type is compared as float64, as the reference does."""
    columns, col_of, outputs, want = [], {}, [], {}
    for i, a in enumerate(aggs):
        if a[0] not in ("min", "max", "minmaxrange"):
            continue
        c = col_of.get(a[1])
        if c is None:
            v = values[i]
            c = col_of[a[1]] = len(columns)
            columns.append(v.contiguous() if v.dtype == torch.int32 else v.to(_F).contiguous())
        want[i] = [(c, True)] * (a[0] != "max") + [(c, False)] * (a[0] != "min")
        outputs += want[i]
    if not outputs:
        return {}
    hit = counts if any(v.dtype == torch.int32 for v in columns) else None
    got = iter(grouped_extremes(columns, outputs, gid, mask, ng, hit))
    return {i: next(got) if len(o) == 1 else (next(got), next(got)) for i, o in want.items()}


def _grouped_all(aggs, cols, ops, mask, gid, ng):
    """Group counts + every agg partial. The count and ALL int32 SUM/AVG aggs
    fuse into ONE exact group-by kernel launch, every MIN/MAX/MINMAXRANGE into
    ONE extreme-kernel call; non-int32 SUM/AVG and distinct presence use their
    own ops."""
    values, kernel_vals, owner = {}, [], {}
    for i, a in enumerate(aggs):
        if a[0] in ("count", "distinct_ids"):
            continue
        if a[0] not in ("sum", "min", "max", "avg", "minmaxrange"):
            raise _unsupported(a[0], "aggregation")
        values[i] = v = _value(a[1], cols, ops, mask.shape[0])
        if a[0] in ("sum", "avg") and v.dtype == torch.int32:
            owner[i] = len(kernel_vals)
            kernel_vals.append(v.contiguous())
    sums, counts = grouped_multi_sum(kernel_vals, gid, mask, ng)
    extremes = _grouped_extremes(aggs, values, mask, gid, ng, counts)
    parts = []
    for i, a in enumerate(aggs):
        if a[0] == "count":
            parts.append(counts)
        elif a[0] == "distinct_ids":
            # grouped DISTINCTCOUNT: a (ng, pad) presence matrix; the plan
            # keeps ng * pad under its budget
            parts.append(presence(cols[a[1]].contiguous(), mask, a[2], gid=gid, ng=ng))
        elif i in owner:
            parts.append(sums[owner[i]] if a[0] == "sum" else (sums[owner[i]], counts))
        elif i in extremes:
            parts.append(extremes[i])
        else:  # SUM / AVG of non-int32 values
            s = _f64_grouped_sum(values[i].to(_F), gid, mask, ng)
            parts.append(s if a[0] == "sum" else (s, counts))
    return counts, tuple(parts)


# ---------------------------------------------------------------------------
# program construction
# ---------------------------------------------------------------------------


def _agg_eval(fspec, gspec, aggs, cols, ops, valid):
    """The full aggregation program body over an explicit doc-validity mask."""
    n_padded = valid.shape[0]
    mask = valid & _filter(fspec, cols, ops, n_padded, valid.device)
    matched = mask.sum(dtype=_I)
    if gspec is None:
        return matched, tuple(_agg_scalar(a, cols, ops, mask) for a in aggs)
    if gspec[0] == "groups_sparse":
        return _sparse_groups(gspec, aggs, cols, ops, mask, matched)
    if gspec[0] != "groups":
        raise _unsupported(gspec[0], "group")
    _, gcols, ng, strides_idx = gspec
    strides = ops[strides_idx]
    gid = torch.zeros(n_padded, dtype=torch.int32, device=valid.device)
    for i, c in enumerate(gcols):
        ids, stride = _promote(cols[c], strides[i])
        gid, term = _promote(gid, ids * stride)
        gid = gid + term
    counts, parts = _grouped_all(aggs, cols, ops, mask, gid, ng)
    return matched, counts, parts


def _sparse_groups(gspec, aggs, cols, ops, mask, matched):
    """High-cardinality product: 64-bit dense gids -> device sort -> run
    compaction into U slots -> aggregation over the slots. The slot table
    `uniq` (slot -> dense gid, 2^62 past the last present group) rides back so
    the host decodes the keys; n_unique > U (colliding clipped slots) is
    caught on the host. The sort and the search are torch's, as the
    reference's are jnp's."""
    _, gcols, u, strides_idx = gspec
    strides = ops[strides_idx]
    gid64 = torch.zeros(mask.shape[0], dtype=_I, device=mask.device)
    for i, c in enumerate(gcols):
        gid64 = gid64 + cols[c].to(_I) * strides[i]
    sent = 1 << 62
    sg = torch.sort(torch.where(mask, gid64, sent)).values
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=mask.device), sg[1:] != sg[:-1]]) & (sg < sent)
    n_unique = first.sum(dtype=torch.int32)
    # torch's cumsum of int32 is int64 (jnp's stays int32): the same values
    slot = torch.clamp(torch.cumsum(first.to(torch.int32), 0) - 1, 0, u - 1)
    # include_self: the sentinel fill takes part, as in .at[slot].min(sg)
    uniq = torch.full((u,), sent, dtype=_I, device=mask.device).scatter_reduce_(0, slot, sg, "amin", include_self=True)
    cid = torch.clamp(torch.searchsorted(uniq, gid64), 0, u - 1).to(torch.int32)
    counts, parts = _grouped_all(aggs, cols, ops, mask, cid, u)
    return matched, counts, parts, uniq, n_unique


def build_fn(spec: tuple):
    """Build the program for a plan spec: run(cols, ops, n_docs, n_padded)
    with cols a dict of device tensors and ops a tuple of staged operands."""
    kind = spec[0]
    if kind != "agg":
        raise _unsupported(kind, "program")
    _, fspec, gspec, aggs = spec

    def run(cols, ops, n_docs, n_padded):
        device = next(iter(cols.values())).device
        valid = torch.arange(n_padded, dtype=torch.int32, device=device) < n_docs
        return _agg_eval(fspec, gspec, aggs, cols, ops, valid)

    return run


# ---------------------------------------------------------------------------
# dispatch: one device program per segment, one device->host copy
# ---------------------------------------------------------------------------


def _flatten(tree):
    """Leaves of a nested tuple of tensors, and the structure to rebuild it."""
    if isinstance(tree, tuple):
        leaves, defs = [], []
        for t in tree:
            l, d = _flatten(t)
            leaves.extend(l)
            defs.append(d)
        return leaves, tuple(defs)
    return [tree], None


def _unflatten(defs, leaves):
    if defs is None:
        return next(leaves)
    return tuple(_unflatten(d, leaves) for d in defs)


def stage_operand(o, device) -> torch.Tensor:
    """Copy one plan operand (numpy array or scalar) to the device."""
    return torch.tensor(np.asarray(o), device=device)


def plan_inputs(plan, device_segment):
    """Device column dict + operand tuple for a plan (owns the no-columns
    '__shape__' dummy convention)."""
    cols = {c: device_segment.arrays[c] for c in plan.columns}
    if not cols:
        # query touches no columns (e.g. SELECT COUNT(*) FROM t): feed a
        # dummy tensor for the device
        any_col = next(iter(device_segment.arrays))
        cols = {"__shape__": device_segment.arrays[any_col]}
    device = next(iter(cols.values())).device
    ops = tuple(stage_operand(o, device) for o in plan.operands)
    return cols, ops


def pack(leaves: list[torch.Tensor]) -> torch.Tensor:
    """All leaves in ONE float64 vector. int64 leaves split into hi/lo 32-bit
    halves (two f64 chunks), so values past 2^53 survive exactly; every other
    leaf converts to f64 losslessly."""
    chunks = []
    for l in leaves:
        flat = l.reshape(-1)
        if flat.dtype == _I:
            chunks.append(torch.div(flat, 1 << 32, rounding_mode="floor").to(_F))
            chunks.append(torch.remainder(flat, 1 << 32).to(_F))
        else:
            chunks.append(flat.to(_F))
    return torch.cat(chunks)


def leaf_meta(leaves: list[torch.Tensor]) -> list[tuple[tuple, np.dtype]]:
    """(shape, numpy dtype) of each leaf: what unpack rebuilds."""
    return [(tuple(l.shape), torch.empty(0, dtype=l.dtype).numpy().dtype) for l in leaves]


def unpack(v: np.ndarray, meta: list[tuple[tuple, np.dtype]]) -> list[np.ndarray]:
    """Inverse of pack on the host: numpy leaves of the given shapes/dtypes."""
    out = []
    i = 0
    for shape, dtype in meta:
        size = int(np.prod(shape, dtype=np.int64))
        if dtype == np.int64:
            hi = v[i : i + size].astype(np.int64)
            lo = v[i + size : i + 2 * size].astype(np.int64)
            i += 2 * size
            chunk = (hi << 32) + lo
        else:
            chunk = v[i : i + size].astype(dtype, copy=False)
            i += size
        out.append(chunk.reshape(shape))
    return out


def dispatch_plan_packed(plan, device_segment):
    """Enqueue the segment's program on its device without a host sync and
    return a zero-arg function that makes the single device->host copy of the
    packed outputs (see `pack`) and re-inflates the output tree."""
    cols, ops = plan_inputs(plan, device_segment)
    out = build_fn(plan.spec)(cols, ops, device_segment.n_docs, device_segment.padded)
    leaves, defs = _flatten(out)
    meta = leaf_meta(leaves)
    vec = pack(leaves)

    def resolve():
        v = vec.cpu().numpy()  # THE device->host copy for this segment
        return _unflatten(defs, iter(unpack(v, meta)))

    return resolve
