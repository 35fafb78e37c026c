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
eager torch would not), and every DISTINCTCOUNT's presence vector of a query
through one call of the presence entry of the one-hot-sum counterpart
(`ops.grouped_sum_f32.presences`, one pass over the docs for all of them),
where the reference scatters with `.at[...].max(mask)` per aggregate.
DISTINCTCOUNTHLL's register update (`sketches.hll_update`, a scatter-max) and
the selection programs (`select`: the first k matching docs by a cumsum and a
binary search; `select_ob`: a top-k with the reference's tie order) are torch ops,
as the reference's are jnp ops. The tensors' device decides what runs: on a
CUDA device the hand-written kernels, on the CPU their plain torch versions.

Aggregations under a FILTER (WHERE) or a null-handling mask (`masked`,
`masked_nan_empty`) split by their effective mask, and each distinct mask
runs the set above once: a FILTERed GROUP BY costs one exact group-by launch
(and one extreme / presences call, if it has such aggregates) per distinct
mask. PERCENTILEEST's histogram (`hist`) is the group counts with gid = bin
(grouped: gid * nbins + bin), so it goes through the exact group-by kernels
too; FUNNELCOUNT's steps (`funnel_steps`) are one presences call a step. The
transforms (`fn`, DEVICE_FUNCS over `torch_ns`), CASE, the compare, IN and
doc-mask filters and the Kleene tree of null handling (`k3root`) are torch
ops, as the reference's are jnp ops.

Accumulator dtype policy (Pinot parity: SUM/MIN/MAX/AVG return DOUBLE, COUNT
returns LONG): float64 value accumulators, int64 counts. Integer sums are
exact: int32 values accumulate in int64 and convert to float64 once, the same
value the reference's exact 16-bit-half sums produce while |sum| < 2^53.

JAX semantics the evaluator reproduces where torch's differ:
 * type promotion — a 0-d operand takes part in promotion like any array
   (torch would let the dimensioned side win within a category), so binary
   ops promote both sides explicitly with torch.promote_types;
 * gathers clip out-of-range indices (torch raises), see `_gather` and
   `_owner_docs`;
 * scatters drop out-of-range group ids, see `_in_range`, and `mv_any`'s
   scatter over the owning docs lands the padding in a slot past the docs;
 * `jnp.mod` is floor-mod: torch.remainder, not fmod (`torch_ns.remainder`,
   which also gives XLA's 0 for an integer divisor of 0).

Multi-value columns are flattened CSR (segment.ColumnIndex): a flat value
vector and the owning doc of each value (`"{col}!docs"`, padding positions at
`pad`, past the padded docs). `mv_any` evaluates its predicate over the flat
values and ORs it into doc space; the *MV aggregations (`mv_count`,
`mv_distinct_ids`, `mv_sum|min|max|avg`) gather the doc mask to the value
positions and reduce as their single-value twins; a GROUP BY over one MV key
(`groups_mv`) or two (`groups_mv2`, each doc's cartesian pairs in a dense
pair space) runs the grouped set above in value space, every doc-space value
and FILTER mask gathered through the owning docs first. A value space is its
own set of launches: one exact group-by launch (and one extreme call) for all
the grouped *MV aggregations of one MV column, one presences call for all the
DISTINCTCOUNTMVs of one column.

Spec tags outside this module's set raise NotImplementedError naming the tag.
"""

from __future__ import annotations

import threading
import weakref

import numpy as np
import torch

from pinot_tpu_torch.ops.extreme import grouped_extremes
from pinot_tpu_torch.ops.groupby import grouped_multi_sum
from pinot_tpu_torch.ops.grouped_sum_f32 import presences
from pinot_tpu_torch.query import torch_ns
from pinot_tpu_torch.query.sketches import hash_device, hll_update, hll_update_grouped
from pinot_tpu_torch.query.transforms import DEVICE_FUNCS

_F = torch.float64
_I = torch.int64

_I32_MAX = int(np.iinfo(np.int32).max)
_I32_MIN = int(np.iinfo(np.int32).min)


def _unsupported(kind: str, what: str):
    return NotImplementedError(f"{what} spec tag {kind!r} is not ported to pinot_tpu_torch yet")


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] with JAX's gather semantics: indices clip into range."""
    return torch.index_select(table, 0, idx.clamp(0, table.shape[0] - 1))


def _take(v: torch.Tensor, idx: torch.Tensor | None) -> torch.Tensor:
    """A doc-space vector in the grouped space: v[idx] for in-range idx, a
    0-d v (a literal) as it is."""
    return v if idx is None or v.dim() == 0 else torch.index_select(v, 0, idx)


def _owner_docs(col: str, cols, n_padded: int) -> torch.Tensor:
    """The owning doc of each flat value of MV column `col`, its padding
    (`pad`, one past the padded docs) clipped to the last doc as JAX's
    gathers clip it: every read through it is masked by the value validity."""
    return cols[f"{col}!docs"].clamp(max=n_padded - 1)


def _mv_vmask(col: str, nv_idx: int, cols, ops, mask) -> torch.Tensor:
    """The per-flat-value mask of an MV aggregation: the doc mask gathered to
    each value position, AND the flat padding's validity."""
    flat = cols[col]
    valid = torch.arange(flat.shape[0], dtype=torch.int32, device=flat.device) < ops[nv_idx]
    return torch.index_select(mask, 0, _owner_docs(col, cols, mask.shape[0])) & valid


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
    if kind == "docid":
        return torch.arange(n_padded, dtype=torch.int32, device=next(iter(cols.values())).device)
    if kind == "dictval":
        return _gather(ops[vspec[2]], cols[vspec[1]])
    if kind == "lit":
        return ops[vspec[1]]
    if kind == "fn":
        _, fn = DEVICE_FUNCS[vspec[1]]
        return torch_ns.apply(fn, [_value(a, cols, ops, n_padded) for a in vspec[2]])
    if kind == "case":
        # reversed fold: the first matching WHEN wins
        device = next(iter(cols.values())).device
        out = torch.broadcast_to(_value(vspec[2], cols, ops, n_padded).to(_F), (n_padded,))
        for fspec, branch in reversed(vspec[1]):
            cond = _filter(fspec, cols, ops, n_padded, device)
            out = torch.where(cond, _value(branch, cols, ops, n_padded).to(_F), out)
        return out
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
            return torch_ns.remainder(l, r)
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


def _is_int(dt: torch.dtype) -> bool:
    return not dt.is_floating_point and dt != torch.bool


def _filter_k3(fspec, cols, ops, n_padded, device):
    """Three-valued filter evaluation: the (true, unknown) doc-mask pair, with
    Kleene logic (AND: FALSE dominates UNKNOWN; OR: TRUE dominates; NOT of
    unknown is unknown), as the host executor's _filter3."""
    kind = fspec[0]
    if kind == "k3_and":
        t, u, any_false = None, None, None
        for c in fspec[1]:
            ct, cu = _filter_k3(c, cols, ops, n_padded, device)
            f = ~ct & ~cu
            t, u, any_false = (ct, cu, f) if t is None else (t & ct, u | cu, any_false | f)
        return t, u & ~any_false
    if kind == "k3_or":
        t, u = None, None
        for c in fspec[1]:
            ct, cu = _filter_k3(c, cols, ops, n_padded, device)
            t, u = (ct, cu) if t is None else (t | ct, u | cu)
        return t, u & ~t
    if kind == "k3_not":
        ct, cu = _filter_k3(fspec[1], cols, ops, n_padded, device)
        return ~ct & ~cu, cu
    if kind == "k3_exact":
        return _filter(fspec[1], cols, ops, n_padded, device), torch.zeros(n_padded, dtype=torch.bool, device=device)
    if kind == "k3_leaf":
        nulls = ops[fspec[2]]
        return _filter(fspec[1], cols, ops, n_padded, device) & ~nulls, nulls
    raise _unsupported(kind, "three-valued filter")


def _filter(fspec, cols, ops, n_padded, device):
    kind = fspec[0]
    if kind == "k3root":
        # three-valued WHERE: only definitely-true docs survive
        return _filter_k3(fspec[1], cols, ops, n_padded, device)[0]
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
    if kind == "docmask":
        # a doc mask the planner computed on the host (a null vector)
        return ops[fspec[1]]
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
    if kind == "cmp2":
        l = _value(fspec[2], cols, ops, n_padded)
        r = _value(fspec[3], cols, ops, n_padded)
        return _CMPS[fspec[1]](l.to(_F), r.to(_F))
    if kind == "in_vals":
        v = _value(fspec[1], cols, ops, n_padded).to(_F)
        return (v[:, None] == ops[fspec[2]][None, :]).any(dim=1)
    if kind == "in_sorted":
        # membership by a probe of the sorted list (padded by repeating its
        # max): one binary search and one gather a doc, flat in the list's
        # length. torch.searchsorted takes one dtype on both sides: integers
        # widen the narrower side (narrowing the list could wrap an
        # out-of-range literal and break its order), anything else compares
        # as float64
        v = _value(fspec[1], cols, ops, n_padded)
        vals = ops[fspec[2]]
        if not (_is_int(v.dtype) and _is_int(vals.dtype)):
            v, vals = v.to(_F), vals.to(_F)
        elif torch.iinfo(vals.dtype).bits > torch.iinfo(v.dtype).bits:
            v = v.to(vals.dtype)
        else:
            vals = vals.to(v.dtype)
        pos = torch.searchsorted(vals, v.contiguous()).clamp(0, vals.shape[0] - 1)
        return torch.index_select(vals, 0, pos) == v
    if kind == "mv_any":
        # MV any-match: the inner predicate over the flat values, masked to
        # the real ones, OR'd into doc space by a count of hits a doc. The
        # padding docids (pad) land in one slot past the docs, cut off
        _, col, inner, nv_idx = fspec
        flat = cols[col]
        pred = _filter(inner, cols, ops, flat.shape[0], device)
        pred = pred & (torch.arange(flat.shape[0], dtype=torch.int32, device=device) < ops[nv_idx])
        hits = torch.zeros(n_padded + 1, dtype=torch.int32, device=device)
        hits.index_add_(0, cols[f"{col}!docs"], pred.to(torch.int32))
        return hits[:n_padded] > 0
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


def _hashes_for(hspec, cols, ops, n_padded):
    """Per-doc uint32 hashes (int64 tensor) of an `hll` spec's values:
    ("gather", col, op) gathers the dictionary's hash table (staged as int32
    bit patterns) by dict id; ("mix", vspec) hashes numeric values on the
    device."""
    if hspec[0] == "gather":
        return _gather(ops[hspec[2]], cols[hspec[1]]).to(_I) & 0xFFFFFFFF
    return hash_device(_value(hspec[1], cols, ops, n_padded))


def _bins(aspec, cols, ops, n_padded) -> torch.Tensor:
    """PERCENTILEEST's histogram bin of every doc (int32): floor((v - lo) *
    inv_w) clamped into [0, nbins - 1] in float64 before the conversion (XLA's
    conversion saturates an out-of-range float, torch's is undefined there);
    a NaN value bins at 0, where XLA's conversion puts it."""
    v = _value(aspec[1], cols, ops, n_padded).to(_F)
    b = torch.floor((v - ops[aspec[2]]) * ops[aspec[3]])
    return torch.nan_to_num(b, nan=0.0).clamp(0, aspec[4] - 1).to(torch.int32)


#: an *MV aggregation's single-value twin, which reduces its flat values
_MV_INNER = {"mv_sum": "sum", "mv_min": "min", "mv_max": "max", "mv_avg": "avg"}


def _mv_inner(aspec) -> tuple[str, int, tuple]:
    """(MV column, n_values operand, twin spec) of a `mv_count` /
    `mv_sum|min|max|avg` spec: the twin's reduction over the flat values
    under the value mask."""
    kind = aspec[0]
    if kind == "mv_count":
        return aspec[1], aspec[2], ("count",)
    if kind in ("mv_sum", "mv_min", "mv_max", "mv_avg"):
        return aspec[2], aspec[3], (_MV_INNER[kind], aspec[1])
    raise AssertionError(aspec)


def _agg_scalar(aspec, cols, ops, mask):
    kind = aspec[0]
    if kind == "count":
        return mask.sum(dtype=_I)
    if kind in ("mv_count", "mv_sum", "mv_min", "mv_max", "mv_avg"):
        col, nv_idx, inner = _mv_inner(aspec)
        return _agg_scalar(inner, cols, ops, _mv_vmask(col, nv_idx, cols, ops, mask))
    if kind == "hll":
        return hll_update(_hashes_for(aspec[1], cols, ops, mask.shape[0]), mask, aspec[2])
    if kind == "hist":
        # the histogram is the group counts with gid = bin
        return grouped_multi_sum([], _bins(aspec, cols, ops, mask.shape[0]), mask, aspec[4])[1]
    if kind == "funnel_steps":
        # un-ordered funnel: per step, the presence of the correlation ids
        # under the step's mask, one presences call a step, stacked (K, pad)
        _, col, pad, steps = aspec
        ids = cols[col].contiguous()
        return torch.stack(
            [presences([ids], [pad], mask & _filter(s, cols, ops, mask.shape[0], mask.device))[0] for s in steps]
        )
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


def _presences(aggs, cols, ops, mask, gid=None, ng=1, gather=None):
    """{agg index: its presence} for every DISTINCTCOUNT (`distinct_ids`)
    of `aggs`, from ONE presences call: a (pad,) vector each over the
    column's dict-id space, or with gid an (ng, pad) matrix each (the plan
    keeps ng * pad under its budget). A scalar DISTINCTCOUNTMV
    (`mv_distinct_ids`) is the presence of its flat ids under the value
    mask: one more presences call for the DISTINCTCOUNTMVs of each MV
    column."""
    spaces: dict = {}  # None (the docs) or an MV column -> agg indices
    for i, a in enumerate(aggs):
        if a[0] == "distinct_ids":
            spaces.setdefault(None, []).append(i)
        elif a[0] == "mv_distinct_ids":
            spaces.setdefault(a[1], []).append(i)
    out = {}
    for col, which in spaces.items():
        if col is None:
            m, ids = mask, [_take(cols[aggs[i][1]], gather).contiguous() for i in which]
        else:
            m, ids = _mv_vmask(col, aggs[which[0]][3], cols, ops, mask), [cols[col]] * len(which)
        out.update(zip(which, presences(ids, [aggs[i][2] for i in which], m, gid=gid, ng=ng)))
    return out


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


def _grouped_all(aggs, cols, ops, mask, gid, ng, gather=None, doc_pad=None):
    """Group counts + every agg partial. The count and ALL int32 SUM/AVG aggs
    fuse into ONE exact group-by kernel launch, every MIN/MAX/MINMAXRANGE into
    ONE extreme-kernel call, every DISTINCTCOUNT into ONE presences call;
    non-int32 SUM/AVG and DISTINCTCOUNTHLL's registers use their own ops.

    `gather` (with `doc_pad`, the padded doc count): an MV GROUP BY, whose
    mask and gid are in value (or pair) space; every doc-space value gathers
    through the owning docs (`gather`, in range) first. Without it, the
    grouped *MV aggregations of each MV column run this set once more in that
    column's value space (its value mask, gid gathered to the values)."""
    n = mask.shape[0] if gather is None else doc_pad
    values, kernel_vals, owner, by_mv = {}, [], {}, {}
    for i, a in enumerate(aggs):
        if a[0] in ("mv_count", "mv_sum", "mv_min", "mv_max", "mv_avg"):
            if gather is not None:
                raise AssertionError("MV aggregations under an MV GROUP BY are planned for the host")
            col, nv_idx, inner = _mv_inner(a)
            by_mv.setdefault(col, (nv_idx, []))[1].append((i, inner))
            continue
        if a[0] in ("count", "distinct_ids", "hll", "hist"):
            continue
        if a[0] not in ("sum", "min", "max", "avg", "minmaxrange"):
            raise _unsupported(a[0], "aggregation")
        values[i] = v = _take(_value(a[1], cols, ops, n), gather)
        if a[0] in ("sum", "avg") and v.dtype == torch.int32:
            owner[i] = len(kernel_vals)
            kernel_vals.append(v.contiguous())
    sums, counts = grouped_multi_sum(kernel_vals, gid, mask, ng)
    extremes = _grouped_extremes(aggs, values, mask, gid, ng, counts)
    flags = _presences(aggs, cols, ops, mask, gid, ng, gather)
    mv_parts = {}
    for col, (nv_idx, members) in by_mv.items():
        vm = _mv_vmask(col, nv_idx, cols, ops, mask)
        gid_v = torch.index_select(gid, 0, _owner_docs(col, cols, mask.shape[0]))
        _, got = _grouped_all([inner for _, inner in members], cols, ops, vm, gid_v, ng)
        mv_parts.update(zip([i for i, _ in members], got))
    parts = []
    for i, a in enumerate(aggs):
        if a[0] == "count":
            parts.append(counts)
        elif i in flags:
            parts.append(flags[i])
        elif i in mv_parts:
            parts.append(mv_parts[i])
        elif a[0] == "hll":
            hashes = _take(_hashes_for(a[1], cols, ops, n), gather)
            parts.append(hll_update_grouped(hashes, mask, gid, ng, a[2]))
        elif a[0] == "hist":
            # per-group histograms: the counts of cells gid * nbins + bin
            nbins = a[4]
            cell, ok = _in_range(gid, ng)
            cell = (cell.to(torch.int32) * nbins + _take(_bins(a, cols, ops, n), gather)).contiguous()
            hist = grouped_multi_sum([], cell, mask & ok, ng * nbins)[1]
            parts.append(hist.reshape(ng, nbins))
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


def _mask_key(spec, ops):
    """A filter spec with each operand index replaced by the identity of its
    staged operand: equal keys are equal masks. (Every int of a filter spec
    that is not a bool is an operand index; `plan_inputs` stages equal scalar
    operands as one tensor, so `year = 1997` in two FILTERs is one key.)"""
    if isinstance(spec, tuple):
        return tuple(_mask_key(x, ops) for x in spec)
    if type(spec) is int:
        return ("op", id(ops[spec]))
    return spec


def _by_mask(aggs, ops) -> list[tuple[tuple, list[tuple[int, tuple, bool]]]]:
    """The aggregates split by their effective mask, the chain of nested
    FILTER (WHERE) / null-handling wrappers (`masked`, `masked_nan_empty`)
    ANDed with the query's mask: [(wrapper filter specs, [(agg index, inner
    spec, whether empty groups give NaN)])], the unwrapped set first (also
    when empty: it gives the group counts)."""
    groups: dict = {(): ((), [])}
    for i, a in enumerate(aggs):
        filters, nan_empty = [], False
        while a[0] in ("masked", "masked_nan_empty"):
            nan_empty = nan_empty or a[0] == "masked_nan_empty"
            filters.append(a[1])
            a = a[2]
        key = tuple(_mask_key(f, ops) for f in filters)
        groups.setdefault(key, (tuple(filters), []))[1].append((i, a, nan_empty))
    return list(groups.values())


def _and_filters(mask, filters, cols, ops, gather=None, doc_pad=None):
    """mask AND each filter's doc mask; under an MV GROUP BY (`gather`) the
    doc masks gather to the value space of `mask` first."""
    for f in filters:
        fm = _filter(f, cols, ops, mask.shape[0] if gather is None else doc_pad, mask.device)
        mask = mask & _take(fm, gather)
    return mask


def _scalar_all(aggs, cols, ops, mask):
    """Every scalar partial: per effective mask, one presences call for its
    DISTINCTCOUNTs, the rest one op each; a null-handling SUM whose mask is
    empty gives NaN (NULL at the reduce)."""
    parts = [None] * len(aggs)
    for filters, members in _by_mask(aggs, ops):
        m = _and_filters(mask, filters, cols, ops)
        inner = [a for _, a, _ in members]
        flags = _presences(inner, cols, ops, m)
        for j, (i, a, nan_empty) in enumerate(members):
            r = flags[j] if j in flags else _agg_scalar(a, cols, ops, m)
            parts[i] = torch.where(m.any(), r.to(_F), float("nan")) if nan_empty else r
    return tuple(parts)


def _grouped_masked(aggs, cols, ops, mask, gid, ng, gather=None, doc_pad=None):
    """Group counts + every grouped partial: one `_grouped_all` per effective
    mask (so one exact group-by launch, one extreme call and one presences
    call per distinct mask); a null-handling SUM gives NaN in a group its
    mask leaves empty, by that mask's own counts. `gather` / `doc_pad`: an
    MV GROUP BY's value space (see _grouped_all)."""
    counts, parts = None, [None] * len(aggs)
    for filters, members in _by_mask(aggs, ops):
        m = _and_filters(mask, filters, cols, ops, gather, doc_pad)
        c, got = _grouped_all([a for _, a, _ in members], cols, ops, m, gid, ng, gather, doc_pad)
        if not filters:
            counts = c
        for (i, _, nan_empty), r in zip(members, got):
            parts[i] = torch.where(c == 0, float("nan"), r.to(_F)) if nan_empty else r
    return counts, tuple(parts)


def _agg_eval(fspec, gspec, aggs, cols, ops, valid):
    """The full aggregation program body over an explicit doc-validity mask."""
    n_padded = valid.shape[0]
    mask = valid & _filter(fspec, cols, ops, n_padded, valid.device)
    matched = mask.sum(dtype=_I)
    if gspec is None:
        return matched, _scalar_all(aggs, cols, ops, mask)
    if gspec[0] == "groups_sparse":
        return _sparse_groups(gspec, aggs, cols, ops, mask, matched)
    if gspec[0] == "groups_mv":
        return (matched,) + _mv_groups(gspec, aggs, cols, ops, mask)
    if gspec[0] == "groups_mv2":
        return (matched,) + _mv2_groups(gspec, aggs, cols, ops, mask)
    if gspec[0] != "groups":
        raise _unsupported(gspec[0], "group")
    _, gcols, ng, strides_idx = gspec
    strides = ops[strides_idx]
    gid = _dense_gid([cols[c] for c in gcols], strides, n_padded, valid.device)
    counts, parts = _grouped_masked(aggs, cols, ops, mask, gid, ng)
    return matched, counts, parts


def _dense_gid(keys, strides, shape, device) -> torch.Tensor:
    """sum(keys[i] * strides[i]) over `shape` (an int32 zero start, JAX's
    promotion; keys broadcast to it)."""
    gid = torch.zeros(shape, dtype=torch.int32, device=device)
    for i, ids in enumerate(keys):
        ids, stride = _promote(ids, strides[i])
        gid, term = _promote(gid, ids * stride)
        gid = gid + term
    return gid


def _mv_groups(gspec, aggs, cols, ops, mask):
    """One MV key: the group ids live in value space, each doc contributes
    once per value; the doc-space keys, values and masks gather through the
    owning docs."""
    _, gcols, ng, strides_idx, mv_col, nv_idx = gspec
    n_padded = mask.shape[0]
    docs = _owner_docs(mv_col, cols, n_padded)
    vmask = _mv_vmask(mv_col, nv_idx, cols, ops, mask)
    keys = [cols[c] if c == mv_col else torch.index_select(cols[c], 0, docs) for c in gcols]
    gid = _dense_gid(keys, ops[strides_idx], docs.shape[0], mask.device)
    return _grouped_masked(aggs, cols, ops, vmask, gid, ng, gather=docs, doc_pad=n_padded)


def _mv2_groups(gspec, aggs, cols, ops, mask):
    """Two MV keys: the grouped set over their pair space (`mv2_pairs`)."""
    pvalid, gid, pair_docs = mv2_pairs(gspec, cols, ops, mask)
    return _grouped_masked(aggs, cols, ops, pvalid, gid, gspec[2], gather=pair_docs, doc_pad=mask.shape[0])


def mv2_pairs(gspec, cols, ops, mask):
    """(pair mask, pair gid, pair's doc) of a `groups_mv2` spec: a dense
    (base flat values x Lb) pair space, each valid pair one cartesian (a
    value, b value) combination of one doc. Pair (v, j) reads b's flat value
    at its doc's offset + j while j < its doc's b length; the offset and
    length tables have pad + 1 entries, so the base's padding docids (pad)
    read a zero length there."""
    _, gcols, _, strides_idx, mv_a, nv_a, mv_b, off_idx, len_idx, lb = gspec
    n_padded = mask.shape[0]
    docids = cols[f"{mv_a}!docs"]
    va = docids.shape[0]
    vmask_a = _mv_vmask(mv_a, nv_a, cols, ops, mask)
    d_off = torch.index_select(ops[off_idx], 0, docids)
    d_len = torch.index_select(ops[len_idx], 0, docids)
    j = torch.arange(lb, dtype=torch.int32, device=mask.device)
    pvalid = (vmask_a[:, None] & (j[None, :] < d_len[:, None])).reshape(-1)
    nb = cols[mv_b].shape[0]
    # an invalid pair's index may pass b's values: clip it, as JAX does
    fidx = (d_off[:, None] + j[None, :]).clamp(0, nb - 1).reshape(-1)
    ids_b = torch.index_select(cols[mv_b], 0, fidx).reshape(va, lb)
    docs = _owner_docs(mv_a, cols, n_padded)
    keys = []
    for c in gcols:
        if c == mv_a:
            keys.append(cols[c][:, None])
        elif c == mv_b:
            keys.append(ids_b)
        else:
            keys.append(torch.index_select(cols[c], 0, docs)[:, None])
    gid = _dense_gid(keys, ops[strides_idx], (va, lb), mask.device).reshape(-1)
    return pvalid, gid, docs[:, None].expand(va, lb).reshape(-1)


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
    counts, parts = _grouped_masked(aggs, cols, ops, mask, cid, u)
    return matched, counts, parts, uniq, n_unique


def first_k(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the first k set docs of `mask` in doc order, padded with
    doc 0 (jnp.nonzero(mask, size=k, fill_value=0)), without a host sync:
    the j-th set doc is the first position where the running count of set
    docs reaches j, one binary search of the cumsum per slot."""
    count = torch.cumsum(mask, 0)
    idx = torch.searchsorted(count, torch.arange(1, k + 1, dtype=count.dtype, device=mask.device))
    return torch.where(idx < mask.shape[0], idx, 0)


def total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int64 key of float64 values in IEEE total order (-NaN < -inf < ... <
    -0.0 < +0.0 < ... < +inf < +NaN), the order XLA's top_k ranks by."""
    bits = x.contiguous().view(_I)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFFFFFFFFFF, bits)


def top_k_stable(key: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the k largest int64 keys, largest first and ties by the
    lower index (lax.top_k's order), without a host sync. torch.topk
    promises no order among ties, so its k-th value only sets the
    threshold: every key above it is taken, then the lowest-index docs
    equal to it up to k, and a stable sort of those k orders them."""
    if k == 0:
        return torch.zeros(0, dtype=_I, device=key.device)
    kth = torch.topk(key, k, sorted=False).values.min()
    above, at = key > kth, key == kth
    take = above | (at & (torch.cumsum(at, 0) <= k - above.sum()))
    idx = first_k(take, k)
    return idx[torch.sort(key[idx], descending=True, stable=True).indices]


def build_fn(spec: tuple):
    """Build the program for a plan spec: run(cols, ops, n_docs, n_padded)
    with cols a dict of device tensors and ops a tuple of staged operands.
    Kinds: "agg" (aggregation, group-by, DISTINCT), "mask" (the filter's doc
    mask alone), "select" (the first k matching docs' projections) and
    "select_ob" (the top k by one key)."""
    kind = spec[0]

    def valid_docs(cols, n_docs, n_padded):
        device = next(iter(cols.values())).device
        return torch.arange(n_padded, dtype=torch.int32, device=device) < n_docs

    def doc_mask(fspec, cols, ops, n_docs, n_padded):
        valid = valid_docs(cols, n_docs, n_padded)
        return valid & _filter(fspec, cols, ops, n_padded, valid.device)

    if kind == "agg":
        _, fspec, gspec, aggs = spec

        def run(cols, ops, n_docs, n_padded):
            return _agg_eval(fspec, gspec, aggs, cols, ops, valid_docs(cols, n_docs, n_padded))

        return run

    if kind == "mask":
        # filter-only program: the multistage leaf Scan's filter
        # (plan.plan_filter_mask); the caller trims the padding tail
        _, fspec = spec

        def run_mask(cols, ops, n_docs, n_padded):
            return doc_mask(fspec, cols, ops, n_docs, n_padded)

        return run_mask

    if kind == "select":
        _, fspec, proj, k = spec

        def run_select(cols, ops, n_docs, n_padded):
            mask = doc_mask(fspec, cols, ops, n_docs, n_padded)
            idx = first_k(mask, k)
            outs = tuple(_gather(_value(p, cols, ops, n_padded), idx) for p in proj)
            return mask.sum(dtype=_I), outs

        return run_select

    if kind == "select_ob":
        _, fspec, proj, kspec, desc, k = spec

        def run_ob(cols, ops, n_docs, n_padded):
            mask = doc_mask(fspec, cols, ops, n_docs, n_padded)
            key = _value(kspec, cols, ops, n_padded).to(_F)
            # masked docs rank at -inf, ASC negates the key (the reference's
            # ranking, ties and NaN included)
            sort_key = torch.where(mask, key if desc else -key, float("-inf"))
            idx = top_k_stable(total_order_key(sort_key), min(k, n_padded))
            outs = tuple(_gather(_value(p, cols, ops, n_padded), idx) for p in proj)
            return mask.sum(dtype=_I), _gather(key, idx), outs

        return run_ob

    raise _unsupported(kind, "program")


def build_masked_fn(spec: tuple):
    """The aggregation program of `build_fn` over an explicit doc-validity
    mask in place of n_docs: run(cols, ops, valid). The sharded executor
    (`parallel/mesh.py`) flattens a table's (S, P) stacked segments into one
    doc vector, so one program over it replaces one a segment (aggregates
    are order-independent)."""
    kind = spec[0]
    assert kind == "agg", spec
    _, fspec, gspec, aggs = spec
    # groups_mv2's per-doc offset / length operand tables index the proto's
    # doc space, which the flat layout has not: execute_sharded reruns those
    # on the proto
    assert gspec is None or gspec[0] != "groups_mv2", gspec

    def run(cols, ops, valid):
        # the doc length comes from the mask: cols may hold MV flat vectors,
        # whose length is the value space
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


#: device copies of operands their owner declared long-lived
#: (`Dictionary.hll_hash_pad`), one per (array, device). Per-query operands
#: (literals, LUTs) never enter: their ids do not recur. An entry goes when
#: its host array is collected (a weakref callback), so the cache lives no
#: longer than the owners. The lock covers concurrent query threads.
_OP_CACHE_LOCK = threading.Lock()
_STABLE_OPS: dict[int, weakref.ref] = {}
_OP_DEVICE_CACHE: dict[tuple[int, str], tuple[weakref.ref, torch.Tensor]] = {}


def _op_cache_drop(key: int) -> None:
    with _OP_CACHE_LOCK:
        _STABLE_OPS.pop(key, None)
        for k in [k for k in _OP_DEVICE_CACHE if k[0] == key]:
            del _OP_DEVICE_CACHE[k]


def mark_stable_operand(o: np.ndarray) -> np.ndarray:
    """Declare a host array stable (immutable and reused across queries):
    its device copy is staged once per device and kept until the array is
    collected."""
    key = id(o)
    with _OP_CACHE_LOCK:
        _STABLE_OPS[key] = weakref.ref(o, lambda _r, k=key: _op_cache_drop(k))
    return o


def _to_tensor(o, device) -> torch.Tensor:
    a = np.asarray(o)
    if a.dtype == np.uint32:
        # uint32 tables (hashes) ride as their int32 bit patterns; readers
        # widen them to int64 and mask to 32 bits
        a = a.view(np.int32)
    return torch.tensor(a, device=device)


def stage_operand(o, device) -> torch.Tensor:
    """Copy one plan operand (numpy array or scalar) to the device; an array
    marked stable is copied once per device and its copy reused."""
    if isinstance(o, np.ndarray):
        key = (id(o), str(device))
        with _OP_CACHE_LOCK:
            ref = _STABLE_OPS.get(key[0])
            stable = ref is not None and ref() is o
            ent = _OP_DEVICE_CACHE.get(key) if stable else None
        if ent is not None and ent[0]() is o:
            return ent[1]
        if stable:
            t = _to_tensor(o, device)
            with _OP_CACHE_LOCK:
                _OP_DEVICE_CACHE[key] = (weakref.ref(o), t)
            return t
    return _to_tensor(o, device)


def plan_inputs(plan, device_segment):
    """Device column dict + operand tuple for a plan (owns the no-columns
    '__shape__' dummy convention)."""
    cols = {c: device_segment.arrays[c] for c in plan.columns}
    if not cols:
        # query touches no columns (e.g. SELECT COUNT(*) FROM t): feed a
        # dummy tensor for the device
        any_col = next(iter(device_segment.arrays))
        cols = {"__shape__": device_segment.arrays[any_col]}
    return cols, stage_operands(plan.operands, next(iter(cols.values())).device)


def stage_operands(operands, device) -> tuple[torch.Tensor, ...]:
    """A plan's operands on `device`. Equal scalar operands (the literal of
    `year = 1997` in two FILTERs) stage as one tensor: _mask_key then sees
    one mask."""
    staged: dict = {}
    ops = []
    for o in operands:
        key = ("value", np.asarray(o).dtype.str, np.asarray(o).tobytes()) if np.ndim(o) == 0 else ("array", id(o))
        if key not in staged:
            staged[key] = stage_operand(o, device)
        ops.append(staged[key])
    return tuple(ops)


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
