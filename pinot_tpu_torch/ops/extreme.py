"""Per-group MIN / MAX: the hand-written Hopper kernel and its plain torch
version.

Three forms of one function, all launching `csrc/grouped_extreme.cu`:

* `grouped_extremes(columns, outputs, gid, mask, ng, counts)` is the
  engine's form: every MIN / MAX of one group-by in one pass. `columns` holds
  the distinct value tensors (int32, float32 or float64), `outputs` the
  (column index, is_min) pairs, so a MIN and a MAX of one column (MINMAXRANGE)
  read it once. One kernel launch takes up to MAX_OUTPUTS distinct outputs;
  wider calls split.
* `grouped_extreme(values, gid, mask, ng, is_min, counts)` is its one-output
  call (the reference's `_int_grouped_extreme` and `segment_min/max` in
  pinot_tpu/query/kernels.py).
* `grouped_min` / `grouped_max(values, gid, mask, ng)` have the contract of
  the JAX package's `pallas_grouped_min` / `pallas_grouped_max`
  (pinot_tpu/ops/groupby_pallas.py): values taken as float32, a float32
  result, +inf / -inf for a group no masked doc reaches.

Result types: float32 values give float32 results, int32 and float64 values
float64 results, +inf (MIN) / -inf (MAX) for an empty group. For an int32
column the caller passes the per-group counts of the same (gid, mask), which
the exact group-by kernel already returns: INT32_MIN and INT32_MAX are real
values, so an empty group is known from its count, never from a sentinel.

Docs with the mask off, or with a group id outside [0, ng), contribute
nothing. A masked NaN makes its group NaN for MIN and MAX alike. -0.0 orders
below +0.0, so MIN may give -0.0 and MAX +0.0 where the reference returns
either sign; the two compare equal.

The tensors' device decides what runs. A CUDA tensor launches the kernel (a
failed build or launch raises); a CPU tensor takes the plain version.
`grouped_extremes.launches` counts kernel launches (one per call of up to
MAX_OUTPUTS outputs). Every launch (on the CPU, every grouped_extremes call)
records through `common/kernel_obs.py`'s KERNELS as `ops.grouped_extreme`,
the JAX package's name.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pinot_tpu_torch.common.kernel_obs import KERNELS, count_launch, streaming_cost

_SOURCE = "grouped_extreme"
#: distinct outputs per kernel launch; wider calls split
MAX_OUTPUTS = 8
#: value dtype -> (code of the C entry, key bytes, result dtype)
_DTYPES = {
    torch.float32: (0, 4, torch.float32),
    torch.int32: (1, 4, torch.float64),
    torch.float64: (2, 8, torch.float64),
}
_I32 = torch.iinfo(torch.int32)
_INF = float("inf")


def _check(columns, outputs, gid, mask, ng, counts) -> None:
    if ng <= 0:
        raise ValueError(f"ng must be positive, got {ng}")
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError(f"gid must be a contiguous 1-D int32 tensor, got {gid.dtype} {tuple(gid.shape)}")
    if mask.dtype != torch.bool or mask.shape != gid.shape or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor of shape {tuple(gid.shape)}")
    for values in columns:
        if values.dtype not in _DTYPES or values.shape != gid.shape or not values.is_contiguous():
            raise ValueError(f"values must be contiguous float32/int32/float64 tensors of shape {tuple(gid.shape)}")
    if not outputs:
        raise ValueError("no outputs")
    for c, _ in outputs:
        if not 0 <= c < len(columns):
            raise ValueError(f"output column {c} outside the {len(columns)} columns")
        if columns[c].dtype == torch.int32:
            if counts is None or counts.dtype != torch.int64 or counts.shape != (ng,) or not counts.is_contiguous():
                raise ValueError("int32 values need the contiguous int64 per-group counts of shape (ng,)")
    for name, t in [("mask", mask), ("counts", counts), *(("values", v) for v in columns)]:
        if t is not None and t.device != gid.device:
            raise ValueError(f"{name} on {t.device}, gid on {gid.device}")


def grouped_extreme_plain(values, gid, mask, ng: int, is_min: bool, counts=None) -> torch.Tensor:
    """The plain torch version of one output: one scatter_reduce_ from the
    type's identity."""
    ok = mask & (gid >= 0) & (gid < ng)
    idx = torch.where(ok, gid, 0).to(torch.int64)
    is_i32 = values.dtype == torch.int32
    if is_i32:
        fill = _I32.max if is_min else _I32.min
    else:
        fill = _INF if is_min else -_INF
    src = torch.where(ok, values, fill)
    out = torch.full((ng,), fill, dtype=values.dtype, device=values.device)
    out.scatter_reduce_(0, idx, src, reduce="amin" if is_min else "amax", include_self=True)
    if is_i32:
        return torch.where(counts > 0, out.to(torch.float64), _INF if is_min else -_INF)
    return out


def grouped_extremes_plain(columns, outputs, gid, mask, ng: int, counts=None) -> list[torch.Tensor]:
    """The plain torch version: one scatter_reduce_ per output."""
    return [grouped_extreme_plain(columns[c], gid, mask, ng, is_min, counts) for c, is_min in outputs]


@functools.cache
def _library():
    from pinot_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    pi32 = ctypes.POINTER(i32)
    lib.grouped_extremes_plan.argtypes = [i32, pi32, i32, i64, pi32, pi32, pi32, ctypes.POINTER(i64)]
    lib.grouped_extremes_plan.restype = i32
    # n_cols, cols, dtypes, n_out, out_col, out_min, gid, mask, n, ng, counts,
    # blocks, smem, finish, scratch, scratch_bytes, outs, stream
    lib.grouped_extremes.argtypes = [
        i32, ctypes.POINTER(ptr), pi32, i32, pi32, pi32, ptr, ptr, i64, i32, ptr,
        i32, i32, i32, ptr, i64, ctypes.POINTER(ptr), ptr,
    ]  # fmt: skip
    lib.grouped_extremes.restype = i32
    return lib


@functools.lru_cache(maxsize=256)
def _plan(index: int, widths: tuple[int, ...], ng: int, n: int) -> tuple[int, int, int, int]:
    """(blocks, dynamic shared bytes or 0, finish blocks or 0, scratch bytes)
    for outputs of these key widths over (ng, n) on device `index`: planned
    once per shape, so a launch makes no runtime query."""
    blocks, smem, finish, scratch = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0), ctypes.c_longlong(0)
    w = (ctypes.c_int * len(widths))(*widths)
    with torch.cuda.device(index):
        err = _library().grouped_extremes_plan(
            len(widths), w, ng, n, ctypes.byref(blocks), ctypes.byref(smem), ctypes.byref(finish), ctypes.byref(scratch)
        )
    if err != 0:
        raise RuntimeError(f"grouped_extremes planning failed with CUDA error {err} (widths={widths}, ng={ng}, n={n})")
    return blocks.value, smem.value, finish.value, scratch.value


def uses_shared_keys(dtypes, ng: int, device: torch.device) -> bool:
    """Whether one launch keeps the keys of outputs over `dtypes` values (one
    dtype per output) in shared memory on the CUDA `device` (False: the
    global-atomics path)."""
    index = torch.cuda.current_device() if device.index is None else device.index
    return _plan(index, tuple(_DTYPES[d][1] for d in dtypes), ng, 0)[1] > 0


@functools.lru_cache(maxsize=256)
def _spec(index: int, dtypes: tuple[torch.dtype, ...], outputs: tuple[tuple[int, bool], ...], ng: int, n: int):
    """What one launch of these distinct outputs over columns of `dtypes`
    needs besides the tensors' pointers: the columns it reads, the C entry's
    dtype / output arrays, the plan, and which results are float32. Built once
    per shape, so a launch builds two pointer arrays and one buffer."""
    used = sorted({c for c, _ in outputs})
    where = {c: i for i, c in enumerate(used)}
    m = len(outputs)
    plan = _plan(index, tuple(_DTYPES[dtypes[c]][1] for c, _ in outputs), ng, n)
    return (
        used,
        (ctypes.c_int * len(used))(*[_DTYPES[dtypes[c]][0] for c in used]),
        (ctypes.c_int * m)(*[where[c] for c, _ in outputs]),
        (ctypes.c_int * m)(*[int(is_min) for _, is_min in outputs]),
        plan,
        [_DTYPES[dtypes[c]][2] == torch.float32 for c, _ in outputs],
    )


def _shape(columns, outputs, gid, ng, counts) -> dict:
    """A launch's shape for the registry's byte model: a masked doc's group id
    and each distinct column's value, each output written once (float32 for
    float32 values, float64 otherwise) and the counts read for int32 ones."""
    used = dict.fromkeys(c for c, _ in outputs)
    out_bytes = sum(ng * (4 if columns[c].dtype == torch.float32 else 8) for c, _ in outputs)
    out_bytes += ng * 8 if counts is not None else 0
    per_doc = 4 + sum(columns[c].element_size() for c in used)
    return {"rows": gid.numel(), "groups": ng, "per_doc": per_doc, "out_bytes": out_bytes, "outputs": len(outputs)}


def _launch(lib, columns, outputs, gid, mask, ng, counts) -> list[torch.Tensor]:
    """One launch for at most MAX_OUTPUTS distinct outputs."""
    n = gid.numel()
    used, dtypes, out_col, out_min, (blocks, smem, finish, nbytes), narrow = _spec(
        gid.device.index, tuple(v.dtype for v in columns), tuple(outputs), ng, n
    )
    m, row = len(outputs), ng * 8
    # one buffer: a float64 row per result (a float32 result in the first
    # half of its row), then the kernel's scratch
    buf = torch.empty(m * row + nbytes, dtype=torch.uint8, device=gid.device)
    rows = buf[: m * row].view(torch.float64).view(m, ng)
    results = [rows[o].view(torch.float32)[:ng] if f32 else rows[o] for o, f32 in enumerate(narrow)]
    base = buf.data_ptr()
    err = KERNELS.launch("ops.grouped_extreme", lambda: lib.grouped_extremes(
        len(used),
        (ctypes.c_void_p * len(used))(*[columns[c].data_ptr() for c in used]),
        dtypes,
        m,
        out_col,
        out_min,
        gid.data_ptr(),
        mask.data_ptr(),
        n,
        ng,
        None if counts is None else counts.data_ptr(),
        blocks,
        smem,
        finish,
        base + m * row,
        nbytes,
        (ctypes.c_void_p * m)(*[base + o * row for o in range(m)]),
        torch.cuda.current_stream(gid.device).cuda_stream,
    ), mask, **_shape(columns, outputs, gid, ng, counts))
    if err != 0:
        raise RuntimeError(f"grouped_extremes launch failed with CUDA error {err}")
    count_launch(grouped_extremes)
    return results


def grouped_extremes_kernel(columns, outputs, gid, mask, ng: int, counts=None) -> list[torch.Tensor]:
    """The CUDA kernel: same results as grouped_extremes_plain. A repeated
    (column, is_min) pair is computed once and returned at each place."""
    lib = _library()
    distinct = tuple(dict.fromkeys((c, bool(is_min)) for c, is_min in outputs))
    got = {}
    with torch.cuda.device(gid.device):
        for start in range(0, len(distinct), MAX_OUTPUTS):
            part = distinct[start : start + MAX_OUTPUTS]
            got.update(zip(part, _launch(lib, columns, part, gid, mask, ng, counts)))
    return [got[(c, bool(is_min))] for c, is_min in outputs]


def grouped_extremes(columns, outputs, gid, mask, ng: int, counts=None) -> list[torch.Tensor]:
    """Per-group MIN / MAX of masked values for each (column index, is_min)
    of `outputs`, in their order; see the module doc for the result types and
    the empty-group rule."""
    _check(columns, outputs, gid, mask, ng, counts)
    if gid.device.type == "cuda":
        return grouped_extremes_kernel(columns, outputs, gid, mask, ng, counts)
    if gid.device.type == "cpu":
        return KERNELS.launch(
            "ops.grouped_extreme",
            lambda: grouped_extremes_plain(columns, outputs, gid, mask, ng, counts),
            mask,
            **_shape(columns, outputs, gid, ng, counts),
        )
    raise ValueError(f"grouped_extremes runs on cuda or cpu tensors, got {gid.device}")


#: kernel launches (the CPU path never adds to it)
grouped_extremes.launches = 0

KERNELS.register(
    "ops.grouped_extreme",
    grouped_extremes_kernel,
    cost_model=streaming_cost,
    description="per-group MIN/MAX of masked f32 / i32 / f64 values (csrc/grouped_extreme.cu)",
)


def grouped_extreme_kernel(values, gid, mask, ng: int, is_min: bool, counts=None) -> torch.Tensor:
    """The CUDA kernel for one output: same result as grouped_extreme_plain."""
    return grouped_extremes_kernel([values], [(0, is_min)], gid, mask, ng, counts)[0]


def grouped_extreme(values, gid, mask, ng: int, is_min: bool, counts=None) -> torch.Tensor:
    """Per-group MIN (is_min) or MAX of masked values: grouped_extremes with
    one output."""
    return grouped_extremes([values], [(0, is_min)], gid, mask, ng, counts)[0]


def grouped_min(values, gid, mask, ng: int) -> torch.Tensor:
    """pallas_grouped_min: float32 per-group MIN of masked values, +inf when
    a group is empty."""
    return grouped_extreme(values.to(torch.float32).contiguous(), gid, mask, ng, True)


def grouped_max(values, gid, mask, ng: int) -> torch.Tensor:
    """pallas_grouped_max: float32 per-group MAX of masked values, -inf when
    a group is empty."""
    return grouped_extreme(values.to(torch.float32).contiguous(), gid, mask, ng, False)
