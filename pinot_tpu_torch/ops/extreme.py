"""Per-group MIN / MAX: the hand-written Hopper kernel and its plain torch
version.

Two forms of one function, both launching `csrc/grouped_extreme.cu`:

* `grouped_min` / `grouped_max(values, gid, mask, ng)` have the contract of
  the JAX package's `pallas_grouped_min` / `pallas_grouped_max`
  (pinot_tpu/ops/groupby_pallas.py): values taken as float32, a float32
  result, +inf / -inf for a group no masked doc reaches.
* `grouped_extreme(values, gid, mask, ng, is_min, counts)` is the engine's
  form (the reference's `_int_grouped_extreme` and `segment_min/max` in
  pinot_tpu/query/kernels.py): int32 or float64 values, a float64 result,
  +inf / -inf for an empty group. For int32 values the caller passes the
  per-group counts of the same (gid, mask), which the exact group-by kernel
  already returns: INT32_MIN and INT32_MAX are real values, so an empty group
  is known from its count, never from a sentinel.

Docs with the mask off, or with a group id outside [0, ng), contribute
nothing. A masked NaN makes its group NaN for MIN and MAX alike. -0.0 orders
below +0.0, so MIN may give -0.0 and MAX +0.0 where the reference returns
either sign; the two compare equal.

The tensors' device decides what runs. A CUDA tensor launches the kernel (a
failed build or launch raises); a CPU tensor takes the plain version.
`grouped_extreme.launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "grouped_extreme"
#: value dtype -> (code of the C entry, key dtype, result dtype)
_DTYPES = {
    torch.float32: (0, torch.int32, torch.float32),
    torch.int32: (1, torch.int32, torch.float64),
    torch.float64: (2, torch.int64, torch.float64),
}
_I32 = torch.iinfo(torch.int32)
_INF = float("inf")


def _check(values, gid, mask, ng, counts) -> None:
    if ng <= 0:
        raise ValueError(f"ng must be positive, got {ng}")
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError(f"gid must be a contiguous 1-D int32 tensor, got {gid.dtype} {tuple(gid.shape)}")
    if mask.dtype != torch.bool or mask.shape != gid.shape or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor of shape {tuple(gid.shape)}")
    if values.dtype not in _DTYPES or values.shape != gid.shape or not values.is_contiguous():
        raise ValueError(f"values must be a contiguous float32/int32/float64 tensor of shape {tuple(gid.shape)}")
    if values.dtype == torch.int32:
        if counts is None or counts.dtype != torch.int64 or counts.shape != (ng,) or not counts.is_contiguous():
            raise ValueError("int32 values need the contiguous int64 per-group counts of shape (ng,)")
    for name, t in (("mask", mask), ("values", values), ("counts", counts)):
        if t is not None and t.device != gid.device:
            raise ValueError(f"{name} on {t.device}, gid on {gid.device}")


def grouped_extreme_plain(values, gid, mask, ng: int, is_min: bool, counts=None) -> torch.Tensor:
    """The plain torch version: one scatter_reduce_ from the type's identity."""
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


@functools.cache
def _library():
    from pinot_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.grouped_extreme
    ptr = ctypes.c_void_p
    # dtype, is_min, values, gid, mask, n, ng, counts, keys, out, stream
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ptr, ptr, ptr, ctypes.c_longlong, ctypes.c_int, ptr, ptr, ptr, ptr]
    fn.restype = ctypes.c_int
    lib.grouped_extreme_uses_shared.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.grouped_extreme_uses_shared.restype = ctypes.c_int
    return lib


def uses_shared_keys(dtype: torch.dtype, ng: int, device: torch.device) -> bool:
    """Whether the kernel keeps ng keys for `dtype` values in shared memory
    on `device` (False: the global-atomics path)."""
    key_bytes = torch.empty(0, dtype=_DTYPES[dtype][1]).element_size()
    with torch.cuda.device(device):
        r = _library().grouped_extreme_uses_shared(key_bytes, ng)
    if r < 0:
        raise RuntimeError(f"CUDA error {-r} querying the shared-memory limit")
    return bool(r)


def grouped_extreme_kernel(values, gid, mask, ng: int, is_min: bool, counts=None) -> torch.Tensor:
    """The CUDA kernel: same result as grouped_extreme_plain."""
    lib = _library()
    code, key_dtype, out_dtype = _DTYPES[values.dtype]
    keys = torch.empty(ng, dtype=key_dtype, device=gid.device)
    out = torch.empty(ng, dtype=out_dtype, device=gid.device)
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        err = lib.grouped_extreme(
            code,
            int(is_min),
            values.data_ptr(),
            gid.data_ptr(),
            mask.data_ptr(),
            gid.numel(),
            ng,
            None if counts is None else counts.data_ptr(),
            keys.data_ptr(),
            out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_extreme launch failed with CUDA error {err}")
    grouped_extreme.launches += 1
    return out


def grouped_extreme(values, gid, mask, ng: int, is_min: bool, counts=None) -> torch.Tensor:
    """Per-group MIN (is_min) or MAX of masked values; see the module doc for
    the result type and the empty-group rule of each value dtype."""
    _check(values, gid, mask, ng, counts)
    if gid.device.type == "cuda":
        return grouped_extreme_kernel(values, gid, mask, ng, is_min, counts)
    if gid.device.type == "cpu":
        return grouped_extreme_plain(values, gid, mask, ng, is_min, counts)
    raise ValueError(f"grouped_extreme runs on cuda or cpu tensors, got {gid.device}")


#: kernel launches (the CPU path never adds to it)
grouped_extreme.launches = 0


def grouped_min(values, gid, mask, ng: int) -> torch.Tensor:
    """pallas_grouped_min: float32 per-group MIN of masked values, +inf when
    a group is empty."""
    return grouped_extreme(values.to(torch.float32).contiguous(), gid, mask, ng, True)


def grouped_max(values, gid, mask, ng: int) -> torch.Tensor:
    """pallas_grouped_max: float32 per-group MAX of masked values, -inf when
    a group is empty."""
    return grouped_extreme(values.to(torch.float32).contiguous(), gid, mask, ng, False)
