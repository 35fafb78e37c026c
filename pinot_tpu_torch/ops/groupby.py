"""Exact group-by SUM + COUNT: the hand-written Hopper kernel and its plain
torch version.

`grouped_multi_sum(values, gid, mask, ng)` has the contract of the JAX
package's `pallas_grouped_multi_sum_blocked` (pinot_tpu/ops/groupby_pallas.py):
exact per-group sums of each int32 column (float64) and per-group counts of the
masked docs (int64). Docs with the mask off, or with a group id outside
[0, ng), contribute nothing.

The tensors' device decides what runs. A CUDA tensor launches the kernel in
`csrc/grouped_sum_count.cu` (built by `ops/build.py`), and a failed build or
launch raises; a CPU tensor takes the plain version, which tests and the
kernel's on-card check compare against. `grouped_multi_sum.launches` counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

#: columns per launch; wider calls split into several launches
MAX_COLS = 8

_SOURCE = "grouped_sum_count"


def _check(values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int) -> None:
    if ng <= 0:
        raise ValueError(f"ng must be positive, got {ng}")
    if gid.dtype != torch.int32 or gid.dim() != 1 or not gid.is_contiguous():
        raise ValueError(f"gid must be a contiguous 1-D int32 tensor, got {gid.dtype} {tuple(gid.shape)}")
    if mask.dtype != torch.bool or mask.shape != gid.shape or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor of shape {tuple(gid.shape)}")
    if mask.device != gid.device:
        raise ValueError(f"mask on {mask.device}, gid on {gid.device}")
    for v in values:
        if v.dtype != torch.int32 or v.shape != gid.shape or not v.is_contiguous():
            raise ValueError(f"values must be contiguous int32 tensors of shape {tuple(gid.shape)}")
        if v.device != gid.device:
            raise ValueError(f"a value column on {v.device}, gid on {gid.device}")


def grouped_multi_sum_plain(values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int) -> torch.Tensor:
    """The plain torch version: (k+1, ng) int64, rows 0..k-1 the sums of each
    column, row k the counts."""
    ok = mask & (gid >= 0) & (gid < ng)
    idx = torch.where(ok, gid, 0).to(torch.int64)
    rows = [torch.where(ok, v, 0).to(torch.int64) for v in values] + [ok.to(torch.int64)]
    out = torch.zeros(len(rows), ng, dtype=torch.int64, device=gid.device)
    return out.index_add_(1, idx, torch.stack(rows))


@functools.cache
def _library():
    from pinot_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    fn = lib.grouped_sum_count
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    lib.grouped_sum_count_uses_shared.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.grouped_sum_count_uses_shared.restype = ctypes.c_int
    return lib


def uses_shared_counters(k: int, ng: int, device: torch.device) -> bool:
    """Whether the kernel keeps (k, ng)'s counters in shared memory on
    `device` (False: the global-atomics path)."""
    with torch.cuda.device(device):
        r = _library().grouped_sum_count_uses_shared(k, ng)
    if r < 0:
        raise RuntimeError(f"CUDA error {-r} querying the shared-memory limit")
    return bool(r)


def _launch(lib, cols: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int, out: torch.Tensor) -> None:
    ptrs = (ctypes.c_void_p * max(len(cols), 1))(*[v.data_ptr() for v in cols])
    stream = torch.cuda.current_stream(gid.device).cuda_stream
    err = lib.grouped_sum_count(ptrs, len(cols), gid.data_ptr(), mask.data_ptr(), gid.numel(), ng, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"grouped_sum_count launch failed with CUDA error {err}")
    grouped_multi_sum.launches += 1


def grouped_multi_sum_kernel(values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int) -> torch.Tensor:
    """The CUDA kernel: same result as grouped_multi_sum_plain."""
    lib = _library()
    k = len(values)
    out = torch.zeros(k + 1, ng, dtype=torch.int64, device=gid.device)
    with torch.cuda.device(gid.device):
        if k <= MAX_COLS:
            _launch(lib, values, gid, mask, ng, out)
            return out
        # wider calls: one launch per MAX_COLS columns, each with its own
        # counts row; the first launch's counts are kept
        for start in range(0, k, MAX_COLS):
            cols = values[start : start + MAX_COLS]
            part = torch.zeros(len(cols) + 1, ng, dtype=torch.int64, device=gid.device)
            _launch(lib, cols, gid, mask, ng, part)
            out[start : start + len(cols)] = part[:-1]
            if start == 0:
                out[-1] = part[-1]
    return out


def grouped_multi_sum(
    values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Exact per-group sums (float64, exact while |sum| < 2^53) of each int32
    column and per-group counts (int64) of masked docs."""
    _check(values, gid, mask, ng)
    if gid.device.type == "cuda":
        out = grouped_multi_sum_kernel(values, gid, mask, ng)
    elif gid.device.type == "cpu":
        out = grouped_multi_sum_plain(values, gid, mask, ng)
    else:
        raise ValueError(f"grouped_multi_sum runs on cuda or cpu tensors, got {gid.device}")
    return [out[j].to(torch.float64) for j in range(len(values))], out[-1]


#: kernel launches (the CPU path never adds to it)
grouped_multi_sum.launches = 0
