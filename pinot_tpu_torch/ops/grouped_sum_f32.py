"""Per-group float32 SUM / COUNT and DISTINCTCOUNT presence: the hand-written
Hopper kernel and its plain torch versions.

Both functions launch `csrc/grouped_sum_f32.cu`, the counterpart of the JAX
package's one-hot-sum Pallas kernel (pinot_tpu/ops/groupby_pallas.py):

* `grouped_sum(values, gid, mask, ng)` / `grouped_count(gid, mask, ng)` have
  the contract of `pallas_grouped_sum` / `pallas_grouped_count`: float32
  per-group sums of the masked values (counts of the masked docs, exact below
  2^24 a group). The kernel adds with atomics in an order that changes from
  run to run, so its sums agree with another order to f32 rounding
  (rtol 1e-4, atol 1e-2 at the tests' sizes). A non-finite value stays in its
  own group, as with segment_sum.
* `presence(ids, mask, pad, gid=None, ng=1)` is "count > 0" of
  `pallas_presence`, without the sum: a bool (pad,) vector, True where a
  masked doc has that id, and with `gid` the grouped form, a bool (ng, pad)
  matrix, the reference engine's `.at[gid, ids].max(mask)` presence. Ids
  outside [0, pad) and group ids outside [0, ng) contribute nothing.

The tensors' device decides what runs. A CUDA tensor launches the kernel (a
failed build or launch raises); a CPU tensor takes the plain version.
`grouped_sum.launches` and `presence.launches` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

_SOURCE = "grouped_sum_f32"


def _check_ids(name: str, t: torch.Tensor, shape) -> None:
    if t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int32 tensor, got {t.dtype} {tuple(t.shape)}")
    if shape is not None and t.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")


def _check_mask(mask: torch.Tensor, like: torch.Tensor) -> None:
    if mask.dtype != torch.bool or mask.shape != like.shape or not mask.is_contiguous():
        raise ValueError(f"mask must be a contiguous bool tensor of shape {tuple(like.shape)}")
    if mask.device != like.device:
        raise ValueError(f"mask on {mask.device}, ids on {like.device}")


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel (a CUDA tensor), False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name} runs on cuda or cpu tensors, got {t.device}")


@functools.cache
def _library():
    from pinot_tpu_torch.ops.build import load

    lib = load(_SOURCE)
    ptr, n, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    # values, gid, mask, n, ng, out, stream
    lib.grouped_sum_f32.argtypes = [ptr, ptr, ptr, n, i, ptr, ptr]
    lib.grouped_sum_f32.restype = ctypes.c_int
    # ids, gid, mask, n, pad, ng, out, stream
    lib.presence_flags.argtypes = [ptr, ptr, ptr, n, i, i, ptr, ptr]
    lib.presence_flags.restype = ctypes.c_int
    lib.grouped_sum_f32_uses_shared.argtypes = [ctypes.c_longlong]
    lib.grouped_sum_f32_uses_shared.restype = ctypes.c_int
    return lib


def uses_shared(state_bytes: int, device: torch.device) -> bool:
    """Whether per-block state of `state_bytes` (ng * 4 for a sum,
    presence_state_bytes for presence) stays in shared memory on `device`."""
    with torch.cuda.device(device):
        r = _library().grouped_sum_f32_uses_shared(state_bytes)
    if r < 0:
        raise RuntimeError(f"CUDA error {-r} querying the shared-memory limit")
    return bool(r)


def presence_state_bytes(pad: int, ng: int) -> int:
    """A block's presence flags: ng * pad bytes, rounded up to 16."""
    return (ng * pad + 15) // 16 * 16


# ---------------------------------------------------------------------------
# SUM / COUNT
# ---------------------------------------------------------------------------


def grouped_sum_plain(values, gid, mask, ng: int) -> torch.Tensor:
    """The plain version: float32 index_add_ of the masked values (of 1 per
    masked doc when values is None)."""
    ok = mask & (gid >= 0) & (gid < ng)
    idx = torch.where(ok, gid, 0).to(torch.int64)
    src = ok.to(torch.float32) if values is None else torch.where(ok, values, 0.0)
    return torch.zeros(ng, dtype=torch.float32, device=gid.device).index_add_(0, idx, src)


def grouped_sum_kernel(values, gid, mask, ng: int) -> torch.Tensor:
    """The CUDA kernel: same result as grouped_sum_plain, to f32 rounding."""
    lib = _library()
    out = torch.zeros(ng, dtype=torch.float32, device=gid.device)
    with torch.cuda.device(gid.device):
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        err = lib.grouped_sum_f32(
            None if values is None else values.data_ptr(),
            gid.data_ptr(),
            mask.data_ptr(),
            gid.numel(),
            ng,
            out.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"grouped_sum_f32 launch failed with CUDA error {err}")
    grouped_sum.launches += 1
    return out


def grouped_sum(values, gid, mask, ng: int) -> torch.Tensor:
    """pallas_grouped_sum: float32 per-group sums of the masked values (taken
    as float32); values None counts the masked docs."""
    if ng <= 0:
        raise ValueError(f"ng must be positive, got {ng}")
    _check_ids("gid", gid, None)
    _check_mask(mask, gid)
    if values is not None:
        values = values.to(torch.float32).contiguous()
        if values.shape != gid.shape or values.device != gid.device:
            raise ValueError(f"values must be a tensor of shape {tuple(gid.shape)} on {gid.device}")
    if _route(gid, "grouped_sum"):
        return grouped_sum_kernel(values, gid, mask, ng)
    return grouped_sum_plain(values, gid, mask, ng)


#: kernel launches of the SUM entry (the CPU path never adds to it)
grouped_sum.launches = 0


def grouped_count(gid, mask, ng: int) -> torch.Tensor:
    """pallas_grouped_count: float32 per-group counts of the masked docs."""
    return grouped_sum(None, gid, mask, ng)


# ---------------------------------------------------------------------------
# presence
# ---------------------------------------------------------------------------


def presence_plain(ids, mask, pad: int, gid=None, ng: int = 1) -> torch.Tensor:
    """The plain version: True at every (group, id) cell a masked doc hits."""
    ok = mask & (ids >= 0) & (ids < pad)
    cell = ids.to(torch.int64)
    if gid is not None:
        ok &= (gid >= 0) & (gid < ng)
        cell = gid.to(torch.int64) * pad + cell
    flags = torch.zeros(ng * pad, dtype=torch.bool, device=ids.device)
    flags[cell[ok]] = True
    return flags if gid is None else flags.view(ng, pad)


def presence_kernel(ids, mask, pad: int, gid=None, ng: int = 1) -> torch.Tensor:
    """The CUDA kernel: same result as presence_plain."""
    lib = _library()
    flags = torch.zeros(ng * pad, dtype=torch.bool, device=ids.device)
    with torch.cuda.device(ids.device):
        stream = torch.cuda.current_stream(ids.device).cuda_stream
        err = lib.presence_flags(
            ids.data_ptr(),
            None if gid is None else gid.data_ptr(),
            mask.data_ptr(),
            ids.numel(),
            pad,
            ng,
            flags.data_ptr(),
            stream,
        )
    if err != 0:
        raise RuntimeError(f"presence_flags launch failed with CUDA error {err}")
    presence.launches += 1
    return flags if gid is None else flags.view(ng, pad)


def presence(ids, mask, pad: int, gid=None, ng: int = 1) -> torch.Tensor:
    """DISTINCTCOUNT presence: bool (pad,) over the ids of masked docs, or
    with `gid` bool (ng, pad) per group."""
    if pad <= 0 or ng <= 0:
        raise ValueError(f"pad and ng must be positive, got pad={pad} ng={ng}")
    _check_ids("ids", ids, None)
    _check_mask(mask, ids)
    if gid is None:
        if ng != 1:
            raise ValueError("the scalar form (gid=None) has ng == 1")
    else:
        _check_ids("gid", gid, ids.shape)
        if gid.device != ids.device:
            raise ValueError(f"gid on {gid.device}, ids on {ids.device}")
    if _route(ids, "presence"):
        return presence_kernel(ids, mask, pad, gid, ng)
    return presence_plain(ids, mask, pad, gid, ng)


#: kernel launches of the PRESENCE entry (the CPU path never adds to it)
presence.launches = 0
