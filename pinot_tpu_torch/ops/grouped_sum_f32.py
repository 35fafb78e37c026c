"""Per-group float32 SUM / COUNT and DISTINCTCOUNT presence: the hand-written
Hopper kernel and its plain torch versions.

Every function launches `csrc/grouped_sum_f32.cu`, the counterpart of the JAX
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
* `presences(columns, pads, mask, gid=None, ng=1)` is the engine's form:
  `presence` of each id column over one mask and one gid, for every
  DISTINCTCOUNT of a query in one pass; a kernel launch takes up to MAX_COLS
  columns, wider calls split. `presence` is its one-column call.

The tensors' device decides what runs. A CUDA tensor launches the kernel (a
failed build or launch raises); a CPU tensor takes the plain version.
`grouped_sum.launches` counts the sum entry's kernel launches and
`presence.launches` the presence entry's, from either presence function.
Both entries' launches (on the CPU, every call of a plain version through a
wrapper) record through `common/kernel_obs.py`'s KERNELS as
`ops.grouped_sum`, the JAX package's name for the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pinot_tpu_torch.common.kernel_obs import KERNELS, count_launch, streaming_cost

_SOURCE = "grouped_sum_f32"
#: id columns per presence launch; wider calls split
MAX_COLS = 8


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
    pptr, pi = ctypes.POINTER(ptr), ctypes.POINTER(i)
    # values, gid, mask, n, ng, out, stream
    lib.grouped_sum_f32.argtypes = [ptr, ptr, ptr, n, i, ptr, ptr]
    lib.grouped_sum_f32.restype = ctypes.c_int
    # grouped, words, n, blocks, smem
    lib.presence_plan.argtypes = [i, n, n, pi, pi]
    lib.presence_plan.restype = ctypes.c_int
    # ncols, ids, pads, gid, mask, n, ng, blocks, smem, outs, table, stream
    lib.presences.argtypes = [i, pptr, pi, ptr, ptr, n, i, i, i, pptr, ptr, ptr]
    lib.presences.restype = ctypes.c_int
    lib.grouped_sum_f32_uses_shared.argtypes = [ctypes.c_longlong]
    lib.grouped_sum_f32_uses_shared.restype = ctypes.c_int
    return lib


def uses_shared(state_bytes: int, device: torch.device) -> bool:
    """Whether a sum's per-block state of `state_bytes` (ng * 4) stays in
    shared memory on `device`."""
    with torch.cuda.device(device):
        r = _library().grouped_sum_f32_uses_shared(state_bytes)
    if r < 0:
        raise RuntimeError(f"CUDA error {-r} querying the shared-memory limit")
    return bool(r)


def presence_words(pads, ng: int) -> int:
    """A block's presence flags of one launch over id columns of `pads`:
    ceil(pad / 32) 32-bit words a (column, group)."""
    return ng * sum(-(-pad // 32) for pad in pads)


# ---------------------------------------------------------------------------
# SUM / COUNT
# ---------------------------------------------------------------------------


def _sum_shape(values, gid, ng: int) -> dict:
    """A sum launch's shape for the registry's byte model: a masked doc's
    group id and value, the float32 sums written once."""
    return {"rows": gid.numel(), "groups": ng, "per_doc": 4 if values is None else 8, "out_bytes": 4 * ng}


def _presence_shape(columns, pads, mask, gid, ng: int) -> dict:
    """A presence launch's shape for the registry's byte model: a masked
    doc's ids (and group id), the flags written once."""
    per_doc = 4 * len(columns) + (4 if gid is not None else 0)
    return {"rows": mask.numel(), "groups": ng, "per_doc": per_doc, "out_bytes": ng * sum(pads),
            "outputs": len(columns)}


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
        err = KERNELS.launch(
            "ops.grouped_sum",
            lambda: lib.grouped_sum_f32(
                None if values is None else values.data_ptr(),
                gid.data_ptr(),
                mask.data_ptr(),
                gid.numel(),
                ng,
                out.data_ptr(),
                stream,
            ),
            mask,
            **_sum_shape(values, gid, ng),
        )
    if err != 0:
        raise RuntimeError(f"grouped_sum_f32 launch failed with CUDA error {err}")
    count_launch(grouped_sum)
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
    return KERNELS.launch(
        "ops.grouped_sum", lambda: grouped_sum_plain(values, gid, mask, ng), mask, **_sum_shape(values, gid, ng)
    )


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


def presences_plain(columns, pads, mask, gid=None, ng: int = 1) -> list[torch.Tensor]:
    """The plain version: presence_plain of each column."""
    return [presence_plain(ids, mask, pad, gid, ng) for ids, pad in zip(columns, pads)]


def _index(device: torch.device) -> int:
    return torch.cuda.current_device() if device.index is None else device.index


@functools.lru_cache(maxsize=256)
def _plan(index: int, grouped: bool, words: int, n: int) -> tuple[int, int]:
    """(blocks, dynamic shared bytes or 0 for byte flags in global memory) of
    a presence launch on device `index`: planned once per shape, so a launch
    makes no runtime query."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().presence_plan(int(grouped), words, n, ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"presence planning failed with CUDA error {err} (words={words}, n={n})")
    return blocks.value, smem.value


def uses_shared_flags(pads, ng: int, device: torch.device, grouped: bool = True) -> bool:
    """Whether one launch keeps the flags of id columns of `pads` over ng
    groups as bits in shared memory on the CUDA `device` (False: byte flags
    in global memory)."""
    return _plan(_index(device), grouped, presence_words(pads, ng), 0)[1] > 0


@functools.lru_cache(maxsize=256)
def _spec(index: int, grouped: bool, pads: tuple[int, ...], ng: int, n: int):
    """The plan and the ctypes pads array of one launch, built once per
    shape."""
    return _plan(index, grouped, presence_words(pads, ng), n), (ctypes.c_int * len(pads))(*pads)


def _launch(lib, columns, pads, mask, gid, ng: int) -> list[torch.Tensor]:
    """One launch for at most MAX_COLS columns: one zeroed buffer holds a
    view a column and, on the shared path, the kernel's bit table."""
    n = mask.numel()
    (blocks, smem), c_pads = _spec(mask.device.index, gid is not None, tuple(pads), ng, n)
    sizes = [ng * pad for pad in pads]
    starts = [sum(sizes[:j]) for j in range(len(sizes))]
    table = -(-sum(sizes) // 4) * 4  # the table's byte offset, 4-byte aligned
    buf = torch.zeros(table + smem, dtype=torch.uint8, device=mask.device)
    base = buf.data_ptr()
    m = len(columns)
    err = KERNELS.launch("ops.grouped_sum", lambda: lib.presences(
        m,
        (ctypes.c_void_p * m)(*[ids.data_ptr() for ids in columns]),
        c_pads,
        None if gid is None else gid.data_ptr(),
        mask.data_ptr(),
        n,
        ng,
        blocks,
        smem,
        (ctypes.c_void_p * m)(*[base + s for s in starts]),
        base + table if smem else None,
        torch.cuda.current_stream(mask.device).cuda_stream,
    ), mask, **_presence_shape(columns, pads, mask, gid, ng))
    if err != 0:
        raise RuntimeError(f"presences launch failed with CUDA error {err}")
    count_launch(presence)
    flags = buf.view(torch.bool)
    views = [flags[s : s + size] for s, size in zip(starts, sizes)]
    return views if gid is None else [v.view(ng, pad) for v, pad in zip(views, pads)]


def presences_kernel(columns, pads, mask, gid=None, ng: int = 1) -> list[torch.Tensor]:
    """The CUDA kernel: same results as presences_plain."""
    lib = _library()
    out = []
    with torch.cuda.device(mask.device):
        for start in range(0, len(columns), MAX_COLS):
            out += _launch(lib, columns[start : start + MAX_COLS], pads[start : start + MAX_COLS], mask, gid, ng)
    return out


def presences(columns, pads, mask, gid=None, ng: int = 1) -> list[torch.Tensor]:
    """DISTINCTCOUNT presence of each id column over one mask (and gid): a
    bool (pad,) vector each, or with `gid` a bool (ng, pad) matrix each."""
    if not columns or len(columns) != len(pads):
        raise ValueError(f"need one pad per id column, got {len(columns)} columns and {len(pads)} pads")
    if ng <= 0 or any(pad <= 0 for pad in pads):
        raise ValueError(f"pads and ng must be positive, got pads={list(pads)} ng={ng}")
    _check_mask(mask, columns[0])
    for ids in columns:
        _check_ids("ids", ids, mask.shape)
        if ids.device != mask.device:
            raise ValueError(f"mask on {mask.device}, ids on {ids.device}")
    if gid is None:
        if ng != 1:
            raise ValueError("the scalar form (gid=None) has ng == 1")
    else:
        _check_ids("gid", gid, mask.shape)
        if gid.device != mask.device:
            raise ValueError(f"gid on {gid.device}, ids on {mask.device}")
    if _route(mask, "presence"):
        return presences_kernel(columns, pads, mask, gid, ng)
    return KERNELS.launch(
        "ops.grouped_sum",
        lambda: presences_plain(columns, pads, mask, gid, ng),
        mask,
        **_presence_shape(columns, pads, mask, gid, ng),
    )


def presence_kernel(ids, mask, pad: int, gid=None, ng: int = 1) -> torch.Tensor:
    """The CUDA kernel for one column: same result as presence_plain."""
    return presences_kernel([ids], [pad], mask, gid, ng)[0]


def presence(ids, mask, pad: int, gid=None, ng: int = 1) -> torch.Tensor:
    """DISTINCTCOUNT presence: bool (pad,) over the ids of masked docs, or
    with `gid` bool (ng, pad) per group."""
    return presences([ids], [pad], mask, gid, ng)[0]


#: kernel launches of the presence entry, from presence and presences (the
#: CPU path never adds to it)
presence.launches = 0

KERNELS.register(
    "ops.grouped_sum",
    presences_kernel,
    cost_model=streaming_cost,
    description="f32 per-group SUM / COUNT and DISTINCTCOUNT presence flags (csrc/grouped_sum_f32.cu)",
)
