"""Exact group-by SUM + COUNT: two hand-written Hopper kernels and their plain
torch versions.

`grouped_multi_sum(values, gid, mask, ng)` has the contract of the JAX
package's `pallas_grouped_multi_sum_blocked` (pinot_tpu/ops/groupby_pallas.py):
exact per-group sums of each int32 column (float64) and per-group counts of the
masked docs (int64). Docs with the mask off, or with a group id outside
[0, ng), contribute nothing.

The shape decides the kernel. While a block's (2k+1) x ng 32-bit counters
(a count, and a low and a high word a sum) fit its shared memory
(`uses_shared_counters`), the flat kernel in
`csrc/grouped_sum_count.cu` runs, the counterpart of the Pallas
`_make_planes_kernel`. Past that, the two-level kernel in
`csrc/grouped_sum_count_2l.cu` (`grouped_multi_sum_2l`, gid = hi << L | lo),
the counterpart of `_make_planes2_kernel`. Both compute the same function.
Where the 32-bit counters moved that limit (k = 0 at ng 29k-58k, k = 1 at
ng 14.5k-19.4k on an H100) the flat kernel took 0.039-0.047 ms of device
time against the two-level kernel's 0.051-0.072, and past it its global
branch tied (k = 0) or lost (k = 1): chip_smoke.py's dispatch_band, H100
80GB HBM3 at 700 W, one 4M-doc segment.

The tensors' device decides what runs. A CUDA tensor launches a kernel (built
by `ops/build.py`), and a failed build or launch raises; a CPU tensor takes the
plain version, `grouped_multi_sum_plain`, which tests and the kernels' on-card
check compare both kernels against. `grouped_multi_sum.launches` counts the
flat kernel's launches, `grouped_multi_sum_2l.launches` the two-level kernel's.
Every launch (on the CPU, every call of the plain version through a wrapper)
records through `common/kernel_obs.py`'s KERNELS, as `ops.grouped_planes`
(flat) and `ops.grouped_planes2` (two-level), the JAX package's names.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from pinot_tpu_torch.common.kernel_obs import KERNELS, CacheObserver, count_launch, streaming_cost

#: columns per launch; wider calls split into several launches
MAX_COLS = 8

_SOURCE = "grouped_sum_count"
_SOURCE_2L = "grouped_sum_count_2l"


def _shape(k: int, n: int, ng: int) -> dict:
    """A launch's shape for the registry's byte model: a masked doc's group
    id and k values, and the (k+1, ng) int64 output."""
    return {"rows": n, "groups": ng, "cols": k, "per_doc": 4 + 4 * k, "out_bytes": (k + 1) * ng * 8, "outputs": k + 1}


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
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # values, k, gid, mask, n, ng, blocks, smem, out, stream
    lib.grouped_sum_count.argtypes = [ctypes.POINTER(ptr), i32, ptr, ptr, ctypes.c_longlong, i32, i32, i32, ptr, ptr]
    lib.grouped_sum_count.restype = i32
    lib.grouped_sum_count_plan.argtypes = [i32, i32, ctypes.c_longlong, ctypes.POINTER(i32), ctypes.POINTER(i32)]
    lib.grouped_sum_count_plan.restype = i32
    return lib


def _cuda_index(device: torch.device) -> int:
    if device.type != "cuda":
        raise ValueError(f"a CUDA device is needed, got {device}")
    return torch.cuda.current_device() if device.index is None else device.index


def uses_shared_counters(k: int, ng: int, device: torch.device) -> bool:
    """Whether the flat kernel keeps (k, ng)'s counters in shared memory on
    the CUDA `device` (False: its global-atomics path, which the engine
    leaves to the two-level kernel)."""
    return _plan(_cuda_index(device), k, ng, 0)[1] > 0


@functools.lru_cache(maxsize=256)
def _plan(index: int, k: int, ng: int, n: int) -> tuple[int, int]:
    """(blocks, dynamic shared bytes, 0 for the global branch) of the flat
    kernel for (k, ng, n) on device `index`: planned once per shape, so a
    launch makes no runtime query."""
    blocks, smem = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = _library().grouped_sum_count_plan(k, ng, n, ctypes.byref(blocks), ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"grouped_sum_count planning failed with CUDA error {err} (k={k}, ng={ng}, n={n})")
    return blocks.value, smem.value


#: engine.kernelCache.*{cache="grouped_sum_count._plan"}: observed at each
#: launch, which also folds the dispatcher's uses_shared_counters lookups
_PLAN_CACHE = CacheObserver(_plan, cache="grouped_sum_count._plan")


def _launch(lib, cols: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int, out: torch.Tensor) -> None:
    n = gid.numel()
    blocks, smem = _plan(gid.device.index, len(cols), ng, n)
    _PLAN_CACHE.observe()
    ptrs = (ctypes.c_void_p * max(len(cols), 1))(*[v.data_ptr() for v in cols])
    stream = torch.cuda.current_stream(gid.device).cuda_stream
    err = KERNELS.launch(
        "ops.grouped_planes",
        lambda: lib.grouped_sum_count(
            ptrs, len(cols), gid.data_ptr(), mask.data_ptr(), n, ng, blocks, smem, out.data_ptr(), stream
        ),
        mask,
        **_shape(len(cols), n, ng),
    )
    if err != 0:
        raise RuntimeError(f"grouped_sum_count launch failed with CUDA error {err}")
    count_launch(grouped_multi_sum)


def _by_launch(launch, values: list[torch.Tensor], gid: torch.Tensor, ng: int) -> torch.Tensor:
    """(k+1, ng) int64 from launches of at most MAX_COLS columns each; every
    launch has its own counts row, and the first launch's counts are kept."""
    k = len(values)
    out = torch.zeros(k + 1, ng, dtype=torch.int64, device=gid.device)
    with torch.cuda.device(gid.device):
        if k <= MAX_COLS:
            launch(values, out)
            return out
        for start in range(0, k, MAX_COLS):
            cols = values[start : start + MAX_COLS]
            part = torch.zeros(len(cols) + 1, ng, dtype=torch.int64, device=gid.device)
            launch(cols, part)
            out[start : start + len(cols)] = part[:-1]
            if start == 0:
                out[-1] = part[-1]
    return out


def grouped_multi_sum_kernel(values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int) -> torch.Tensor:
    """The flat CUDA kernel: same result as grouped_multi_sum_plain."""
    lib = _library()
    return _by_launch(lambda cols, out: _launch(lib, cols, gid, mask, ng, out), values, gid, ng)


# -- the two-level form: gid = hi << L | lo ----------------------------------


#: widest L the two-level kernel takes by default. Its reduce flushes each
#: group a block saw with one global atomic, so the flush grows with the
#: blocks times 2^L; past 2^12 groups a block that costs more than the wider
#: buckets save in the partition (L sweep at configs 8-9's shapes, PERF.md)
MAX_BITS = 12


def fit_bits(k: int, limit: int) -> int:
    """The widest L whose (2k+1) x 2^L 32-bit shared counters (a count and a
    low and a high word per column) fit `limit` bytes."""
    bits = 0
    while (2 * k + 1) * 4 << (bits + 1) <= limit:
        bits += 1
    return bits


def two_level_bits(k: int, ng: int, limit: int) -> int:
    """L of the two-level gid: the widest whose counters fit `limit` bytes,
    no wider than MAX_BITS and than ng needs."""
    bits = min(fit_bits(k, limit), MAX_BITS)
    while bits > 0 and 1 << (bits - 1) >= ng:
        bits -= 1
    return bits


@functools.cache
def _library_2l():
    from pinot_tpu_torch.ops.build import load

    lib = load(_SOURCE_2L)
    lib.grouped_sum_count_2l.argtypes = [
        ctypes.POINTER(ctypes.c_void_p),
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.c_void_p,
        ctypes.c_longlong,
        ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.grouped_sum_count_2l.restype = ctypes.c_int
    lib.grouped_sum_count_2l_scratch.argtypes = [
        ctypes.c_int,
        ctypes.c_longlong,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
    ]
    lib.grouped_sum_count_2l_scratch.restype = ctypes.c_int
    lib.grouped_sum_count_2l_sparse_max.argtypes = lib.grouped_sum_count_2l_scratch.argtypes
    lib.grouped_sum_count_2l_sparse_max.restype = ctypes.c_int
    lib.grouped_sum_count_2l_shared_limit.argtypes = []
    lib.grouped_sum_count_2l_shared_limit.restype = ctypes.c_int
    return lib


def shared_limit(device: torch.device) -> int:
    """Opt-in shared memory of one block on the CUDA `device`, in bytes."""
    return _shared_limit(_cuda_index(device))


@functools.cache
def _shared_limit(index: int) -> int:
    with torch.cuda.device(index):
        r = _library_2l().grouped_sum_count_2l_shared_limit()
    if r < 0:
        raise RuntimeError(f"CUDA error {-r} querying the shared-memory limit")
    return r


@functools.lru_cache(maxsize=256)
def _scratch_bytes(index: int, k: int, n: int, ng: int, bits: int) -> int:
    need = ctypes.c_longlong(0)
    with torch.cuda.device(index):
        err = _library_2l().grouped_sum_count_2l_scratch(k, n, ng, bits, ctypes.byref(need))
    if err != 0:
        raise RuntimeError(f"grouped_sum_count_2l planning failed with CUDA error {err} (k={k}, ng={ng}, L={bits})")
    return need.value


_SCRATCH_CACHE = CacheObserver(_scratch_bytes, cache="grouped_sum_count_2l._scratch_bytes")


def sparse_max(k: int, n: int, ng: int, bits: int, device: torch.device) -> int:
    """The most masked in-range docs a hi bucket of the two-level kernel may
    hold on the CUDA `device` and still be sparse, its docs added straight
    into the output with no record: the kernel's own plan for (k, n, ng, L)."""
    docs = ctypes.c_longlong(0)
    with torch.cuda.device(_cuda_index(device)):
        err = _library_2l().grouped_sum_count_2l_sparse_max(k, n, ng, bits, ctypes.byref(docs))
    if err != 0:
        raise RuntimeError(f"grouped_sum_count_2l planning failed with CUDA error {err} (k={k}, ng={ng}, L={bits})")
    return docs.value


def _launch_2l(lib, cols, gid: torch.Tensor, mask: torch.Tensor, ng: int, bits: int, out: torch.Tensor) -> None:
    n = gid.numel()
    need = _scratch_bytes(gid.device.index, len(cols), n, ng, bits)
    _SCRATCH_CACHE.observe()
    # freed when this returns: the caching allocator hands it out again only
    # to work queued after the kernel on the same stream
    scratch = torch.empty(need, dtype=torch.uint8, device=gid.device)
    ptrs = (ctypes.c_void_p * max(len(cols), 1))(*[v.data_ptr() for v in cols])
    stream = torch.cuda.current_stream(gid.device).cuda_stream
    err = KERNELS.launch(
        "ops.grouped_planes2",
        lambda: lib.grouped_sum_count_2l(
            ptrs, len(cols), gid.data_ptr(), mask.data_ptr(), n, ng, bits, scratch.data_ptr(), need, out.data_ptr(),
            stream,
        ),
        mask,
        **_shape(len(cols), n, ng),
    )
    if err != 0:
        raise RuntimeError(f"grouped_sum_count_2l launch failed with CUDA error {err}")
    count_launch(grouped_multi_sum_2l)


def grouped_multi_sum_2l_kernel(
    values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int, bits: int | None = None
) -> torch.Tensor:
    """The two-level CUDA kernel: same result as grouped_multi_sum_plain.
    `bits` is L; by default the widest whose counters fit a block's shared
    memory. Every L gives the same result."""
    if bits is not None and not 0 <= bits <= 30:
        raise ValueError(f"bits must lie in [0, 30], got {bits}")
    lib = _library_2l()
    limit = shared_limit(gid.device)

    def launch(cols, out):
        _launch_2l(lib, cols, gid, mask, ng, two_level_bits(len(cols), ng, limit) if bits is None else bits, out)

    return _by_launch(launch, values, gid, ng)


def _device_kind(gid: torch.Tensor, name: str) -> str:
    if gid.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu tensors, got {gid.device}")
    return gid.device.type


def grouped_multi_sum_2l(values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int) -> torch.Tensor:
    """grouped_multi_sum's function through the two-level kernel, as (k+1, ng)
    int64: rows 0..k-1 the sums, row k the counts."""
    _check(values, gid, mask, ng)
    if _device_kind(gid, "grouped_multi_sum_2l") == "cuda":
        return grouped_multi_sum_2l_kernel(values, gid, mask, ng)
    return KERNELS.launch(
        "ops.grouped_planes2",
        lambda: grouped_multi_sum_plain(values, gid, mask, ng),
        mask,
        **_shape(len(values), gid.numel(), ng),
    )


#: two-level kernel launches (the CPU path never adds to it)
grouped_multi_sum_2l.launches = 0


def grouped_multi_sum(
    values: list[torch.Tensor], gid: torch.Tensor, mask: torch.Tensor, ng: int
) -> tuple[list[torch.Tensor], torch.Tensor]:
    """Exact per-group sums (float64, exact while |sum| < 2^53) of each int32
    column and per-group counts (int64) of masked docs: on a card the flat
    kernel while its counters fit shared memory, else the two-level one."""
    _check(values, gid, mask, ng)
    if _device_kind(gid, "grouped_multi_sum") == "cpu":
        out = KERNELS.launch(
            "ops.grouped_planes",
            lambda: grouped_multi_sum_plain(values, gid, mask, ng),
            mask,
            **_shape(len(values), gid.numel(), ng),
        )
    elif uses_shared_counters(min(len(values), MAX_COLS), ng, gid.device):
        out = grouped_multi_sum_kernel(values, gid, mask, ng)
    else:
        out = grouped_multi_sum_2l_kernel(values, gid, mask, ng)
    return [out[j].to(torch.float64) for j in range(len(values))], out[-1]


#: flat kernel launches (the CPU path never adds to it)
grouped_multi_sum.launches = 0


KERNELS.register(
    "ops.grouped_planes",
    grouped_multi_sum_kernel,
    cost_model=streaming_cost,
    description="exact per-group SUM of int32 columns + COUNT, counters in shared memory (csrc/grouped_sum_count.cu)",
)
KERNELS.register(
    "ops.grouped_planes2",
    grouped_multi_sum_2l_kernel,
    cost_model=streaming_cost,
    description="exact per-group SUM + COUNT for large ng, two-level gid (csrc/grouped_sum_count_2l.cu)",
)
