#!/usr/bin/env python3
"""Card check of pinot_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the root of the repository

1. Card: prints the card's name and power limit, builds every CUDA kernel of
   the package from the sources in the checkout (nvcc, sm_90a, one process
   per source, all started together).
2. Kernels: holds each kernel against its plain torch version on the card,
   at the main path's shapes and at edge cases, and times kernel, plain
   version and the PyTorch library call beside the bound. Kernels:
   grouped_sum_count (exact int sums + counts), grouped_extreme (MIN/MAX of
   f32, i32 and f64 values) and grouped_sum_f32 (f32 sums / counts and the
   DISTINCTCOUNT presence flags). Tolerance: exact equality (== , NaN equal
   to NaN) for everything but f32 sums, which add in a run-dependent order
   and are held to rtol 1e-4, atol 1e-2.
3. Main path: generates the SSB-flavoured lineorder (16M rows, seed 0, the
   generator of bench.py), builds 4 segments of 4M rows with the package's
   SegmentBuilder, stages them on the card and runs configs 1-7 (BASELINE
   1-4, grouped MIN/MAX, grouped and scalar DISTINCTCOUNT) through
   QueryEngine(..., device="cuda").execute. Every result row is held against
   a numpy oracle over the raw arrays; the kernels' launch counters are reset
   just before that run and read just after, per config.

Every phase that fails raises, and the script exits non-zero. The last line
of standard output is {"ok": true, "device": {...}}; the line before it is a
JSON object with one entry per kernel.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

N_ROWS = 16_000_000
N_SEGMENTS = 4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
L2_FLUSH_BYTES = 128 << 20  # > the 50 MB L2

NATIONS = [f"NATION_{i:02d}" for i in range(25)]
CATEGORIES = [f"MFGR#{i // 10 + 1}{i % 10 + 1}" for i in range(25)]

# BASELINE configs 1-4, the SQL texts of bench.py
CONFIGS = {
    "1_count_filter": "SELECT COUNT(*) FROM lineorder WHERE c_nation = 'NATION_07'",
    "2_filtered_agg": (
        "SELECT SUM(lo_revenue), MIN(lo_quantity), MAX(lo_revenue), AVG(lo_supplycost) "
        "FROM lineorder WHERE d_year BETWEEN 1994 AND 1996 AND c_nation = 'NATION_03'"
    ),
    "3_q1_groupby": (
        "SELECT d_year, SUM(lo_revenue) FROM lineorder "
        "WHERE (c_nation = 'NATION_01' OR c_nation = 'NATION_02') AND lo_quantity < 25 "
        "GROUP BY d_year ORDER BY d_year LIMIT 20"
    ),
    "4_q4_groupby_orderby": (
        "SELECT d_year, c_nation, p_category, SUM(lo_revenue - lo_supplycost) "
        "FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
        "GROUP BY d_year, c_nation, p_category ORDER BY SUM(lo_revenue - lo_supplycost) DESC LIMIT 10"
    ),
}
CONFIGS.update(
    {
        "5_groupby_minmax": (
            "SELECT d_year, c_nation, COUNT(*), MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost), "
            "MAX(lo_revenue / lo_quantity) FROM lineorder WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 "
            "GROUP BY d_year, c_nation ORDER BY d_year, c_nation LIMIT 200"
        ),
        "6_groupby_distinct": (
            "SELECT d_year, p_category, COUNT(*), DISTINCTCOUNT(c_nation) FROM lineorder "
            "WHERE lo_quantity = 1 AND lo_revenue < 20000 "
            "GROUP BY d_year, p_category ORDER BY d_year, p_category LIMIT 200"
        ),
        "7_distinct": (
            "SELECT COUNT(DISTINCT c_nation), DISTINCTCOUNT(p_category), MIN(lo_revenue) FROM lineorder "
            "WHERE lo_quantity = 1 AND lo_revenue < 20000"
        ),
    }
)
#: kernel launches per segment of each config: (grouped_sum_count,
#: grouped_extreme, presence)
LAUNCHES_PER_SEGMENT = {
    "1_count_filter": (0, 0, 0),
    "2_filtered_agg": (0, 0, 0),
    "3_q1_groupby": (1, 0, 0),
    "4_q4_groupby_orderby": (1, 0, 0),
    "5_groupby_minmax": (1, 5, 0),  # MIN, MAX, MINMAXRANGE (2) of int32, MAX of float64
    "6_groupby_distinct": (1, 0, 1),
    "7_distinct": (0, 0, 2),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


def time_ms(torch, fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over `iters` runs, each after the L2
    is flushed (the main path reads its columns from device memory)."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters


# ---------------------------------------------------------------------------
# phase 2: the exact group-by kernel against its plain version
# ---------------------------------------------------------------------------


def kernel_cases(torch, gb):
    """(name, values, gid, mask, ng, expect_shared) at the main path's shape
    and at the edges of the kernel's contract."""
    rng = np.random.default_rng(1)
    dev = "cuda"
    i32 = np.iinfo(np.int32)

    def t(a, dtype=torch.int32):
        return torch.as_tensor(a).to(dtype).to(dev).contiguous()

    n = 4_194_304
    q4_gid = rng.integers(0, 4375, n)
    q4 = (
        "q4_shape",
        [t(rng.integers(-600_000, 600_001, n))],
        t(q4_gid),
        t(rng.random(n) < 0.7, torch.bool),
        4608,
        True,
    )
    n2 = 1 << 20
    extremes = rng.choice(np.array([i32.min, i32.max, -1, 0, 1], dtype=np.int64), size=(3, n2))
    gid2 = rng.integers(-3, 259, n2)  # a few ids outside [0, 256): dropped
    ext = ("k3_int32_extremes", [t(extremes[j]) for j in range(3)], t(gid2), t(rng.random(n2) < 0.9, torch.bool), 256, True)
    empty = ("empty_mask", [t(rng.integers(-5, 6, n2))], t(rng.integers(0, 100, n2)), t(np.zeros(n2, bool), torch.bool), 256, True)
    wide = (
        "k9_two_launches",
        [t(rng.integers(-(1 << 20), 1 << 20, n2)) for _ in range(9)],
        t(rng.integers(0, 300, n2)),
        t(rng.random(n2) < 0.6, torch.bool),
        300,
        True,
    )
    big = (
        "ng_2^20_k2_global",
        [t(rng.integers(-1000, 1001, n)) for _ in range(2)],
        t(rng.integers(0, 1 << 20, n)),
        t(rng.random(n) < 0.5, torch.bool),
        1 << 20,
        False,
    )
    return [q4, ext, empty, wide, big]


def check_kernels(torch, gb) -> dict:
    results = []
    max_err = 0.0
    q4 = None
    for name, values, gid, mask, ng, expect_shared in kernel_cases(torch, gb):
        shared = gb.uses_shared_counters(len(values), ng, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = gb.grouped_multi_sum_kernel(values, gid, mask, ng)
        torch.cuda.synchronize()
        want = gb.grouped_multi_sum_plain(values, gid, mask, ng)
        equal = torch.equal(got, want)
        err = float((got - want).abs().max().item())
        max_err = max(max_err, err)
        results.append({"case": name, "k": len(values), "ng": ng, "n": gid.numel(), "shared_counters": shared, "equal": equal})
        if not equal:
            raise AssertionError(f"{name}: kernel != plain version (max abs err {err})")
        if name == "q4_shape":
            q4 = (values, gid, mask, ng)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_count", "cases": results})

    values, gid, mask, ng = q4
    k, n = len(values), gid.numel()
    kernel_ms = time_ms(torch, lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng), iters=50)
    plain_ms = time_ms(torch, lambda: gb.grouped_multi_sum_plain(values, gid, mask, ng), iters=20)
    # the yardstick: ONE PyTorch call computing the same function on the same
    # inputs, prepared outside the timed region
    ok = mask & (gid >= 0) & (gid < ng)
    idx = torch.where(ok, gid, 0).to(torch.int64)
    src = torch.stack([torch.where(ok, v, 0).to(torch.int64) for v in values] + [ok.to(torch.int64)])
    dst = torch.zeros(k + 1, ng, dtype=torch.int64, device="cuda")
    library_ms = time_ms(torch, lambda: dst.index_add_(1, idx, src), iters=20)
    # bytes over the HBM rate: every input once, the output once; and the
    # data-dependent form, where only docs with the mask on need their group
    # id and values read
    out_bytes = (k + 1) * ng * 8
    bound_bytes = n * (4 + 1 + 4 * k) + out_bytes
    bound_ms = bound_bytes / HBM_BYTES_PER_S * 1e3
    data_bytes = n + int(mask.sum().item()) * (4 + 4 * k) + out_bytes
    bound_data_ms = data_bytes / HBM_BYTES_PER_S * 1e3
    timing = {
        "phase": "kernel_timing",
        "kernel": "grouped_sum_count",
        "shape": {"n": n, "k": k, "ng": ng},
        "kernel_ms": kernel_ms,
        "plain_ms": plain_ms,
        "library_ms": library_ms,
        "bound_ms": bound_ms,
        "bound_bytes": bound_bytes,
        "bound_data_ms": bound_data_ms,
        "bound_data_bytes": data_bytes,
        "card": card_line(),
    }
    emit(timing)
    return {"max_abs_err": max_err, **timing}


def same(torch, got, want) -> bool:
    """Exact equality under == (so -0.0 == +0.0), NaN equal to NaN, and the
    same dtype and shape."""
    if got.dtype != want.dtype or got.shape != want.shape:
        return False
    eq = got == want
    if got.dtype.is_floating_point:
        eq |= got.isnan() & want.isnan()
    return bool(eq.all().item())


def abs_err(torch, got, want) -> float:
    """Largest |got - want| over the entries finite on both sides."""
    g, w = got.to(torch.float64), want.to(torch.float64)
    fin = torch.isfinite(g) & torch.isfinite(w)
    return float((g - w)[fin].abs().max().item()) if bool(fin.any().item()) else 0.0


def hbm_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def _tensor(torch, a, dtype):
    return torch.as_tensor(np.ascontiguousarray(a)).to("cuda").to(dtype).contiguous()


def _in_range(torch, gid, mask, ng):
    ok = mask & (gid >= 0) & (gid < ng)
    return ok, torch.where(ok, gid, 0).to(torch.int64)


def _counts(torch, gid, mask, ng):
    ok, idx = _in_range(torch, gid, mask, ng)
    return torch.bincount(idx[ok], minlength=ng)


# ---------------------------------------------------------------------------
# phase 2b: the extreme kernel (grouped MIN/MAX) against its plain version
# ---------------------------------------------------------------------------


def extreme_cases(torch):
    """(name, values, gid, mask, ng, is_min, counts, expect_shared): Q4's
    shape, the engine's shapes (config 5: 125 groups of ng = 256), and the
    edges of the kernel's contract."""
    rng = np.random.default_rng(2)
    f32, f64, i32, b = torch.float32, torch.float64, torch.int32, torch.bool
    cases = []

    def add(name, values, gid, mask, ng, is_min, shared):
        counts = _counts(torch, gid, mask, ng) if values.dtype == i32 else None
        cases.append((name, values, gid, mask, ng, is_min, counts, shared))

    n = 4_194_304
    gid = _tensor(torch, rng.integers(0, 4375, n), i32)
    mask = _tensor(torch, rng.random(n) < 0.7, b)
    for is_min in (True, False):
        tag = "min" if is_min else "max"
        add(f"q4_shape_f32_{tag}", _tensor(torch, rng.uniform(-1e6, 1e6, n), f32), gid, mask, 4608, is_min, True)
        add(f"q4_shape_i32_{tag}", _tensor(torch, rng.integers(-600_000, 600_001, n), i32), gid, mask, 4608, is_min, True)
        add(f"q4_shape_f64_{tag}", _tensor(torch, rng.normal(0, 1e6, n), f64), gid, mask, 4608, is_min, True)

    # config 5's shape: 125 present groups of ng = 256, heavy contention
    egid = _tensor(torch, rng.integers(0, 125, n), i32)
    emask = _tensor(torch, rng.random(n) < 0.65, b)
    qty = rng.integers(1, 51, n)
    rev = rng.integers(100, 600_000, n)
    add("engine_ng256_i32_min", _tensor(torch, qty, i32), egid, emask, 256, True, True)
    add("engine_ng256_i32_max", _tensor(torch, rev, i32), egid, emask, 256, False, True)
    add("engine_ng256_f64_max", _tensor(torch, rev / qty, f64), egid, emask, 256, False, True)

    n2 = 1 << 20
    gid2 = _tensor(torch, rng.integers(0, 256, n2), i32)
    none = _tensor(torch, np.zeros(n2, bool), b)
    add("empty_mask_f32_min", _tensor(torch, rng.normal(0, 1, n2), f32), gid2, none, 256, True, True)
    add("empty_mask_i32_max", _tensor(torch, rng.integers(-5, 6, n2), i32), gid2, none, 256, False, True)
    add("empty_mask_f64_min", _tensor(torch, rng.normal(0, 1, n2), f64), gid2, none, 256, True, True)

    ogid = _tensor(torch, rng.integers(-3, 300, n2), i32)  # ids outside [0, 256): dropped
    omask = _tensor(torch, rng.random(n2) < 0.8, b)
    add("out_of_range_f32_max", _tensor(torch, rng.normal(0, 1, n2), f32), ogid, omask, 256, False, True)
    add("out_of_range_i32_min", _tensor(torch, rng.integers(-9, 9, n2), i32), ogid, omask, 256, True, True)

    i32_info = np.iinfo(np.int32)
    pool = np.array([i32_info.min, i32_info.max, i32_info.min + 1, i32_info.max - 1, -1, 0, 1], dtype=np.int64)
    for is_min in (True, False):
        tag = "min" if is_min else "max"
        # sparse mask: some groups hold only INT32_MAX (or only INT32_MIN) docs
        add(f"int32_extremes_{tag}", _tensor(torch, rng.choice(pool, n2), i32), gid2,
            _tensor(torch, rng.random(n2) < 0.002, b), 256, is_min, True)
        specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5])
        x = rng.choice(specials, n2, p=[0.0005, 0.3, 0.3, 0.001, 0.001, 0.1985, 0.199])
        add(f"nan_signed_zero_f32_{tag}", _tensor(torch, x, f32), gid2, omask, 256, is_min, True)
        add(f"nan_signed_zero_f64_{tag}", _tensor(torch, x, f64), gid2, omask, 256, is_min, True)

    big_gid = _tensor(torch, rng.integers(0, 1 << 20, n), i32)
    big_mask = _tensor(torch, rng.random(n) < 0.5, b)
    add("ng_2^20_global_f32_min", _tensor(torch, rng.normal(0, 1, n), f32), big_gid, big_mask, 1 << 20, True, False)
    add("ng_2^20_global_i32_max", _tensor(torch, rng.integers(-1000, 1001, n), i32), big_gid, big_mask, 1 << 20, False, False)
    add("ng_2^20_global_f64_min", _tensor(torch, rng.normal(0, 1, n), f64), big_gid, big_mask, 1 << 20, True, False)
    return cases


def check_extreme(torch, ext) -> dict:
    results, max_err, keep = [], 0.0, {}
    for name, values, gid, mask, ng, is_min, counts, expect_shared in extreme_cases(torch):
        shared = ext.uses_shared_keys(values.dtype, ng, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = ext.grouped_extreme_kernel(values, gid, mask, ng, is_min, counts)
        torch.cuda.synchronize()
        want = ext.grouped_extreme_plain(values, gid, mask, ng, is_min, counts)
        equal = same(torch, got, want)
        err = abs_err(torch, got, want)
        max_err = max(max_err, err)
        results.append(
            {"case": name, "dtype": str(values.dtype), "ng": ng, "n": gid.numel(), "shared_keys": shared,
             "nan_groups": int(got.isnan().sum().item()), "equal": equal}
        )
        if not equal:
            raise AssertionError(f"{name}: grouped_extreme kernel != plain version (max abs err {err})")
        keep[name] = (values, gid, mask, ng, is_min, counts)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_extreme", "cases": results})

    timings = {}
    for name in ("q4_shape_i32_min", "q4_shape_f32_min", "q4_shape_f64_max", "engine_ng256_i32_min", "engine_ng256_f64_max"):
        values, gid, mask, ng, is_min, counts = keep[name]
        n, vbytes = gid.numel(), values.element_size()
        ok, idx = _in_range(torch, gid, mask, ng)
        fill = (np.iinfo(np.int32).max if is_min else np.iinfo(np.int32).min) if values.dtype == torch.int32 else (
            math.inf if is_min else -math.inf
        )
        src = torch.where(ok, values, fill)
        dst = torch.full((ng,), fill, dtype=values.dtype, device="cuda")
        # outputs written once (f32 for f32 values, f64 otherwise), and the
        # int32 form reads the per-group counts
        out_bytes = ng * (4 if values.dtype == torch.float32 else 8) + (ng * 8 if counts is not None else 0)
        masked = int(mask.sum().item())
        timings[name] = {
            "shape": {"n": n, "ng": ng, "dtype": str(values.dtype), "is_min": is_min},
            "kernel_ms": time_ms(torch, lambda: ext.grouped_extreme_kernel(values, gid, mask, ng, is_min, counts), 50),
            "plain_ms": time_ms(torch, lambda: ext.grouped_extreme_plain(values, gid, mask, ng, is_min, counts), 20),
            "library_ms": time_ms(
                torch, lambda: dst.scatter_reduce_(0, idx, src, reduce="amin" if is_min else "amax", include_self=True), 20
            ),
            "bound_ms": hbm_ms(n * (4 + 1 + vbytes) + out_bytes),
            "bound_data_ms": hbm_ms(n + masked * (4 + vbytes) + out_bytes),
        }
    emit({"phase": "kernel_timing", "kernel": "grouped_extreme", "timings": timings, "card": card_line()})
    return {"max_abs_err": max_err, **timings["q4_shape_i32_min"]}


# ---------------------------------------------------------------------------
# phase 2c: the f32 sum / presence kernel against its plain versions
# ---------------------------------------------------------------------------


def sum_f32_cases(torch):
    """(name, values or None, gid, mask, ng, expect_shared)."""
    rng = np.random.default_rng(3)
    f32, i32, b = torch.float32, torch.int32, torch.bool
    n, n2 = 4_194_304, 1 << 20
    gid = _tensor(torch, rng.integers(0, 4375, n), i32)
    mask = _tensor(torch, rng.random(n) < 0.7, b)
    vals = _tensor(torch, rng.uniform(-100, 100, n), f32)
    gid2 = _tensor(torch, rng.integers(0, 256, n2), i32)
    ogid = _tensor(torch, rng.integers(-3, 300, n2), i32)
    mask2 = _tensor(torch, rng.random(n2) < 0.8, b)
    none = _tensor(torch, np.zeros(n2, bool), b)
    x = rng.uniform(-100, 100, n2)
    x[rng.random(n2) < 0.0001] = np.nan  # a non-finite value stays in its own group
    x[rng.random(n2) < 0.0001] = np.inf
    big_gid = _tensor(torch, rng.integers(0, 1 << 20, n), i32)
    return [
        ("q4_shape_sum", vals, gid, mask, 4608, True),
        ("q4_shape_count", None, gid, mask, 4608, True),
        ("engine_ng256_sum", _tensor(torch, rng.uniform(-100, 100, n2), f32), gid2, mask2, 256, True),
        ("empty_mask_sum", _tensor(torch, x, f32), gid2, none, 256, True),
        ("empty_mask_count", None, gid2, none, 256, True),
        ("out_of_range_sum", _tensor(torch, rng.uniform(-100, 100, n2), f32), ogid, mask2, 256, True),
        ("out_of_range_count", None, ogid, mask2, 256, True),
        ("non_finite_sum", _tensor(torch, x, f32), gid2, mask2, 256, True),
        ("ng_2^20_global_sum", vals, big_gid, mask, 1 << 20, False),
        ("ng_2^20_global_count", None, big_gid, mask, 1 << 20, False),
    ]


def presence_cases(torch):
    """(name, ids, mask, pad, gid or None, ng, expect_shared): Q4's shape,
    the engine's shapes (config 6: ng = 256, pad = 32; config 7: scalar,
    pad = 32, both at config 6-7's selectivity and at 70%), and the edges."""
    rng = np.random.default_rng(4)
    i32, b = torch.int32, torch.bool
    n = 4_194_304
    ids = _tensor(torch, rng.integers(0, 25, n), i32)
    mask = _tensor(torch, rng.random(n) < 0.7, b)
    sparse = _tensor(torch, rng.random(n) < 0.00066, b)
    q4_gid = _tensor(torch, rng.integers(0, 4375, n), i32)
    egid = _tensor(torch, rng.integers(0, 175, n), i32)
    none = _tensor(torch, np.zeros(n, bool), b)
    oids = _tensor(torch, rng.integers(-2, 40, n), i32)  # ids outside [0, 32): dropped
    ogid = _tensor(torch, rng.integers(-3, 300, n), i32)
    big_ids = _tensor(torch, rng.integers(0, 1000, n), i32)
    big_gid = _tensor(torch, rng.integers(0, 1 << 14, n), i32)
    return [
        ("q4_shape_grouped_pad32", ids, mask, 32, q4_gid, 4608, True),
        ("q4_shape_scalar_pad32", ids, mask, 32, None, 1, True),
        ("engine_ng256_pad32", ids, mask, 32, egid, 256, True),
        ("engine_ng256_pad32_sparse", ids, sparse, 32, egid, 256, True),
        ("engine_scalar_pad32", ids, mask, 32, None, 1, True),
        ("engine_scalar_pad32_sparse", ids, sparse, 32, None, 1, True),
        ("empty_mask_grouped", ids, none, 32, egid, 256, True),
        ("empty_mask_scalar", ids, none, 32, None, 1, True),
        ("out_of_range_grouped", oids, mask, 32, ogid, 256, True),
        ("out_of_range_scalar", oids, mask, 32, None, 1, True),
        ("cells_2^24_global", big_ids, mask, 1024, big_gid, 1 << 14, False),
    ]


def check_sum_f32(torch, gs) -> dict:
    results, max_err, keep = [], 0.0, {}
    for name, values, gid, mask, ng, expect_shared in sum_f32_cases(torch):
        shared = gs.uses_shared(ng * 4, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = gs.grouped_sum_kernel(values, gid, mask, ng)
        torch.cuda.synchronize()
        want = gs.grouped_sum_plain(values, gid, mask, ng)
        if values is None:  # counts: exact
            ok = same(torch, got, want)
        else:
            ok = bool(torch.allclose(got, want, rtol=1e-4, atol=1e-2, equal_nan=True))
            ok &= bool(torch.equal(got.isnan(), want.isnan()))
        err = abs_err(torch, got, want)
        max_err = max(max_err, err)
        results.append({"case": name, "ng": ng, "n": gid.numel(), "shared": shared, "max_abs_err": err, "ok": ok})
        if not ok:
            raise AssertionError(f"{name}: grouped_sum_f32 kernel != plain version (max abs err {err})")
        keep[name] = (values, gid, mask, ng)
    for name, ids, mask, pad, gid, ng, expect_shared in presence_cases(torch):
        shared = gs.uses_shared(gs.presence_state_bytes(pad, ng), ids.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        got = gs.presence_kernel(ids, mask, pad, gid, ng)
        torch.cuda.synchronize()
        want = gs.presence_plain(ids, mask, pad, gid, ng)
        equal = same(torch, got, want)
        results.append(
            {"case": name, "pad": pad, "ng": ng, "n": ids.numel(), "shared": shared,
             "present": int(got.sum().item()), "equal": equal}
        )
        if not equal:
            raise AssertionError(f"{name}: presence kernel != plain version")
        keep[name] = (ids, mask, pad, gid, ng)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_f32", "cases": results})

    timings = {}
    values, gid, mask, ng = keep["q4_shape_sum"]
    n, masked = gid.numel(), int(mask.sum().item())
    ok, idx = _in_range(torch, gid, mask, ng)
    src = torch.where(ok, values, 0.0)
    dst = torch.zeros(ng, dtype=torch.float32, device="cuda")
    timings["q4_shape_sum"] = {
        "shape": {"n": n, "ng": ng},
        "kernel_ms": time_ms(torch, lambda: gs.grouped_sum_kernel(values, gid, mask, ng), 50),
        "plain_ms": time_ms(torch, lambda: gs.grouped_sum_plain(values, gid, mask, ng), 20),
        "library_ms": time_ms(torch, lambda: dst.index_add_(0, idx, src), 20),
        "bound_ms": hbm_ms(n * (4 + 1 + 4) + 4 * ng),
        "bound_data_ms": hbm_ms(n + masked * (4 + 4) + 4 * ng),
    }
    for name in ("engine_ng256_pad32", "engine_scalar_pad32", "engine_ng256_pad32_sparse", "q4_shape_grouped_pad32"):
        ids, mask, pad, gid, ng = keep[name]
        n, masked = ids.numel(), int(mask.sum().item())
        ok = mask & (ids >= 0) & (ids < pad)
        cell = ids.to(torch.int64)
        if gid is not None:
            ok &= (gid >= 0) & (gid < ng)
            cell = gid.to(torch.int64) * pad + cell
        idx = torch.where(ok, cell, 0)
        src = ok.to(torch.uint8)
        dst = torch.zeros(ng * pad, dtype=torch.uint8, device="cuda")
        per_doc = 4 + (4 if gid is not None else 0)
        timings[name] = {
            "shape": {"n": n, "ng": ng, "pad": pad, "mask_on": masked},
            "kernel_ms": time_ms(torch, lambda: gs.presence_kernel(ids, mask, pad, gid, ng), 50),
            "plain_ms": time_ms(torch, lambda: gs.presence_plain(ids, mask, pad, gid, ng), 20),
            "library_ms": time_ms(torch, lambda: dst.scatter_reduce_(0, idx, src, reduce="amax"), 20),
            "bound_ms": hbm_ms(n * (per_doc + 1) + ng * pad),
            "bound_data_ms": hbm_ms(n + masked * per_doc + ng * pad),
        }
    emit({"phase": "kernel_timing", "kernel": "grouped_sum_f32", "timings": timings, "card": card_line()})
    return {"max_abs_err": max_err, **timings["engine_ng256_pad32"]}


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------


def make_ssb_data(n: int, seed: int = 0):
    """bench.py's SSB-flavoured lineorder generator (same draws, same order),
    also returning the dictionary codes the oracle groups by."""
    rng = np.random.default_rng(seed)
    year = rng.integers(1992, 1999, n).astype(np.int32)
    nation = rng.integers(0, 25, n)
    category = rng.integers(0, 25, n)
    data = {
        "d_year": year,
        "c_nation": np.array(NATIONS, dtype=object)[nation],
        "p_category": np.array(CATEGORIES, dtype=object)[category],
        "lo_revenue": rng.integers(100, 600_000, n).astype(np.int64),
        "lo_supplycost": rng.integers(50, 100_000, n).astype(np.int64),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
    }
    return data, nation, category


def oracle(data, nation, category) -> dict:
    year, qty = data["d_year"], data["lo_quantity"]
    rev, cost = data["lo_revenue"], data["lo_supplycost"]
    out = {"1_count_filter": [[int((nation == 7).sum())]]}

    m = (year >= 1994) & (year <= 1996) & (nation == 3)
    out["2_filtered_agg"] = [
        [float(rev[m].sum()), float(qty[m].min()), float(rev[m].max()), float(cost[m].sum()) / int(m.sum())]
    ]

    m = ((nation == 1) | (nation == 2)) & (qty < 25)
    yi = year[m] - 1992
    sums = np.bincount(yi, weights=rev[m], minlength=7)  # exact: integer partials < 2^53
    cnt = np.bincount(yi, minlength=7)
    out["3_q1_groupby"] = [[1992 + y, float(sums[y])] for y in range(7) if cnt[y]][:20]

    m = (qty > 5) & (year >= 1993) & (year <= 1997)
    key = (year[m].astype(np.int64) - 1992) * 625 + nation[m] * 25 + category[m]
    sums = np.bincount(key, weights=(rev[m] - cost[m]).astype(np.float64), minlength=7 * 625)
    cnt = np.bincount(key, minlength=7 * 625)
    present = np.flatnonzero(cnt)
    top = present[np.argsort(-sums[present], kind="stable")][:10]
    out["4_q4_groupby_orderby"] = [
        [1992 + int(g // 625), NATIONS[int(g // 25 % 25)], CATEGORIES[int(g % 25)], float(sums[g])] for g in top
    ]

    m = (qty > 5) & (year >= 1993) & (year <= 1997)
    key = (year[m].astype(np.int64) - 1992) * 25 + nation[m]  # (d_year, c_nation): NATION_xx sort by index
    order = np.argsort(key, kind="stable")
    k = key[order]
    starts = np.flatnonzero(np.r_[True, k[1:] != k[:-1]])

    def per_group(v, ufunc):
        return ufunc.reduceat(v[m][order], starts)

    cost = data["lo_supplycost"]
    ratio = rev.astype(np.float64) / qty.astype(np.float64)  # IEEE division, as on the card
    counts = np.diff(np.r_[starts, len(k)])
    mins_q = per_group(qty, np.minimum)
    maxs_r = per_group(rev, np.maximum)
    range_c = per_group(cost, np.maximum) - per_group(cost, np.minimum)
    maxs_ratio = per_group(ratio, np.maximum)
    out["5_groupby_minmax"] = [
        [1992 + int(g // 25), NATIONS[int(g % 25)], int(c), float(a), float(b), float(r), float(x)]
        for g, c, a, b, r, x in zip(k[starts], counts, mins_q, maxs_r, range_c, maxs_ratio)
    ][:200]

    m = (qty == 1) & (rev < 20000)
    key = (year[m].astype(np.int64) - 1992) * 25 + category[m]
    cnt = np.bincount(key, minlength=7 * 25)
    distinct = np.bincount(np.unique(key * 25 + nation[m]) // 25, minlength=7 * 25)
    present = sorted(np.flatnonzero(cnt), key=lambda g: (g // 25, CATEGORIES[g % 25]))  # ORDER BY the strings
    out["6_groupby_distinct"] = [
        [1992 + int(g // 25), CATEGORIES[int(g % 25)], int(cnt[g]), int(distinct[g])] for g in present
    ][:200]
    out["7_distinct"] = [[len(np.unique(nation[m])), len(np.unique(category[m])), float(rev[m].min())]]
    return out


def rows_match(name: str, got: list, want: list) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for c, (a, b) in enumerate(zip(g, w)):
            # AVG is a float quotient: 1e-12 relative; everything else exact (MIN/MAX
    # of the float64 quotient too: both sides divide with IEEE rounding)
            same = math.isclose(a, b, rel_tol=1e-12) if (name == "2_filtered_agg" and c == 3) else a == b
            if not same or type(a) is not type(b):
                raise AssertionError(f"{name} row {r} col {c}: got {a!r}, oracle {b!r}")


def run_main_path(torch, counters: dict) -> dict:
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.query import QueryEngine
    from pinot_tpu_torch.segment import SegmentBuilder

    t0 = time.perf_counter()
    data, nation, category = make_ssb_data(N_ROWS)
    want = oracle(data, nation, category)
    t_gen = time.perf_counter() - t0

    schema = Schema.build(
        "lineorder",
        dimensions=[("d_year", DataType.INT), ("c_nation", DataType.STRING), ("p_category", DataType.STRING)],
        metrics=[("lo_revenue", DataType.LONG), ("lo_supplycost", DataType.LONG), ("lo_quantity", DataType.INT)],
    )
    t0 = time.perf_counter()
    per = N_ROWS // N_SEGMENTS
    builder = SegmentBuilder(schema)
    segments = [
        builder.build({c: v[i * per : (i + 1) * per] for c, v in data.items()}, f"lineorder_{i}")
        for i in range(N_SEGMENTS)
    ]
    t_build = time.perf_counter() - t0
    del data

    engine = QueryEngine(segments, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    staged = [seg.to_device_cached("cuda") for seg in segments]
    torch.cuda.synchronize()
    t_stage = time.perf_counter() - t0
    staged_bytes = sum(t.numel() * t.element_size() for s in staged for t in s.arrays.values())
    emit(
        {
            "phase": "slice_setup",
            "rows": N_ROWS,
            "segments": N_SEGMENTS,
            "generate_s": t_gen,
            "build_s": t_build,
            "stage_s": t_stage,
            "staged_bytes": staged_bytes,
        }
    )

    # the main path: every count from 0, one execute per config, counts read
    # after each config and at the end
    for fn in counters.values():
        fn.launches = 0
    launches = {}
    for name, sql in CONFIGS.items():
        before = [fn.launches for fn in counters.values()]
        res = engine.execute(sql)
        launches[name] = {k: fn.launches - b for (k, fn), b in zip(counters.items(), before)}
        rows_match(name, res.rows, want[name])
        expect = dict(zip(counters, (N_SEGMENTS * c for c in LAUNCHES_PER_SEGMENT[name])))
        if launches[name] != expect:
            raise AssertionError(f"{name}: launches {launches[name]}, expected {expect}")
        if res.num_docs_scanned <= 0 or res.total_docs != N_ROWS:
            raise AssertionError(f"{name}: docsScanned {res.num_docs_scanned}, totalDocs {res.total_docs}")
    main_launches = {k: fn.launches for k, fn in counters.items()}
    for k, v in main_launches.items():
        if v == 0:
            raise AssertionError(f"the main path never launched {k}")
    emit({"phase": "main_path", "results_match_oracle": True, "launches_per_config": launches, "launches": main_launches})

    wall = {}
    for name, sql in CONFIGS.items():
        for _ in range(2):
            engine.execute(sql)
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            engine.execute(sql)  # ends in the device->host copies
            ms.append((time.perf_counter() - t0) * 1e3)
        wall[name] = {"p50_ms": float(np.median(ms)), "runs_ms": ms}
    emit(
        {
            "phase": "main_path_timing",
            "wall": wall,
            "max_memory_allocated": torch.cuda.max_memory_allocated(),
            "card": card_line(),
        }
    )
    emit({"phase": "where_the_time_goes", "configs": {name: breakdown(torch, engine, sql) for name, sql in CONFIGS.items()}})
    return {"launches": main_launches}


def breakdown(torch, engine, sql: str) -> dict:
    """One warm execute split at the engine's own seams (host clock, each
    seam synchronised), then one execute under torch.profiler for the
    device's busy time and its largest kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.execute(sql)
    torch.cuda.synchronize()
    t = [time.perf_counter()]
    ctx = engine.make_context(sql)
    pend = [(seg, engine._dispatch_segment(seg, ctx)) for seg in engine.segments]
    t.append(time.perf_counter())
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    partials = [engine._finish_segment(seg, ctx, disp)[0] for seg, disp in pend]
    t.append(time.perf_counter())
    engine.reduce(ctx, partials)
    t.append(time.perf_counter())
    seams = ["parse_plan_enqueue_ms", "device_drain_ms", "copy_convert_ms", "reduce_ms"]
    out = {k: (t[i + 1] - t[i]) * 1e3 for i, k in enumerate(seams)}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.execute(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, memsets): the CPU ops that
    # launched them carry the same time again
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in ops) / 1e3 if ops else None
    ops.sort(key=lambda e: -e.self_device_time_total)
    out.update(
        {
            "profiled_wall_ms": wall_ms,
            "device_busy_ms": busy_ms,
            "device_idle_share": None if busy_ms is None else 1.0 - busy_ms / wall_ms,
            "top_device_ops": [
                {"name": e.key[:80], "calls": e.count, "ms": e.self_device_time_total / 1e3} for e in ops[:8]
            ],
        }
    )
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb
    from pinot_tpu_torch.ops import grouped_sum_f32 as gs

    card = card_line()
    print(card, flush=True)
    name = torch.cuda.get_device_name(0)
    emit(
        {
            "phase": "card",
            "name": name,
            "count": torch.cuda.device_count(),
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "python": sys.version.split()[0],
        }
    )
    report = build.build(["grouped_sum_count", "grouped_extreme", "grouped_sum_f32"])
    emit({"phase": "build", "nvcc": build.nvcc_path(), "flags": list(build.NVCC_FLAGS), "report": report})

    timing = {
        "grouped_sum_count": check_kernels(torch, gb),
        "grouped_extreme": check_extreme(torch, ext),
        "grouped_sum_f32": check_sum_f32(torch, gs),
    }
    counters = {"grouped_sum_count": gb.grouped_multi_sum, "grouped_extreme": ext.grouped_extreme, "presence": gs.presence}
    main = run_main_path(torch, counters)
    # the sum entry of grouped_sum_f32 is not on the main path: the kernel's
    # main-path launches are its presence entry's
    launches = {**main["launches"], "grouped_sum_f32": main["launches"]["presence"]}

    print(card_line(), flush=True)
    kernels = []
    for kname, replaces in (
        ("grouped_sum_count", "pinot_tpu/ops/groupby_pallas.py:318"),
        ("grouped_extreme", "pinot_tpu/ops/groupby_pallas.py:232"),
        ("grouped_sum_f32", "pinot_tpu/ops/groupby_pallas.py:152"),
    ):
        t = timing[kname]
        kernels.append(
            {
                "name": kname,
                "route": "cuda",
                "source": f"pinot_tpu_torch/ops/csrc/{kname}.cu",
                "replaces": replaces,
                "launches": launches[kname],
                "max_abs_err": t["max_abs_err"],
                "ms": t["kernel_ms"],
                "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_data_ms"],
                "bound_by": "bytes",
                "library_ms": t["library_ms"],
            }
        )
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
