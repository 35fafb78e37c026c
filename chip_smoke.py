#!/usr/bin/env python3
"""Card check of pinot_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the root of the repository

1. Card: prints the card's name and power limit, builds every CUDA kernel of
   the package from the sources in the checkout (nvcc, sm_90a, one process
   per source, all started together).
2. Kernels: holds each kernel against its plain torch version on the card,
   at the main path's shapes and at edge cases, and times kernel, plain
   version and the PyTorch library call beside the bound. Kernels:
   grouped_sum_count (exact int sums + counts), grouped_sum_count_2l (the
   same function for large group counts, two-level gid; timed beside
   grouped_sum_count's global-atomics branch), grouped_extreme (MIN/MAX of
   f32, i32 and f64 values) and grouped_sum_f32 (f32 sums / counts and the
   DISTINCTCOUNT presence flags). Tolerance: exact equality (== , NaN equal
   to NaN) for everything but f32 sums, which add in a run-dependent order
   and are held to rtol 1e-4, atol 1e-2. Two choices of the wrappers are
   timed on both sides: `dispatch_band`, the flat against the two-level
   exact group-by where grouped_multi_sum switches between them, and
   `extreme_finish`, grouped_extreme's finish folded into its last block
   against a separate finish kernel.
3. Main path: generates the SSB-flavoured lineorder (16M rows, seed 0, the
   generator of bench.py, then lo_custkey and lo_suppkey), builds 4 segments
   of 4M rows with the package's SegmentBuilder, stages them on the card and
   runs configs 1-9 (BASELINE 1-4, grouped MIN/MAX, grouped and scalar
   DISTINCTCOUNT, a 90k-group GROUP BY, a sparse customer x supplier GROUP
   BY) through QueryEngine(..., device="cuda").execute. Every result row is
   held against a numpy oracle over the raw arrays; the kernels' launch
   counters are reset just before that run and read just after, per config.

Every phase that fails raises, and the script exits non-zero. The last line
of standard output is {"ok": true, "device": {...}}; the line before it is a
JSON object with one entry per kernel.
"""

from __future__ import annotations

import contextlib
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
        # "top customers": 90,000 customers (ng 90,112), past the flat
        # kernel's shared counters
        "8_groupby_wide": (
            "SELECT lo_custkey, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE d_year BETWEEN 1993 AND 1997 "
            "GROUP BY lo_custkey ORDER BY SUM(lo_revenue) DESC, lo_custkey LIMIT 10"
        ),
        # "top customer-supplier pairs": a key product of 5.4e8 > 2^20, the
        # sort-compaction path into U = 2^20 slots
        "9_groupby_sparse": (
            "SELECT lo_custkey, lo_suppkey, SUM(lo_revenue), COUNT(*) FROM lineorder "
            "WHERE d_year = 1997 AND lo_quantity <= 5 GROUP BY lo_custkey, lo_suppkey "
            "ORDER BY SUM(lo_revenue) DESC, lo_custkey, lo_suppkey LIMIT 10"
        ),
    }
)
#: kernel launches per segment of each config: (grouped_sum_count,
#: grouped_extremes, presence, grouped_sum_count_2l)
LAUNCHES_PER_SEGMENT = {
    "1_count_filter": (0, 0, 0, 0),
    "2_filtered_agg": (0, 0, 0, 0),
    "3_q1_groupby": (1, 0, 0, 0),
    "4_q4_groupby_orderby": (1, 0, 0, 0),
    "5_groupby_minmax": (1, 1, 0, 0),  # MIN, MAX, MINMAXRANGE of int32 and MAX of float64: one launch
    "6_groupby_distinct": (1, 0, 1, 0),
    "7_distinct": (0, 0, 2, 0),
    "8_groupby_wide": (0, 0, 0, 1),
    "9_groupby_sparse": (0, 0, 0, 1),
}
#: SSB's customer and supplier key ranges at scale factor 3 (~16M x 6/16
#: lineorder rows)
N_CUSTOMERS = 90_000
N_SUPPLIERS = 6_000


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


def time_ms(torch, fn, iters: int, warmup: int = 2, queued: bool = False) -> float:
    """Mean time of fn() in ms between CUDA events over `iters` runs, each
    after the L2 is flushed (the main path reads its columns from device
    memory). The span holds the host's enqueue of fn's work wherever the
    device waits for it; with `queued` the device first spins for ~1 ms, so
    the host has enqueued all of fn before the span starts and the span is
    device time alone."""
    return _timed(torch, fn, iters, warmup, queued)[0]


def device_and_host_ms(torch, fn, iters: int = 50) -> tuple[float, float]:
    """(device ms alone, host ms): time_ms(queued=True), and the mean wall
    time of the fn() calls themselves on the host clock. The device is
    spinning while fn runs, so that is the host's enqueue of fn's work."""
    return _timed(torch, fn, iters, 2, True)


def _timed(torch, fn, iters: int, warmup: int, queued: bool) -> tuple[float, float]:
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    total = host = 0.0
    for _ in range(iters):
        flush.zero_()
        if queued:
            torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / iters, host / iters * 1e3


# ---------------------------------------------------------------------------
# phase 2: the exact group-by kernel against its plain version
# ---------------------------------------------------------------------------


def ssb_shapes(torch, n: int = 4_194_304, seed: int = 6):
    """Config 3-5's group ids, masks and value columns over one segment of
    SSB-like data (make_ssb_data's distributions): config 3 ng 256 with 7
    groups (d_year) and a 3.8% mask; configs 4 and 5 the 64% mask of
    lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997, config 4 ng 4608 with
    4375 groups (d_year, c_nation, p_category), 3125 of them masked, config 5
    ng 256 with 175 groups (d_year, c_nation), 125 of them masked."""
    rng = np.random.default_rng(seed)
    year, nation, cat = rng.integers(0, 7, n), rng.integers(0, 25, n), rng.integers(0, 25, n)
    qty, rev, cost = rng.integers(1, 51, n), rng.integers(100, 600_000, n), rng.integers(50, 100_000, n)
    i32, b = torch.int32, torch.bool
    m45 = _tensor(torch, (qty > 5) & (year >= 1) & (year <= 5), b)
    return {
        "year": _tensor(torch, year, i32),
        "m3": _tensor(torch, ((nation == 1) | (nation == 2)) & (qty < 25), b),
        "g4": _tensor(torch, year * 625 + nation * 25 + cat, i32),
        "g5": _tensor(torch, year * 25 + nation, i32),
        "m45": m45,
        "qty": _tensor(torch, qty, i32),
        "rev": _tensor(torch, rev, i32),
        "cost": _tensor(torch, cost, i32),
        "profit": _tensor(torch, rev - cost, i32),
        "ratio": _tensor(torch, rev / qty, torch.float64),
    }


def kernel_cases(torch, ssb):
    """(name, values, gid, mask, ng, expect_shared) at the main path's shapes
    and at the edges of the kernel's contract."""
    rng = np.random.default_rng(1)
    i32 = np.iinfo(np.int32)

    def t(a, dtype=torch.int32):
        return _tensor(torch, a, dtype)

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
    main = [
        ("config3_shape", [ssb["rev"]], ssb["year"], ssb["m3"], 256, True),
        ("config4_shape", [ssb["profit"]], ssb["g4"], ssb["m45"], 4608, True),
        ("config5_shape_k0", [], ssb["g5"], ssb["m45"], 256, True),
    ]
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
    # contention: 7 present groups of ng 256 under a 90% mask
    hot = ("contention_7_groups_90pct", [ssb["rev"]], ssb["year"], t(rng.random(ssb["year"].numel()) < 0.9, torch.bool),
           256, True)
    # sums near +-2^31 a doc over ~2^18 docs a group: the high words carry
    # both ways, and one group's sum stays positive, one's negative
    near = np.array([i32.max, i32.max - 1, i32.min, i32.min + 1], dtype=np.int64)
    cgid = rng.integers(0, 6, n2)
    cval = rng.choice(near, n2)
    cval[cgid == 4] = i32.max
    cval[cgid == 5] = i32.min
    carry = ("sums_near_2^31_carry", [t(cval), t(-cval - 1)], t(cgid), t(rng.random(n2) < 0.95, torch.bool), 6, True)
    tail_v, tail_g, tail_m = t(rng.integers(-50, 50, n2 + 3)), t(rng.integers(0, 256, n2 + 3)), t(rng.random(n2 + 3) < 0.8, torch.bool)
    tails = [(f"tail_of_{r}_docs", [tail_v[: n2 + r]], tail_g[: n2 + r], tail_m[: n2 + r], 256, True) for r in (1, 2, 3)]
    # views from element 1: 4-byte aligned pointers, no 16-byte loads
    unaligned = ("unaligned_views", [tail_v[1 : n2 + 1]], tail_g[1 : n2 + 1], tail_m[1 : n2 + 1], 256, True)
    one = ("ng_1", [t(rng.integers(-(1 << 30), 1 << 30, n2))], t(rng.integers(-1, 2, n2)), t(rng.random(n2) < 0.7, torch.bool), 1, True)
    return [q4, *main, ext, empty, wide, big, hot, carry, *tails, unaligned, one]


def _b1_timing(torch, gb, values, gid, mask, ng) -> dict:
    """Device time alone, the host's enqueue and the span with it, the plain
    version's and index_add_'s times, and the bounds, for one shape."""
    k, n = len(values), gid.numel()
    fn = lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng)  # noqa: E731
    # the yardstick: ONE PyTorch call computing the same function on the
    # same inputs, prepared outside the timed region
    ok, idx = _in_range(torch, gid, mask, ng)
    src = torch.stack([torch.where(ok, v, 0).to(torch.int64) for v in values] + [ok.to(torch.int64)])
    dst = torch.zeros(k + 1, ng, dtype=torch.int64, device=gid.device)
    device_ms, host_ms = device_and_host_ms(torch, fn)
    out = {
        "shape": {"n": n, "k": k, "ng": ng, "mask_on": int(mask.sum().item()),
                  "groups": int(torch.unique(gid[mask]).numel())},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, iters=50),
        "plain_ms": time_ms(torch, lambda: gb.grouped_multi_sum_plain(values, gid, mask, ng), iters=10),
        "library_ms": time_ms(torch, lambda: dst.index_add_(1, idx, src), iters=10),
    }
    # bytes over the HBM rate: every input once, the output once; and the
    # data-dependent form, where only docs with the mask on need their group
    # id and values read
    out_bytes = (k + 1) * ng * 8
    out["bound_ms"] = hbm_ms(n * (4 + 1 + 4 * k) + out_bytes)
    out["bound_data_ms"] = hbm_ms(n + out["shape"]["mask_on"] * (4 + 4 * k) + out_bytes)
    return out


def check_kernels(torch, gb, ssb) -> dict:
    results = []
    max_err = 0.0
    keep = {}
    for name, values, gid, mask, ng, expect_shared in kernel_cases(torch, ssb):
        shared = gb.uses_shared_counters(min(len(values), gb.MAX_COLS), ng, gid.device)
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
        keep[name] = (values, gid, mask, ng)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_count", "cases": results})

    # Q4's shape (continuity with earlier runs) and every shape the main path
    # launches the kernel at
    timings = {
        name: _b1_timing(torch, gb, *keep[name])
        for name in ("q4_shape", "config3_shape", "config4_shape", "config5_shape_k0")
    }
    emit({"phase": "kernel_timing", "kernel": "grouped_sum_count", "timings": timings, "card": card_line()})
    return {"max_abs_err": max_err, **timings["q4_shape"]}


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
# phase 2a: the two-level exact group-by kernel against its plain version
# ---------------------------------------------------------------------------


def two_level_cases(torch):
    """(name, values, gid, mask, ng, L or None for the default): configs 8
    and 9's shapes, ng = 2^20 with a dense mask under three L, and the edges
    of the kernel's contract. Every case lies past the flat kernel's shared
    counters, where the engine takes the two-level kernel."""
    rng = np.random.default_rng(5)
    i32, b = torch.int32, torch.bool
    n, n2 = 4_194_304, 1 << 20

    def rev(m):
        return _tensor(torch, rng.integers(100, 600_000, m), i32)

    cases = []
    # config 8: GROUP BY lo_custkey, 71% of the docs pass the filter
    cases.append(("config8_shape", [rev(n)], _tensor(torch, rng.integers(0, 90_000, n), i32),
                  _tensor(torch, rng.random(n) < 0.71, b), 90_112, None))
    # config 9: 1.4% of the docs pass; their slots are the first ~57k of
    # U = 2^20, the other docs' slots lie anywhere
    m9 = rng.random(n) < 0.0143
    g9 = rng.integers(0, 1 << 20, n)
    g9[m9] = rng.integers(0, 57_000, int(m9.sum()))
    cases.append(("config9_shape", [rev(n)], _tensor(torch, g9, i32), _tensor(torch, m9, b), 1 << 20, None))
    # ng = 2^20 with a dense mask; L must not change the answer: the widest
    # L that fits (14), L = 9, and L = 4, whose 65,536 buckets pass the
    # shared histogram (a global atomic per doc)
    dense = ([rev(n)], _tensor(torch, rng.integers(0, 1 << 20, n), i32), _tensor(torch, rng.random(n) < 0.9, b))
    cases.append(("ng_2^20_dense_mask", *dense, 1 << 20, None))
    cases.append(("ng_2^20_dense_mask_L14", *dense, 1 << 20, 14))
    cases.append(("ng_2^20_dense_mask_L9", *dense, 1 << 20, 9))
    cases.append(("ng_2^20_dense_mask_L4_global_hist", *dense, 1 << 20, 4))
    # k = 8 at ng = 2^20: a 72 MB output, past the 50 MB L2
    cases.append(("ng_2^20_k8_past_L2", [rev(n) for _ in range(8)], *dense[1:], 1 << 20, None))
    gid2 = _tensor(torch, rng.integers(0, 100_003, n2), i32)
    mask2 = _tensor(torch, rng.random(n2) < 0.6, b)
    cases.append(("ng_100003_k2_not_a_multiple", [rev(n2), _tensor(torch, rng.integers(-10**6, 10**6, n2), i32)],
                  gid2, mask2, 100_003, None))
    cases.append(("k9_two_launches", [_tensor(torch, rng.integers(-(1 << 20), 1 << 20, n2), i32) for _ in range(9)],
                  gid2, mask2, 100_003, None))
    cases.append(("k0_counts_only", [], gid2, mask2, 100_003, None))
    cases.append(("empty_mask", [rev(n2)], gid2, _tensor(torch, np.zeros(n2, bool), b), 100_003, None))
    one = np.zeros(n2, bool)
    one[777_777] = True
    cases.append(("one_doc", [rev(n2)], gid2, _tensor(torch, one, b), 100_003, None))
    i32_info = np.iinfo(np.int32)
    ogid = rng.integers(-3, 50_300, n2)
    ogid[::101] = i32_info.max
    ogid[1::103] = i32_info.min
    cases.append(("out_of_range_gids", [rev(n2)], _tensor(torch, ogid, i32), mask2, 50_000, None))
    pool = np.array([i32_info.min, i32_info.max, -1, 0, 1], dtype=np.int64)
    cases.append(("int32_extremes_k3", [_tensor(torch, rng.choice(pool, n2), i32) for _ in range(3)],
                  _tensor(torch, rng.integers(0, 40_000, n2), i32), _tensor(torch, rng.random(n2) < 0.9, b), 40_000, None))
    # skew: every doc in one bucket (bucket 1 of L = 12)
    cases.append(("one_bucket", [rev(n)], _tensor(torch, rng.integers(1 << 12, 2 << 12, n), i32),
                  _tensor(torch, rng.random(n) < 0.9, b), 1 << 20, None))
    # n % 4 = 3: the last docs after the 4-doc steps; then group ids one
    # element past an aligned start, which rules out the 16-byte loads
    n3 = n2 - 3
    cases.append(("tail_of_3_docs", [rev(n3)], gid2[:n3].contiguous(), mask2[:n3].contiguous(), 100_003, None))
    cases.append(("unaligned_gid", [rev(n3)], gid2[1 : n3 + 1], mask2[1 : n3 + 1], 100_003, None))
    return cases


def pass_times(torch, fn, calls: int = 5) -> dict:
    """Device ms per call of each kernel and memset that fn() launches,
    from torch.profiler over `calls` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {
        e.key[:60]: e.self_device_time_total / 1e3 / calls
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    }


def check_two_level(torch, gb) -> dict:
    results, keep, max_err = [], {}, 0.0
    limit = gb.shared_limit(torch.device("cuda"))
    for name, values, gid, mask, ng, bits in two_level_cases(torch):
        k = len(values)
        if gb.uses_shared_counters(min(k, gb.MAX_COLS), ng, gid.device):
            raise AssertionError(f"{name}: (k={k}, ng={ng}) fits the flat kernel's shared counters")
        got = gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng, bits)
        torch.cuda.synchronize()
        used = gb.two_level_bits(min(k, gb.MAX_COLS), ng, limit) if bits is None else bits
        want = gb.grouped_multi_sum_plain(values, gid, mask, ng)
        equal = torch.equal(got, want)
        err = float((got - want).abs().max().item())
        max_err = max(max_err, err)
        results.append({"case": name, "k": k, "ng": ng, "n": gid.numel(), "L": used,
                        "mask_on": int(mask.sum().item()), "equal": equal})
        if not equal:
            raise AssertionError(f"{name}: grouped_sum_count_2l kernel != plain version (max abs err {err})")
        keep[name] = (values, gid, mask, ng, used)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_sum_count_2l", "shared_limit": limit, "cases": results})

    timings = {}
    for name in ("config8_shape", "config9_shape", "ng_2^20_k8_past_L2"):
        values, gid, mask, ng, bits = keep[name]
        k, n, masked = len(values), gid.numel(), int(mask.sum().item())
        ok, idx = _in_range(torch, gid, mask, ng)
        src = torch.stack([torch.where(ok, v, 0).to(torch.int64) for v in values] + [ok.to(torch.int64)])
        dst = torch.zeros(k + 1, ng, dtype=torch.int64, device="cuda")
        out_bytes = (k + 1) * ng * 8
        timings[name] = {
            "shape": {"n": n, "k": k, "ng": ng, "L": bits, "mask_on": masked},
            "kernel_ms": time_ms(torch, lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng), 50),
            # the flat kernel's global-atomics branch at the same shape
            "flat_global_ms": time_ms(torch, lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng), 50),
            "plain_ms": time_ms(torch, lambda: gb.grouped_multi_sum_plain(values, gid, mask, ng), 10),
            "library_ms": time_ms(torch, lambda: dst.index_add_(1, idx, src), 20),
            "bound_ms": hbm_ms(n * (4 + 1 + 4 * k) + out_bytes),
            "bound_data_ms": hbm_ms(n + masked * (4 + 4 * k) + out_bytes),
            # every L whose counters fit, and the device time of each pass
            "kernel_ms_by_L": {
                L: time_ms(torch, lambda L=L: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng, L), 20)
                for L in range(6, gb.fit_bits(k, limit) + 1)
            },
            "pass_ms": pass_times(torch, lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng)),
            # device time alone, the output's zero fill included: the times
            # above also hold the host's enqueue, which a shared host stretches
            "kernel_device_ms": time_ms(torch, lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng), 50, queued=True),
            "flat_global_device_ms": time_ms(torch, lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng), 50, queued=True),
        }
    emit({"phase": "kernel_timing", "kernel": "grouped_sum_count_2l", "timings": timings, "card": card_line()})
    emit({"phase": "dispatch_band", "timings": dispatch_band(torch, gb), "card": card_line()})
    return {"max_abs_err": max_err, **timings["config8_shape"]}


#: (k, ng) on both sides of where grouped_multi_sum leaves the flat kernel
#: for the two-level one on an H100 (232,448 B a block): the flat kernel's
#: (2k+1) x ng 32-bit counters fit up to ng 58,112 at k = 0 and 19,370 at
#: k = 1; 64-bit counters, (k+1) x ng x 8 B, fitted up to 29,056 and 14,528
BAND = [(0, 24_576), (0, 40_960), (0, 57_344), (0, 61_440), (1, 12_288), (1, 18_432), (1, 22_528)]


def dispatch_band(torch, gb) -> dict:
    """Device time alone of the flat and the two-level kernel, each checked
    against the plain version, at the BAND shapes: one 4M-doc segment, ids
    uniform over ng, a 70% mask. Where grouped_multi_sum takes each is
    `engine_takes`."""
    rng = np.random.default_rng(9)
    n = 4_194_304
    mask = _tensor(torch, rng.random(n) < 0.7, torch.bool)
    value = _tensor(torch, rng.integers(100, 600_000, n), torch.int32)
    out = {}
    for k, ng in BAND:
        gid = _tensor(torch, rng.integers(0, ng, n), torch.int32)
        values = [value][:k]
        want = gb.grouped_multi_sum_plain(values, gid, mask, ng)
        flat = lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng)  # noqa: E731
        two = lambda: gb.grouped_multi_sum_2l_kernel(values, gid, mask, ng)  # noqa: E731
        for name, fn in (("flat", flat), ("two_level", two)):
            if not torch.equal(fn(), want):
                raise AssertionError(f"k={k} ng={ng}: the {name} kernel != plain version")
        shared = gb.uses_shared_counters(k, ng, gid.device)
        blocks = gb._plan(gid.device.index, k, ng, n)[0]
        out[f"k{k}_ng{ng}"] = {
            "flat_shared_counters": shared,
            "flat_blocks": blocks,
            "engine_takes": "flat" if shared else "two_level",
            "flat_device_ms": time_ms(torch, flat, 50, queued=True),
            "two_level_device_ms": time_ms(torch, two, 50, queued=True),
        }
    return out


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


def multi_cases(torch, ssb):
    """(name, columns, outputs, gid, mask, ng, counts or None, expect_shared)
    for grouped_extremes: config 5's five outputs over one (gid, mask), and
    the edges of the multi-output contract."""
    rng = np.random.default_rng(8)
    f32, f64, i32, b = torch.float32, torch.float64, torch.int32, torch.bool
    cases = []

    def add(name, columns, outputs, gid, mask, ng, shared):
        counts = _counts(torch, gid, mask, ng) if any(c.dtype == i32 for c in columns) else None
        cases.append((name, columns, outputs, gid, mask, ng, counts, shared))

    # config 5: MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost),
    # MAX(lo_revenue / lo_quantity)
    five = [(0, True), (1, False), (2, True), (2, False), (3, False)]
    add("config5_five_outputs", [ssb["qty"], ssb["rev"], ssb["cost"], ssb["ratio"]], five, ssb["g5"], ssb["m45"], 256, True)
    n2 = 1 << 20
    gid2 = _tensor(torch, rng.integers(0, 256, n2), i32)
    mask2 = _tensor(torch, rng.random(n2) < 0.7, b)
    i32c = _tensor(torch, rng.integers(-(1 << 31), 1 << 31, n2), i32)
    f64c = _tensor(torch, rng.normal(0, 1e6, n2), f64)
    add("same_column_min_and_max", [f64c, i32c], [(0, True), (0, False), (1, False), (1, True)], gid2, mask2, 256, True)
    add("repeated_outputs", [i32c], [(0, True), (0, True), (0, False)], gid2, mask2, 256, True)
    specials = np.array([np.nan, 0.0, -0.0, np.inf, -np.inf, 1.5, -1.5])
    x = rng.choice(specials, n2, p=[0.0005, 0.3, 0.3, 0.001, 0.001, 0.1985, 0.199])
    y = rng.choice(specials, n2, p=[0.0002, 0.35, 0.35, 0.0004, 0.0004, 0.149, 0.15])
    add("nan_signed_zero_across_outputs", [_tensor(torch, x, f32), _tensor(torch, y, f64), i32c],
        [(0, True), (0, False), (1, True), (1, False), (2, False)], gid2, mask2, 256, True)
    none = _tensor(torch, np.zeros(n2, bool), b)
    add("all_off_mask", [_tensor(torch, x, f32), i32c, f64c], [(0, True), (1, False), (2, True), (2, False)],
        gid2, none, 256, True)
    ogid = _tensor(torch, rng.integers(-3, 300, n2), i32)  # ids outside [0, 256): dropped
    add("ids_out_of_range", [i32c, f64c, _tensor(torch, x, f32)], [(0, True), (1, False), (2, True), (2, False)],
        ogid, mask2, 256, True)
    cols9 = [_tensor(torch, rng.normal(0, 1, n2), f32), i32c, _tensor(torch, rng.integers(-9, 9, n2), i32), f64c,
             _tensor(torch, rng.uniform(-1, 1, n2), f64)]
    nine = [(0, True), (0, False), (1, True), (1, False), (2, True), (2, False), (3, True), (3, False), (4, False)]
    add("nine_outputs_two_launches", cols9, nine, gid2, mask2, 256, True)
    # ng past a block's shared memory: keys in global memory, finish kernel
    n = 4_194_304
    bgid = _tensor(torch, rng.integers(0, 1 << 16, n), i32)
    bmask = _tensor(torch, rng.random(n) < 0.5, b)
    add("ng_2^16_past_shared", [_tensor(torch, rng.normal(0, 1, n), f64), _tensor(torch, rng.integers(-1000, 1001, n), i32)],
        [(0, True), (0, False), (1, True), (1, False)], bgid, bmask, 1 << 16, False)
    # views from element 1: no 16-byte loads
    add("unaligned_views", [i32c[1:], f64c[1:]], [(0, True), (1, False)], gid2[1:], mask2[1:], 256, True)
    return cases


def check_extreme(torch, ext, ssb) -> dict:
    results, max_err, keep = [], 0.0, {}
    for name, values, gid, mask, ng, is_min, counts, expect_shared in extreme_cases(torch):
        shared = ext.uses_shared_keys([values.dtype], ng, gid.device)
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
    for name, columns, outputs, gid, mask, ng, counts, expect_shared in multi_cases(torch, ssb):
        distinct = list(dict.fromkeys(outputs))
        shared = ext.uses_shared_keys([columns[c].dtype for c, _ in distinct[: ext.MAX_OUTPUTS]], ng, gid.device)
        if shared != expect_shared:
            raise AssertionError(f"{name}: shared-memory path {shared}, expected {expect_shared}")
        before = ext.grouped_extremes.launches
        got = ext.grouped_extremes_kernel(columns, outputs, gid, mask, ng, counts)
        torch.cuda.synchronize()
        launches = ext.grouped_extremes.launches - before
        if launches != -(-len(distinct) // ext.MAX_OUTPUTS):
            raise AssertionError(f"{name}: {launches} launches for {len(distinct)} distinct outputs")
        want = ext.grouped_extremes_plain(columns, outputs, gid, mask, ng, counts)
        equal = all(same(torch, g, w) for g, w in zip(got, want))
        err = max(abs_err(torch, g, w) for g, w in zip(got, want))
        max_err = max(max_err, err)
        results.append(
            {"case": name, "outputs": len(outputs), "dtypes": [str(columns[c].dtype) for c, _ in outputs], "ng": ng,
             "n": gid.numel(), "shared_keys": shared, "launches": launches,
             "nan_groups": sum(int(g.isnan().sum().item()) for g in got), "equal": equal}
        )
        if not equal:
            raise AssertionError(f"{name}: grouped_extremes kernel != plain version (max abs err {err})")
        keep[name] = (columns, outputs, gid, mask, ng, counts)
    emit({"phase": "kernel_vs_plain", "kernel": "grouped_extreme", "cases": results})

    timings = {}
    for name in ("q4_shape_i32_min", "q4_shape_f32_min", "q4_shape_f64_max", "engine_ng256_i32_min", "engine_ng256_f64_max"):
        values, gid, mask, ng, is_min, counts = keep[name]
        timings[name] = _b3_timing(torch, ext, [values], [(0, is_min)], gid, mask, ng, counts)
    # the main path's one shape: config 5's five outputs in one launch; the
    # library time is one scatter_reduce_ per output, summed (no single
    # PyTorch call computes all five)
    timings["config5_five_outputs"] = _b3_timing(torch, ext, *keep["config5_five_outputs"])
    emit({"phase": "kernel_timing", "kernel": "grouped_extreme", "timings": timings, "card": card_line()})
    emit({"phase": "extreme_finish", "timings": finish_timings(torch, ext, ssb), "card": card_line()})
    return {"max_abs_err": max_err, **timings["config5_five_outputs"]}


@contextlib.contextmanager
def _finish_in(ext, fold: bool):
    """grouped_extremes launches planned meanwhile finish in their pass's
    last block (fold) or in a separate finish kernel, whatever the plan
    says."""
    real = ext._plan

    def plan(index, widths, ng, n):
        blocks, smem, finish, scratch = real(index, widths, ng, n)
        # the finish kernel strides over the cells, so any grid is right;
        # this is the plan's own (256 threads a block)
        return blocks, smem, 0 if fold else -(-len(widths) * ng // 256), scratch

    ext._spec.cache_clear()
    ext._plan = plan
    try:
        yield
    finally:
        ext._plan = real
        ext._spec.cache_clear()


def finish_timings(torch, ext, ssb) -> dict:
    """The extreme kernel's finish folded into its last block against a
    separate finish kernel, each checked against the plain version: device
    time alone and the host's enqueue, at config 5's five outputs (1280
    cells) and at four outputs (MIN and MAX of an int32 and a float64
    column) over ng 256-4096 (1024-16384 cells), one 4M-doc segment."""
    rng = np.random.default_rng(10)
    n = 4_194_304
    mask = _tensor(torch, rng.random(n) < 0.65, torch.bool)
    cols = [ssb["rev"], ssb["ratio"]]
    four = [(0, True), (0, False), (1, True), (1, False)]
    shapes = {"config5_five_outputs": ([ssb["qty"], ssb["rev"], ssb["cost"], ssb["ratio"]],
                                       [(0, True), (1, False), (2, True), (2, False), (3, False)], ssb["g5"], ssb["m45"], 256)}
    for ng in (256, 512, 1024, 2048, 4096):
        shapes[f"four_outputs_ng{ng}"] = (cols, four, _tensor(torch, rng.integers(0, ng, n), torch.int32), mask, ng)
    out = {}
    for name, (columns, outputs, gid, m, ng) in shapes.items():
        counts = _counts(torch, gid, m, ng)
        want = ext.grouped_extremes_plain(columns, outputs, gid, m, ng, counts)
        fn = lambda: ext.grouped_extremes_kernel(columns, outputs, gid, m, ng, counts)  # noqa: E731
        widths = tuple(ext._DTYPES[columns[c].dtype][1] for c, _ in outputs)
        row = {"cells": len(outputs) * ng, "plan_folds": ext._plan(gid.device.index, widths, ng, n)[2] == 0}
        if name == "config5_five_outputs" and not row["plan_folds"]:
            raise AssertionError("config 5's outputs take a separate finish kernel: two kernels a group-by")
        for how, fold in (("fold", True), ("finish_kernel", False)):
            with _finish_in(ext, fold):
                if not all(same(torch, g, w) for g, w in zip(fn(), want)):
                    raise AssertionError(f"{name}: grouped_extremes ({how}) != plain version")
                row[f"{how}_device_ms"], row[f"{how}_host_ms"] = device_and_host_ms(torch, fn)
        out[name] = row
    return out


def _b3_timing(torch, ext, columns, outputs, gid, mask, ng, counts) -> dict:
    n, masked = gid.numel(), int(mask.sum().item())
    ok, idx = _in_range(torch, gid, mask, ng)
    scatter = []
    for c, is_min in outputs:
        values = columns[c]
        fill = (np.iinfo(np.int32).max if is_min else np.iinfo(np.int32).min) if values.dtype == torch.int32 else (
            math.inf if is_min else -math.inf
        )
        src = torch.where(ok, values, fill)
        dst = torch.full((ng,), fill, dtype=values.dtype, device=gid.device)
        scatter.append((dst, src, "amin" if is_min else "amax"))

    def library():
        for dst, src, how in scatter:
            dst.scatter_reduce_(0, idx, src, reduce=how, include_self=True)

    fn = lambda: ext.grouped_extremes_kernel(columns, outputs, gid, mask, ng, counts)  # noqa: E731
    # each distinct column read once; outputs written once (f32 for f32
    # values, f64 otherwise); the int32 form reads the per-group counts
    col_bytes = sum(columns[c].element_size() for c in dict.fromkeys(c for c, _ in outputs))
    out_bytes = sum(ng * (4 if columns[c].dtype == torch.float32 else 8) for c, _ in outputs)
    out_bytes += ng * 8 if counts is not None else 0
    device_ms, host_ms = device_and_host_ms(torch, fn)
    return {
        "shape": {"n": n, "ng": ng, "mask_on": masked,
                  "outputs": [[str(columns[c].dtype), "min" if is_min else "max"] for c, is_min in outputs]},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, 50),
        "plain_ms": time_ms(torch, lambda: ext.grouped_extremes_plain(columns, outputs, gid, mask, ng, counts), 10),
        "library_ms": time_ms(torch, library, 10),
        "bound_ms": hbm_ms(n * (4 + 1 + col_bytes) + out_bytes),
        "bound_data_ms": hbm_ms(n + masked * (4 + col_bytes) + out_bytes),
    }


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
    dst = torch.zeros(ng, dtype=torch.float32, device=gid.device)
    fn = lambda: gs.grouped_sum_kernel(values, gid, mask, ng)  # noqa: E731
    device_ms, host_ms = device_and_host_ms(torch, fn)
    timings["q4_shape_sum"] = {
        "shape": {"n": n, "ng": ng},
        "kernel_device_ms": device_ms,
        "kernel_host_ms": host_ms,
        "kernel_ms": time_ms(torch, fn, 50),
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
        dst = torch.zeros(ng * pad, dtype=torch.uint8, device=ids.device)
        per_doc = 4 + (4 if gid is not None else 0)
        fn = lambda: gs.presence_kernel(ids, mask, pad, gid, ng)  # noqa: E731
        device_ms, host_ms = device_and_host_ms(torch, fn)
        timings[name] = {
            "shape": {"n": n, "ng": ng, "pad": pad, "mask_on": masked},
            "kernel_device_ms": device_ms,
            "kernel_host_ms": host_ms,
            "kernel_ms": time_ms(torch, fn, 50),
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
    then the customer and supplier keys drawn after them, so configs 1-7 see
    bench.py's data; also returns the dictionary codes the oracle groups by."""
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
    data["lo_custkey"] = rng.integers(1, N_CUSTOMERS + 1, n).astype(np.int32)
    data["lo_suppkey"] = rng.integers(1, N_SUPPLIERS + 1, n).astype(np.int32)
    return data, nation, category


def oracle(data, nation, category) -> tuple[dict, dict]:
    """(rows of each config, groups in all of configs 8 and 9)."""
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

    cust, supp = data["lo_custkey"], data["lo_suppkey"]
    m = (year >= 1993) & (year <= 1997)
    sums = np.bincount(cust[m], weights=rev[m], minlength=N_CUSTOMERS + 1)  # exact: integer partials < 2^53
    cnt = np.bincount(cust[m], minlength=N_CUSTOMERS + 1)
    present = np.flatnonzero(cnt)
    top = present[np.lexsort((present, -sums[present]))][:10]
    out["8_groupby_wide"] = [[int(c), float(sums[c]), int(cnt[c])] for c in top]

    m = (year == 1997) & (qty <= 5)
    pairs, inv = np.unique(cust[m].astype(np.int64) * (N_SUPPLIERS + 1) + supp[m], return_inverse=True)
    sums = np.bincount(inv, weights=rev[m])
    cnt = np.bincount(inv)
    c_of, s_of = pairs // (N_SUPPLIERS + 1), pairs % (N_SUPPLIERS + 1)
    top = np.lexsort((s_of, c_of, -sums))[:10]
    out["9_groupby_sparse"] = [[int(c_of[g]), int(s_of[g]), float(sums[g]), int(cnt[g])] for g in top]
    return out, {"8_groupby_wide": len(present), "9_groupby_sparse": len(pairs)}


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
    want, groups = oracle(data, nation, category)
    t_gen = time.perf_counter() - t0

    schema = Schema.build(
        "lineorder",
        dimensions=[
            ("d_year", DataType.INT),
            ("c_nation", DataType.STRING),
            ("p_category", DataType.STRING),
            ("lo_custkey", DataType.INT),
            ("lo_suppkey", DataType.INT),
        ],
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
            "oracle_groups": groups,
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
    report = build.build(["grouped_sum_count", "grouped_sum_count_2l", "grouped_extreme", "grouped_sum_f32"])
    emit({"phase": "build", "nvcc": build.nvcc_path(), "flags": list(build.NVCC_FLAGS), "report": report})

    ssb = ssb_shapes(torch)
    timing = {
        "grouped_sum_count": check_kernels(torch, gb, ssb),
        "grouped_sum_count_2l": check_two_level(torch, gb),
        "grouped_extreme": check_extreme(torch, ext, ssb),
        "grouped_sum_f32": check_sum_f32(torch, gs),
    }
    counters = {
        "grouped_sum_count": gb.grouped_multi_sum,
        "grouped_extreme": ext.grouped_extremes,
        "presence": gs.presence,
        "grouped_sum_count_2l": gb.grouped_multi_sum_2l,
    }
    main = run_main_path(torch, counters)
    # the sum entry of grouped_sum_f32 is not on the main path: the kernel's
    # main-path launches are its presence entry's
    launches = {**main["launches"], "grouped_sum_f32": main["launches"]["presence"]}

    print(card_line(), flush=True)
    kernels = []
    for kname, replaces in (
        ("grouped_sum_count", "pinot_tpu/ops/groupby_pallas.py:318"),
        ("grouped_sum_count_2l", "pinot_tpu/ops/groupby_pallas.py:396"),
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
                "device_ms": t["kernel_device_ms"],
                "host_ms": t.get("kernel_host_ms"),
                "shape": t["shape"],
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
