#!/usr/bin/env python3
"""Card check of pinot_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py        # from the root of the repository

1. Card: prints the card's name and power limit, builds every CUDA kernel of
   the package from the sources in the checkout (nvcc, sm_90a).
2. Kernels: holds each kernel against its plain torch version on the card
   (exact equality), at the main path's shapes and at edge cases, and times
   kernel, plain version and the PyTorch library call beside the bound.
3. Main path: generates the SSB-flavoured lineorder (16M rows, seed 0, the
   generator of bench.py), builds 4 segments of 4M rows with the package's
   SegmentBuilder, stages them on the card and runs BASELINE configs 1-4
   through QueryEngine(..., device="cuda").execute. Every result row is held
   against a numpy oracle over the raw arrays; the kernels' launch counters
   are reset just before that run and read just after.

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
GROUP_BY_CONFIGS = ("3_q1_groupby", "4_q4_groupby_orderby")


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
    return out


def rows_match(name: str, got: list, want: list) -> None:
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} rows, oracle {len(want)}")
    for r, (g, w) in enumerate(zip(got, want)):
        for c, (a, b) in enumerate(zip(g, w)):
            # AVG is a float quotient: 1e-12 relative; everything else exact
            same = math.isclose(a, b, rel_tol=1e-12) if (name == "2_filtered_agg" and c == 3) else a == b
            if not same or type(a) is not type(b):
                raise AssertionError(f"{name} row {r} col {c}: got {a!r}, oracle {b!r}")


def run_main_path(torch, gb) -> dict:
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

    # the main path: counts from 0, one execute per config, counts read after
    gb.grouped_multi_sum.launches = 0
    launches = {}
    for name, sql in CONFIGS.items():
        before = gb.grouped_multi_sum.launches
        res = engine.execute(sql)
        launches[name] = gb.grouped_multi_sum.launches - before
        rows_match(name, res.rows, want[name])
        expect = N_SEGMENTS if name in GROUP_BY_CONFIGS else 0
        if launches[name] != expect:
            raise AssertionError(f"{name}: grouped_sum_count launched {launches[name]} times, expected {expect}")
        if res.num_docs_scanned <= 0 or res.total_docs != N_ROWS:
            raise AssertionError(f"{name}: docsScanned {res.num_docs_scanned}, totalDocs {res.total_docs}")
    main_launches = gb.grouped_multi_sum.launches
    if main_launches == 0:
        raise AssertionError("the main path never launched grouped_sum_count")
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
    from pinot_tpu_torch.ops import groupby as gb

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
    report = build.build(["grouped_sum_count"])
    emit({"phase": "build", "nvcc": build.nvcc_path(), "flags": list(build.NVCC_FLAGS), "report": report})

    timing = check_kernels(torch, gb)
    main = run_main_path(torch, gb)

    print(card_line(), flush=True)
    emit(
        {
            "kernels": [
                {
                    "name": "grouped_sum_count",
                    "route": "cuda",
                    "source": "pinot_tpu_torch/ops/csrc/grouped_sum_count.cu",
                    "replaces": "pinot_tpu/ops/groupby_pallas.py:318",
                    "launches": main["launches"],
                    "max_abs_err": timing["max_abs_err"],
                    "ms": timing["kernel_ms"],
                    "plain_ms": timing["plain_ms"],
                    "bound_ms": timing["bound_data_ms"],
                    "bound_by": "bytes",
                    "library_ms": timing["library_ms"],
                }
            ]
        }
    )
    emit({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
