#!/usr/bin/env python3
"""A/B on one card of the exact group-by kernel (grouped_sum_count) and the
extreme kernel (grouped_extreme) of another checkout of pinot_tpu_torch and
of this one, in turns: other, this, this, other.

    python3 chip_ab.py OTHER_ROOT

OTHER_ROOT holds another pinot_tpu_torch/, for example the parent commit's:
    git archive HEAD~1 pinot_tpu_torch | tar -x -C _checkout/parent
Each turn runs in a process of its own (two packages of one name do not load
into one), builds the two kernels from its checkout's sources, and times them
with chip_smoke's timing loop at chip_smoke's shapes: the flat kernel at Q4's
shape, configs 3, 4 and 5's and 7 groups under a 90% mask; the extreme kernel
for config 5's five outputs (one call per output where the checkout has no
grouped_extremes) and for an int32 MIN at Q4's shape. Each result is held
against the checkout's plain version. Prints one JSON line per turn: device
ms alone, the host's enqueue ms and the span ms per shape, and the card's
name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
B1_SHAPES = ("q4_shape", "config3_shape", "config4_shape", "config5_shape_k0", "contention_7_groups_90pct")


def turn(root: str) -> dict:
    """Times the kernels of the pinot_tpu_torch under `root`."""
    import torch

    import chip_smoke as cs  # this checkout's, imported before `root` leads the path

    sys.path.insert(0, os.path.abspath(root))
    from pinot_tpu_torch.ops import build
    from pinot_tpu_torch.ops import extreme as ext
    from pinot_tpu_torch.ops import groupby as gb

    if not os.path.abspath(gb.__file__).startswith(os.path.abspath(root)):
        raise RuntimeError(f"{gb.__file__} is not under {root}")

    def timed(fn, equal: bool) -> dict:
        if not equal:
            raise AssertionError(f"{root}: kernel != plain version")
        device_ms, host_ms = cs.device_and_host_ms(torch, fn)
        return {"device_ms": device_ms, "host_ms": host_ms, "span_ms": cs.time_ms(torch, fn, 50)}

    t0 = time.perf_counter()
    build.build(["grouped_sum_count", "grouped_extreme"])
    out = {"root": root, "build_s": time.perf_counter() - t0, "b1": {}, "b3": {}}
    ssb = cs.ssb_shapes(torch)
    for name, values, gid, mask, ng, _ in cs.kernel_cases(torch, ssb):
        if name in B1_SHAPES:
            fn = lambda: gb.grouped_multi_sum_kernel(values, gid, mask, ng)  # noqa: E731
            out["b1"][name] = timed(fn, torch.equal(fn(), gb.grouped_multi_sum_plain(values, gid, mask, ng)))

    five = next(c for c in cs.multi_cases(torch, ssb) if c[0] == "config5_five_outputs")
    _, cols, outputs, gid, mask, ng, counts, _ = five
    if hasattr(ext, "grouped_extremes_kernel"):
        fn5 = lambda: ext.grouped_extremes_kernel(cols, outputs, gid, mask, ng, counts)  # noqa: E731
    else:
        fn5 = lambda: [ext.grouped_extreme_kernel(cols[c], gid, mask, ng, m, counts) for c, m in outputs]  # noqa: E731
    want = [ext.grouped_extreme_plain(cols[c], gid, mask, ng, m, counts) for c, m in outputs]
    out["b3"]["config5_five_outputs"] = timed(fn5, all(cs.same(torch, g, w) for g, w in zip(fn5(), want)))
    q4 = next(c for c in cs.extreme_cases(torch) if c[0] == "q4_shape_i32_min")
    _, values, gid, mask, ng, is_min, counts, _ = q4
    fn = lambda: ext.grouped_extreme_kernel(values, gid, mask, ng, is_min, counts)  # noqa: E731
    out["b3"]["q4_shape_i32_min"] = timed(fn, cs.same(torch, fn(), ext.grouped_extreme_plain(values, gid, mask, ng, is_min, counts)))
    out["card"] = cs.card_line()
    return out


def main() -> int:
    if sys.argv[1:2] == ["--turn"]:
        print(json.dumps(turn(sys.argv[2])), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("usage, on a CUDA card: chip_ab.py OTHER_ROOT", file=sys.stderr)
        return 2
    other = sys.argv[1]
    failed = 0
    for tag, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root],
                           capture_output=True, text=True, timeout=900)
        if r.returncode != 0:
            failed += 1
            print(f"== {tag} ({root}) failed, rc {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}", flush=True)
            continue
        print(json.dumps({"tag": tag, **json.loads(r.stdout.strip().splitlines()[-1])}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
