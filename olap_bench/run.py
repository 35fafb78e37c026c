"""The benchmark of pinot_tpu_torch: one run of one cell.

    python3 olap_bench/run.py --workload tpch_q1_c8 --seed 7 --seconds 51 --trace 0

Run from the root of a checkout (it reads `BENCHMARK.json` there). With
`--trace 0` the result's metrics are the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics, read from a profiled slice of the
window. The last line of standard output is the result, one JSON object;
the last lines of standard error are the numbers compared, each beside its
limit. The run needs as many CUDA cards as the cell asks for and exits
non-zero, with no result, without them.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _finite(obj):
    """`obj` with every non-finite float replaced, so the line is JSON."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return 1e300 if obj > 0 else -1e300
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite(v) for v in obj]
    return obj


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    from olap_bench.harness import Cell, main_guard_modules, run_cell

    cell = Cell.load(args.workload, ROOT / "BENCHMARK.json")
    chips = next(w["chips"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"] if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA card(s); this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS, log=log)
    banned = main_guard_modules()
    if banned:
        log(f"the run loaded modules it must not: {banned}")
        return 3
    for name, n in result["checks"].items():
        log(f"check {name}: {n['value']!r} (limit {n['limit']!r})")
    print(json.dumps(_finite(result)), flush=True)
    return 0


if __name__ == "__main__":
    # run as a script: the checkout's root, not this directory, is where
    # olap_bench and the program are imported from
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
