"""The readings a cell's limits are set from: the program's numbers on many
seeds, and the control's on some, in one process.

    python3 olap_bench/control.py --workload tpch_q1_c8 --first-seed 100 \\
        --seeds 12 --control-seeds 3 --seconds 5

For each of `--seeds` seeds it makes one short run of the cell (the window
at the cell's own load, then the comparison: the program's reading); for
each of the first `--control-seeds` it also answers every distinct query of
the traffic with the configuration's control in the program's place and
compares that. The control (`control` in the configuration, as
`{"program": {<QueryEngine option>: value}}`) is the program with its own
path of the nearest precision below the one the configuration states
switched on: for `tpch_lineitem_sf10`, `fast32`, a QueryEngine that stages
DOUBLE columns as float32.

Each reading is one JSON line on standard output. The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device: str) -> dict:
    """The compared numbers of the cell's control on `seed`'s data."""
    import torch

    from olap_bench import check, segments
    from olap_bench.harness import load_module
    from olap_bench.reference.sql import Evaluator

    dev = torch.device(device)
    generator = load_module(cell.root / "generators" / f"{cell.config['generator']}.py")
    table = generator.generate(cell.config, seed % 2**63, dev).sorted_by(cell.config["sort_column"])
    sqls = [sql for _, sql in cell.traffic.distinct()]
    from pinot_tpu_torch.query import QueryEngine

    engine = QueryEngine(
        segments.build(table, cell.config["segments"], cell.config["sort_column"]),
        device=dev,
        **cell.config["control"]["program"],
    )
    answers = {s: {tuple(tuple(r) for r in engine.execute(s).rows): 1} for s in sqls}
    del engine
    host = table.to_host()
    del table
    numbers, details = check.compare(answers, Evaluator(host).answer_all(sqls), 0, cell.config["limits"])
    return {"numbers": numbers, "worst_gap": details["worst_gap"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--first-seed", type=int, required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)

    import torch

    from olap_bench.harness import Cell, run_cell

    if not torch.cuda.is_available():
        print("the readings are the card's: no CUDA card here", file=sys.stderr)
        return 2
    cell = Cell.load(args.workload, ROOT / "BENCHMARK.json")
    for i in range(args.seeds):
        seed = args.first_seed + i
        result = run_cell(cell, seed, args.seconds, False, "cuda:0", time.perf_counter(), log=lambda m: print(m, file=sys.stderr))
        print(json.dumps({"seed": seed, "side": "program", "correct": result["correct"], "numbers": result["checks"]}), flush=True)
        if i < args.control_seeds:
            got = control_numbers(cell, seed, "cuda:0")
            print(json.dumps({"seed": seed, "side": "control", **got}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    if sys.path and Path(sys.path[0]).resolve() == Path(__file__).resolve().parent:
        sys.path.pop(0)
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
