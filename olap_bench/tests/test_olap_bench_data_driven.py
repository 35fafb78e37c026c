"""A cell added as files only: in a copy of the benchmark, a new
configuration, traffic mix and per-layer metric, and entries for them in the
copy's BENCHMARK.json, run on the CPU at SF 0.01 with no file of the
benchmark edited."""

from __future__ import annotations

import hashlib
import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def digests(root: Path) -> dict:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*"))
        if p.is_file() and "__pycache__" not in p.parts
    }


def test_a_new_cell_needs_only_new_files(tmp_path):
    bench_dir = tmp_path / "olap_bench"
    shutil.copytree(HERE, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = digests(bench_dir)

    config = json.loads((bench_dir / "configs" / "tpch_lineitem_sf10.json").read_text())
    config.update(scale_factor=0.01, rows=59_986, segments=6, text_pool_bytes=1 << 20)
    (bench_dir / "configs" / "tpch_tiny.json").write_text(json.dumps(config))
    (bench_dir / "traffic" / "modes.json").write_text(
        json.dumps(
            {
                "clients": 3,
                "scheduler": {"kind": "fcfs", "runners": 2},
                "queries": {
                    "by_mode": "SELECT l_shipmode, COUNT(*), SUM(l_extendedprice) FROM lineitem "
                    "WHERE l_shipinstruct = '{instruct}' AND l_quantity >= {quantity} GROUP BY l_shipmode "
                    "ORDER BY l_shipmode LIMIT 100",
                },
                "params": {"instruct": {"choice": ["NONE", "COLLECT COD"]}, "quantity": {"int": [10, 40]}},
            }
        )
    )
    (bench_dir / "metrics" / "answered.py").write_text(
        "def read(run):\n    return sum(1 for r in run.records if not r.error)\n"
    )
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["configs"].append({**bench["configs"][0], "name": "tpch_tiny", "file": "olap_bench/configs/tpch_tiny.json"})
    bench["workloads"].append(
        {"name": "tiny.modes", "config": "tpch_tiny", "traffic": "modes", "chips": 1, "why": "a test's cell"}
    )
    bench["per_layer"].append(
        {
            "name": "answered",
            "unit": "queries",
            "better": "higher",
            "source": "host_clock",
            "layer": "engine front: parse, plan, enqueue",
            "moves": "qps",
            "workloads": ["tiny.modes"],
        }
    )
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    code = (
        "import json, sys, time\n"
        "from pathlib import Path\n"
        "from olap_bench.harness import Cell, run_cell\n"
        "cell = Cell.load('tiny.modes', Path('BENCHMARK.json'))\n"
        "print(json.dumps(run_cell(cell, 12345, 2.0, True, 'cpu', time.perf_counter(), log=lambda m: None)))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code],
        cwd=tmp_path,
        env={"PYTHONPATH": f"{tmp_path}:{ROOT}", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["metrics"]["answered"]["value"] == result["attempted"] > 0
    assert "submit_ms" not in result["metrics"]  # the cell names only its own metric
    assert digests(bench_dir) == {**before, **{k: v for k, v in digests(bench_dir).items() if k not in before}}
