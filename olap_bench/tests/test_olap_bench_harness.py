"""The harness on the CPU at SF 0.01: each cell's run compares correct; runs
with the timed path broken underneath compare not correct; the controls
fail; the command refuses to run without a card or without the program."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from olap_bench import check
from olap_bench.harness import Cell, run_cell

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
CELLS = ["tpch_q1_c8"]
SEED = 2**31 + 5
SMALL = {"scale_factor": 0.01, "rows": 59_986, "text_pool_bytes": 1 << 20}


def small_cell(name: str) -> Cell:
    cell = Cell.load(name, ROOT / "BENCHMARK.json")
    cell.config = dict(cell.config, **SMALL)
    return cell


def quiet(_msg: str) -> None:
    pass


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_cpu(name):
    result = run_cell(small_cell(name), SEED, 1.0, False, "cpu", time.perf_counter(), log=quiet)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    cell = small_cell(name)
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert result["metrics"]["qps"]["value"] > 0
    assert list(result)[-1] == "checks"


def test_traced_run_reads_its_metrics_on_the_cpu():
    result = run_cell(small_cell("tpch_q1_c8"), SEED, 3.0, True, "cpu", time.perf_counter(), log=quiet)
    assert result["correct"]
    # the CPU's trace holds no device operation, so the device's metrics read nothing
    assert {"submit_ms", "resolve_ms", "stage_s", "warm_s"} <= set(result["metrics"])
    assert not {"program_roofline", "device_idle_pct"} & set(result["metrics"])
    assert "window_s" in result["device"] and "breakdown" in result


def test_qps_is_every_answer_over_the_time_to_the_last():
    """Queries in flight at the close count, and the time runs to the last
    answer: no answer falls on either side of the close by phase."""
    from olap_bench.harness import Run, _longest_silence, end_to_end
    from olap_bench.loop import QueryRecord

    def rec(start, done, error=None):
        return QueryRecord(0, "q", "sql", start, start, start, done, done, error=error)

    run = Run(small_cell("tpch_q1_c8"), setup={"setup_s": 20.0}, window=(100.0, 110.0))
    run.records = [rec(100.0, 103.0), rec(100.0, 106.0), rec(103.0, 109.0), rec(106.0, 112.0), rec(109.0, 111.0, "x")]
    units = {"qps": "queries/s", "p50_ms": "ms", "setup_s": "s"}
    got = end_to_end(run, units)
    assert got["qps"]["value"] == 4 / 12.0
    assert got["p50_ms"]["value"] == 3000.0 * 2  # 3, 6, 6, 6 s and a failure's 1e12 ms: the median is 6 s
    assert got["setup_s"]["value"] == 20.0 and set(got) == set(units)
    assert _longest_silence(run.records, run.window) == 3.0


def _alter_one_value(monkeypatch):
    """An answer altered where it is produced: the reduce's first aggregate
    value off by one."""
    from pinot_tpu_torch.query import reduce as reduce_mod

    for fn in ("reduce_aggregation", "reduce_group_by"):
        real = getattr(reduce_mod, fn)

        def altered(ctx, partials, _real=real):
            rows = _real(ctx, partials)
            for row in rows[:1]:
                i = next(i for i, v in enumerate(row) if isinstance(v, float))
                row[i] += 1.0
            return rows

        monkeypatch.setattr(reduce_mod, fn, altered)


def _drop_a_segment(monkeypatch):
    """Half of the batch left out, for an engine over segments: every other
    segment's partial replaced by the empty one."""
    from pinot_tpu_torch.query import engine as engine_mod
    from pinot_tpu_torch.query import pruner

    real = engine_mod.QueryEngine._resolve_partials

    def dropped(self, ctx, pend, pruned):
        out, scanned, summary = real(self, ctx, pend, pruned)
        out[::2] = [pruner.empty_partial(ctx) for _ in out[::2]]
        return out, scanned, summary

    monkeypatch.setattr(engine_mod.QueryEngine, "_resolve_partials", dropped)


@pytest.mark.parametrize("fault", [_alter_one_value, _drop_a_segment])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    result = run_cell(small_cell(name), SEED, 1.0, False, "cpu", time.perf_counter(), log=quiet)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name):
    """The configuration's control (the program's own float32 staging of
    DOUBLE columns) fails the comparison."""
    from olap_bench.control import control_numbers

    got = control_numbers(small_cell(name), SEED, "cpu")
    assert not check.passes(got["numbers"]), got


def test_command_refuses_without_a_card(capsys):
    from olap_bench import run

    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "tpch_q1_c8", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, the command exits non-zero and prints no result."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "olap_bench", ignore=shutil.ignore_patterns("__pycache__"))
    command = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    proc = subprocess.run(
        [sys.executable, *command[1:], "--workload", "tpch_q1_c8", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0 and proc.stdout.strip() == ""
