"""One run of one cell: set-up, the measured window, the check, the metrics.

Everything a cell uses is found by name: `BENCHMARK.json` names the cell's
configuration and traffic, and the per-layer metrics that read it;
`configs/<config>.json` names its generator (`generators/<name>.py`);
`traffic/<traffic>.json` is read by the one traffic generator;
`metrics/<metric>.py` holds each per-layer metric's reader (`read(run)`,
which returns the number or None where it finds nothing to read).

Set-up, counted from the start of the process: import torch and the program
and open the device; generate the table from the seed on the device and put
its rows in the order of the sort column; cut the segments and hand them to
the program (`segment_from_numpy`); stage them (`to_device_cached`); start
the program's query scheduler the traffic names; warm up: one round of the
clients together, each sending every query of the mix once (the programs'
captures happen there). The window follows, then, with the program's state freed,
the reference answers every distinct query the window ran and the answers
are compared.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import statistics
import sys
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from olap_bench import check, loop, segments
from olap_bench.reference.sql import Evaluator
from olap_bench.traffic import Traffic

HERE = Path(__file__).resolve().parent
#: a failed query's latency, ms: a failure misses every latency limit
FAILED_MS = 1e12


def load_module(path: Path):
    """The Python file at `path` as a module of its own."""
    name = f"olap_bench.{path.parent.name}.{path.stem}"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


@dataclass
class Cell:
    """A cell and what it names, loaded from a benchmark file."""

    name: str
    config_name: str
    config: dict
    traffic: Traffic
    end_to_end: list
    per_layer: list
    root: Path

    @staticmethod
    def load(name: str, benchmark: Path, root: Path = HERE) -> "Cell":
        bench = json.loads(Path(benchmark).read_text())
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in {benchmark}; it has {sorted(cells)}")
        w = cells[name]

        def mine(metric: dict) -> bool:
            return name in metric.get("workloads", [name])

        return Cell.of(
            name,
            w["config"],
            w["traffic"],
            [m for m in bench["end_to_end"] if mine(m)],
            [m for m in bench["per_layer"] if mine(m)],
            root,
        )

    @staticmethod
    def of(name: str, config: str, traffic: str, end_to_end: list, per_layer: list, root: Path = HERE) -> "Cell":
        """A cell of the configuration and traffic files named."""
        return Cell(
            name,
            config,
            json.loads((root / "configs" / f"{config}.json").read_text()),
            Traffic.load(root / "traffic" / f"{traffic}.json"),
            end_to_end,
            per_layer,
            root,
        )


@dataclass
class Run:
    """What one run recorded: what the per-layer metrics read."""

    cell: Cell
    setup: dict = field(default_factory=dict)
    records: list = field(default_factory=list)
    window: tuple = (0.0, 0.0)
    slice: object = None
    least: object = None
    reference: dict = field(default_factory=dict)

    def in_slice(self) -> list:
        """The queries sent inside the profiled slice."""
        if self.slice is None:
            return []
        return [r for r in self.records if self.slice.start <= r.start < self.slice.end]


def _sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str, t_process: float, log=print) -> dict:
    """One run of `cell`; returns the result line's object (with the
    compared numbers last, under "checks")."""
    import torch

    from pinot_tpu_torch.query import QueryEngine, graphs
    from pinot_tpu_torch.query.scheduler import make_scheduler

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
        torch.zeros(1, device=dev)
    run = Run(cell)
    setup = run.setup
    setup["import_s"] = time.perf_counter() - t_process

    t = time.perf_counter()
    generator = load_module(cell.root / "generators" / f"{cell.config['generator']}.py")
    table = generator.generate(cell.config, seed % 2**63, dev).sorted_by(cell.config["sort_column"])
    _sync(torch, dev)
    setup["generate_s"] = time.perf_counter() - t

    t = time.perf_counter()
    host = table.to_host()
    cuts = segments.bounds(host, cell.config["segments"], cell.config["sort_column"])
    descs = segments.descriptions(table, host, cuts)
    del table
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    from pinot_tpu_torch.segment.convert import segment_from_numpy

    segs = [segment_from_numpy(d) for d in descs]
    del descs
    setup["build_s"] = time.perf_counter() - t

    t = time.perf_counter()
    before = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    for s in segs:
        s.to_device_cached(dev)
    _sync(torch, dev)
    setup["stage_s"] = time.perf_counter() - t
    if dev.type == "cuda":
        setup["staged_bytes"] = torch.cuda.memory_allocated(dev) - before

    engine = QueryEngine(segs, device=dev)
    scheduler = make_scheduler(cell.traffic.scheduler["kind"], num_runners=cell.traffic.scheduler["runners"])
    scheduler.start()
    profiler = None
    try:
        t = time.perf_counter()
        warm_streams = [cell.traffic.stream(seed, 1000 + i) for i in range(cell.traffic.clients)]
        warm = loop.run(engine, scheduler, warm_streams, 0.0, rounds=len(cell.traffic.queries))
        if any(r.error for r in warm.records):
            raise RuntimeError(f"warm-up queries failed: {[r.error for r in warm.records if r.error][:3]}")
        _sync(torch, dev)
        setup["warm_s"] = time.perf_counter() - t
        stats0 = graphs.GRAPHS.stats()
        setup["captures"] = stats0["captures"]
        setup["graph_bytes"] = stats0["bytes"]
        setup["setup_s"] = time.perf_counter() - t_process

        if trace:
            from olap_bench.profile import Profiler

            # a steady sub-window: the middle third, ten seconds at most
            length = min(seconds / 3, 10.0)
            now = time.perf_counter()
            profiler = Profiler(now + (seconds - length) / 2, length, now + seconds, cuda=dev.type == "cuda")
        streams = [cell.traffic.stream(seed, i) for i in range(cell.traffic.clients)]
        cpu0 = time.process_time()
        out = loop.run(engine, scheduler, streams, seconds, on_tick=profiler.tick if profiler else None)
        cpu_s = time.process_time() - cpu0
    finally:
        if profiler is not None:
            profiler.close()
        scheduler.stop()
    run.records, run.window = out.records, out.window
    stats1 = graphs.GRAPHS.stats()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if profiler is not None:
        run.slice = profiler.read()
        log(f"trace: slice {run.slice.seconds:.3f} s, {len(run.slice.ops)} device operations; events by category {run.slice.categories}")
    executors = dict(engine.segment_modes)
    # the program's state goes before the reference runs
    del engine, segs
    graphs.GRAPHS.clear()
    gc.collect()

    t = time.perf_counter()
    run.reference = Evaluator(host).answer_all(out.answers)
    reference_s = time.perf_counter() - t
    failed = [r for r in run.records if r.error]
    numbers, details = check.compare(out.answers, run.reference, len(failed), cell.config["limits"])
    correct = check.passes(numbers) and details["answers_compared"] > 0

    log(f"setup: {json.dumps({k: round(v, 4) if isinstance(v, float) else v for k, v in setup.items()})}")
    log(
        f"window: {len(run.records)} queries, {len(failed)} failed; graphs after the window {stats1}; "
        f"captures in the window {stats1['captures'] - stats0['captures']}, evictions {stats1['evictions'] - stats0['evictions']}; "
        f"segments by executor {executors}; answered in each fifth of the window {_by_fifth(run.records, run.window)}; "
        f"longest time with no answer {_longest_silence(run.records, run.window):.3f} s; "
        f"process CPU {cpu_s:.2f} s in the window, {threading.active_count()} Python threads, {_os_threads()} threads"
    )
    log(f"reference: {reference_s:.3f} s for {len(run.reference)} distinct queries; {details}")
    for r in failed[:5]:
        log(f"failed: {r.name}: {r.error}")

    result = {
        "correct": bool(correct),
        "attempted": len(run.records),
        "failed": len(failed),
        "metrics": {},
        "device": {
            "platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        from olap_bench.roofline import LeastBytes

        run.least = LeastBytes(host, cuts)
        for m in cell.per_layer:
            value = load_module(cell.root / "metrics" / f"{m['name']}.py").read(run)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["device"]["busy_s"] = run.slice.busy_seconds()
        result["device"]["window_s"] = run.slice.seconds
        result["breakdown"] = {"device_ops": run.slice.top_ops(), "idle_gaps": run.slice.idle_gaps(run.in_slice())}
    else:
        result["metrics"] = end_to_end(run, {m["name"]: m["unit"] for m in cell.end_to_end})
    result["checks"] = numbers
    return result


def _os_threads() -> str:
    """The process's thread count, as the OS has it."""
    try:
        with open("/proc/self/status") as f:
            return next((line.split()[1] for line in f if line.startswith("Threads:")), "?")
    except OSError:
        return "?"


def _by_fifth(records, window) -> list[int]:
    start, end = window
    counts = [0] * 5
    for r in records:
        if not r.error and start <= r.done <= end:
            counts[min(int((r.done - start) / (end - start) * 5), 4)] += 1
    return counts


def _longest_silence(records, window) -> float:
    """The longest time, from the window's start to its last answer, in
    which no query was answered (a stall of the host or the card shows
    here)."""
    done = sorted(r.done for r in records if not r.error)
    return max(np.diff([window[0], *done]), default=0.0)


def end_to_end(run: Run, units: dict) -> dict:
    """qps, p50_ms, p95_ms and setup_s of a run. qps is all the work over
    all the time: every query the window sent and answered, over the time
    from the window's start to the last answer (the queries in flight at the
    close included, so no answer falls on either side of the close by
    phase)."""
    start, _ = run.window
    lat = [FAILED_MS if r.error else r.latency_ms for r in run.records]
    done = [r.done for r in run.records if not r.error]
    values = {
        "qps": len(done) / (max(done) - start) if done else 0.0,
        "p50_ms": float(np.percentile(lat, 50)) if lat else FAILED_MS,
        "p95_ms": float(np.percentile(lat, 95)) if lat else FAILED_MS,
        "setup_s": run.setup["setup_s"],
    }
    return {k: {"value": v, "unit": units[k]} for k, v in values.items() if k in units}


def mean(values) -> float | None:
    values = list(values)
    return statistics.fmean(values) if values else None


def main_guard_modules() -> list[str]:
    """Modules loaded in this process whose top-level name is JAX's or the
    JAX package's."""
    banned = {"jax", "jaxlib", "flax", "pinot_tpu"}
    return sorted({m.split(".")[0] for m in sys.modules} & banned)
