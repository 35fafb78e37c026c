"""The profiled slice of a traced run, and what the benchmark reads from it.

torch.profiler (CPU and CUDA activities) records one steady sub-window of
the traffic. Its Chrome trace is read back for the device's operations
(kernels, copies and fills) and one marker the harness places at a known
host-clock time, which puts the device's timeline on the host clock of the
harness's own spans. From it come the device's busy time (the union of its
operations' intervals inside the slice), the operations that took most
time, by the names the profiler gives, and the idle gaps, each labelled by
what the client threads were doing then.
"""

from __future__ import annotations

import json
import os
import tempfile
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
MARK = "olap_bench.clock_mark"


@dataclass
class Slice:
    start: float  # host clock, seconds
    end: float
    #: device operations: (name, start, end, category), host seconds
    ops: list = field(default_factory=list)
    #: the trace's complete events by category
    categories: dict = field(default_factory=dict)
    #: whether the profiler traced a card (a CPU run's slice has no device)
    cuda: bool = True

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def busy_intervals(self, keep=None) -> list[tuple[float, float]]:
        """The union of the intervals of the operations that `keep(name,
        category)` keeps (all, without it), clipped to the slice."""
        spans = sorted(
            (max(s, self.start), min(e, self.end)) for n, s, e, c in self.ops if keep is None or keep(n, c)
        )
        out: list[list[float]] = []
        for s, e in spans:
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    def busy_seconds(self, keep=None) -> float:
        return sum(e - s for s, e in self.busy_intervals(keep))

    def top_ops(self, n: int = 10) -> list[list]:
        total: dict[str, float] = defaultdict(float)
        for name, s, e, _ in self.ops:
            total[name] += max(0.0, min(e, self.end) - max(s, self.start))
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, records, n: int = 10) -> list[list]:
        """The longest gaps between device operations inside the slice, each
        named by what the clients' queries were doing at its middle: queued
        for a runner, in submit, in resolve, or none in flight (the client
        loop)."""
        busy = self.busy_intervals()
        gaps, at = [], self.start
        for s, e in busy:
            if s > at:
                gaps.append((at, s))
            at = max(at, e)
        if at < self.end:
            gaps.append((at, self.end))
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for s, e in gaps[:n]:
            mid = (s + e) / 2
            doing: Counter = Counter()
            clients = {r.client for r in records}
            for c in clients:
                state = "loop"
                for r in records:
                    if r.client != c or r.start > mid or r.done < mid:
                        continue
                    state = "queued" if mid < r.running else "submit" if mid < r.submitted else "resolve"
                    break
                doing[state] += 1
            label = " ".join(f"{k}:{doing[k]}" for k in ("queued", "submit", "resolve", "loop") if doing[k])
            out.append([label or "no client", e - s])
        return out


class Profiler:
    """torch.profiler over one slice of the window. Made before the window,
    where it sets the tracer up and warms it (the profiler's schedule:
    warm-up, then one recorded step); the window's ticks start the recorded
    step at `start` (host clock seconds) and end it `length` seconds later,
    or at `stop_by` if that comes first."""

    def __init__(self, start: float, length: float, stop_by: float, cuda: bool = True):
        import torch

        self.start_at, self.length, self.stop_by = start, length, stop_by
        self.end_at = start + length
        self.cuda = cuda
        self.started = self.stopped = self.mark_host = None
        self.events: list = []
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(
            activities=acts,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=self._keep,
        )
        self.prof.__enter__()

    def _keep(self, prof) -> None:
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
        finally:
            os.unlink(path)
        self.events = trace["traceEvents"] if isinstance(trace, dict) else trace

    def tick(self, now: float) -> None:
        import torch

        if self.started is None and now >= self.start_at:
            self.prof.step()  # warm-up -> recorded
            self.started = time.perf_counter()
            self.end_at = min(self.started + self.length, self.stop_by)
            with torch.profiler.record_function(MARK):
                self.mark_host = time.perf_counter()
        elif self.started is not None and self.stopped is None and now >= self.end_at:
            self.stopped = time.perf_counter()
            self.prof.step()  # recorded -> done: the trace is kept

    def close(self) -> None:
        """End the profiler (what it recorded stays readable)."""
        if self.prof is not None:
            self.prof.__exit__(None, None, None)
            self.prof = None

    def read(self) -> Slice:
        """The slice, with the device's operations on the host clock."""
        if self.stopped is None:
            raise RuntimeError("the profiled slice did not run: the window is shorter than its start")
        mark = [e for e in self.events if e.get("name") == MARK and e.get("ph") == "X"]
        if not mark:
            raise RuntimeError("the profiler's trace lacks the clock marker")
        # the marker's trace time against the host clock read inside it
        offset = self.mark_host - float(mark[0]["ts"]) / 1e6
        ops = [
            (
                e["name"],
                float(e["ts"]) / 1e6 + offset,
                (float(e["ts"]) + float(e.get("dur", 0))) / 1e6 + offset,
                e["cat"],
            )
            for e in self.events
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
        ]
        by_cat = Counter(e.get("cat") for e in self.events if e.get("ph") == "X")
        return Slice(self.started, self.stopped, ops, dict(by_cat), self.cuda)
