"""Kernel & memory observability: per-kernel device-time attribution, device
memory accounting and roofline analytics.

The JAX package's `common/kernel_obs.py`, re-based on the card:

- `KernelRegistry`: every hand-written kernel registers under a stable name
  (the reference's: `ops.grouped_planes`, `ops.grouped_planes2`,
  `ops.grouped_extreme`, `ops.grouped_sum`) with a bytes / operations cost
  model, and its wrapper launches through `launch()`. Each launch folds into
  labelled `engine.kernel.*{kernel=,shape=}` Timer / Meter families, the
  current query's device ms and peak memory in the accountant, and a
  `kernel.execute` event and the deviceExecution phase of the active trace.
- Device time comes from CUDA events, not from a fence. `launch()` records a
  start and an end `torch.cuda.Event(enable_timing=True)` on the current
  stream around the launch and queues the pair with the launch's mask count
  (a device scalar, for the byte model) on the collector the engine opened
  for the segment (`collect()`). `resolve()` reads `elapsed_time` once the
  query's device->host copies have synchronized the stream, so its dispatch
  half makes no host sync. The pair spans the launch as the stream sees
  it: where the device idles when the start event is recorded (a
  host-bound query), that includes the host's enqueue of the launch, so
  the registry's ms are a span, not device time alone, and its
  `pctOfPeak` a lower bound. Launches outside any collector (a
  direct call of a wrapper) queue on the registry and resolve, with a wait
  on their end event, when a snapshot is read (or when 4096 are held). On the CPU (the plain
  versions) a launch's time is the host wall of the call, recorded at once.
  A disabled registry records nothing and makes no event.
- `timed_sync()` times a whole device program and its one device->host copy
  (the sharded executor's `exchange.sharded`) with one CUDA event pair,
  whose end event is the wait for the copy, and resolves the launches the
  program made, which run on no segment's collector; their mask counts
  ride at the end of the same copy.
- Memory: live / peak bytes from `torch.cuda.memory_stats()`
  (`allocated_bytes.all.current` / `.peak`) when a card is in use, else a
  deterministic host-side estimator, so the CPU tests see the same math.
- `roofline()`: per-(kernel, shape-bucket) achieved GB/s against the
  configured peak (by default an H100 SXM's 3,350 GB/s), arithmetic
  intensity and the offenders ranked by device ms spent below the roof.

Shape labels are power-of-two buckets of the rows, never raw shapes, so the
label cardinality stays bounded whatever the workload.
"""

from __future__ import annotations

import contextvars
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Callable

import numpy as np

from pinot_tpu_torch.common.accounting import default_accountant
from pinot_tpu_torch.common.metrics import server_metrics
from pinot_tpu_torch.common.trace import ServerQueryPhase, active_trace, trace_event

#: HBM bandwidth the roofline divides by unless configured: an H100 SXM's
#: 3.35 TB/s (NVIDIA data sheet), the rate chip_smoke.py's bounds use
DEFAULT_HBM_PEAK_GBPS = 3350.0


def shape_bucket(n) -> str:
    """Power-of-two bucket label for a row count: 2^k covers [2^k, 2^(k+1))."""
    try:
        n = int(n)
    except (TypeError, ValueError):
        return "0"
    if n <= 0:
        return "0"
    return f"2^{n.bit_length() - 1}"


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to a kernel wrapper's `.launches` counter, atomically: the
    query scheduler's runner threads launch concurrently."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def streaming_cost(shape: dict) -> tuple[float, float]:
    """Bytes and operations of one launch of a kernel that streams a doc mask:
    each doc's mask byte, `per_doc` bytes of each masked doc (its group id
    and values), and the output written once (`out_bytes`); one operation a
    masked doc and output. chip_smoke.py's data-dependent bound
    (`bound_data_ms`) reckons the same bytes."""
    rows = max(float(shape.get("rows", 0)), 0.0)
    masked = max(float(shape.get("masked", 0)), 0.0)
    nbytes = rows + masked * float(shape.get("per_doc", 0)) + float(shape.get("out_bytes", 0))
    return nbytes, masked * float(shape.get("outputs", 1))


# -- device memory ------------------------------------------------------------


class HostHbmEstimator:
    """Deterministic host-side model of device memory, used where no card
    reports its allocator's figures (the CPU tests). Kernels report their
    working-set bytes as transient footprints; long-lived residency uses
    alloc/free."""

    def __init__(self):
        self._live = 0
        self._peak = 0
        self._lock = threading.Lock()

    def alloc(self, nbytes: int) -> None:
        n = max(int(nbytes), 0)
        with self._lock:
            self._live += n
            self._peak = max(self._peak, self._live)

    def free(self, nbytes: int) -> None:
        n = max(int(nbytes), 0)
        with self._lock:
            self._live = max(self._live - n, 0)

    def transient(self, nbytes: int) -> int:
        """One launch's working set, allocated and freed within the call:
        moves peak, not live. Returns the modeled footprint (live at peak)."""
        n = max(int(nbytes), 0)
        with self._lock:
            footprint = self._live + n
            self._peak = max(self._peak, footprint)
            return footprint

    @property
    def live(self) -> int:
        with self._lock:
            return self._live

    @property
    def peak(self) -> int:
        with self._lock:
            return self._peak

    def reset(self) -> None:
        with self._lock:
            self._live = 0
            self._peak = 0


#: seconds a read of the allocator's figures is reused: `memory_stats()`
#: builds a dict of hundreds of entries, too dear to read at every resolve
_HBM_TTL_S = 0.1
_hbm_cache: list = [0.0, None]


def device_hbm_stats() -> dict | None:
    """Live / peak allocated bytes of the caching allocator, summed over the
    cards (read at most every _HBM_TTL_S), or None where no card has been
    used in this process (one that never imported torch: a controller)."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    now = time.monotonic()
    if _hbm_cache[1] is None or now - _hbm_cache[0] > _HBM_TTL_S:
        live = peak = 0
        for i in range(torch.cuda.device_count()):
            s = torch.cuda.memory_stats_as_nested_dict(i)["allocated_bytes"]["all"]
            live += int(s.get("current", 0))
            peak += int(s.get("peak", 0))
        _hbm_cache[:] = [now, {"liveBytes": live, "peakBytes": peak}]
    return dict(_hbm_cache[1])


# -- the registry -------------------------------------------------------------


@dataclass
class RegisteredKernel:
    """One hand-written kernel. `cost_model(shape) -> (bytes, operations)`
    prices a single launch from its shape signature."""

    name: str
    root: object = None
    cost_model: Callable[[dict], tuple[float, float]] | None = None
    description: str = ""


@dataclass
class _KernelStats:
    calls: int = 0
    device_ms: float = 0.0
    bytes_moved: float = 0.0
    flops: float = 0.0


@dataclass
class _Pending:
    """One CUDA launch whose events have not been read yet."""

    name: str
    start: object
    end: object
    masked: object  # a device scalar (the launch's mask count) or None
    shape: dict


#: launches outside any collector held before they are read (with a wait)
_MAX_ORPHANS = 4096

# the launches of the segment being dispatched in this context (None: no
# engine collector open)
_COLLECTOR: contextvars.ContextVar[list | None] = contextvars.ContextVar("pinot_kernel_launches", default=None)


class KernelRegistry:
    """Registry + device-time ledger of every hand-written kernel."""

    def __init__(self, hbm_peak_gbps: float = DEFAULT_HBM_PEAK_GBPS):
        self._lock = threading.Lock()
        self._enabled = True
        self._hbm_peak_gbps = float(hbm_peak_gbps)
        self._kernels: dict[str, RegisteredKernel] = {}
        self._stats: dict[tuple[str, str], _KernelStats] = {}
        self._orphans: list[_Pending] = []
        # (registry, name, bucket) -> the metric series a record updates,
        # resolved once (series keys are built by escaping every label)
        self._series: dict = {}
        self.hbm = HostHbmEstimator()

    # -- configuration ------------------------------------------------------

    @property
    def enabled(self) -> bool:
        return self._enabled

    @property
    def hbm_peak_gbps(self) -> float:
        return self._hbm_peak_gbps

    def configure(self, enabled: bool | None = None, hbm_peak_gbps: float | None = None) -> None:
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            if hbm_peak_gbps is not None:
                self._hbm_peak_gbps = float(hbm_peak_gbps)

    # -- registration -------------------------------------------------------

    def register(
        self,
        name: str,
        root: object = None,
        cost_model: Callable[[dict], tuple[float, float]] | None = None,
        description: str = "",
    ) -> RegisteredKernel:
        """Register a kernel under a stable name. Double registration is a
        programming error (two kernels would alias one ledger row)."""
        k = RegisteredKernel(name, root, cost_model, description)
        with self._lock:
            if name in self._kernels:
                raise ValueError(f"kernel {name!r} already registered")
            self._kernels[name] = k
        return k

    def is_registered(self, name: str) -> bool:
        with self._lock:
            return name in self._kernels

    def kernel_names(self) -> list[str]:
        with self._lock:
            return sorted(self._kernels)

    # -- launching ----------------------------------------------------------

    def launch(self, name: str, fn: Callable[[], object], mask: torch.Tensor, **shape):
        """Run one launch of kernel `name` (`fn`) and record it. `mask` is
        the launch's doc mask: its count of set docs feeds the byte model
        (`shape["masked"]`), and its device decides how the launch is timed
        (module docstring)."""
        if not self._enabled:
            return fn()
        if mask.device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            self.record(name, (time.perf_counter() - t0) * 1e3, masked=int(mask.sum()), **shape)
            return out
        import torch

        stream = torch.cuda.current_stream(mask.device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        out = fn()
        end.record(stream)
        pending = _Pending(name, start, end, mask.sum(), shape)
        sink = _COLLECTOR.get()
        if sink is not None:
            sink.append(pending)
        else:
            with self._lock:
                self._orphans.append(pending)
                full = len(self._orphans) >= _MAX_ORPHANS
            if full:
                self._drain_orphans()
        return out

    @contextmanager
    def collect(self):
        """Collect the CUDA launches made in this context (one segment's
        dispatch) into a list, for `resolve()` once they have run."""
        sink: list = []
        token = _COLLECTOR.set(sink)
        try:
            yield sink
        finally:
            _COLLECTOR.reset(token)

    def resolve(self, pending: list, wait: bool = False, masked: list | None = None) -> None:
        """Record launches whose end events have completed (with `wait`, wait
        for them first): read each event pair's elapsed time and each mask
        count, in one device->host copy for all the counts, unless the caller
        copied them already (`masked`)."""
        if not pending:
            return
        if wait:
            for p in pending:
                p.end.synchronize()
        if masked is None:
            import torch

            masked = torch.stack([p.masked for p in pending]).cpu().tolist()
        for p, m in zip(pending, masked):
            self._record(p.name, p.start.elapsed_time(p.end), {**p.shape, "masked": int(m)}, gauges=False)
        self._set_hbm_gauges()

    def timed_sync(self, name: str, fn: Callable[[], "torch.Tensor | list[torch.Tensor]"], device, **shape):
        """Run `fn`, which enqueues device programs and returns their packed
        float64 output vector (or a list of them, one a mesh slot), and copy
        each to the host: the device->host copies its caller consumes (the
        sharded executor's). Returns the host vector (or the list). The
        registry records the programs and the copies under `name` and
        resolves the kernel launches made inside `fn`, collected apart from
        any segment's. On a card the launches' mask counts ride at the end of
        the first copy, a CUDA event pair on `device` spans the programs and
        the copies into pinned memory, and the wait for the copies is the
        wait for the end event: no fence and no extra copy. On the CPU the
        host wall of both is recorded. A disabled registry runs and copies."""

        def as_list(out):
            return out if isinstance(out, list) else [out]

        def shaped(out, vecs):
            return vecs if isinstance(out, list) else vecs[0]

        if not self._enabled:
            out = fn()
            return shaped(out, [o.cpu().numpy() for o in as_list(out)])
        import torch

        device = torch.device(device)
        if device.type != "cuda":
            t0 = time.perf_counter()
            out = fn()
            host = shaped(out, [o.cpu().numpy() for o in as_list(out)])
            self.record(name, (time.perf_counter() - t0) * 1e3, **shape)
            return host
        stream = torch.cuda.current_stream(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        with self.collect() as launches:
            start.record(stream)
            out = fn()
            outs = list(as_list(out))
            k = len(launches)
            if k:
                first = outs[0]
                counts = torch.stack([p.masked.to(first.device) for p in launches]).to(first.dtype)
                outs[0] = torch.cat([first, counts])
        hosts = []
        for o in outs:
            h = torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
            h.copy_(o, non_blocking=True)
            hosts.append(h)
        end.record(stream)
        for o in outs:
            if o.device != device and o.device.type == "cuda":
                torch.cuda.current_stream(o.device).synchronize()
        end.synchronize()
        vecs = [h.numpy() for h in hosts]
        if k:
            self.resolve(launches, masked=vecs[0][-k:].tolist())
            vecs[0] = vecs[0][:-k]
        self.record(name, start.elapsed_time(end), **shape)
        return shaped(out, vecs)

    def _drain_orphans(self) -> None:
        with self._lock:
            orphans, self._orphans = self._orphans, []
        self.resolve(orphans, wait=True)

    # -- recording ----------------------------------------------------------

    def record(self, name: str, device_ms: float, **shape) -> None:
        """Fold one timed launch into the ledger, the metrics, the current
        query's accountant tracker and the active trace."""
        self._record(name, device_ms, shape, gauges=True)

    def _record(self, name: str, device_ms: float, shape: dict, gauges: bool) -> None:
        k = self._kernels.get(name)
        if k is None:
            return
        nbytes, flops = (0.0, 0.0)
        if k.cost_model is not None:
            nbytes, flops = k.cost_model(shape)
            nbytes, flops = max(float(nbytes), 0.0), max(float(flops), 0.0)
        bucket = shape_bucket(shape.get("rows", 0))
        with self._lock:
            s = self._stats.setdefault((name, bucket), _KernelStats())
            s.calls += 1
            s.device_ms += device_ms
            s.bytes_moved += nbytes
            s.flops += flops
        footprint = self.hbm.transient(int(nbytes))
        timer, invocations, moved = self._metric_series(name, bucket)
        timer.update_ms(device_ms)
        invocations.mark()
        if nbytes:
            moved.mark(int(nbytes))
        if gauges:
            self._set_hbm_gauges()
        default_accountant.sample(device_ms=device_ms, hbm_bytes=footprint)
        trace_event("kernel.execute", kernel=name, shape=bucket, deviceMs=round(device_ms, 3), bytesMoved=int(nbytes))
        tr = active_trace()
        if tr is not None:
            tr.record_phase(ServerQueryPhase.DEVICE_EXECUTION, device_ms)

    def _metric_series(self, name: str, bucket: str) -> tuple:
        """The (deviceMs timer, invocations meter, bytesMoved meter) of a
        (kernel, shape) in the current server registry."""
        reg = server_metrics()
        got = self._series.get((id(reg), name, bucket))
        if got is None or got[0] is not reg:
            labels = {"kernel": name, "shape": bucket}
            got = (reg, reg.timer("engine.kernel.deviceMs", **labels), reg.meter("engine.kernel.invocations", **labels),
                   reg.meter("engine.kernel.bytesMoved", **labels))
            self._series[(id(reg), name, bucket)] = got
        return got[1:]

    def _set_hbm_gauges(self) -> None:
        hbm = self.hbm_snapshot()
        reg = server_metrics()
        reg.gauge("engine.hbm.liveBytes").set(hbm["liveBytes"])
        reg.gauge("engine.hbm.peakBytes").set(hbm["peakBytes"])

    # -- reporting ----------------------------------------------------------

    def hbm_snapshot(self) -> dict:
        dev = device_hbm_stats()
        if dev is not None:
            return {**dev, "source": "device"}
        return {"liveBytes": self.hbm.live, "peakBytes": self.hbm.peak, "source": "estimator"}

    def stats_snapshot(self) -> dict[tuple[str, str], dict]:
        self._drain_orphans()
        with self._lock:
            return {
                key: {"calls": s.calls, "deviceMs": s.device_ms, "bytesMoved": s.bytes_moved, "flops": s.flops}
                for key, s in self._stats.items()
            }

    def total_device_ms(self) -> float:
        return sum(s["deviceMs"] for s in self.stats_snapshot().values())

    def roofline(self, peak_gbps: float | None = None, top: int = 10) -> dict:
        """Per-(kernel, shape-bucket) achieved GB/s against the peak,
        arithmetic intensity, and the offenders ranked by device ms spent
        below the roof (the gap alone would rank microscopic kernels first)."""
        peak = float(peak_gbps) if peak_gbps is not None else self._hbm_peak_gbps
        rows = []
        for (name, bucket), s in sorted(self.stats_snapshot().items()):
            dev_s = s["deviceMs"] / 1e3
            achieved = (s["bytesMoved"] / dev_s / 1e9) if dev_s > 0 else 0.0
            pct = (100.0 * achieved / peak) if peak > 0 else 0.0
            rows.append(
                {
                    "kernel": name,
                    "shape": bucket,
                    "calls": s["calls"],
                    "deviceMs": round(s["deviceMs"], 3),
                    "bytesMoved": int(s["bytesMoved"]),
                    "flops": int(s["flops"]),
                    "achievedGBps": round(achieved, 3),
                    "arithmeticIntensity": round(s["flops"] / s["bytesMoved"], 4) if s["bytesMoved"] else 0.0,
                    "pctOfPeak": round(pct, 3),
                    "rooflineGap": round(peak / achieved, 1) if achieved > 0 else None,
                    "lostMs": round(s["deviceMs"] * max(1.0 - pct / 100.0, 0.0), 3),
                }
            )
        offenders = sorted((r for r in rows if r["rooflineGap"] is not None), key=lambda r: -r["lostMs"])
        return {
            "hbmPeakGBps": peak,
            "enabled": self._enabled,
            "kernels": rows,
            "offenders": offenders[: max(int(top), 0)],
            "hbm": self.hbm_snapshot(),
            "registered": self.kernel_names(),
        }

    # -- test hooks ---------------------------------------------------------

    def reset_stats(self) -> None:
        with self._lock:
            self._stats.clear()
            self._orphans.clear()
        self.hbm.reset()


#: process-wide registry every kernel wrapper registers into at import time
KERNELS = KernelRegistry()
