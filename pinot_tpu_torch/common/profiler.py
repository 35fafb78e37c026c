"""Continuous sampling wall-clock profiler with per-query attribution.

Model: a single daemon thread wakes `hz` times per second, snapshots every
thread's current Python frame via `sys._current_frames()`, folds each stack
into a semicolon-joined root->leaf frame string ("collapsed stack", the
flamegraph.pl / pprof interchange format), and counts occurrences. Each
sample is attributed to the query the sampled thread is serving by reading
the accountant's thread registry (`ResourceAccountant.thread_bindings()`,
maintained by `default_accountant.scope(qid)` on every query worker thread)
— the contextvar the accountant also keeps is only visible from inside the
bound thread, so external attribution must go through thread idents. Results
are served at `GET /debug/pprof` on broker and server: the continuous
bounded ring by default, or a fresh on-demand window with `?seconds=N`.

This is the JAX package's `common/profiler.py`; it samples host threads and
knows nothing of the device.

This is the always-on, in-process collection pattern of production serving
stacks (Monarch-style low overhead; py-spy/pprof semantics) rather than a
tracing profiler: cost is O(threads x stack depth) per tick and independent
of request rate.

Bias caveats — inherent to the sampling model, worth knowing before reading
a profile:

- **Wall-clock, not CPU.** A thread blocked in `queue.get` or a socket read
  is sampled exactly like one spinning in a kernel; profiles answer "where
  do threads spend wall time", not "where do they burn CPU". Cross-check
  against the accountant's cpu_ns (`/debug/workload`) for CPU attribution.
- **GIL shadowing.** `sys._current_frames()` runs with the GIL held, so
  pure-C regions (NumPy kernels, torch ops, CUDA launches) show up as the Python
  frame that *called* them — time inside the C call is attributed to its
  Python call site, never to a finer grain.
- **Lockstep aliasing.** A periodic workload whose period divides the
  sampling interval is systematically over- or under-sampled. The default
  rate is a prime (31 Hz) to decorrelate from common 10/20/50/100 ms
  periods, but adversarial periodicity can still bias counts.
- **Attribution races at scope edges.** A sample that lands between
  `scope()` enter/exit and the first real work of a query may be counted
  unattributed (or against the previous query on a reused pool thread) for
  up to one tick.
- **Ring eviction.** The continuous ring keeps at most `ring_max_stacks`
  distinct stacks; when full, the rarest half is evicted and counted in
  `dropped_stacks` — heavy hitters survive, the long tail is approximate.
"""

from __future__ import annotations

import sys
import threading
import time

DEFAULT_HZ = 31.0
MAX_CAPTURE_SECONDS = 30.0


def fold_stack(frame, max_depth: int = 64) -> str:
    """Collapse one frame chain into `root;...;leaf` where each element is
    `module_basename:function`. Depth-capped from the leaf side (the root
    frames of a deep stack are dropped first — leaves carry the signal)."""
    parts: list[str] = []
    f = frame
    while f is not None and len(parts) < max_depth:
        code = f.f_code
        fname = code.co_filename.rsplit("/", 1)[-1]
        if fname.endswith(".py"):
            fname = fname[:-3]
        parts.append(f"{fname}:{code.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


class _Window:
    """One on-demand capture bucket: (query_id, folded_stack) -> count."""

    __slots__ = ("counts", "samples")

    def __init__(self):
        self.counts: dict[tuple[str, str], int] = {}
        self.samples = 0


class SamplingProfiler:
    """See module docstring. Thread-safe; one instance per process role."""

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        ring_max_stacks: int = 2048,
        accountant=None,
        max_depth: int = 64,
    ):
        self.hz = max(float(hz), 0.1)
        self.ring_max_stacks = int(ring_max_stacks)
        self.max_depth = int(max_depth)
        if accountant is None:
            from pinot_tpu_torch.common.accounting import default_accountant

            accountant = default_accountant
        self._accountant = accountant
        self._lock = threading.Lock()
        self._ring: dict[tuple[str, str], int] = {}
        self._ring_samples = 0
        self._dropped_stacks = 0
        self._started_ts: float | None = None
        self._windows: list[_Window] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._self_idents: set[int] = set()

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        """Start continuous ring sampling (idempotent)."""
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            t = threading.Thread(target=self._run, name="pinot-profiler", daemon=True)
            self._thread = t
            self._started_ts = time.time()
        t.start()

    def stop(self) -> None:
        with self._lock:
            t = self._thread
            self._thread = None
        if t is not None:
            self._stop.set()
            t.join(timeout=2.0)

    @property
    def running(self) -> bool:
        with self._lock:
            return self._thread is not None and self._thread.is_alive()

    def _run(self) -> None:
        interval = 1.0 / self.hz
        with self._lock:
            self._self_idents.add(threading.get_ident())
        while not self._stop.wait(interval):
            self.sample_once()

    # -- sampling -----------------------------------------------------------

    def sample_once(self) -> None:
        """Take one sample of every live thread into the ring and any open
        capture windows. Public so tests can drive deterministic ticks."""
        frames = sys._current_frames()
        bindings = self._accountant.thread_bindings()
        me = threading.get_ident()
        with self._lock:
            skip_idents = set(self._self_idents)
        skip_idents.add(me)
        folded = [
            (bindings.get(ident, ""), fold_stack(frame, self.max_depth))
            for ident, frame in frames.items()
            if ident not in skip_idents
        ]
        del frames
        with self._lock:
            for key in folded:
                self._ring[key] = self._ring.get(key, 0) + 1
                self._ring_samples += 1
                for w in self._windows:
                    w.counts[key] = w.counts.get(key, 0) + 1
                    w.samples += 1
            if len(self._ring) > self.ring_max_stacks:
                self._evict_locked()

    def _evict_locked(self) -> None:
        # keep the most frequent half; the evicted tail is tallied so the
        # exposition can report how approximate the ring is
        keep = sorted(self._ring.items(), key=lambda kv: -kv[1])[: self.ring_max_stacks // 2]
        self._dropped_stacks += len(self._ring) - len(keep)
        self._ring = dict(keep)

    def capture(self, seconds: float) -> dict:
        """On-demand bounded window: sample inline from the calling thread at
        `self.hz` for `seconds` (clamped to MAX_CAPTURE_SECONDS) and return
        that window's profile dict. Independent of the continuous ring —
        works whether or not the daemon is running (the daemon, if running,
        feeds the same window so concurrent captures don't undersample)."""
        seconds = min(max(float(seconds), 0.0), MAX_CAPTURE_SECONDS)
        w = _Window()
        with self._lock:
            self._windows.append(w)
            self._self_idents.add(threading.get_ident())
        try:
            interval = 1.0 / self.hz
            end = time.monotonic() + seconds
            while time.monotonic() < end:
                time.sleep(interval)
                self.sample_once()
        finally:
            with self._lock:
                self._windows.remove(w)
                self._self_idents.discard(threading.get_ident())
        with self._lock:
            counts = dict(w.counts)
            samples = w.samples
        return self._render(counts, samples, kind="window", seconds=seconds)

    # -- exposition ---------------------------------------------------------

    def profile(self) -> dict:
        """Continuous-ring profile dict (GET /debug/pprof default)."""
        with self._lock:
            counts = dict(self._ring)
            samples = self._ring_samples
            dropped = self._dropped_stacks
            since = self._started_ts
        d = self._render(counts, samples, kind="ring")
        d["droppedStacks"] = dropped
        if since is not None:
            d["sinceTs"] = round(since, 3)
        return d

    def _render(self, counts: dict, samples: int, kind: str, seconds: float | None = None) -> dict:
        stacks = [
            {"queryId": qid, "stack": stack.split(";"), "count": n}
            for (qid, stack), n in sorted(counts.items(), key=lambda kv: -kv[1])
        ]
        attributed = sum(s["count"] for s in stacks if s["queryId"])
        d = {
            "kind": kind,
            "hz": self.hz,
            "samples": samples,
            "attributedSamples": attributed,
            "stacks": stacks,
        }
        if seconds is not None:
            d["seconds"] = seconds
        return d

    @staticmethod
    def collapsed_text(profile: dict) -> str:
        """Render a profile dict as flamegraph.pl collapsed-stack lines:
        `root;...;leaf count`, with attributed samples rooted under a
        synthetic `query:<id>` frame so per-query flames separate."""
        lines = []
        for s in profile["stacks"]:
            frames = list(s["stack"])
            if s["queryId"]:
                frames.insert(0, f"query:{s['queryId']}")
            lines.append(f"{';'.join(frames)} {s['count']}")
        return "\n".join(lines) + ("\n" if lines else "")


# per-process profiler singleton (one per role would need per-role threads;
# broker+server sharing a process in tests share one profiler the same way
# they share default_accountant)
_profiler: SamplingProfiler | None = None
_profiler_lock = threading.Lock()


def get_profiler() -> SamplingProfiler:
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = SamplingProfiler()
        return _profiler


def maybe_start_profiler(obs_config) -> SamplingProfiler | None:
    """Start the process-wide continuous profiler when
    ObservabilityConfig.profiler_enabled is set; no-op (returns None)
    otherwise. First caller's config wins the hz/ring knobs — an already
    built singleton is only (re)started, never reconfigured."""
    if not getattr(obs_config, "profiler_enabled", False):
        return None
    global _profiler
    with _profiler_lock:
        if _profiler is None:
            _profiler = SamplingProfiler(
                hz=obs_config.profiler_hz,
                ring_max_stacks=obs_config.profiler_ring_max_stacks,
            )
        p = _profiler
    p.start()
    return p


def reset_profiler() -> None:
    """Test hook: stop and drop the singleton."""
    global _profiler
    with _profiler_lock:
        p = _profiler
        _profiler = None
    if p is not None:
        p.stop()
