"""Device-link profiling: measured round trip and bandwidth of the
host<->device path.

The same engine runs against very different attachments, so operators that
ship per-row data to the device and read per-row results back (the
multistage sort permutation, window scan and join probe) gate on THIS
measured profile instead of a static row count: the AdaptiveServerSelector
philosophy (reference: pinot-broker/.../routing/adaptiveserverselector/)
applied to the accelerator link.

This is the JAX package's `common/devlink.py` measuring the port's own
device: the probe runs once a process and device on first use, one tiny
round trip for the latency and one 4 MB round trip for the bandwidth, each a
`.to(device)` and back with a synchronize. `transfer_cost_s` is the
reference's model.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

#: (rtt seconds, bytes per second) by device string; tests pin an entry
_profiles: dict[str, tuple[float, float]] = {}
_lock = threading.Lock()


def _round_trip(a: np.ndarray, device: torch.device) -> None:
    t = torch.from_numpy(a).to(device)
    t.cpu()
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def link_profile(device="cuda") -> tuple[float, float]:
    """(rtt_seconds, bytes_per_second) of the link to `device`, memoized."""
    key = str(torch.device(device))
    with _lock:
        prof = _profiles.get(key)
        if prof is None:
            dev = torch.device(device)
            tiny = np.zeros(8, np.uint8)
            big = np.zeros(1 << 22, np.uint8)  # 4 MB
            _round_trip(tiny, dev)  # warm the path
            t0 = time.perf_counter()
            _round_trip(tiny, dev)
            rtt = time.perf_counter() - t0
            t0 = time.perf_counter()
            _round_trip(big, dev)
            dt = max(time.perf_counter() - t0 - rtt, 1e-9)
            prof = _profiles[key] = (rtt, (2 * big.nbytes) / dt)
    return prof


def transfer_cost_s(n_bytes: int, round_trips: int = 1, device="cuda") -> float:
    """Modeled wall-clock to move n_bytes over the link in round_trips syncs."""
    rtt, bw = link_profile(device)
    return round_trips * rtt + n_bytes / bw
