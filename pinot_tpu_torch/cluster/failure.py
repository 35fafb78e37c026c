"""Broker-side failure detection with exponential-backoff retry.

Reference parity: pinot-broker/.../failuredetector/FailureDetector +
BaseExponentialBackoffRetryFailureDetector: servers that fail a connection
are marked unhealthy and excluded from routing; a retry schedule with
exponentially growing delays probes them; a successful probe (or successful
query) restores them. The broker consults `healthy()` before routing and
calls `mark_failure/mark_success` from the scatter path.
"""

from __future__ import annotations

import threading
import time


class FailureDetector:
    def __init__(
        self,
        initial_delay_sec: float = 0.5,
        backoff_factor: float = 2.0,
        max_delay_sec: float = 60.0,
        probe_ttl_sec: float = 10.0,
    ):
        self._initial = initial_delay_sec
        self._factor = backoff_factor
        self._max = max_delay_sec
        #: how long a claimed probe blocks other callers before the slot
        #: reopens (a prober that died mid-query must not wedge the server
        #: in unhealthy forever)
        self._probe_ttl = probe_ttl_sec
        # server -> (next_retry_ts, current_delay, probe_claimed_until)
        self._down: dict[str, tuple[float, float, float]] = {}
        self._lock = threading.Lock()

    def mark_failure(self, server_id: str) -> None:
        now = time.monotonic()
        with self._lock:
            prev = self._down.get(server_id)
            delay = self._initial if prev is None else min(prev[1] * self._factor, self._max)
            # a failure resolves any outstanding probe claim: slot reopens
            # when the (longer) backoff next expires
            self._down[server_id] = (now + delay, delay, 0.0)

    def mark_success(self, server_id: str) -> None:
        with self._lock:
            self._down.pop(server_id, None)

    def _admit(self, server_id: str, entry: tuple[float, float, float], now: float) -> bool:
        """Caller holds the lock. When the retry is due and the probe slot is
        free, the CALLER claims it — exactly one query probes a down server
        per backoff window; concurrent queries keep seeing unhealthy until
        mark_success/mark_failure resolves the claim (or the claim's TTL
        expires). Kills the thundering herd onto a still-down server."""
        next_ts, delay, probe_until = entry
        if now < next_ts or now < probe_until:
            return False
        self._down[server_id] = (next_ts, delay, now + self._probe_ttl)
        return True

    def is_healthy(self, server_id: str) -> bool:
        """Healthy, or unhealthy-but-due-for-retry: a True on a down server
        means this caller took the single probe slot."""
        with self._lock:
            entry = self._down.get(server_id)
            if entry is None:
                return True
            return self._admit(server_id, entry, time.monotonic())

    def unhealthy_servers(self) -> list[str]:
        now = time.monotonic()
        with self._lock:
            return sorted(s for s, entry in self._down.items() if not self._admit(s, entry, now))

    def filter_ideal_state(self, ideal_state: dict[str, dict[str, str]]) -> dict[str, dict[str, str]]:
        """Drop replicas on currently-unhealthy servers (routing exclusion).
        Segments whose every replica is down keep their full replica map —
        better to try a down server than to fail unroutable."""
        bad = set(self.unhealthy_servers())
        if not bad:
            return ideal_state
        out = {}
        for seg, replicas in ideal_state.items():
            kept = {s: st for s, st in replicas.items() if s not in bad}
            out[seg] = kept if kept else replicas
        return out
