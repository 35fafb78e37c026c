"""Admission control for the serving path: never enqueue doomed work.

Reference parity: the scheduler/accounting tier of
pinot-core/.../query/scheduler/ (QueryScheduler + ResourceManager) plus the
broker-side rejection semantics of HelixExternalViewBasedQueryQuotaManager.
The controller sits in front of a `QueryScheduler` and decides, per query,
one of three outcomes BEFORE any work is enqueued:

- ADMIT  — projected completion fits the remaining deadline budget; the
  query runs on the scheduler's bounded runner pool.
- DEGRADE — the projection does not fit but the client set
  `allowPartialResults`; the query is admitted with a degrade marker and
  the scatter layer trims fan-out (serve from fewer servers) instead of
  queueing the full plan into deadline death.
- SHED — the projection does not fit and partial results are not allowed;
  the query is rejected immediately with `SchedulerRejectedError`
  (registered SERVER_OUT_OF_CAPACITY code, HTTP 503 + Retry-After). A
  query that would only time out after consuming queue+runner resources is
  turned away in microseconds instead.

The wait projection is a standard M/M/c-style estimate from live scheduler
state: with `pending` queued jobs, `in_flight` running jobs, `c` runners,
and a per-table service-time EWMA `svc`, a new arrival waits roughly
`max(0, pending + in_flight - c + 1) * svc / c` and completes `svc` later.
The EWMA is fed by observed execution times (queue wait excluded), floored
at `min_service_ms` so a cold estimator never projects zero.
"""

from __future__ import annotations

import threading
import time

from pinot_tpu_torch.common.config import SchedulerConfig
from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
from pinot_tpu_torch.common.metrics import BrokerGauge, BrokerMeter, broker_metrics
from pinot_tpu_torch.common.trace import trace_event
from pinot_tpu_torch.query.scheduler import SchedulerRejectedError

#: decide() outcomes (shed is an exception, not a return value)
ADMIT = "admit"
DEGRADE = "degrade"


class AdmissionController:
    """Broker/server-side admission tier over a QueryScheduler.

    Thread-safe; one instance per Broker (and optionally per Server). The
    scheduler is started lazily on first use and stopped via `stop()`.
    """

    def __init__(self, config: SchedulerConfig | None = None, scheduler=None, role: str = "broker"):
        self.config = config or SchedulerConfig()
        self.scheduler = scheduler if scheduler is not None else self.config.make()
        self.role = role
        self._ewma_ms: dict[str, float] = {}
        # table -> next estimator-liveness probe timestamp (monotonic)
        self._probe_next: dict[str, float] = {}
        self._lock = threading.Lock()
        self._started = False
        # lifetime counters (meters carry the same data per-table; these
        # feed the /debug/admission snapshot without a registry scan)
        self.admitted = 0
        self.shed = 0
        self.degraded = 0
        self.probed = 0

    # -- lifecycle -----------------------------------------------------------

    def _ensure_started(self) -> None:
        if self.scheduler is None or self._started:
            return
        with self._lock:
            if not self._started:
                self.scheduler.start()
                self._started = True

    def stop(self) -> None:
        with self._lock:
            started, self._started = self._started, False
        if started and self.scheduler is not None:
            self.scheduler.stop()

    # -- service-time estimator ----------------------------------------------

    def service_estimate_ms(self, table: str) -> float:
        floor = self.config.min_service_ms
        with self._lock:
            est = self._ewma_ms.get(table)
            if est is None and self._ewma_ms:
                # cold table: borrow the busiest estimate rather than the
                # floor, so a new table doesn't sneak past a loaded scheduler
                est = max(self._ewma_ms.values())
        return max(floor, est) if est is not None else floor

    def note_service_time(self, table: str, ms: float) -> None:
        alpha = self.config.service_ewma_alpha
        with self._lock:
            prev = self._ewma_ms.get(table)
            self._ewma_ms[table] = ms if prev is None else prev + alpha * (ms - prev)

    # -- admission decision --------------------------------------------------

    def estimate_wait_ms(self, table: str) -> float:
        """Projected queue wait for a new arrival (0 when a runner is free)."""
        sched = self.scheduler
        if sched is None:
            return 0.0
        c = max(1, sched.num_runners)
        ahead = sched.pending() + sched.in_flight()
        svc = self.service_estimate_ms(table)
        return max(0, ahead - c + 1) * svc / c

    def decide(self, table: str, deadline=None, allow_partial: bool = False) -> str:
        """ADMIT or DEGRADE, or raise SchedulerRejectedError (shed).

        Runs before any enqueue; must stay microseconds-cheap (the
        admission_overhead microbench gates it at <2% of query time)."""
        try:
            FAULTS.maybe_fail("scheduler.admit")
        except InjectedFault as e:
            trace_event("fault.injected", point="scheduler.admit", table=table)
            self._mark_shed(table, f"injected admission fault: {e}", retry_after_s=1.0)
        self._ensure_started()
        reg = broker_metrics()
        sched = self.scheduler
        if sched is not None:
            reg.gauge(BrokerGauge.ADMISSION_QUEUE_DEPTH).set(sched.pending())
            reg.gauge(BrokerGauge.ADMISSION_IN_FLIGHT).set(sched.in_flight())
            for group, depth in sched.queue_depths().items():
                reg.gauge(BrokerGauge.ADMISSION_QUEUE_DEPTH, table=group or "_default").set(depth)
        if sched is None or not self.config.shed_enabled:
            return self._mark_admitted(table)
        remaining_s = deadline.remaining() if deadline is not None else None
        if remaining_s is None:
            return self._mark_admitted(table)
        wait_ms = self.estimate_wait_ms(table)
        projected_ms = wait_ms + self.service_estimate_ms(table)
        budget_ms = remaining_s * 1000.0 * self.config.shed_headroom
        if projected_ms <= budget_ms:
            if self._probe_next:
                # recovered: a future estimate-only rejection starts a fresh
                # shed-then-probe sequence instead of instantly probing
                with self._lock:
                    self._probe_next.pop(table, None)
            return self._mark_admitted(table)
        if allow_partial:
            self.degraded += 1
            reg.meter(BrokerMeter.ADMISSION_DEGRADED, table=table).mark()
            return DEGRADE
        # Estimator-liveness probe (FailureDetector single-probe parity):
        # with no queue pressure the rejection rests entirely on the service
        # EWMA, which only updates when a query completes — shedding 100%
        # would freeze a poisoned estimate forever (a JIT-cold warmup is
        # enough to push it past the deadline, observed as a permanent
        # 503 storm in bench.py cluster). The first estimate-only shed
        # starts the probe clock; one query per interval is then admitted
        # as a probe so the estimate can recover. Real backlog
        # (wait_ms > 0) still sheds unconditionally.
        if wait_ms <= 0.0:
            now = time.monotonic()
            interval_s = self.config.probe_interval_ms / 1000.0
            with self._lock:
                due = self._probe_next.get(table)
                probe = due is not None and now >= due
                if probe or due is None:
                    self._probe_next[table] = now + interval_s
            if probe:
                self.probed += 1
                reg.meter(BrokerMeter.ADMISSION_PROBED, table=table).mark()
                return self._mark_admitted(table)
        self._mark_shed(
            table,
            f"projected completion {projected_ms:.0f}ms exceeds remaining "
            f"deadline budget {remaining_s * 1000.0:.0f}ms "
            f"(queue wait ~{wait_ms:.0f}ms)",
            retry_after_s=wait_ms / 1000.0,
        )
        raise AssertionError("unreachable")  # _mark_shed always raises

    def _mark_admitted(self, table: str) -> str:
        self.admitted += 1
        broker_metrics().meter(BrokerMeter.ADMISSION_ADMITTED, table=table).mark()
        return ADMIT

    def _mark_shed(self, table: str, message: str, retry_after_s: float) -> None:
        self.shed += 1
        broker_metrics().meter(BrokerMeter.ADMISSION_SHED, table=table).mark()
        raise SchedulerRejectedError(message, retry_after_s=max(1.0, retry_after_s))

    # -- scheduled execution -------------------------------------------------

    def execute(self, fn, table: str, *args, workload: str = "PRIMARY", **kwargs):
        """Run `fn` on the scheduler's runner pool and block for the result,
        feeding the observed service time back into the estimator. Falls
        back to inline execution when scheduling is disabled."""
        if self.scheduler is None:
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.note_service_time(table, (time.perf_counter() - t0) * 1000.0)
        self._ensure_started()
        submit_ts = time.perf_counter()

        def run():
            t0 = time.perf_counter()
            broker_metrics().histogram("broker.admission.queueWaitMs", table=table).update_ms(
                (t0 - submit_ts) * 1000.0
            )
            try:
                return fn(*args, **kwargs)
            finally:
                self.note_service_time(table, (time.perf_counter() - t0) * 1000.0)

        try:
            fut = self.scheduler.submit(run, table=table, workload=workload)
        except SchedulerRejectedError as e:
            # queue overflow at submit: account it as a shed (decide() only
            # projects; the bounded queue is the hard backstop)
            self._mark_shed(table, str(e), retry_after_s=self.estimate_wait_ms(table) / 1000.0)
        return fut.result()

    # -- observability -------------------------------------------------------

    def snapshot(self) -> dict:
        """Live state for GET /debug/admission."""
        with self._lock:
            estimates = dict(self._ewma_ms)
        sched = self.scheduler
        return {
            "role": self.role,
            "enabled": self.scheduler is not None,
            "shedEnabled": self.config.shed_enabled,
            "shedHeadroom": self.config.shed_headroom,
            "scheduler": sched.stats() if sched is not None else None,
            "serviceEstimateMs": {t: round(v, 3) for t, v in estimates.items()},
            "counters": {
                "admitted": self.admitted,
                "shed": self.shed,
                "degraded": self.degraded,
                "probed": self.probed,
            },
        }
