"""Server-side query schedulers: FCFS, priority token-bucket, binary workload.

Reference parity: pinot-core/.../core/query/scheduler/ —
- QueryScheduler base: submit -> future, bounded runner threads
  (QueryScheduler.java)
- FCFSQueryScheduler: arrival order
- PriorityScheduler + MultiLevelPriorityQueue + TableTokenPriorityQueue's
  token bucket (scheduler/tokenbucket/TokenPriorityQueue.java): one scheduler
  group per table; each group accrues CPU tokens over time and spends them as
  its queries run; the group with the most unspent tokens is served first, so
  a table that hogged runners is throttled behind light tables
- BinaryWorkloadScheduler (scheduler/BinaryWorkloadScheduler.java): two lanes —
  PRIMARY (latency-critical, gets all runners) and SECONDARY (capped
  concurrency + bounded queue, rejects on overflow)

Schedulers run the callable on their own runner pool; callers block on the
returned future (the broker's scatter thread is the "Netty event loop" analog
that must not execute queries inline).

The JAX package's `query/scheduler.py`. A job is typically
`QueryEngine.execute`; whatever it raises (a CUDA error, a failed kernel
build, a QueryKilledError, a deadline) reaches the caller through the
future.
"""

from __future__ import annotations

import contextvars
import queue
import threading
import time
from concurrent.futures import Future

from pinot_tpu_torch.common.errors import QueryErrorCode


class SchedulerRejectedError(RuntimeError):
    """Query rejected at submission (queue overflow / shutdown) or shed by
    the admission tier — the QueryScheduler 'server out of capacity' error
    response. Carries the registered error code so `code_of()` maps it at
    every response boundary, plus an optional `Retry-After` hint in seconds
    (the admission controller's projected drain time)."""

    error_code = QueryErrorCode.SERVER_OUT_OF_CAPACITY

    def __init__(self, message: str, retry_after_s: float | None = None):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class _Job:
    __slots__ = ("fn", "args", "kwargs", "future", "group", "workload", "enqueue_ts", "ctx")

    def __init__(self, fn, args, kwargs, group, workload):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self.future: Future = Future()
        self.group = group
        self.workload = workload
        self.enqueue_ts = time.perf_counter()
        # snapshot the submitter's contextvars (TraceRunnable parity): runner
        # threads see the submitting request's active trace, so segment-level
        # spans land under the right parent instead of being dropped
        self.ctx = contextvars.copy_context()

    def run(self):
        if not self.future.set_running_or_notify_cancel():
            return
        try:
            self.future.set_result(self.ctx.run(self.fn, *self.args, **self.kwargs))
        except BaseException as e:  # noqa: BLE001 — future carries it to caller
            self.future.set_exception(e)


#: runner threads started eagerly; the pool grows on demand up to
#: num_runners as submissions back up (idle services stay this small)
_CORE_RUNNERS = 4


class QueryScheduler:
    """Base: N runner threads draining `_next_job()`.

    The pool is elastic: `start()` spawns at most `_CORE_RUNNERS` threads
    and `submit()` adds one (up to `num_runners`) whenever queued+running
    work exceeds the live thread count — so a broker with a generous
    `num_runners` cap doesn't pin dozens of idle threads per instance."""

    def __init__(self, num_runners: int = 4, name: str = "scheduler"):
        self.num_runners = num_runners
        self._name = name
        self._threads: list[threading.Thread] = []
        self._running = False
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queued = 0  # jobs enqueued but not yet picked up (pending())
        self._in_flight = 0  # jobs picked up by a runner, not yet finished

    def pending(self) -> int:
        """Queued-but-not-running job count (leak-check / observability)."""
        with self._lock:
            return self._queued

    def in_flight(self) -> int:
        """Jobs currently executing on runner threads."""
        with self._lock:
            return self._in_flight

    def queue_depths(self) -> dict[str, int]:
        """Per-group queued-job counts (single anonymous group by default;
        strategy subclasses report their real lanes/groups)."""
        with self._lock:
            return {"": self._queued}

    def stats(self) -> dict:
        """Live scheduler state for /debug/admission and metrics export."""
        with self._lock:
            return {
                "kind": self._name,
                "numRunners": self.num_runners,
                "liveRunners": len(self._threads),
                "running": self._running,
                "pending": self._queued,
                "inFlight": self._in_flight,
            }

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> None:
        with self._lock:
            if self._running:
                return
            self._running = True
            self._spawn_locked(min(self.num_runners, _CORE_RUNNERS))

    def _spawn_locked(self, n: int) -> None:
        for _ in range(n):
            t = threading.Thread(
                target=self._runner_loop,
                name=f"{self._name}-runner-{len(self._threads)}",
                daemon=True,
            )
            self._threads.append(t)
            t.start()

    def stop(self) -> None:
        with self._lock:
            self._running = False
            # drain queued jobs so callers blocked on their Futures unblock
            # instead of hanging forever (runners only finish in-flight work)
            for job in self._drain():
                self._queued -= 1
                if not job.future.cancel():
                    job.future.set_exception(SchedulerRejectedError("scheduler stopped"))
            self._wake.notify_all()
        for t in self._threads:
            t.join(timeout=5)
        self._threads.clear()

    # -- submission ---------------------------------------------------------

    def submit(self, fn, *args, table: str = "", workload: str = "PRIMARY", **kwargs) -> Future:
        job = _Job(fn, args, kwargs, group=table, workload=workload)
        with self._lock:
            if not self._running:
                raise SchedulerRejectedError("scheduler not running")
            self._enqueue(job)
            self._queued += 1
            # grow the elastic pool while work is backing up
            if (
                len(self._threads) < self.num_runners
                and self._queued + self._in_flight > len(self._threads)
            ):
                self._spawn_locked(1)
            self._wake.notify()
        return job.future

    # -- strategy hooks (called under self._lock) ---------------------------

    def _enqueue(self, job: _Job) -> None:
        raise NotImplementedError

    def _dequeue(self) -> _Job | None:
        raise NotImplementedError

    def _on_finish(self, job: _Job, elapsed_s: float) -> None:
        pass

    def _drain(self) -> list["_Job"]:
        """Remove and return ALL queued jobs (stop-time only). The default
        loops _dequeue; schedulers whose _dequeue gates on run caps (e.g.
        binary workload's secondary lane) MUST override with a policy-free
        drain, or capped jobs would be left queued with waiters hung."""
        out = []
        while True:
            job = self._dequeue()
            if job is None:
                return out
            out.append(job)

    # -- runner -------------------------------------------------------------

    def _runner_loop(self) -> None:
        while True:
            with self._lock:
                while self._running and (job := self._dequeue()) is None:
                    self._wake.wait(timeout=0.1)
                if not self._running:
                    return
                self._queued -= 1
                self._in_flight += 1
            t0 = time.perf_counter()
            job.run()
            elapsed = time.perf_counter() - t0
            with self._lock:
                self._in_flight -= 1
                self._on_finish(job, elapsed)
                self._wake.notify()


class FCFSScheduler(QueryScheduler):
    """Arrival order (FCFSQueryScheduler parity)."""

    def __init__(self, num_runners: int = 4):
        super().__init__(num_runners, "fcfs")
        self._q: queue.SimpleQueue[_Job] = queue.SimpleQueue()

    def _enqueue(self, job: _Job) -> None:
        self._q.put(job)

    def _dequeue(self) -> _Job | None:
        try:
            return self._q.get_nowait()
        except queue.Empty:
            return None


class _TokenBucket:
    """Per-group CPU-time budget (tokenbucket/ parity): tokens accrue at
    `rate` per second up to `burst`; running queries spend wall seconds."""

    __slots__ = ("tokens", "rate", "burst", "last_refill")

    def __init__(self, rate: float, burst: float):
        self.tokens = burst
        self.rate = rate
        self.burst = burst
        self.last_refill = time.perf_counter()

    def refill(self) -> None:
        now = time.perf_counter()
        self.tokens = min(self.burst, self.tokens + (now - self.last_refill) * self.rate)
        self.last_refill = now

    def spend(self, seconds: float) -> None:
        self.refill()
        self.tokens -= seconds


class PriorityScheduler(QueryScheduler):
    """Multi-level priority across scheduler groups (one per table), ordered
    by unspent tokens (MultiLevelPriorityQueue + PriorityScheduler parity).
    `max_pending_per_group` bounds each group's queue (reject on overflow)."""

    def __init__(
        self,
        num_runners: int = 4,
        tokens_per_sec: float = 1.0,
        token_burst_sec: float = 4.0,
        max_pending_per_group: int = 64,
    ):
        super().__init__(num_runners, "priority")
        self._groups: dict[str, list[_Job]] = {}
        self._buckets: dict[str, _TokenBucket] = {}
        self._rate = tokens_per_sec
        self._burst = token_burst_sec
        self._max_pending = max_pending_per_group

    def _bucket(self, group: str) -> _TokenBucket:
        b = self._buckets.get(group)
        if b is None:
            b = _TokenBucket(self._rate, self._burst)
            self._buckets[group] = b
        return b

    def _enqueue(self, job: _Job) -> None:
        q = self._groups.setdefault(job.group, [])
        if len(q) >= self._max_pending:
            raise SchedulerRejectedError(f"scheduler group {job.group!r} queue full ({self._max_pending})")
        self._bucket(job.group)
        q.append(job)

    def _dequeue(self) -> _Job | None:
        best = None
        best_tokens = None
        for g, q in self._groups.items():
            if not q:
                continue
            b = self._bucket(g)
            b.refill()
            if best is None or b.tokens > best_tokens:
                best, best_tokens = g, b.tokens
        if best is None:
            return None
        return self._groups[best].pop(0)

    def _on_finish(self, job: _Job, elapsed_s: float) -> None:
        self._bucket(job.group).spend(elapsed_s)

    def group_tokens(self) -> dict[str, float]:
        with self._lock:
            for b in self._buckets.values():
                b.refill()
            return {g: b.tokens for g, b in self._buckets.items()}

    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            return {g: len(q) for g, q in self._groups.items()}

    def stats(self) -> dict:
        out = super().stats()
        out["maxPendingPerGroup"] = self._max_pending
        out["queueDepths"] = self.queue_depths()
        out["groupTokens"] = self.group_tokens()
        return out


class BinaryWorkloadScheduler(QueryScheduler):
    """Two lanes (BinaryWorkloadScheduler parity): PRIMARY jobs always run;
    SECONDARY jobs are capped at `secondary_runners` concurrent and
    `max_secondary_pending` queued."""

    def __init__(self, num_runners: int = 4, secondary_runners: int = 1, max_secondary_pending: int = 16):
        super().__init__(num_runners, "binary-workload")
        self._primary: list[_Job] = []
        self._secondary: list[_Job] = []
        self._secondary_cap = max(1, secondary_runners)
        self._secondary_running = 0
        self._max_secondary_pending = max_secondary_pending

    def _enqueue(self, job: _Job) -> None:
        if job.workload == "SECONDARY":
            if len(self._secondary) >= self._max_secondary_pending:
                raise SchedulerRejectedError("secondary workload queue full")
            self._secondary.append(job)
        else:
            self._primary.append(job)

    def _dequeue(self) -> _Job | None:
        if self._primary:
            return self._primary.pop(0)
        if self._secondary and self._secondary_running < self._secondary_cap:
            self._secondary_running += 1
            return self._secondary.pop(0)
        return None

    def _on_finish(self, job: _Job, elapsed_s: float) -> None:
        if job.workload == "SECONDARY":
            self._secondary_running -= 1

    def _drain(self) -> list[_Job]:
        out = self._primary + self._secondary
        self._primary.clear()
        self._secondary.clear()
        return out

    def queue_depths(self) -> dict[str, int]:
        with self._lock:
            return {"PRIMARY": len(self._primary), "SECONDARY": len(self._secondary)}

    def stats(self) -> dict:
        out = super().stats()
        out["queueDepths"] = self.queue_depths()
        out["secondaryRunning"] = self._secondary_running
        return out


def make_scheduler(kind: str, num_runners: int = 4, **kwargs) -> QueryScheduler:
    """Config-driven factory (pinot.server.query.scheduler.name parity:
    fcfs | priority | binary_workload)."""
    kind = kind.lower()
    if kind == "fcfs":
        return FCFSScheduler(num_runners)
    if kind == "priority":
        return PriorityScheduler(num_runners, **kwargs)
    if kind in ("binary_workload", "binaryworkload"):
        return BinaryWorkloadScheduler(num_runners, **kwargs)
    raise ValueError(f"unknown scheduler kind: {kind}")
