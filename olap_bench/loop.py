"""The closed loop: client threads that each send a query when their last
one returns.

A client sends each query to the program's query scheduler
(`pinot_tpu_torch.query.scheduler`, a pool of runner threads, as a Pinot
server runs its queries) and waits for its answer. A runner runs it as the
engine's one path does:
`QueryEngine.submit(sql)` (parse, plan, the per-segment programs enqueued,
no sync), then the `resolve()` it returns (the copies back, the convert, the
reduce). Each is timed with the host clock, and the client times the whole
query, from sending it to holding its `ResultTable`. A client sends no new
query once the window has closed and finishes the one it has in flight;
that query is compared with the others and its latency counts.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class QueryRecord:
    client: int
    name: str
    sql: str
    start: float  # the client sent it (perf_counter seconds)
    running: float  # the engine's submit called
    submitted: float  # submit returned
    resolved: float  # the ResultTable made
    done: float  # the client holds the answer, or the failure
    error: str | None = None
    segments: int = 0
    pruned: int = 0
    docs_scanned: int = 0

    @property
    def latency_ms(self) -> float:
        return (self.done - self.start) * 1e3


@dataclass
class LoopResult:
    records: list = field(default_factory=list)
    #: sql -> {rows as a tuple of tuples: times returned}
    answers: dict = field(default_factory=dict)
    window: tuple = (0.0, 0.0)


def _execute(engine, sql: str):
    """The server's side of one query: (result, submit called, submit
    returned, resolved)."""
    running = time.perf_counter()
    resolve = engine.submit(sql)
    submitted = time.perf_counter()
    result = resolve()
    return result, running, submitted, time.perf_counter()


def _one(engine, scheduler, client: int, name: str, sql: str, out: LoopResult, lock: threading.Lock) -> QueryRecord:
    start = time.perf_counter()
    try:
        result, running, submitted, resolved = scheduler.submit(_execute, engine, sql).result()
    except Exception as exc:  # noqa: BLE001 — a failed query is counted, never raised past the run
        now = time.perf_counter()
        return QueryRecord(client, name, sql, start, start, now, now, now, error=f"{type(exc).__name__}: {exc}")
    rec = QueryRecord(
        client,
        name,
        sql,
        start,
        running,
        submitted,
        resolved,
        time.perf_counter(),
        segments=result.num_segments_queried,
        pruned=result.num_segments_pruned,
        docs_scanned=result.num_docs_scanned,
    )
    if result.exceptions or result.partial_result:
        rec.error = f"exceptions {result.exceptions}, partial {result.partial_result}"
        return rec
    key = tuple(tuple(r) for r in result.rows)
    with lock:
        seen = out.answers.setdefault(sql, {})
        seen[key] = seen.get(key, 0) + 1
    return rec


def run(engine, scheduler, streams: list, seconds: float, on_tick=None, rounds: int | None = None) -> LoopResult:
    """Drive `engine` through `scheduler` from one client thread a stream
    ((name, sql) iterators) for `seconds`, or, with
    `rounds`, until each client has sent that many queries. `on_tick(now)`
    is called by the main thread about every 10 ms while the window is open
    (the profiler's slice starts and stops there)."""
    out = LoopResult()
    lock = threading.Lock()
    start = time.perf_counter()
    end = start + seconds
    per_client: list[list] = [[] for _ in streams]

    def client(i: int, stream) -> None:
        while len(per_client[i]) < rounds if rounds is not None else time.perf_counter() < end:
            name, sql = next(stream)
            per_client[i].append(_one(engine, scheduler, i, name, sql, out, lock))

    threads = [threading.Thread(target=client, args=(i, s), name=f"client-{i}", daemon=True) for i, s in enumerate(streams)]
    for t in threads:
        t.start()
    while rounds is None:
        now = time.perf_counter()
        if now >= end:
            break
        if on_tick is not None:
            on_tick(now)
        time.sleep(min(0.01, end - now))
    if on_tick is not None:
        on_tick(time.perf_counter())
    for t in threads:
        # a query in flight at the close is waited for, a minute at most
        t.join(timeout=None if rounds is not None else 60.0)
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise RuntimeError(f"clients still in a query a minute after the window closed: {stuck}")
    out.records = sorted((r for recs in per_client for r in recs), key=lambda r: r.start)
    out.window = (start, end)
    return out
