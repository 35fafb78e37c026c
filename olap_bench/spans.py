"""The program's span log, read for the per-layer metrics of a traced run.

The program logs its spans (`pinot_tpu_torch.common.trace.SPANS`) while a
torch profiler records, so a traced run's log holds the profiled slice's
spans, each overlapping one whole. Every span is clipped to `run.slice`. A
per-query figure is the clipped time over the queries in the slice counted
fractionally (Little's law): each query counts the share of its life, from
the client sending it to its answer, inside the slice, so no query need lie
wholly inside it. A program without the log gives nothing to read.
"""

from __future__ import annotations


def spans(run) -> list:
    """The logged spans that overlap the slice ([] where the program has
    no log, or nothing was logged)."""
    if run.slice is None:
        return []
    try:
        from pinot_tpu_torch.common.trace import SPANS
    except ImportError:
        return []
    start, end = run.slice.start, run.slice.end
    return [r for r in SPANS.records() if r.end > start and r.start < end]


def named(records: list, name: str) -> list:
    return [r for r in records if r.name == name]


def clipped(run, start: float, end: float) -> float:
    """Seconds of [start, end] inside the slice."""
    return max(0.0, min(end, run.slice.end) - max(start, run.slice.start))


def total(run, records: list) -> float:
    return sum(clipped(run, r.start, r.end) for r in records)


def inside(records: list, outer: list) -> list:
    """The records that lie within one of `outer` on the same thread (a
    thread's spans nest)."""
    by_thread: dict = {}
    for o in outer:
        by_thread.setdefault(o.thread, []).append(o)
    return [
        r for r in records if any(o.start <= r.start and r.end <= o.end for o in by_thread.get(r.thread, ()))
    ]


def queries(run) -> float:
    """The queries in the slice, each counted by the share of its life
    inside it."""
    return sum(
        clipped(run, r.start, r.done) / (r.done - r.start) for r in run.records if r.done > r.start
    )


def per_query_ms(run, seconds: float) -> float | None:
    n = queries(run)
    return 1e3 * seconds / n if n > 0 else None
