"""Compiled programs' launch: the host time of the `segment.enqueue` spans
inside `engine.submit` (operands bound, the graph found or captured, the
wait for the pool's lock, the replay, the copy enqueued), per query in the
slice."""

from olap_bench import spans


def read(run):
    logged = spans.spans(run)
    if not logged:
        return None
    submits = spans.named(logged, "engine.submit")
    return spans.per_query_ms(run, spans.total(run, spans.inside(spans.named(logged, "segment.enqueue"), submits)))
