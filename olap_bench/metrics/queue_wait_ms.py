"""Query scheduler: the time a query waits for a runner, from its enqueue
to its start (`scheduler.wait` spans), per query in the slice."""

from olap_bench import spans


def read(run):
    logged = spans.spans(run)
    return spans.per_query_ms(run, spans.total(run, spans.named(logged, "scheduler.wait"))) if logged else None
