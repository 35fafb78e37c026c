"""Engine front: parse, prune and plan, the host time of `engine.submit`
less the `segment.enqueue` spans inside it, per query in the slice."""

from olap_bench import spans


def read(run):
    logged = spans.spans(run)
    if not logged:
        return None
    submits = spans.named(logged, "engine.submit")
    enqueues = spans.inside(spans.named(logged, "segment.enqueue"), submits)
    return spans.per_query_ms(run, spans.total(run, submits) - spans.total(run, enqueues))
