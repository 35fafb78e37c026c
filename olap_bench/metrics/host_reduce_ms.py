"""Convert, reduce, build result: the host time of `engine.resolve` less
the `segment.sync` spans inside it, per query in the slice."""

from olap_bench import spans


def read(run):
    logged = spans.spans(run)
    if not logged:
        return None
    resolves = spans.named(logged, "engine.resolve")
    syncs = spans.inside(spans.named(logged, "segment.sync"), resolves)
    return spans.per_query_ms(run, spans.total(run, resolves) - spans.total(run, syncs))
