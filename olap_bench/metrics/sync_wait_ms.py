"""Copies back: the host blocked on the card, the `segment.sync` spans
inside `engine.resolve`, per query in the slice."""

from olap_bench import spans


def read(run):
    logged = spans.spans(run)
    if not logged:
        return None
    resolves = spans.named(logged, "engine.resolve")
    return spans.per_query_ms(run, spans.total(run, spans.inside(spans.named(logged, "segment.sync"), resolves)))
