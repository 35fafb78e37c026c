"""Compiled per-segment programs on the card: each segment's card time (the
`card_ms` of its `segment.resolve` span, its program's CUDA event pair),
placed on the host clock as the interval that ends when the host's wait
for its copy ended (its `segment.sync`) and clipped to the slice, per query
in the slice. Nothing off a card."""

from olap_bench import spans


def read(run):
    if run.slice is None or not run.slice.cuda:
        return None
    logged = spans.spans(run)
    if not logged:
        return None
    resolves = [r for r in spans.named(logged, "segment.resolve") if "card_ms" in r.attrs]
    syncs = spans.named(logged, "segment.sync")
    seconds = 0.0
    for r in resolves:
        done = max((s.end for s in spans.inside(syncs, [r])), default=r.end)
        seconds += spans.clipped(run, done - r.attrs["card_ms"] / 1e3, done)
    return spans.per_query_ms(run, seconds)
