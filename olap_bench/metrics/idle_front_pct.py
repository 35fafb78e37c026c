"""Device idle caused by the engine front: the share of the slice in which
the card ran no kernel, copy or fill while a query was in `engine.submit`."""

from olap_bench import spans


def read(run):
    if run.slice is None or not run.slice.cuda or run.slice.seconds <= 0:
        return None
    logged = spans.spans(run)
    if not logged:
        return None
    submits = spans.named(logged, "engine.submit")
    fronts: list = []
    for s, e in sorted((max(r.start, run.slice.start), min(r.end, run.slice.end)) for r in submits):
        if fronts and s <= fronts[-1][1]:
            fronts[-1][1] = max(fronts[-1][1], e)
        elif e > s:
            fronts.append([s, e])
    busy = run.slice.busy_intervals()
    idle = 0.0
    for s, e in fronts:
        covered = sum(max(0.0, min(e, b1) - max(s, b0)) for b0, b1 in busy)
        idle += (e - s) - covered
    return 100.0 * idle / run.slice.seconds
