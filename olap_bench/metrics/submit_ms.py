"""Engine front (parse, plan, prune, enqueue): the mean host time of
`QueryEngine.submit`, which returns once every segment's program is
enqueued, with no sync, over the traced window's answered queries."""

from olap_bench.harness import mean


def read(run):
    return mean((r.submitted - r.running) * 1e3 for r in run.records if not r.error)
