"""Copies back, convert, reduce: the mean host time of the `resolve()` that
`submit` returns, over the traced window's answered queries."""

from olap_bench.harness import mean


def read(run):
    return mean((r.resolved - r.submitted) * 1e3 for r in run.records if not r.error)
