"""Compiled per-segment programs: the least bytes of the queries sent inside
the profiled slice (`roofline.LeastBytes.program`), at the card's peak
bandwidth, over the time the card ran kernels in the slice."""

from olap_bench.roofline import HBM_BYTES_PER_S


def read(run):
    busy = run.slice.busy_seconds(lambda name, cat: cat == "kernel") if run.slice else 0.0
    queries = run.in_slice()
    if busy <= 0 or not queries:
        return None
    least = sum(run.least.program(r.sql, len(run.reference[r.sql])) for r in queries if not r.error)
    return 100.0 * least / HBM_BYTES_PER_S / busy
