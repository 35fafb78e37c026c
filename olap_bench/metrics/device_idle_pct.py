"""Device: the share of the profiled slice in which the card ran no kernel,
copy or fill (one less the union of their intervals over the slice)."""


def read(run):
    if run.slice is None or not run.slice.cuda or run.slice.seconds <= 0:
        return None
    return 100.0 * (1.0 - run.slice.busy_seconds() / run.slice.seconds)
