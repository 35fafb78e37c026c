"""Warm-up of the cell's programs: the host time of the warm-up round (the
clients together, each sending every query of the mix once), in which the
program captures its graphs (`captures` beside it on the run's set-up
line)."""


def read(run):
    return run.setup.get("warm_s")
