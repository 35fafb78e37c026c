"""Staging: the host time to stage every segment on the device
(`ImmutableSegment.to_device_cached`), synchronised."""


def read(run):
    return run.setup.get("stage_s")
