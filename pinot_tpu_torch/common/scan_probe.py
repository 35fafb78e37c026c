"""Index-probe attribution hook (dependency-free base layer).

The JAX package's `common/scan_probe.py`. The index structures report into
it (a segment-layer module cannot import ``query/scan_stats.py``, which
pulls the engine); ``query/scan_stats.py`` re-exports these names. The
port's segments carry no aux index yet (their bloom, geo and posting-list
probes come with the indexes), so today only the engine's collectors run.

Cost model: when nobody is collecting, ``record_index_probe`` is one
contextvar read plus a None check, so index hot paths stay unburdened.
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager

_PROBES: contextvars.ContextVar = contextvars.ContextVar(
    "pinot_scan_probes", default=None
)


def record_index_probe(kind: str, entries: int) -> None:
    """Called from index filter entry points: `entries` internal index
    entries were examined to answer one probe.  No-op (one contextvar read)
    unless a collector is installed."""
    sink = _PROBES.get()
    if sink is not None:
        sink[kind] = sink.get(kind, 0) + int(entries)


@contextmanager
def collect_probes(sink: dict):
    token = _PROBES.set(sink)
    try:
        yield sink
    finally:
        _PROBES.reset(token)
