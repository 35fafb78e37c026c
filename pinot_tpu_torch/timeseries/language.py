"""Timeseries language-plugin SPI.

Reference parity: pinot-timeseries/pinot-timeseries-spi's
TimeSeriesLogicalPlanner — each query LANGUAGE is a plugin that parses its
own syntax into the shared plan-node tree (LeafTimeSeriesPlanNode +
TransformNode), and the single physical engine executes any of them
(PinotTimeSeriesConfiguration registers languages by name; the reference
ships pinot-timeseries-m3ql as the first plugin).

Two registries:
- languages: name -> planner(query_str) -> plan tree
- series ops: name -> op(block, args, request) -> block  (the pipeline
  operator tier; plugins may add ops and every registered language can emit
  them as TransformNodes)

This is the JAX package's `timeseries/language.py`; the lazy plugin import
loads this package's `plan` and `promql`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_LANGUAGES: dict[str, Callable] = {}
_SERIES_OPS: dict[str, Callable] = {}


def register_timeseries_language(name: str, planner: Callable) -> None:
    """planner: query string -> plan tree (TimeSeriesLogicalPlanner SPI)."""
    _LANGUAGES[name.lower()] = planner


def get_timeseries_planner(name: str) -> Callable:
    key = name.lower()
    if key not in _LANGUAGES:
        # language plugins self-register on import (PluginManager analog)
        import importlib

        for mod in ("pinot_tpu_torch.timeseries.plan", "pinot_tpu_torch.timeseries.promql"):
            importlib.import_module(mod)
        if key not in _LANGUAGES:
            raise KeyError(
                f"unknown timeseries language {name!r}; registered: {sorted(_LANGUAGES)}"
            )
    return _LANGUAGES[key]


def registered_languages() -> list[str]:
    return sorted(_LANGUAGES)


def register_series_op(name: str, fn: Callable) -> None:
    """fn(block, args: list[str], request) -> TimeSeriesBlock."""
    _SERIES_OPS[name.lower()] = fn


def get_series_op(name: str) -> Callable:
    return _SERIES_OPS[name.lower()]


def has_series_op(name: str) -> bool:
    return name.lower() in _SERIES_OPS


def registered_series_ops() -> list[str]:
    return sorted(_SERIES_OPS)


# -- built-in op pack (beyond the core set in engine.py) ---------------------


def _map(block, fn):
    # one per-series map helper for the whole tier (engine.py re-exports it)
    from pinot_tpu_torch.timeseries.plan import TimeSeriesBlock

    return TimeSeriesBlock(
        block.buckets, block.tag_names, {k: fn(v) for k, v in block.series.items()}
    )


def ranked_k(block, k: int, largest: bool):
    """Shared top-k/bottom-k by nansum — ONE ranking implementation for the
    engine's topk and the op pack's bottomk."""
    from pinot_tpu_torch.timeseries.plan import TimeSeriesBlock

    ranked = sorted(
        block.series.items(), key=lambda kv: (-np.nansum(kv[1]) if largest else np.nansum(kv[1]))
    )
    return TimeSeriesBlock(block.buckets, block.tag_names, dict(ranked[: max(1, k)]))


def _op_transform_null(block, args, request):
    """transformNull <v>: replace empty buckets with a constant (m3ql
    transformNull / PromQL-style vector fill)."""
    fill = float(args[0]) if args else 0.0
    return _map(block, lambda v: np.where(np.isnan(v), fill, v))


def _op_absolute(block, args, request):
    return _map(block, np.abs)


def _op_integral(block, args, request):
    """Running sum over time (m3ql integral); empty buckets contribute 0 but
    stay empty in the output."""

    def f(v):
        filled = np.where(np.isnan(v), 0.0, v)
        out = np.cumsum(filled)
        out[np.isnan(v)] = np.nan
        return out

    return _map(block, f)


def _op_per_second(block, args, request):
    """Counter value per second of bucket width (PromQL rate flavor over
    already-bucketed deltas)."""
    return _map(block, lambda v: v / float(request.step))


def _op_bottomk(block, args, request):
    return ranked_k(block, int(args[0]) if args else 1, largest=False)


def _op_clamp_min(block, args, request):
    lo = float(args[0])
    return _map(block, lambda v: np.maximum(v, lo))


def _op_clamp_max(block, args, request):
    hi = float(args[0])
    return _map(block, lambda v: np.minimum(v, hi))


for _name, _fn in {
    "transformnull": _op_transform_null,
    "absolute": _op_absolute,
    "integral": _op_integral,
    "persecond": _op_per_second,
    "bottomk": _op_bottomk,
    "clampmin": _op_clamp_min,
    "clampmax": _op_clamp_max,
}.items():
    register_series_op(_name, _fn)
