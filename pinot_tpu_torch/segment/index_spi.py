"""Pluggable index-type SPI.

Reference parity: StandardIndexes + IndexType/IndexPlugin
(pinot-segment-spi/.../index/StandardIndexes.java:73-85 registers 13 types:
forward, dictionary, nullvalue_vector, bloom_filter, fst_index,
inverted_index, json_index, range_index, text_index, h3_index, vector_index,
map_index, star_tree). Here every type is an entry in one registry:

    IndexTypeSpec(name, build(seg, col, indexing_config) -> index | None)

The standard types register below (their builders delegate to the same
implementations SegmentBuilder wires directly); third-party plugins call
register_index_type() and declare columns via
TableConfig.extra["customIndexes"] = {"mytype": ["col", ...]} — the builder
runs them after the standard set and stores results in
seg.extras[name][col].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np


@dataclass(frozen=True)
class IndexTypeSpec:
    name: str
    build: Callable[[Any, str, Any], Any]  # (segment, column, IndexingConfig) -> index
    # where results land in seg.extras — standard types alias to the short
    # keys the query engine and the store actually consult
    extras_key: str | None = None

    @property
    def target_key(self) -> str:
        return self.extras_key or self.name


_REGISTRY: dict[str, IndexTypeSpec] = {}


def register_index_type(spec: IndexTypeSpec) -> None:
    _REGISTRY[spec.name] = spec


def get_index_type(name: str) -> IndexTypeSpec:
    if name not in _REGISTRY:
        raise KeyError(f"unknown index type {name!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def registered_index_types() -> list[str]:
    return sorted(_REGISTRY)


def build_custom_indexes(seg, table_config) -> None:
    """Run third-party index builders declared in
    TableConfig.extra['customIndexes'] = {type: [columns]}. The declaration
    is recorded on the segment so persistence can rebuild the indexes on
    load (SegmentPreProcessor on-load build parity)."""
    declared = (table_config.extra or {}).get("customIndexes", {})
    built: dict = {}
    for type_name, cols in declared.items():
        spec = get_index_type(type_name)
        for col in cols:
            idx = spec.build(seg, col, table_config.indexing)
            if idx is not None:
                seg.extras.setdefault(spec.target_key, {})[col] = idx
                built.setdefault(type_name, []).append(col)
    if built:
        seg.extras["__custom_indexes__"] = built


def rebuild_custom_indexes(seg, declared: dict) -> None:
    """Loader-side rebuild of custom indexes from the persisted declaration
    {type: [columns]} — plugin indexes survive a write/load cycle without a
    plugin serde contract."""
    for type_name, cols in declared.items():
        try:
            spec = get_index_type(type_name)
        except KeyError:
            continue  # plugin not registered in this process: skip quietly
        for col in cols:
            idx = spec.build(seg, col, None)
            if idx is not None:
                seg.extras.setdefault(spec.target_key, {})[col] = idx
    seg.extras["__custom_indexes__"] = dict(declared)


# -- standard registrations ---------------------------------------------------


def _std(name: str, fn) -> None:
    register_index_type(IndexTypeSpec(name, fn))


def _dict_col(seg, col):
    ci = seg.columns.get(col)
    return ci if ci is not None and ci.is_dict_encoded else None


def _build_bloom(seg, col, _cfg):
    from pinot_tpu_torch.segment.indexes import BloomFilter

    ci = seg.columns.get(col)
    if ci is None:
        return None
    vals = ci.dictionary.values if ci.is_dict_encoded else np.unique(ci.forward)
    return BloomFilter.build(np.asarray(vals))


def _build_inverted(seg, col, _cfg):
    from pinot_tpu_torch.segment.indexes import InvertedIndex

    ci = _dict_col(seg, col)
    return InvertedIndex.build(ci.forward, ci.cardinality) if ci else None


def _build_range(seg, col, _cfg):
    from pinot_tpu_torch.segment.indexes import RangeIndex

    ci = seg.columns.get(col)
    return RangeIndex.build(ci.forward) if ci is not None else None


def _build_text(seg, col, _cfg):
    from pinot_tpu_torch.segment.indexes import TextIndex

    ci = _dict_col(seg, col)
    return TextIndex.build(ci.materialize()) if ci else None


def _build_json(seg, col, _cfg):
    from pinot_tpu_torch.segment.indexes import JsonIndex

    ci = _dict_col(seg, col)
    return JsonIndex.build(ci.materialize()) if ci else None


def _build_fst(seg, col, _cfg):
    from pinot_tpu_torch.common.types import DataType
    from pinot_tpu_torch.segment.indexes import FstIndex

    ci = _dict_col(seg, col)
    if ci is None or ci.data_type != DataType.STRING:
        return None  # numeric dicts sort numerically: prefix intervals invalid
    return FstIndex.build(ci.dictionary.values)


def _build_map(seg, col, _cfg):
    from pinot_tpu_torch.segment.indexes import MapIndex

    ci = seg.columns.get(col)
    return MapIndex.build(ci.materialize()) if ci is not None else None


def _std2(name, fn, key):
    register_index_type(IndexTypeSpec(name, fn, extras_key=key))


_std2("bloom_filter", _build_bloom, "bloom")
_std2("inverted_index", _build_inverted, "inverted")
_std2("range_index", _build_range, "range")
_std2("text_index", _build_text, "text")
_std2("json_index", _build_json, "json")
_std2("fst_index", _build_fst, "fst")
_std2("map_index", _build_map, "map")
# forward / dictionary / nullvalue_vector / star_tree / h3 / vector are wired
# structurally by SegmentBuilder (they need build-time inputs beyond one
# column); they register as named types for discoverability
_std("forward", lambda seg, col, cfg: None)
_std("dictionary", lambda seg, col, cfg: None)
_std("nullvalue_vector", lambda seg, col, cfg: None)
_std("star_tree", lambda seg, col, cfg: None)
_std("h3_index", lambda seg, col, cfg: None)
_std("vector_index", lambda seg, col, cfg: None)
