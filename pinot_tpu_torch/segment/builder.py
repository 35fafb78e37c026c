"""Segment creation: raw rows/columns -> in-memory immutable segment.

Reference parity: SegmentIndexCreationDriverImpl (pinot-segment-local/.../
creator/impl/SegmentIndexCreationDriverImpl.java:93): a stats pass over the
input followed by per-column index creation. Columnar-first: input is a dict
of numpy arrays (or a list of row dicts, pivoted once) and the creation is
vectorized numpy.

Encoding decisions (IndexingConfig semantics, as in the JAX package):
  - DIMENSION / DATE_TIME columns: dictionary-encoded by default.
  - METRIC columns: raw by default (Pinot's common noDictionaryColumns pattern).
  - TableConfig.indexing.{dictionary,no_dictionary}_columns override.
  - STRING/BYTES/JSON are ALWAYS dictionary-encoded: only ids ever reach the
    device.

This package builds single-value and multi-value (flattened CSR, see
`ColumnIndex`) dictionary and raw columns, the null vectors of
`null_handling` (into `seg.extras["null"]`; an MV column has none) and the
star-tree tables of `star_tree_configs` (into `seg.extras["startree"]`); a
table config that asks for anything else raises NotImplementedError naming it.
"""

from __future__ import annotations

from typing import Any, Mapping, Sequence

import numpy as np

from pinot_tpu_torch.common.config import UNSUPPORTED_INDEX_FIELDS, TableConfig
from pinot_tpu_torch.common.types import DataType, FieldType, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.segment import ColumnIndex, ImmutableSegment, bm_from_bool
from pinot_tpu_torch.segment.startree import build_star_table
from pinot_tpu_torch.segment.stats import ColumnStats


def _pivot(rows: Sequence[Mapping[str, Any]], schema: Schema) -> dict[str, np.ndarray]:
    cols: dict[str, list] = {c: [] for c in schema.columns}
    for r in rows:
        for c in schema.columns:
            cols[c].append(r.get(c))
    return {c: np.asarray(vals, dtype=object) for c, vals in cols.items()}


def _separate_nulls(raw: np.ndarray, dt: DataType) -> tuple[np.ndarray, np.ndarray | None]:
    """Replace None entries with the type's default null placeholder
    (FieldSpec DEFAULT_* parity) and return (values, null bool mask or None).
    A nullable LONG column's placeholder is int64 min, so its staged copy
    stays int64 (see ImmutableSegment.to_device)."""
    if raw.dtype != object:
        return raw, None
    nulls = np.asarray([v is None for v in raw], dtype=bool)
    if nulls.any():
        raw = raw.copy()
        raw[nulls] = dt.default_null
    found = nulls if nulls.any() else None
    if dt in (DataType.STRING, DataType.BYTES, DataType.JSON):
        return raw, found
    return raw.astype(dt.np_dtype), found


class SegmentBuilder:
    """Builds one immutable segment from input data."""

    def __init__(self, schema: Schema, table_config: TableConfig | None = None):
        self.schema = schema
        self.config = table_config or TableConfig(schema.name)
        idx = self.config.indexing
        for name in UNSUPPORTED_INDEX_FIELDS:
            if getattr(idx, name):
                raise NotImplementedError(f"IndexingConfig.{name} is not supported by pinot_tpu_torch yet (ROADMAP A6)")

    def _use_dictionary(self, col: str) -> bool:
        spec = self.schema[col]
        idx = self.config.indexing
        if spec.data_type in (DataType.STRING, DataType.BYTES, DataType.JSON):
            return True
        if col in idx.no_dictionary_columns:
            return False
        if col in idx.dictionary_columns:
            return True
        return spec.field_type in (FieldType.DIMENSION, FieldType.DATE_TIME)

    def build(
        self,
        data: Sequence[Mapping[str, Any]] | Mapping[str, np.ndarray],
        segment_name: str,
    ) -> ImmutableSegment:
        if isinstance(data, Mapping):
            columns = {c: np.asarray(v) for c, v in data.items()}
        else:
            columns = _pivot(data, self.schema)
        n_docs = len(next(iter(columns.values()))) if columns else 0
        seg = ImmutableSegment(name=segment_name, schema=self.schema, n_docs=n_docs)
        for col in self.schema.columns:
            if col not in columns:
                raise ValueError(f"missing column {col!r} in input data")
            raw = columns[col]
            if len(raw) != n_docs:
                raise ValueError(f"column {col!r} length {len(raw)} != {n_docs}")
            dt = self.schema[col].data_type
            if not self.schema[col].single_value:
                seg.columns[col] = self._build_mv_column(col, dt, raw)
                continue
            raw, nulls = _separate_nulls(raw, dt)
            if nulls is not None and self.config.indexing.null_handling:
                seg.extras.setdefault("null", {})[col] = bm_from_bool(nulls)
            if self._use_dictionary(col):
                dictionary, ids = Dictionary.from_column(dt, raw)
                stats = ColumnStats.from_dictionary(col, dt, ids, dictionary)
                fwd = ids
            else:
                dictionary = None
                vals = np.asarray(raw, dtype=dt.np_dtype)
                card = len(np.unique(vals))
                stats = ColumnStats.collect(col, dt, vals, card)
                fwd = vals
            seg.columns[col] = ColumnIndex(col, dt, dictionary, fwd, stats)
        for st_cfg in self.config.indexing.star_tree_configs:
            seg.extras.setdefault("startree", []).append(build_star_table(seg, st_cfg))
        return seg

    def _build_mv_column(self, col: str, dt: DataType, raw) -> ColumnIndex:
        """A multi-value column -> flattened CSR ColumnIndex: the per-doc value
        lists (None is an empty list) back to back in one vector, the
        dictionary over the flat values, and int32 `lens`."""
        lens = np.asarray([0 if v is None else len(v) for v in raw], dtype=np.int32)
        parts = [np.asarray(v) for v in raw if v is not None and len(v)]
        if parts:
            flat = np.concatenate([p.astype(object) if p.dtype == object else p for p in parts])
        else:
            flat = np.zeros(0, dtype=dt.np_dtype)
        if self._use_dictionary(col):
            dictionary, fwd = Dictionary.from_column(dt, flat)
            stats = ColumnStats.from_dictionary(col, dt, fwd, dictionary)
        else:
            dictionary = None
            fwd = np.asarray(flat, dtype=dt.np_dtype)
            stats = ColumnStats.collect(col, dt, fwd, len(np.unique(fwd)))
        # a sorted flat vector does not mean sorted docs: the doc-range fast
        # path never takes an MV column
        stats.is_sorted = False
        return ColumnIndex(col, dt, dictionary, fwd, stats, lens=lens)
