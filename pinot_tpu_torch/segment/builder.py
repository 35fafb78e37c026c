"""Segment creation: raw rows/columns -> immutable segment, in memory or on
disk.

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

It builds single-value and multi-value (flattened CSR, see `ColumnIndex`)
dictionary and raw columns, the null vectors of `null_handling` (into
`seg.extras["null"]`; an MV column has none), the star-tree tables of
`star_tree_configs` (into `seg.extras["startree"]`), the vector index of a
`vector_index_columns` column (its input an (n_docs, dim) matrix, kept only
in the index) and the auxiliary indexes of the other index fields
(`_build_aux_indexes`, segment/indexes.py), as the JAX package's builder
does. `write_segment` persists a segment as the single-file `segment.ptseg`
(segment/store.py) or the npz layout (`metadata.json` + `columns.npz`), the
analog of Pinot's V3 single-file `columns.psf` + `metadata.properties`
(SingleFileIndexDirectory.java:88).
"""

from __future__ import annotations

import io
import json
from pathlib import Path
from typing import Any, Mapping, Sequence

import numpy as np

from pinot_tpu_torch.common.config import TableConfig
from pinot_tpu_torch.common.durability import atomic_write_bytes, atomic_write_text
from pinot_tpu_torch.common.types import DataType, FieldType, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.segment import ColumnIndex, ImmutableSegment, bm_from_bool
from pinot_tpu_torch.segment.startree import build_star_table
from pinot_tpu_torch.segment.stats import ColumnStats

FORMAT_VERSION = 1


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
        vector_cols = set(self.config.indexing.vector_index_columns)
        for col in self.schema.columns:
            if col not in columns:
                raise ValueError(f"missing column {col!r} in input data")
            raw = columns[col]
            if len(raw) != n_docs:
                raise ValueError(f"column {col!r} length {len(raw)} != {n_docs}")
            dt = self.schema[col].data_type
            if col in vector_cols:
                # an embedding column: its (n_docs, dim) matrix lives in the
                # vector index only (EXACT: brute-force top-k; HNSW: graph)
                from pinot_tpu_torch.segment.indexes import HnswIndex, VectorIndex

                kind = HnswIndex if self.config.indexing.vector_index_type.upper() == "HNSW" else VectorIndex
                seg.extras.setdefault("vector", {})[col] = kind.build(np.asarray(raw))
                continue
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
        self._build_aux_indexes(seg)
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

    def _build_aux_indexes(self, seg: ImmutableSegment) -> None:
        from pinot_tpu_torch.segment.indexes import BloomFilter, InvertedIndex, RangeIndex

        idx = self.config.indexing
        for col in idx.bloom_filter_columns:
            ci = seg.columns.get(col)
            if ci is None:
                continue
            vals = ci.dictionary.values if ci.is_dict_encoded else np.unique(ci.forward)
            seg.extras.setdefault("bloom", {})[col] = BloomFilter.build(np.asarray(vals))
        for col in idx.inverted_index_columns:
            ci = seg.columns.get(col)
            if ci is None or not ci.is_dict_encoded:
                continue
            seg.extras.setdefault("inverted", {})[col] = InvertedIndex.build(ci.forward, ci.cardinality)
        for col in idx.range_index_columns:
            ci = seg.columns.get(col)
            if ci is None:
                continue
            seg.extras.setdefault("range", {})[col] = RangeIndex.build(ci.forward)
        if idx.text_index_columns or idx.json_index_columns or idx.geo_index_columns:
            from pinot_tpu_torch.segment.h3 import H3Index
            from pinot_tpu_torch.segment.indexes import JsonIndex, TextIndex

            for col in idx.text_index_columns:
                ci = seg.columns.get(col)
                if ci is None or not ci.is_dict_encoded:
                    continue
                seg.extras.setdefault("text", {})[col] = TextIndex.build(ci.materialize())
            for col in idx.json_index_columns:
                ci = seg.columns.get(col)
                if ci is None or not ci.is_dict_encoded:
                    continue
                seg.extras.setdefault("json", {})[col] = JsonIndex.build(ci.materialize())
            for pair in idx.geo_index_columns:
                lat_col, lng_col = pair
                la, ln = seg.columns.get(lat_col), seg.columns.get(lng_col)
                if la is None or ln is None:
                    continue
                seg.extras.setdefault("geo", {})[f"{lat_col},{lng_col}"] = H3Index.build(
                    lat_col, lng_col, la.materialize().astype(np.float64), ln.materialize().astype(np.float64)
                )
        for col in idx.fst_index_columns:
            ci = seg.columns.get(col)
            # STRING dictionaries only: numeric dicts sort numerically, so
            # lexicographic prefix intervals would be wrong
            if ci is None or not ci.is_dict_encoded or ci.data_type != DataType.STRING:
                continue
            from pinot_tpu_torch.segment.indexes import FstIndex

            seg.extras.setdefault("fst", {})[col] = FstIndex.build(ci.dictionary.values)
        for col in idx.map_index_columns:
            ci = seg.columns.get(col)
            if ci is None:
                continue
            from pinot_tpu_torch.segment.indexes import MapIndex

            seg.extras.setdefault("map", {})[col] = MapIndex.build(ci.materialize())
        # third-party index types (IndexPlugin / StandardIndexes SPI parity)
        if (self.config.extra or {}).get("customIndexes"):
            from pinot_tpu_torch.segment.index_spi import build_custom_indexes

            build_custom_indexes(seg, self.config)

    # -- persistence ---------------------------------------------------------

    def build_and_write(self, data, segment_name: str, out_dir: str | Path) -> Path:
        return write_segment(self.build(data, segment_name), out_dir)


def write_segment(seg: ImmutableSegment, out_dir: str | Path, fmt: str = "ptseg", codec: str | None = None) -> Path:
    """Write a segment under `<out_dir>/<segment_name>/`.

    fmt="ptseg" (default): single-file V3-analog format with fixed-bit packed
    dict ids + chunks compressed by `codec` (lz4 when None) + per-entry CRC
    (segment/store.py).
    fmt="npz": the v1 numpy archive layout (metadata.json + columns.npz).
    Either loads in the JAX package too, and its files load here.
    """
    if fmt == "ptseg":
        from pinot_tpu_torch.segment.store import write_segment_file

        return write_segment_file(seg, Path(out_dir) / seg.name, codec)
    if fmt != "npz":
        raise ValueError(f"unknown segment format {fmt!r}; expected 'ptseg' or 'npz'")
    return _write_segment_npz(seg, out_dir)


def _write_segment_npz(seg: ImmutableSegment, out_dir: str | Path) -> Path:
    """v1 layout: `<out_dir>/<segment_name>/{metadata.json, columns.npz}`."""
    seg_dir = Path(out_dir) / seg.name
    seg_dir.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}
    col_meta = []
    for col, ci in seg.columns.items():
        arrays[f"fwd::{col}"] = ci.forward
        if ci.lens is not None:
            arrays[f"mvlens::{col}"] = ci.lens
        if ci.dictionary is not None:
            dv = ci.dictionary.values
            if ci.data_type == DataType.BYTES:
                # hex-encode: numpy 'S' dtype strips trailing \x00 bytes
                arrays[f"dict::{col}"] = np.asarray([v.hex() for v in dv], dtype=str)
            elif ci.data_type in (DataType.STRING, DataType.JSON):
                # store string dictionaries as fixed-width unicode npz entries
                arrays[f"dict::{col}"] = np.asarray(dv, dtype=str)
            else:
                arrays[f"dict::{col}"] = dv
        col_meta.append(
            {
                "name": col,
                "encoding": "DICT" if ci.dictionary is not None else "RAW",
                "stats": ci.stats.to_dict(),
                **({"mv": True} if ci.lens is not None else {}),
            }
        )
    star_meta = []
    for i, st in enumerate(seg.extras.get("startree", [])):
        for k, arr in st.arrays.items():
            arrays[f"star{i}::{k}"] = arr
        star_meta.append(
            {"dimensions": st.dimensions, "pairs": st.function_column_pairs, "nRows": st.n_rows}
        )
    aux_meta: dict = {"bloom": {}, "inverted": [], "range": []}
    for col, bf in seg.extras.get("bloom", {}).items():
        arrays[f"bloom::{col}"] = bf.bits
        aux_meta["bloom"][col] = bf.n_hashes
    for col, inv in seg.extras.get("inverted", {}).items():
        arrays[f"inv_off::{col}"] = inv.offsets
        arrays[f"inv_doc::{col}"] = inv.doc_ids
        aux_meta["inverted"].append(col)
    for col, ri in seg.extras.get("range", {}).items():
        arrays[f"range_doc::{col}"] = ri.sorted_doc_ids
        arrays[f"range_val::{col}"] = ri.sorted_values
        aux_meta["range"].append(col)
    if seg.extras.get("__custom_indexes__"):
        aux_meta["custom"] = seg.extras["__custom_indexes__"]
    # serialize the archive to memory then land it via the atomic-write
    # helper: a crash mid-save must not leave a torn columns.npz behind
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    atomic_write_bytes(seg_dir / "columns.npz", buf.getvalue())
    meta = {
        "formatVersion": FORMAT_VERSION,
        "segmentName": seg.name,
        "numDocs": seg.n_docs,
        "schema": json.loads(seg.schema.to_json()),
        "columns": col_meta,
        "starTrees": star_meta,
        "auxIndexes": aux_meta,
    }
    atomic_write_text(seg_dir / "metadata.json", json.dumps(meta, indent=1))
    return seg_dir
