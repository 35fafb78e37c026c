"""Carry a segment across from plain data.

`segment_from_numpy` rebuilds an `ImmutableSegment` from a description made
of plain values and numpy arrays only, so a segment built elsewhere (by the
JAX package's builder, or read from any store) is queried here over the
byte-identical forward arrays and dictionary ids. It is the counterpart of
carrying a model's weights across.

    desc = {
        "name": "lineorder_0",                  # optional, default "segment"
        "schema": "<Schema.to_json() text>",
        "n_docs": 4000,
        "columns": {
            "<column>": {
                "forward": np.ndarray,          # dict ids (int32) or raw values;
                                                # an MV column's flat values
                "dictionary": np.ndarray | None,  # sorted unique values
                "stats": {...},                 # ColumnStats.to_dict() form
                "lens": np.ndarray,             # MV only: int32 value count
                                                # of each doc (sum = len(forward))
            },
            ...
        },
        "null": {"<column>": np.ndarray},       # optional: null-vector bitmaps
                                                # (little-endian uint64 words)
        "startree": [                           # optional: star-tree tables
            {
                "dimensions": [...],            # split order
                "function_column_pairs": [...],
                "n_rows": 90,
                "arrays": {"<column>": np.ndarray, ...},
            },
            ...
        ],
    }
"""

from __future__ import annotations

import numpy as np

from pinot_tpu_torch.common.types import Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.segment import ColumnIndex, ImmutableSegment
from pinot_tpu_torch.segment.startree import StarTable
from pinot_tpu_torch.segment.stats import ColumnStats


def segment_from_numpy(desc: dict) -> ImmutableSegment:
    schema = Schema.from_json(desc["schema"])
    n_docs = int(desc["n_docs"])
    seg = ImmutableSegment(name=desc.get("name", "segment"), schema=schema, n_docs=n_docs)
    for col in schema.columns:
        if col not in desc["columns"]:
            raise ValueError(f"segment description has no column {col!r}")
        spec = schema[col]
        cd = desc["columns"][col]
        fwd = np.ascontiguousarray(cd["forward"])
        lens = None
        n_values = n_docs
        if not spec.single_value:
            if cd.get("lens") is None:
                raise ValueError(f"multi-value column {col!r} needs its per-doc value counts (\"lens\")")
            lens = np.ascontiguousarray(cd["lens"], dtype=np.int32)
            if lens.shape != (n_docs,) or (lens < 0).any():
                raise ValueError(f"column {col!r}: lens of shape {lens.shape}, expected ({n_docs},) counts >= 0")
            n_values = int(lens.sum(dtype=np.int64))
        if fwd.ndim != 1 or len(fwd) != n_values:
            raise ValueError(f"column {col!r}: forward array of shape {fwd.shape}, expected ({n_values},)")
        values = cd.get("dictionary")
        dictionary = None
        if values is not None:
            values = np.asarray(values)
            if fwd.dtype != np.int32:
                raise ValueError(f"column {col!r}: dict ids must be int32, got {fwd.dtype}")
            dictionary = Dictionary(spec.data_type, values)
        elif fwd.dtype != spec.data_type.np_dtype:
            raise ValueError(
                f"column {col!r}: raw values must be {spec.data_type.np_dtype}, got {fwd.dtype}"
            )
        stats = ColumnStats.from_dict(cd["stats"])
        if lens is not None:
            # the doc-range fast path never takes an MV column
            stats.is_sorted = False
        seg.columns[col] = ColumnIndex(col, spec.data_type, dictionary, fwd, stats, lens=lens)
    for col, bitmap in desc.get("null", {}).items():
        if col not in seg.columns:
            raise ValueError(f"null vector of unknown column {col!r}")
        seg.extras.setdefault("null", {})[col] = np.ascontiguousarray(bitmap, dtype=np.uint64)
    for st in desc.get("startree", ()):
        arrays = {name: np.ascontiguousarray(a) for name, a in st["arrays"].items()}
        table = StarTable(list(st["dimensions"]), list(st["function_column_pairs"]), int(st["n_rows"]), arrays)
        seg.extras.setdefault("startree", []).append(table)
    return seg
