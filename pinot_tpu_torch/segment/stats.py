"""Per-column statistics collected at segment build time.

Reference parity: the stats pass of SegmentIndexCreationDriverImpl
(pinot-segment-local/.../creator/impl/SegmentIndexCreationDriverImpl.java:93)
and ColumnMetadata. Stats drive (a) encoding decisions, (b) host-side segment
pruning (min/max like ColumnValueSegmentPruner), (c) group-by cardinality
products.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np

from pinot_tpu_torch.common.types import DataType


@dataclass
class ColumnStats:
    column: str
    data_type: DataType
    cardinality: int
    min_value: Any
    max_value: Any
    is_sorted: bool
    total_docs: int

    def to_dict(self) -> dict:
        def _plain(v):
            if isinstance(v, np.generic):
                return v.item()
            if isinstance(v, bytes):
                return {"__bytes__": v.hex()}
            return v

        return {
            "column": self.column,
            "dataType": self.data_type.value,
            "cardinality": self.cardinality,
            "min": _plain(self.min_value),
            "max": _plain(self.max_value),
            "sorted": self.is_sorted,
            "totalDocs": self.total_docs,
        }

    @staticmethod
    def from_dict(d: dict) -> "ColumnStats":
        def _unplain(v):
            if isinstance(v, dict) and "__bytes__" in v:
                return bytes.fromhex(v["__bytes__"])
            return v

        return ColumnStats(
            column=d["column"],
            data_type=DataType(d["dataType"]),
            cardinality=d["cardinality"],
            min_value=_unplain(d["min"]),
            max_value=_unplain(d["max"]),
            is_sorted=d["sorted"],
            total_docs=d["totalDocs"],
        )

    @staticmethod
    def from_dictionary(column: str, data_type: DataType, dict_ids: np.ndarray, dictionary) -> "ColumnStats":
        """Fast path when a sorted dictionary already exists: min/max are the
        dictionary endpoints and sortedness of ids == sortedness of values
        (ids are assigned in value order), avoiding a second O(N) value pass."""
        n = len(dict_ids)
        is_sorted = bool(np.all(dict_ids[:-1] <= dict_ids[1:])) if n > 1 else True
        if len(dictionary) == 0:
            mn, mx = ("", "") if data_type in (DataType.STRING, DataType.BYTES, DataType.JSON) else (0, 0)
        else:
            mn, mx = dictionary.min_value, dictionary.max_value
        return ColumnStats(column, data_type, dictionary.cardinality, mn, mx, is_sorted, n)

    @staticmethod
    def collect(column: str, data_type: DataType, values: np.ndarray, cardinality: int) -> "ColumnStats":
        if data_type in (DataType.STRING, DataType.BYTES, DataType.JSON):
            col = np.asarray(values).astype(str)
            is_sorted = bool(np.all(col[:-1] <= col[1:])) if len(col) > 1 else True
            # numpy min/max ufuncs lack unicode loops; use Python reduction
            mn = min(col.tolist()) if len(col) else ""
            mx = max(col.tolist()) if len(col) else ""
        else:
            col = np.asarray(values, dtype=data_type.np_dtype)
            is_sorted = bool(np.all(col[:-1] <= col[1:])) if len(col) > 1 else True
            mn = col.min().item() if len(col) else 0
            mx = col.max().item() if len(col) else 0
        return ColumnStats(column, data_type, cardinality, mn, mx, is_sorted, len(col))
