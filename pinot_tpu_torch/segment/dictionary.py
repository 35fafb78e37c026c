"""Per-column sorted dictionaries: value <-> dense id.

Reference parity: pinot-segment-spi/.../index/reader/Dictionary.java:37 and the
OnHeap/OffHeap dictionary readers in pinot-segment-local. Ids are assigned in
sorted value order, which is the property the query engine exploits: any
equality/range/IN predicate over a dict-encoded column lowers to integer
comparisons on ids with host-resolved bounds, so no string compare ever
reaches the device.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from pinot_tpu_torch.common.types import DataType


class Dictionary:
    """Immutable sorted dictionary over a column's distinct values."""

    def __init__(self, data_type: DataType, values: np.ndarray):
        self.data_type = data_type
        # values must be sorted ascending and unique
        self.values = values

    # -- construction -------------------------------------------------------

    @staticmethod
    def from_column(data_type: DataType, column: np.ndarray) -> tuple["Dictionary", np.ndarray]:
        """Build dictionary from raw column; returns (dict, dictId array int32)."""
        if data_type == DataType.BYTES:
            col = np.asarray(column, dtype=object)
            values, ids = np.unique(np.asarray([bytes(v) for v in col], dtype=object), return_inverse=True)
        elif data_type in (DataType.STRING, DataType.JSON):
            # sort-based unique over a fixed-width '<U' array: numpy compares
            # the strings as code-point arrays in C, where an object array
            # would compare Python objects one call at a time. The order is
            # numpy's string order, the same the reference's factorize + sort
            # produces, so ids and values match it exactly.
            values, ids = np.unique(np.asarray(column).astype(str), return_inverse=True)
        else:
            values, ids = np.unique(np.asarray(column, dtype=data_type.np_dtype), return_inverse=True)
        return Dictionary(data_type, values), ids.reshape(-1).astype(np.int32)

    def hll_hash_pad(self) -> np.ndarray:
        """uint32 hash of every dictionary value (`sketches.hash_any`),
        zero-padded to a power of two, memoized. The memo is valid because a
        dictionary never changes after construction. The array is marked as a
        stable operand, so the kernel layer stages it once per device and
        keeps that copy while the array lives, instead of copying a multi-MB
        table with every DISTINCTCOUNTHLL query."""
        hv = getattr(self, "_hll_hash_pad", None)
        if hv is None:
            from pinot_tpu_torch.query.kernels import mark_stable_operand
            from pinot_tpu_torch.query.sketches import hash_any

            hv = hash_any(self.values)
            pad = 1 << max(int(np.ceil(np.log2(max(len(hv), 1)))), 0)
            if len(hv) == 0:
                hv = np.zeros(1, dtype=np.uint32)
            if len(hv) < pad:
                hv = np.concatenate([hv, np.zeros(pad - len(hv), dtype=np.uint32)])
            self._hll_hash_pad = hv = mark_stable_operand(hv)
        return hv

    # -- lookups ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.values)

    @property
    def cardinality(self) -> int:
        return len(self.values)

    def get(self, dict_id: int) -> Any:
        v = self.values[dict_id]
        # unwrap numpy scalars for host-side result tables
        return v.item() if isinstance(v, np.generic) else v

    def get_many(self, dict_ids: np.ndarray) -> np.ndarray:
        return self.values[dict_ids]

    def _coerce(self, value: Any):
        if self.data_type == DataType.BYTES:
            return bytes(value) if not isinstance(value, bytes) else value
        if self.data_type in (DataType.STRING, DataType.JSON):
            return str(value)
        # Non-integral float predicate against an integral dictionary must NOT
        # truncate (WHERE x = 20.5 matches nothing; x >= 20.5 excludes 20):
        # keep it as float64 — searchsorted/== handle the mixed comparison.
        if self.data_type.is_integral and isinstance(value, float) and not float(value).is_integer():
            return np.float64(value)
        return self.data_type.np_dtype.type(value)

    def index_of(self, value: Any) -> int:
        """Exact id of value, or -1 if absent (Dictionary.java indexOf)."""
        v = self._coerce(value)
        i = int(np.searchsorted(self.values, v))
        if i < len(self.values) and self.values[i] == v:
            return i
        return -1

    def insertion_index_of(self, value: Any) -> int:
        """Sorted insertion point (>=0 found; -(pos+1) like Java binarySearch)."""
        v = self._coerce(value)
        i = int(np.searchsorted(self.values, v))
        if i < len(self.values) and self.values[i] == v:
            return i
        return -(i + 1)

    def id_range_for(self, lower: Any, upper: Any, lower_inclusive: bool, upper_inclusive: bool) -> tuple[int, int]:
        """Dict-id closed interval [lo, hi] covering the value range; empty if
        lo > hi. This is how range predicates lower to id comparisons."""
        if lower is None:
            lo = 0
        else:
            lv = self._coerce(lower)
            lo = int(np.searchsorted(self.values, lv, side="left" if lower_inclusive else "right"))
        if upper is None:
            hi = len(self.values) - 1
        else:
            uv = self._coerce(upper)
            hi = int(np.searchsorted(self.values, uv, side="right" if upper_inclusive else "left")) - 1
        return lo, hi

    def ids_for_values(self, values: Sequence[Any]) -> np.ndarray:
        """Ids of the values present in this dictionary (for IN predicates)."""
        out = []
        for v in values:
            i = self.index_of(v)
            if i >= 0:
                out.append(i)
        return np.asarray(sorted(out), dtype=np.int32)

    @property
    def min_value(self) -> Any:
        v = self.values[0]
        return v.item() if isinstance(v, np.generic) else v

    @property
    def max_value(self) -> Any:
        v = self.values[-1]
        return v.item() if isinstance(v, np.generic) else v
