"""In-memory segment representations.

Host side: `ImmutableSegment` — numpy forward arrays + dictionaries + stats
(reference parity: ImmutableSegmentImpl, pinot-segment-local/.../indexsegment/
immutable/ImmutableSegmentImpl.java:67, and DataSource/ForwardIndexReader from
pinot-segment-spi).

Device side: `DeviceSegment` — a dict of dense torch tensors on one device:
dict-encoded columns as int32 id vectors, raw columns as native-dtype vectors,
padded to a multiple of DOC_PAD. Filters become vector compares over these
tensors; there is no row-at-a-time or block-at-a-time decode step because the
columnar data is already resident on the device in compute layout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from pinot_tpu_torch.common.types import DataType, Schema
from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.stats import ColumnStats

# Doc counts pad to a multiple of DOC_PAD so every segment of similar size
# shares tensor shapes. Padded tail rows are zeros and are masked out by the
# engine via iota < n_docs.
DOC_PAD = 1024


def padded_len(n_docs: int) -> int:
    return max(DOC_PAD, ((n_docs + DOC_PAD - 1) // DOC_PAD) * DOC_PAD)


@dataclass
class ColumnIndex:
    """All materialized per-column data for one single-value segment column."""

    name: str
    data_type: DataType
    dictionary: Dictionary | None  # None => raw-encoded column
    forward: np.ndarray  # int32 dict ids, or raw values (np dtype of the type)
    stats: ColumnStats

    @property
    def is_dict_encoded(self) -> bool:
        return self.dictionary is not None

    @property
    def is_mv(self) -> bool:
        # multi-value columns are not built by this package yet
        return False

    @property
    def cardinality(self) -> int:
        return self.dictionary.cardinality if self.dictionary else self.stats.cardinality

    def materialize(self, doc_ids: np.ndarray | None = None) -> np.ndarray:
        """Decode to raw values (optionally only for given docIds)."""
        fwd = self.forward if doc_ids is None else self.forward[doc_ids]
        return self.dictionary.get_many(fwd) if self.dictionary is not None else fwd


@dataclass
class ImmutableSegment:
    name: str
    schema: Schema
    n_docs: int
    columns: dict[str, ColumnIndex] = field(default_factory=dict)
    # extra index structures attach here once they are ported
    extras: dict[str, Any] = field(default_factory=dict)
    # staged copies by device, filled by to_device_cached
    _device_cache: dict[str, "DeviceSegment"] = field(default_factory=dict, repr=False, compare=False)

    def to_device_cached(self, device: str | torch.device = "cuda") -> "DeviceSegment":
        """Memoized staging: one staged copy per segment and device, shared by
        every engine that queries the segment."""
        key = str(torch.device(device))
        ds = self._device_cache.get(key)
        if ds is None:
            ds = self.to_device(device)
            self._device_cache[key] = ds
        return ds

    def to_device(self, device: str | torch.device = "cuda") -> "DeviceSegment":
        """Stage every column to `device` as torch tensors.

        Dtype policy (the reference's): int64 raw columns are losslessly
        narrowed to int32 when their min/max fit; float64 stays float64 (query
        semantics, Pinot DOUBLE, depend on it). The tail pads with zeros.
        """
        device = torch.device(device)
        pad = padded_len(self.n_docs)
        arrays: dict[str, torch.Tensor] = {}
        for name, ci in self.columns.items():
            fwd = ci.forward
            if len(fwd) < pad:
                fwd = np.concatenate([fwd, np.zeros(pad - len(fwd), dtype=fwd.dtype)])
            if fwd.dtype == np.int64:
                # dict ids are already int32; this is the raw-column path
                if np.iinfo(np.int32).min <= ci.stats.min_value and ci.stats.max_value <= np.iinfo(np.int32).max:
                    fwd = fwd.astype(np.int32)
            arrays[name] = torch.tensor(fwd, device=device)
        return DeviceSegment(name=self.name, host=self, n_docs=self.n_docs, padded=pad, arrays=arrays)


@dataclass
class DeviceSegment:
    """A segment staged in device memory: dense columnar tensors."""

    name: str
    host: ImmutableSegment
    n_docs: int
    padded: int
    arrays: dict[str, torch.Tensor]  # column -> tensor of shape (padded,)

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device
