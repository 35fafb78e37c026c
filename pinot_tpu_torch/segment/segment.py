"""In-memory segment representations.

Host side: `ImmutableSegment` — numpy forward arrays + dictionaries + stats
(reference parity: ImmutableSegmentImpl, pinot-segment-local/.../indexsegment/
immutable/ImmutableSegmentImpl.java:67, and DataSource/ForwardIndexReader from
pinot-segment-spi).

Device side: `DeviceSegment` — a dict of dense torch tensors on one device:
dict-encoded columns as int32 id vectors, raw columns as native-dtype vectors,
padded to a multiple of DOC_PAD. Filters become vector compares over these
tensors; there is no row-at-a-time or block-at-a-time decode step because the
columnar data is already resident on the device in compute layout. A
multi-value column stages as its flat value vector plus the vector of each
value's owning doc (`"{col}!docs"`), both padded to a multiple of DOC_PAD.
"""

from __future__ import annotations

import functools
import threading
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

# serializes staging, so two query threads stage a segment once
_STAGE_LOCK = threading.Lock()


def padded_len(n_docs: int) -> int:
    return max(DOC_PAD, ((n_docs + DOC_PAD - 1) // DOC_PAD) * DOC_PAD)


def bm_from_bool(mask: np.ndarray) -> np.ndarray:
    """Bool mask -> little-endian uint64-word bitmap, zero-padded to whole
    words (the JAX package's null-vector format)."""
    nwords = (len(mask) + 63) // 64
    bits = np.zeros(nwords * 64, dtype=np.uint8)
    bits[: len(mask)] = mask.astype(np.uint8)
    return np.packbits(bits, bitorder="little").view(np.uint64)


def bm_to_bool(a: np.ndarray, n_docs: int) -> np.ndarray:
    return np.unpackbits(np.asarray(a).view(np.uint8), bitorder="little")[:n_docs].astype(bool)


@dataclass
class ColumnIndex:
    """All materialized per-column data for one segment column.

    A multi-value column (the MV read API of ForwardIndexReader,
    pinot-segment-spi/.../index/reader/ForwardIndexReader.java:200-332) is
    flattened CSR: `forward` holds every value back to back and `lens` each
    doc's value count. On the device every program stays a dense 1-D op:
    predicates evaluate over the flat vector and OR into doc space; MV
    aggregations gather the doc mask to value positions."""

    name: str
    data_type: DataType
    dictionary: Dictionary | None  # None => raw-encoded column
    forward: np.ndarray  # int32 dict ids, or raw values (np dtype of the type)
    stats: ColumnStats
    lens: np.ndarray | None = None  # MV only: int32 per-doc value count
    # MV: offsets(), flat_docids() and doc_tables(), memoized (the column is
    # immutable)
    _csr: dict = field(default_factory=dict, repr=False, compare=False)

    @property
    def is_dict_encoded(self) -> bool:
        return self.dictionary is not None

    @property
    def is_mv(self) -> bool:
        return self.lens is not None

    @property
    def cardinality(self) -> int:
        return self.dictionary.cardinality if self.dictionary else self.stats.cardinality

    def offsets(self) -> np.ndarray:
        """MV: each doc's start offset into the flat values, n_docs + 1 long
        (read-only, memoized)."""
        if "offsets" not in self._csr:
            out = np.zeros(len(self.lens) + 1, dtype=np.int64)
            np.cumsum(self.lens, out=out[1:])
            out.flags.writeable = False
            self._csr["offsets"] = out
        return self._csr["offsets"]

    def flat_docids(self) -> np.ndarray:
        """MV: the owning doc of each flat value position (int32, read-only,
        memoized)."""
        if "docids" not in self._csr:
            out = np.repeat(np.arange(len(self.lens), dtype=np.int32), self.lens)
            out.flags.writeable = False
            self._csr["docids"] = out
        return self._csr["docids"]

    def doc_tables(self, pad: int) -> tuple[np.ndarray, np.ndarray]:
        """MV: each doc's (offset, value count) as int32 tables of pad + 1
        entries, zero past the docs: groups_mv2's operands, memoized and
        declared stable operands, so a device stages them once."""
        if ("tables", pad) not in self._csr:
            from pinot_tpu_torch.query.kernels import mark_stable_operand

            n = len(self.lens)
            off, lens = np.zeros(pad + 1, dtype=np.int32), np.zeros(pad + 1, dtype=np.int32)
            off[:n] = self.offsets()[:n]
            lens[:n] = self.lens
            self._csr[("tables", pad)] = (mark_stable_operand(off), mark_stable_operand(lens))
        return self._csr[("tables", pad)]

    def materialize(self, doc_ids: np.ndarray | None = None) -> np.ndarray:
        """Decode to raw values (optionally only for given docIds). An MV
        column gives an object array of per-doc value arrays."""
        if self.is_mv:
            flat = self.dictionary.get_many(self.forward) if self.dictionary is not None else self.forward
            off = self.offsets()
            docs = np.arange(len(self.lens)) if doc_ids is None else np.asarray(doc_ids)
            out = np.empty(len(docs), dtype=object)
            for i, d in enumerate(docs.tolist()):
                out[i] = flat[off[d] : off[d + 1]]
            return out
        fwd = self.forward if doc_ids is None else self.forward[doc_ids]
        return self.dictionary.get_many(fwd) if self.dictionary is not None else fwd


@dataclass
class ImmutableSegment:
    name: str
    schema: Schema
    n_docs: int
    columns: dict[str, ColumnIndex] = field(default_factory=dict)
    # index structures beside the columns: "null" (column -> null-vector
    # bitmap, see bm_from_bool), "startree" (its star tables)
    extras: dict[str, Any] = field(default_factory=dict)
    # staged copies by device, filled by to_device_cached
    _device_cache: dict[str, "DeviceSegment"] = field(default_factory=dict, repr=False, compare=False)
    # decoded null masks and their padded doc masks, by key
    _null_cache: dict[Any, np.ndarray | None] = field(default_factory=dict, repr=False, compare=False)

    def null_mask(self, cols) -> np.ndarray | None:
        """Docs where any of `cols` is null (the union of their null vectors),
        or None when none of them has a null vector. Memoized: one bitmap
        expansion a column set, however many queries read it."""
        key = ("union", frozenset(cols))
        if key not in self._null_cache:
            nulls = None
            for name in sorted(key[1]):
                nv = self.extras.get("null", {}).get(name)
                if nv is not None:
                    b = bm_to_bool(nv, self.n_docs)
                    nulls = b if nulls is None else (nulls | b)
            self._null_cache[key] = nulls
        return self._null_cache[key]

    def null_docmask(self, cols, negate: bool) -> np.ndarray:
        """null_mask(cols) (or its complement) as a doc mask of padded_len
        docs, the tail off: one array object a segment, declared a stable
        operand, so its staged copy is made once a device."""
        key = ("docmask", frozenset(cols), negate)
        if key not in self._null_cache:
            from pinot_tpu_torch.query.kernels import mark_stable_operand

            nulls = self.null_mask(cols)
            m = np.zeros(padded_len(self.n_docs), dtype=bool)
            if nulls is not None:
                m[: self.n_docs] = ~nulls if negate else nulls
            elif negate:
                m[: self.n_docs] = True
            self._null_cache[key] = mark_stable_operand(m)
        return self._null_cache[key]

    @functools.cached_property
    def size_bytes(self) -> int:
        """Resident host-memory estimate (forward arrays + dictionaries), as
        the reference's: what the accountant and the heat map charge a
        segment's execution (computed once: the columns never change)."""
        total = 0
        for ci in self.columns.values():
            if isinstance(ci.forward, np.ndarray):
                total += ci.forward.nbytes
            vals = getattr(ci.dictionary, "values", None)
            if isinstance(vals, np.ndarray) and vals.dtype != object:
                total += vals.nbytes
        return total

    def to_device_cached(self, device: str | torch.device = "cuda", fast32: bool = False) -> "DeviceSegment":
        """Memoized staging: one staged copy per segment, device and `fast32`,
        shared by every engine that queries the segment, and by every thread:
        a second thread asking while the first stages waits for its copy. A
        lossy float32 copy and a lossless one are kept apart."""
        key = f"{torch.device(device)}/f32" if fast32 else str(torch.device(device))
        ds = self._device_cache.get(key)
        if ds is None:
            with _STAGE_LOCK:
                ds = self._device_cache.get(key)
                if ds is None:
                    ds = self.to_device(device, fast32=fast32)
                    self._device_cache[key] = ds
        return ds

    def to_device(self, device: str | torch.device = "cuda", fast32: bool = False) -> "DeviceSegment":
        """Stage every column to `device` as torch tensors.

        Dtype policy (the reference's): int64 raw columns are losslessly
        narrowed to int32 when their min/max fit; float64 stays float64 (query
        semantics, Pinot DOUBLE, depend on it) unless `fast32` opts into lossy
        float32 storage for speed. The tail pads with zeros.

        An MV column stages its flat values and, as `"{col}!docs"`, each
        value's owning doc (int32), both padded to padded_len(n_values). The
        padding docids are `pad`, one past the padded doc range: the programs
        mask those positions by the plan's n_values operand.
        """
        device = torch.device(device)
        pad = padded_len(self.n_docs)
        arrays: dict[str, torch.Tensor] = {}
        for name, ci in self.columns.items():
            fwd = ci.forward
            size = pad
            if ci.is_mv:
                size = padded_len(len(fwd))
                docids = np.full(size, pad, dtype=np.int32)
                docids[: len(fwd)] = ci.flat_docids()
                arrays[f"{name}!docs"] = torch.tensor(docids, device=device)
            if len(fwd) < size:
                fwd = np.concatenate([fwd, np.zeros(size - len(fwd), dtype=fwd.dtype)])
            if fwd.dtype == np.int64:
                # dict ids are already int32; this is the raw-column path
                if np.iinfo(np.int32).min <= ci.stats.min_value and ci.stats.max_value <= np.iinfo(np.int32).max:
                    fwd = fwd.astype(np.int32)
            elif fwd.dtype == np.float64 and fast32 and not ci.is_mv:
                fwd = fwd.astype(np.float32)
            arrays[name] = torch.tensor(fwd, device=device)
        ds = DeviceSegment(name=self.name, host=self, n_docs=self.n_docs, padded=pad, arrays=arrays)
        from pinot_tpu_torch.common.leakcheck import staging_tracker

        staging_tracker.track(ds)
        return ds


@dataclass
class DeviceSegment:
    """A segment staged in device memory: dense columnar tensors."""

    name: str
    host: ImmutableSegment
    n_docs: int
    padded: int
    # column -> tensor of shape (padded,); an MV column's flat values and
    # "{col}!docs" have shape (padded_len(n_values),)
    arrays: dict[str, torch.Tensor]

    @property
    def device(self) -> torch.device:
        return next(iter(self.arrays.values())).device
