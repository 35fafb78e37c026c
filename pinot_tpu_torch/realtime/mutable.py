"""Mutable (consuming) segment: append-only columnar buffers.

Reference parity: MutableSegmentImpl (pinot-segment-local/.../indexsegment/
mutable/MutableSegmentImpl.java:126 — index(GenericRow) at :515, addNewRow at
:710) with growing mutable dictionaries (realtime/impl/dictionary/).
Redesigned: rows append into numpy-backed growable buffers with
insertion-ordered dictionaries (id = arrival order); queries run against a
SNAPSHOT ImmutableSegment materialized on demand (sorted dictionaries,
engine-compatible), cached by doc-count watermark — the analog of Pinot
queries reading the consuming segment at a row-count watermark. A query
stages each new snapshot on the server's device (`to_device_cached`); the
previous generation's staged copy goes with its snapshot. seal() produces
the final immutable segment for commit.

This is the JAX package's `realtime/mutable.py` over the port's builder.
"""

from __future__ import annotations

import threading
from typing import Any, Mapping

import numpy as np

from pinot_tpu_torch.common.config import TableConfig
from pinot_tpu_torch.common.types import DataType, Schema
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.segment import ImmutableSegment


class _GrowBuf:
    """Amortized-growth typed append buffer."""

    def __init__(self, dtype):
        self.dtype = dtype
        self._arr = np.empty(1024, dtype=dtype)
        self.n = 0

    def append(self, v) -> None:
        if self.n == len(self._arr):
            bigger = np.empty(len(self._arr) * 2, dtype=self.dtype)
            bigger[: self.n] = self._arr
            self._arr = bigger
        self._arr[self.n] = v
        self.n += 1

    def view(self) -> np.ndarray:
        return self._arr[: self.n]


class MutableSegment:
    def __init__(self, name: str, schema: Schema, table_config: TableConfig | None = None):
        self.name = name
        self.schema = schema
        self.config = table_config or TableConfig(schema.name)
        self._lock = threading.RLock()
        self._cols: dict[str, _GrowBuf] = {}
        self._obj_cols: dict[str, list] = {}  # string/bytes/json columns
        for col in schema.columns:
            dt = schema[col].data_type
            if dt in (DataType.STRING, DataType.BYTES, DataType.JSON):
                self._obj_cols[col] = []
            else:
                self._cols[col] = _GrowBuf(dt.np_dtype)
        self._snapshot: ImmutableSegment | None = None
        self._snapshot_docs = -1
        # upsert integration: fn(n_docs) -> bool mask attached to snapshots
        self.valid_provider = None

    @property
    def n_docs(self) -> int:
        with self._lock:
            any_col = next(iter(self.schema.columns), None)
            if any_col is None:
                return 0
            return self._cols[any_col].n if any_col in self._cols else len(self._obj_cols[any_col])

    def index(self, row: Mapping[str, Any]) -> None:
        """Append one decoded row (MutableSegmentImpl.index parity)."""
        with self._lock:
            for col in self.schema.columns:
                spec = self.schema[col]
                v = row.get(col)
                if v is None:
                    v = spec.data_type.default_null
                if col in self._obj_cols:
                    self._obj_cols[col].append(v)
                else:
                    self._cols[col].append(v)

    def get_row(self, doc_id: int) -> dict:
        """Read back one indexed row (partial-upsert merges need the previous
        full row; MutableSegmentImpl exposes the same via its readers)."""
        with self._lock:
            row = {}
            for col, buf in self._cols.items():
                row[col] = buf.view()[doc_id].item()
            for col, lst in self._obj_cols.items():
                row[col] = lst[doc_id]
            return row

    def snapshot(self) -> ImmutableSegment:
        """Engine-compatible immutable view at the current doc watermark.
        Cached until more rows arrive."""
        with self._lock:
            n = self.n_docs
            if self._snapshot is not None and self._snapshot_docs == n:
                return self._snapshot
            data: dict[str, np.ndarray] = {}
            for col, buf in self._cols.items():
                data[col] = buf.view().copy()
            for col, lst in self._obj_cols.items():
                data[col] = np.asarray(list(lst), dtype=object)
            snap = SegmentBuilder(self.schema, self.config).build(data, self.name)
            if self.valid_provider is not None:
                snap.extras["valid_docs"] = self.valid_provider
            self._snapshot = snap
            self._snapshot_docs = n
            return snap

    def seal(self, final_name: str | None = None) -> ImmutableSegment:
        """Final immutable segment for commit (RealtimeSegmentConverter role)."""
        with self._lock:
            snap = self.snapshot()
            if final_name and final_name != snap.name:
                snap = ImmutableSegment(
                    name=final_name, schema=snap.schema, n_docs=snap.n_docs, columns=snap.columns
                )
            return snap
