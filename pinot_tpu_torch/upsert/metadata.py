"""Partition-level upsert / dedup metadata managers.

Reference parity:
- PartitionUpsertMetadataManager / ConcurrentMapPartitionUpsertMetadataManager
  (pinot-segment-local/.../upsert/): PK -> RecordLocation map, validDocIds per
  segment, comparison-column conflict resolution (newer wins, ties go to the
  later arrival), delete-record handling, validDocIds snapshot persistence
  (BasePartitionUpsertMetadataManager snapshot logic; SURVEY §5.4c).
- ConcurrentMapPartitionDedupMetadataManager (pinot-segment-local/.../dedup/):
  PK presence map with metadata TTL.

Valid docs are dense boolean masks (not Roaring bitmaps): the engine ANDs
them straight into the per-segment filter mask.
"""

from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from pathlib import Path

import numpy as np


@dataclass
class RecordLocation:
    segment: str
    doc_id: int
    comparison: float
    deleted: bool = False  # tombstone: location of the winning delete marker


class _ValidDocs:
    """Growable dense boolean validity mask for one segment."""

    def __init__(self, n: int = 0):
        self._arr = np.zeros(max(n, 64), dtype=bool)
        self.n = n

    def ensure(self, doc_id: int) -> None:
        if doc_id >= len(self._arr):
            grown = np.zeros(max(len(self._arr) * 2, doc_id + 1), dtype=bool)
            grown[: len(self._arr)] = self._arr
            self._arr = grown
        if doc_id >= self.n:
            self.n = doc_id + 1

    def set(self, doc_id: int, value: bool) -> None:
        self.ensure(doc_id)
        self._arr[doc_id] = value

    def mask(self, n_docs: int) -> np.ndarray:
        self.ensure(n_docs - 1) if n_docs > 0 else None
        return self._arr[:n_docs]


class PartitionUpsertMetadataManager:
    def __init__(
        self,
        pk_columns: list[str],
        comparison_column: str | None = None,
        delete_column: str | None = None,
    ):
        if not pk_columns:
            raise ValueError("upsert requires schema primaryKeyColumns")
        self.pk_columns = list(pk_columns)
        self.comparison_column = comparison_column
        self.delete_column = delete_column
        self._map: dict[tuple, RecordLocation] = {}
        self._valid: dict[str, _ValidDocs] = {}
        # segment name -> row reader (fn(doc_id) -> dict), for partial merges
        self._readers: dict[str, object] = {}
        self._lock = threading.RLock()

    # -- key helpers ---------------------------------------------------------

    def pk_of(self, row: dict) -> tuple:
        return tuple(row.get(c) for c in self.pk_columns)

    def cmp_of(self, row: dict) -> float:
        if self.comparison_column is None:
            return 0.0
        v = row.get(self.comparison_column)
        return float(v) if v is not None else float("-inf")

    # -- segment registration ------------------------------------------------

    def register_reader(self, segment_name: str, reader) -> None:
        """reader: fn(doc_id) -> dict row (used for PARTIAL merges)."""
        with self._lock:
            self._readers[segment_name] = reader

    def valid_provider(self, segment_name: str):
        """Returns fn(n_docs) -> bool mask for attaching to segment extras.
        Resolves the bitmap by name at call time, so providers survive
        restore() replacing the underlying _ValidDocs objects."""

        def provider(n_docs: int) -> np.ndarray:
            with self._lock:
                return self._valid_of(segment_name).mask(n_docs).copy()

        return provider

    def _valid_of(self, segment: str) -> _ValidDocs:
        vd = self._valid.get(segment)
        if vd is None:
            vd = self._valid[segment] = _ValidDocs()
        return vd

    # -- core upsert logic ---------------------------------------------------

    def add_row(self, segment: str, doc_id: int, row: dict) -> None:
        """Register one ingested row (MutableSegmentImpl -> upsert manager
        handoff, ConcurrentMapPartitionUpsertMetadataManager.addRecord)."""
        pk = self.pk_of(row)
        cmp = self.cmp_of(row)
        is_delete = bool(self.delete_column and row.get(self.delete_column))
        with self._lock:
            vd = self._valid_of(segment)
            vd.ensure(doc_id)
            prev = self._map.get(pk)
            if prev is not None and cmp < prev.comparison:
                # out-of-order arrival loses (including against a tombstone:
                # the delete's comparison value is kept exactly so late older
                # records cannot resurrect the key)
                vd.set(doc_id, False)
                return
            if is_delete:
                # delete marker wins: invalidate previous, keep a tombstone
                # carrying the delete's comparison value; the marker row
                # itself stays invisible
                if prev is not None and not prev.deleted:
                    self._invalidate(prev)
                self._map[pk] = RecordLocation(segment, doc_id, cmp, deleted=True)
                vd.set(doc_id, False)
                return
            if prev is not None and not prev.deleted:
                self._invalidate(prev)
            self._map[pk] = RecordLocation(segment, doc_id, cmp)
            vd.set(doc_id, True)

    def _invalidate(self, loc: RecordLocation) -> None:
        self._valid_of(loc.segment).set(loc.doc_id, False)

    def add_segment(self, segment) -> None:
        """Bootstrap from a loaded immutable segment (addSegment on server
        restart: replays PKs in docId order)."""
        cols = {c: segment.columns[c].materialize() for c in self.pk_columns}
        cmpv = (
            segment.columns[self.comparison_column].materialize()
            if self.comparison_column and self.comparison_column in segment.columns
            else None
        )
        delv = (
            segment.columns[self.delete_column].materialize()
            if self.delete_column and self.delete_column in segment.columns
            else None
        )
        for doc in range(segment.n_docs):
            row = {c: cols[c][doc] for c in self.pk_columns}
            if cmpv is not None:
                row[self.comparison_column] = cmpv[doc]
            if delv is not None:
                row[self.delete_column] = delv[doc]
            self.add_row(segment.name, doc, row)

    def remove_segment(self, segment_name: str) -> None:
        with self._lock:
            self._valid.pop(segment_name, None)
            self._readers.pop(segment_name, None)
            self._map = {pk: loc for pk, loc in self._map.items() if loc.segment != segment_name}

    # -- partial upsert ------------------------------------------------------

    def previous_row(self, row: dict) -> dict | None:
        """Latest full row for this PK (for PARTIAL merges), or None."""
        pk = self.pk_of(row)
        with self._lock:
            loc = self._map.get(pk)
            if loc is None or loc.deleted:
                return None
            reader = self._readers.get(loc.segment)
            if reader is None:
                return None
            return reader(loc.doc_id)

    # -- stats / persistence -------------------------------------------------

    @property
    def num_primary_keys(self) -> int:
        with self._lock:
            return sum(1 for loc in self._map.values() if not loc.deleted)

    def snapshot(self, path: str | Path) -> None:
        """Persist validDocIds + PK map (validDocIds snapshot parity,
        BasePartitionUpsertMetadataManager.persistValidDocIdsSnapshot)."""
        with self._lock:
            state = {
                "valid": {s: vd.mask(vd.n).tolist() for s, vd in self._valid.items()},
                "map": [
                    {
                        "pk": list(pk),
                        "segment": loc.segment,
                        "doc": loc.doc_id,
                        "cmp": loc.comparison,
                        "deleted": loc.deleted,
                    }
                    for pk, loc in self._map.items()
                ],
            }
        from pinot_tpu_torch.common.durability import atomic_write_json

        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        # a crash mid-snapshot must leave the previous snapshot readable,
        # not a torn JSON doc that poisons the next restore
        atomic_write_json(p, state)

    def restore(self, path: str | Path) -> None:
        state = json.loads(Path(path).read_text())
        with self._lock:
            self._valid = {}
            for s, bits in state["valid"].items():
                vd = _ValidDocs(len(bits))
                vd._arr[: len(bits)] = np.asarray(bits, dtype=bool)
                self._valid[s] = vd
            self._map = {
                tuple(e["pk"]): RecordLocation(e["segment"], e["doc"], e["cmp"], e.get("deleted", False))
                for e in state["map"]
            }


class PartitionDedupMetadataManager:
    """PK-based ingestion dedup with metadata TTL
    (ConcurrentMapPartitionDedupMetadataManager parity)."""

    def __init__(self, pk_columns: list[str], metadata_ttl: float = 0.0, time_column: str | None = None):
        if not pk_columns:
            raise ValueError("dedup requires schema primaryKeyColumns")
        self.pk_columns = list(pk_columns)
        self.metadata_ttl = metadata_ttl
        self.time_column = time_column
        self._map: dict[tuple, float] = {}
        self._max_time = float("-inf")
        self._evicted_until = float("-inf")
        self._lock = threading.Lock()

    def check_and_add(self, row: dict) -> bool:
        """True if the row is new (index it); False if a duplicate (drop)."""
        pk = tuple(row.get(c) for c in self.pk_columns)
        t = 0.0
        if self.time_column is not None:
            v = row.get(self.time_column)
            t = float(v) if v is not None else 0.0
        with self._lock:
            if self.metadata_ttl > 0:
                self._max_time = max(self._max_time, t)
                cutoff = self._max_time - self.metadata_ttl
                # amortized eviction: rebuild only when the watermark advanced
                # by >= ttl/4 since the last sweep (Pinot evicts periodically,
                # not per record)
                if cutoff > float("-inf") and cutoff - self._evicted_until >= self.metadata_ttl / 4:
                    self._map = {k: v for k, v in self._map.items() if v >= cutoff}
                    self._evicted_until = cutoff
                if t < cutoff:
                    return False  # outside retention: treat as expired
                prev = self._map.get(pk)
                if prev is not None and prev >= cutoff:
                    return False
                self._map[pk] = t
                return True
            if pk in self._map:
                return False
            self._map[pk] = t
            return True

    @property
    def num_primary_keys(self) -> int:
        with self._lock:
            return len(self._map)
