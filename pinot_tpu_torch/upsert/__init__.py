"""Upsert & dedup: primary-key -> latest-doc tracking with valid-doc masks.

Reference parity: pinot-segment-local/.../upsert/
ConcurrentMapPartitionUpsertMetadataManager + PartialUpsertHandler, and
pinot-segment-local/.../dedup/ConcurrentMapPartitionDedupMetadataManager.

Design note: Pinot tracks validDocIds as ThreadSafeMutableRoaringBitmaps;
here they are dense boolean masks — the same representation the filter
programs consume — so upsert visibility rides into the per-segment program
as its docmask operand (no bitmap decode on the hot path). The snapshot file
is the JAX package's, byte for byte: either package restores the other's.
"""

from pinot_tpu_torch.upsert.metadata import (
    PartitionDedupMetadataManager,
    PartitionUpsertMetadataManager,
    RecordLocation,
)
from pinot_tpu_torch.upsert.partial import merge_partial

__all__ = [
    "PartitionDedupMetadataManager",
    "PartitionUpsertMetadataManager",
    "RecordLocation",
    "merge_partial",
]
