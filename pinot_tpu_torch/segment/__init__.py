from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.stats import ColumnStats
from pinot_tpu_torch.segment.builder import SegmentBuilder
from pinot_tpu_torch.segment.segment import ColumnIndex, DeviceSegment, ImmutableSegment
from pinot_tpu_torch.segment.convert import segment_from_numpy

__all__ = [
    "Dictionary",
    "ColumnStats",
    "SegmentBuilder",
    "ColumnIndex",
    "DeviceSegment",
    "ImmutableSegment",
    "segment_from_numpy",
]
