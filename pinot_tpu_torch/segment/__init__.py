from pinot_tpu_torch.segment.dictionary import Dictionary
from pinot_tpu_torch.segment.stats import ColumnStats
from pinot_tpu_torch.segment.builder import SegmentBuilder, write_segment
from pinot_tpu_torch.segment.segment import ColumnIndex, DeviceSegment, ImmutableSegment
from pinot_tpu_torch.segment.convert import segment_from_numpy
from pinot_tpu_torch.segment.loader import load_segment

__all__ = [
    "Dictionary",
    "ColumnStats",
    "SegmentBuilder",
    "write_segment",
    "ColumnIndex",
    "DeviceSegment",
    "ImmutableSegment",
    "segment_from_numpy",
    "load_segment",
]
