from pinot_tpu_torch.realtime.mutable import MutableSegment
from pinot_tpu_torch.realtime.stream import InMemoryStream, StreamMessage, get_stream_factory, register_stream_factory
from pinot_tpu_torch.realtime.manager import RealtimeTableManager

__all__ = [
    "MutableSegment",
    "InMemoryStream",
    "StreamMessage",
    "get_stream_factory",
    "register_stream_factory",
    "RealtimeTableManager",
]
