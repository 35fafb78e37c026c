from pinot_tpu_torch.timeseries.plan import (
    LeafTimeSeriesPlanNode,
    TimeSeriesBlock,
    TransformNode,
    parse_timeseries,
)
from pinot_tpu_torch.timeseries.engine import RangeTimeSeriesRequest, TimeSeriesEngine

__all__ = [
    "LeafTimeSeriesPlanNode",
    "TimeSeriesBlock",
    "TransformNode",
    "parse_timeseries",
    "RangeTimeSeriesRequest",
    "TimeSeriesEngine",
]
