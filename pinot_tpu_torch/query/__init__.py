from pinot_tpu_torch.query.sql import parse_sql, SqlParseError
from pinot_tpu_torch.query.context import QueryContext, QueryType
from pinot_tpu_torch.query.result import ResultTable

__all__ = ["parse_sql", "SqlParseError", "QueryContext", "QueryType", "QueryEngine", "ResultTable"]


def __getattr__(name):
    # the engine loads torch when imported; the segment store reaches this
    # package (its indexes hash with query.sketches) in a controller
    # process, which has no device work
    if name == "QueryEngine":
        from pinot_tpu_torch.query.engine import QueryEngine

        return QueryEngine
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
