from pinot_tpu_torch.query.sql import parse_sql, SqlParseError
from pinot_tpu_torch.query.context import QueryContext, QueryType
from pinot_tpu_torch.query.engine import QueryEngine
from pinot_tpu_torch.query.result import ResultTable

__all__ = ["parse_sql", "SqlParseError", "QueryContext", "QueryType", "QueryEngine", "ResultTable"]
