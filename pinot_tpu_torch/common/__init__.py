from pinot_tpu_torch.common.types import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.common.config import (
    DedupConfig,
    IndexingConfig,
    StarTreeIndexConfig,
    TableConfig,
    TableType,
    UpsertConfig,
)

__all__ = [
    "DataType",
    "FieldSpec",
    "FieldType",
    "Schema",
    "DedupConfig",
    "IndexingConfig",
    "StarTreeIndexConfig",
    "TableConfig",
    "TableType",
    "UpsertConfig",
]
