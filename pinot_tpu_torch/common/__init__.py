from pinot_tpu_torch.common.types import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.common.config import IndexingConfig, StarTreeIndexConfig, TableConfig

__all__ = ["DataType", "FieldSpec", "FieldType", "Schema", "IndexingConfig", "StarTreeIndexConfig", "TableConfig"]
