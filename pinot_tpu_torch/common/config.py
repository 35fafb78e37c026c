"""Table configuration: the subset the port's segment builder reads.

Reference parity: TableConfig / IndexingConfig (pinot-spi/.../config/table/).
Field names match the JAX package's `common/config.py`, so a configuration
written for either package reads the same. The builder encodes columns from
`no_dictionary_columns` / `dictionary_columns`, builds the star-tree tables
of `star_tree_configs`, the null vectors of `null_handling`, and the
auxiliary indexes of every `*_index_columns` / `bloom_filter_columns` field
(segment/indexes.py); `extra["customIndexes"]` names plugin index types
(segment/index_spi.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class StarTreeIndexConfig:
    """Parity with StarTreeIndexConfig (dimensionsSplitOrder,
    functionColumnPairs, maxLeafRecords)."""

    dimensions_split_order: list[str] = field(default_factory=list)
    function_column_pairs: list[str] = field(default_factory=list)  # e.g. "SUM__revenue"
    max_leaf_records: int = 10000

    def to_dict(self) -> dict:
        return {
            "dimensionsSplitOrder": self.dimensions_split_order,
            "functionColumnPairs": self.function_column_pairs,
            "maxLeafRecords": self.max_leaf_records,
        }

    @staticmethod
    def from_dict(d: dict) -> "StarTreeIndexConfig":
        return StarTreeIndexConfig(
            d.get("dimensionsSplitOrder", []),
            d.get("functionColumnPairs", []),
            d.get("maxLeafRecords", 10000),
        )


@dataclass
class IndexingConfig:
    no_dictionary_columns: list[str] = field(default_factory=list)
    dictionary_columns: list[str] = field(default_factory=list)
    inverted_index_columns: list[str] = field(default_factory=list)
    range_index_columns: list[str] = field(default_factory=list)
    bloom_filter_columns: list[str] = field(default_factory=list)
    star_tree_configs: list[StarTreeIndexConfig] = field(default_factory=list)
    text_index_columns: list[str] = field(default_factory=list)
    json_index_columns: list[str] = field(default_factory=list)
    geo_index_columns: list[list[str]] = field(default_factory=list)
    vector_index_columns: list[str] = field(default_factory=list)
    #: vector index flavor: EXACT (brute-force top-k, the default) or HNSW
    vector_index_type: str = "EXACT"
    fst_index_columns: list[str] = field(default_factory=list)
    map_index_columns: list[str] = field(default_factory=list)
    #: null vector index per column (enableNullHandling parity)
    null_handling: bool = False


@dataclass
class TableConfig:
    table_name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    #: free-form settings; "customIndexes": {index type: [columns]}
    extra: dict = field(default_factory=dict)
