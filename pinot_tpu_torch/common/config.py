"""Table configuration: the subset the port's segment builder reads.

Reference parity: TableConfig / IndexingConfig (pinot-spi/.../config/table/).
Field names match the JAX package's `common/config.py`, so a configuration
written for either package reads the same. The builder encodes columns from
`no_dictionary_columns` / `dictionary_columns` and builds the star-tree
tables of `star_tree_configs`; every other index field is declared here only
so that the builder can refuse it by name until the index is ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field

#: IndexingConfig fields that ask for a structure the port does not build yet
UNSUPPORTED_INDEX_FIELDS = (
    "inverted_index_columns",
    "range_index_columns",
    "bloom_filter_columns",
    "text_index_columns",
    "json_index_columns",
    "geo_index_columns",
    "vector_index_columns",
    "fst_index_columns",
    "map_index_columns",
)


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
    fst_index_columns: list[str] = field(default_factory=list)
    map_index_columns: list[str] = field(default_factory=list)
    #: null vector index per column (enableNullHandling parity)
    null_handling: bool = False


@dataclass
class TableConfig:
    table_name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
