"""Logical data model: data types, field specs, table schema.

Reference parity: pinot-spi/src/main/java/org/apache/pinot/spi/data/Schema.java:65
and FieldSpec.java (DIMENSION / METRIC / DATE_TIME field categories, typed
columns with default null values). Each type carries its numpy storage dtype;
segment staging (segment.py) decides the device dtype from it.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum
from typing import Any, Iterable

import numpy as np


class DataType(Enum):
    """Column logical types (subset of Pinot's FieldSpec.DataType)."""

    INT = "INT"
    LONG = "LONG"
    FLOAT = "FLOAT"
    DOUBLE = "DOUBLE"
    BOOLEAN = "BOOLEAN"
    TIMESTAMP = "TIMESTAMP"  # millis since epoch, stored as int64
    STRING = "STRING"
    BYTES = "BYTES"
    JSON = "JSON"

    @property
    def is_numeric(self) -> bool:
        return self in _NUMERIC

    @property
    def is_integral(self) -> bool:
        return self in (DataType.INT, DataType.LONG, DataType.BOOLEAN, DataType.TIMESTAMP)

    @property
    def np_dtype(self) -> np.dtype:
        """Host (storage) dtype. STRING/BYTES/JSON are object arrays host-side
        and exist on device only via their dictionary ids."""
        return _NP_DTYPES[self]

    @property
    def default_null(self) -> Any:
        return _DEFAULT_NULLS[self]


_NUMERIC = frozenset(
    {DataType.INT, DataType.LONG, DataType.FLOAT, DataType.DOUBLE, DataType.BOOLEAN, DataType.TIMESTAMP}
)

_NP_DTYPES = {
    DataType.INT: np.dtype(np.int32),
    DataType.LONG: np.dtype(np.int64),
    DataType.FLOAT: np.dtype(np.float32),
    DataType.DOUBLE: np.dtype(np.float64),
    DataType.BOOLEAN: np.dtype(np.int32),
    DataType.TIMESTAMP: np.dtype(np.int64),
    DataType.STRING: np.dtype(object),
    DataType.BYTES: np.dtype(object),
    DataType.JSON: np.dtype(object),
}

# Pinot default null placeholders (FieldSpec.java DEFAULT_* constants).
_DEFAULT_NULLS = {
    DataType.INT: np.iinfo(np.int32).min,
    DataType.LONG: np.iinfo(np.int64).min,
    DataType.FLOAT: float("-inf"),
    DataType.DOUBLE: float("-inf"),
    DataType.BOOLEAN: 0,
    DataType.TIMESTAMP: 0,
    DataType.STRING: "null",
    DataType.BYTES: b"",
    DataType.JSON: "null",
}


class FieldType(Enum):
    DIMENSION = "DIMENSION"
    METRIC = "METRIC"
    DATE_TIME = "DATE_TIME"


@dataclass(frozen=True)
class FieldSpec:
    name: str
    data_type: DataType
    field_type: FieldType = FieldType.DIMENSION
    single_value: bool = True
    # DATE_TIME granularity/format strings kept for parity; not interpreted yet.
    format: str | None = None
    granularity: str | None = None

    def to_dict(self) -> dict:
        d = {
            "name": self.name,
            "dataType": self.data_type.value,
            "fieldType": self.field_type.value,
            "singleValue": self.single_value,
        }
        if self.format:
            d["format"] = self.format
        if self.granularity:
            d["granularity"] = self.granularity
        return d

    @staticmethod
    def from_dict(d: dict) -> "FieldSpec":
        return FieldSpec(
            name=d["name"],
            data_type=DataType(d["dataType"]),
            field_type=FieldType(d.get("fieldType", "DIMENSION")),
            single_value=d.get("singleValue", True),
            format=d.get("format"),
            granularity=d.get("granularity"),
        )


@dataclass
class Schema:
    """Table schema: ordered column -> FieldSpec map.

    Construction mirrors Pinot's SchemaBuilder (Schema.java:65): dimensions,
    metrics and dateTime fields.
    """

    name: str
    fields: dict[str, FieldSpec] = field(default_factory=dict)
    # Pinot Schema.java primaryKeyColumns parity (upsert/dedup key)
    primary_key_columns: list[str] = field(default_factory=list)

    @staticmethod
    def build(
        name: str,
        dimensions: Iterable[tuple[str, DataType]] = (),
        metrics: Iterable[tuple[str, DataType]] = (),
        date_times: Iterable[tuple[str, DataType]] = (),
        primary_key_columns: Iterable[str] = (),
    ) -> "Schema":
        s = Schema(name, primary_key_columns=list(primary_key_columns))
        for col, dt in dimensions:
            s.add(FieldSpec(col, dt, FieldType.DIMENSION))
        for col, dt in metrics:
            s.add(FieldSpec(col, dt, FieldType.METRIC))
        for col, dt in date_times:
            s.add(FieldSpec(col, dt, FieldType.DATE_TIME))
        return s

    def add(self, spec: FieldSpec) -> "Schema":
        if spec.name in self.fields:
            raise ValueError(f"duplicate column: {spec.name}")
        self.fields[spec.name] = spec
        return self

    def __contains__(self, col: str) -> bool:
        return col in self.fields

    def __getitem__(self, col: str) -> FieldSpec:
        return self.fields[col]

    @property
    def columns(self) -> list[str]:
        return list(self.fields)

    @property
    def dimension_columns(self) -> list[str]:
        return [c for c, f in self.fields.items() if f.field_type == FieldType.DIMENSION]

    @property
    def metric_columns(self) -> list[str]:
        return [c for c, f in self.fields.items() if f.field_type == FieldType.METRIC]

    def to_json(self) -> str:
        return json.dumps(
            {
                "schemaName": self.name,
                "fields": [f.to_dict() for f in self.fields.values()],
                "primaryKeyColumns": self.primary_key_columns,
            }
        )

    @staticmethod
    def from_json(s: str) -> "Schema":
        """Accepts both this framework's flat `fields` form and the
        reference's Schema.json layout (dimensionFieldSpecs /
        metricFieldSpecs / dateTimeFieldSpecs, Schema.java:65) so reference
        schema files load unchanged."""
        d = json.loads(s)
        schema = Schema(d["schemaName"], primary_key_columns=d.get("primaryKeyColumns", []))
        if "fields" in d:
            for fd in d["fields"]:
                schema.add(FieldSpec.from_dict(fd))
            return schema
        for key, ftype in (
            ("dimensionFieldSpecs", FieldType.DIMENSION),
            ("metricFieldSpecs", FieldType.METRIC),
            ("dateTimeFieldSpecs", FieldType.DATE_TIME),
        ):
            for fd in d.get(key, []):
                schema.add(
                    FieldSpec(
                        name=fd["name"],
                        data_type=DataType(fd["dataType"]),
                        field_type=ftype,
                        single_value=fd.get("singleValueField", True),
                        format=fd.get("format"),
                        granularity=fd.get("granularity"),
                    )
                )
        return schema
