"""Star-tree index: pre-aggregation over a dimension split order.

Reference parity: StarTreeV2 (pinot-segment-spi/.../index/startree/), the
builders (pinot-segment-local/.../startree/v2/builder/
OffHeapSingleTreeBuilder) and the query-side swap (`query/startree_exec.py`).
This is the JAX package's `segment/startree.py` in numpy: the star tree is
materialized as its leaf level, one row per distinct combination of the split
dimensions carrying the pre-aggregated values, as a dense columnar table that
shares the parent segment's dictionaries. A matching query runs the ordinary
filter / group-by program over those rows instead of the segment's docs.

The rows come in the reference's order (its pandas groupby(sort=True)):
lexicographic by the split dimensions' dict ids. `__count` and sums of
integer-valued metrics are exact; a DOUBLE metric's sum adds in row order,
where pandas' groupby sum is compensated, so the two can differ in the last
bits.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from pinot_tpu_torch.common.config import StarTreeIndexConfig
from pinot_tpu_torch.common.types import DataType, FieldSpec, FieldType, Schema
from pinot_tpu_torch.segment.segment import ColumnIndex, ImmutableSegment
from pinot_tpu_torch.segment.stats import ColumnStats


@dataclass
class StarTable:
    """One pre-aggregated table (the leaf level of one star-tree config)."""

    dimensions: list[str]  # split order
    function_column_pairs: list[str]  # e.g. "SUM__revenue"
    n_rows: int
    # dict-id columns per dimension + value columns per pair + __count
    arrays: dict[str, np.ndarray] = field(default_factory=dict)

    def supports_agg(self, func: str, arg_col: str | None) -> bool:
        if func == "count":
            return True
        if func in ("sum", "avg"):
            return f"SUM__{arg_col}" in self.function_column_pairs
        if func == "min":
            return f"MIN__{arg_col}" in self.function_column_pairs
        if func == "max":
            return f"MAX__{arg_col}" in self.function_column_pairs
        if func == "minmaxrange":
            return f"MIN__{arg_col}" in self.function_column_pairs and f"MAX__{arg_col}" in self.function_column_pairs
        if func in ("distinctcount", "distinctcountbitmap", "distinctcounthll"):
            # distinct over a split dimension is presence-preserving
            return arg_col in self.dimensions
        return False


def _row_of_doc(id_cols: list[np.ndarray]) -> tuple[np.ndarray, np.ndarray]:
    """(star row of each doc, first doc of each row): rows numbered in
    lexicographic order of the docs' dict-id tuples. The code is re-densified
    after each dimension, which keeps that order and stays below n * card."""
    code = np.zeros(len(id_cols[0]), dtype=np.int64)
    for ids in id_cols:
        card = int(ids.max()) + 1 if len(ids) else 1
        _, code = np.unique(code * card + ids, return_inverse=True)
        code = code.reshape(-1)
    _, first = np.unique(code, return_index=True)
    return code, first


def build_star_table(seg: ImmutableSegment, config: StarTreeIndexConfig) -> StarTable:
    """Leaf-level pre-aggregation: group by all split dimensions' dict ids,
    aggregate the configured function-column pairs (MultipleTreesBuilder
    analog, vectorized)."""
    dims = config.dimensions_split_order
    for d in dims:
        ci = seg.columns.get(d)
        if ci is None or not ci.is_dict_encoded:
            raise ValueError(f"star-tree dimension {d!r} must be a dict-encoded column")

    def _norm(p: str) -> str:
        func, col = p.split("__", 1)
        return f"{func.upper()}__{col}"  # uppercase the FUNC, preserve the column

    # COUNT__* (Pinot's AggregationFunctionColumnPair.COUNT_STAR) is served by
    # the always-present __count column; accept and drop it from the pair list
    pairs = list(dict.fromkeys(_norm(p) for p in config.function_column_pairs if not _norm(p).startswith("COUNT__")))
    values = {}
    for p in pairs:
        col = p.split("__", 1)[1]
        if col not in seg.columns:
            raise ValueError(f"star-tree pair {p}: unknown column {col!r}")
        if col not in values:
            ci = seg.columns[col]
            raw = ci.dictionary.get_many(ci.forward) if ci.is_dict_encoded else ci.forward
            values[col] = np.asarray(raw).astype(np.float64)

    row, first = _row_of_doc([seg.columns[d].forward for d in dims])
    n_rows = len(first)
    arrays: dict[str, np.ndarray] = {"__count": np.bincount(row, minlength=n_rows).astype(np.int64)}
    for d in dims:
        arrays[d] = seg.columns[d].forward[first].astype(np.int32)

    def grouped(func: str, v: np.ndarray) -> np.ndarray:
        if func == "SUM":
            # NaN skipped, as pandas' sum skips it
            return np.bincount(row, weights=np.where(np.isnan(v), 0.0, v), minlength=n_rows)
        out = np.full(n_rows, np.nan)
        (np.fmin if func == "MIN" else np.fmax).at(out, row, v)
        return out

    for p in pairs:
        func, col = p.split("__", 1)
        if func in ("SUM", "MIN", "MAX"):
            arrays[p] = grouped(func, values[col])
        elif func == "AVG":
            # an AVG pair stores the SUM (the count comes from __count), like
            # Pinot's AvgPair value aggregator
            arrays[f"SUM__{col}"] = grouped("SUM", values[col])
        else:
            raise ValueError(f"unsupported star-tree aggregation {func}")
    pairs = [p for p in arrays if "__" in p and not p.startswith("__")]
    return StarTable(dimensions=list(dims), function_column_pairs=pairs, n_rows=n_rows, arrays=arrays)


def star_table_as_segment(seg: ImmutableSegment, st: StarTable) -> ImmutableSegment:
    """Wrap a StarTable as an engine-queryable segment: dimension columns
    share the parent's dictionaries; pre-agg columns are raw metrics."""
    schema = Schema(seg.schema.name + "__star")
    star = ImmutableSegment(name=seg.name + "__star", schema=schema, n_docs=st.n_rows)
    for d in st.dimensions:
        parent = seg.columns[d]
        ids = st.arrays[d]
        schema.add(FieldSpec(d, parent.data_type, FieldType.DIMENSION))
        stats = ColumnStats.from_dictionary(d, parent.data_type, ids, parent.dictionary)
        star.columns[d] = ColumnIndex(d, parent.data_type, parent.dictionary, ids, stats)
    for name in ["__count", *st.function_column_pairs]:
        vals = st.arrays[name]
        dt = DataType.LONG if name == "__count" else DataType.DOUBLE
        schema.add(FieldSpec(name, dt, FieldType.METRIC))
        stats = ColumnStats.collect(name, dt, vals, len(np.unique(vals)))
        star.columns[name] = ColumnIndex(name, dt, None, vals.astype(dt.np_dtype), stats)
    return star
