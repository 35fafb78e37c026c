"""Dimension tables: fully-in-memory PK-keyed lookup tables + LOOKUP UDF.

Reference parity: DimensionTableDataManager (pinot-core/.../data/manager/
offline/DimensionTableDataManager.java) — a table flagged dimTable is loaded
entirely into a primary-key map on every server, powering the lookUp() UDF
(LookupTransformFunction): lookUp('dimTable', 'destColumn', 'pkCol', pkExpr,
...). The controller refreshes the registry on every segment upload/delete;
the host expression evaluator consumes it.

This is the JAX package's `cluster/dimension.py`. The registry is per
process, as the reference's is; where servers run in processes of their own
the controller hands each remote server the table's deep-store locations
(`RemoteServerClient.load_dim_table`), and the server process loads its own
copy with `load_dim_table`, so lookUp answers on the server that evaluates
it.
"""

from __future__ import annotations

import threading

import numpy as np


class DimensionTableDataManager:
    def __init__(self, table: str, pk_columns: list[str], schema=None):
        if not pk_columns:
            raise ValueError(f"dimension table {table!r} needs primaryKeyColumns in its schema")
        self.table = table
        self.pk_columns = list(pk_columns)
        self._rows: dict[tuple, dict] = {}
        # schema-declared string columns: authoritative even before any
        # segment loads (an all-miss lookup must already return 'null'
        # strings, not NaNs). Segment loads add to this set as a fallback
        # when no schema was provided.
        self._schema_str_cols: frozenset[str] = frozenset(
            c for c, f in schema.fields.items() if f.data_type.np_dtype == np.dtype(object)
        ) if schema is not None else frozenset()
        self._str_cols: set[str] = set(self._schema_str_cols)
        self._lock = threading.Lock()

    def load_segments(self, segments) -> None:
        """Full rebuild from the table's current segments (the reference
        reloads the whole map on segment changes too)."""
        rows: dict[tuple, dict] = {}
        str_cols: set[str] = set()
        for seg in segments:
            cols = {c: ci.materialize() for c, ci in seg.columns.items()}
            for c, ci in seg.columns.items():
                dt = getattr(ci, "data_type", None)
                if dt is not None:
                    if dt.np_dtype == np.dtype(object):
                        str_cols.add(c)
                elif cols[c].dtype.kind in "USO":
                    str_cols.add(c)
            n = seg.n_docs
            for i in range(n):
                row = {c: v[i] for c, v in cols.items()}
                pk = tuple(row[c] for c in self.pk_columns)
                rows[pk] = row  # later segments win (refresh semantics)
        with self._lock:
            self._rows = rows
            # full rebuild: schema-declared string columns plus what THIS
            # segment set shows (stale dtype observations don't survive)
            self._str_cols = set(self._schema_str_cols) | str_cols

    def lookup(self, pk: tuple):
        with self._lock:
            return self._rows.get(pk)

    def lookup_column(self, dest_column: str, keys: list[tuple]) -> np.ndarray:
        """Misses take the null substitute of the destination's type
        ('null' for strings, NaN for numerics — FieldSpec default-null
        parity). String-ness comes from the dim table's SCHEMA, not from the
        per-batch hit values, so an all-miss batch on a string column still
        returns 'null' strings instead of NaNs."""
        with self._lock:
            out = [(self._rows.get(k) or {}).get(dest_column) for k in keys]
            is_str = dest_column in self._str_cols
        if is_str:
            return np.asarray(["null" if x is None else x for x in out], dtype=object)
        return np.asarray([np.nan if x is None else float(x) for x in out], dtype=np.float64)

    @property
    def size(self) -> int:
        with self._lock:
            return len(self._rows)


_registry: dict[str, DimensionTableDataManager] = {}
_registry_lock = threading.Lock()


def register_dim_table(manager: DimensionTableDataManager) -> None:
    with _registry_lock:
        _registry[manager.table] = manager


def get_dim_table(table: str) -> DimensionTableDataManager:
    with _registry_lock:
        m = _registry.get(table)
    if m is None:
        raise KeyError(
            f"no dimension table {table!r} loaded (set extra.isDimTable=true on its table config)"
        )
    return m


def unregister_dim_table(table: str) -> None:
    with _registry_lock:
        _registry.pop(table, None)


def load_dim_table(table: str, schema, locations: list) -> DimensionTableDataManager:
    """Build and register `table`'s PK map from its segments' deep-store
    directories (`schema` names the primary key and the string columns)."""
    from pinot_tpu_torch.segment.loader import load_segment

    mgr = DimensionTableDataManager(table, schema.primary_key_columns if schema else [], schema=schema)
    mgr.load_segments([load_segment(loc) for loc in locations])
    register_dim_table(mgr)
    return mgr
