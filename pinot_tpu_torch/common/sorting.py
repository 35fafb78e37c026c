"""Null-aware multi-key sorting for the broker reduce.

Reference semantics (OrderByExpressionContext, pinot-common/src/main/java/
org/apache/pinot/common/request/context/OrderByExpressionContext.java): the
default ordering treats nulls as the LARGEST value, so nulls land last under
ASC but FIRST under DESC. This is the JAX package's `common/sorting.py` over
numpy columns: one stable sort per key, from the last key to the first, each
one the order pandas' `sort_values(kind="mergesort")` gives.
"""

from __future__ import annotations

import numpy as np


def _is_null(col: np.ndarray) -> np.ndarray:
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype == object:
        return np.fromiter((v is None or (isinstance(v, float) and v != v) for v in col), bool, len(col))
    return np.zeros(len(col), dtype=bool)


def sort_nulls_largest(columns: list[np.ndarray], ascending: list[bool]) -> np.ndarray:
    """Row permutation of a stable multi-key sort where missing values
    (None/NaN) rank as the largest value: last for ASC keys, first for DESC
    keys, in their current order. A DESC key sorts by its negated dense rank,
    so equal keys keep their order (a reversed ASC sort would reverse them)."""
    n = len(columns[0]) if columns else 0
    perm = np.arange(n)
    for col, asc in reversed(list(zip(columns, ascending))):
        v = np.asarray(col)[perm]
        null = _is_null(v)
        keep = np.flatnonzero(~null)
        _, rank = np.unique(v[keep], return_inverse=True)
        rank = rank.reshape(-1)
        order = keep[np.argsort(rank if asc else -rank, kind="stable")]
        nulls = np.flatnonzero(null)
        perm = perm[np.concatenate([order, nulls] if asc else [nulls, order])]
    return perm
