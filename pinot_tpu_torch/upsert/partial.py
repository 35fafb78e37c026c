"""Partial-upsert merge strategies.

Reference parity: pinot-segment-local/.../upsert/merger/ (OverwriteMerger,
IgnoreMerger, IncrementMerger, AppendMerger, UnionMerger, MaxMerger,
MinMerger) driven by PartialUpsertHandler.
"""

from __future__ import annotations


def _merge_value(strategy: str, prev, new):
    s = strategy.upper()
    if s == "OVERWRITE":
        return new if new is not None else prev
    if s == "IGNORE":
        return prev if prev is not None else new
    if s == "INCREMENT":
        if prev is None:
            return new
        if new is None:
            return prev
        return prev + new
    if s == "MAX":
        if prev is None or new is None:
            return new if prev is None else prev
        return max(prev, new)
    if s == "MIN":
        if prev is None or new is None:
            return new if prev is None else prev
        return min(prev, new)
    if s == "APPEND":
        pl = list(prev) if isinstance(prev, (list, tuple)) else ([prev] if prev is not None else [])
        nl = list(new) if isinstance(new, (list, tuple)) else ([new] if new is not None else [])
        return pl + nl
    if s == "UNION":
        pl = list(prev) if isinstance(prev, (list, tuple)) else ([prev] if prev is not None else [])
        nl = list(new) if isinstance(new, (list, tuple)) else ([new] if new is not None else [])
        out = list(pl)
        for v in nl:
            if v not in out:
                out.append(v)
        return out
    raise ValueError(f"unknown partial upsert strategy {strategy!r}")


def merge_partial(
    prev_row: dict,
    new_row: dict,
    pk_columns: list[str],
    comparison_column: str | None,
    strategies: dict,
    default_strategy: str = "OVERWRITE",
) -> dict:
    """Merge a new partial row with the previous full row. PK and comparison
    columns always come from the new row (PartialUpsertHandler semantics)."""
    fixed = set(pk_columns)
    if comparison_column:
        fixed.add(comparison_column)
    out = {}
    for col in set(prev_row) | set(new_row):
        if col in fixed:
            out[col] = new_row.get(col, prev_row.get(col))
            continue
        strategy = strategies.get(col, default_strategy)
        out[col] = _merge_value(strategy, prev_row.get(col), new_row.get(col))
    return out
