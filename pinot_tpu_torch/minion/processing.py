"""Segment processing framework: map (partition/filter) -> reduce (rollup /
concat / dedup) -> rebuild segments.

Reference parity: pinot-core/.../segment/processing/framework/
SegmentProcessorFramework — mappers apply time filtering + partitioning
(SegmentMapper), reducers concat or rollup rows per partition
(ConcatReducer/RollupReducer), then SegmentIndexCreationDriver rebuilds
output segments. Used by the merge/rollup/purge/realtime-to-offline minion
tasks. The whole pipeline is columnar host numpy: segments decode to
columns, and the rebuilt segments reach the device only when a server
serves them.

This is the JAX package's `minion/processing.py`. Its reduce is pandas
(`groupby(dims, as_index=False, sort=True).agg(how)` and
`drop_duplicates(subset=dims or None, keep="first")`); here it is numpy that
keeps pandas' semantics:
- ROLLUP: one row a group, groups in sorted order of the dimension tuples;
  a row whose key holds None or NaN is dropped (dropna). SUM skips NaN,
  adds floats with Kahan compensation in row order in the column's own
  float type and integers in 64 bits that wrap; MIN / MAX skip NaN (NaN
  for a group that has none) and keep the first of equal values; COUNT
  rolls up as SUM. With no dimensions, one row of whole-column reductions,
  its values brought to one dtype as pandas' Series of scalars does.
- DEDUP: the first row of each key, in first-appearance order; null equals
  null.
- Each output column is cast back to its input dtype (so an int32 SUM
  wraps).
Partitioning a STRING column uses Python's `hash()`, as the reference does.
It is salted per process, so two processes can partition the same rows
differently.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from pinot_tpu_torch.common.types import Schema
from pinot_tpu_torch.segment.segment import ImmutableSegment

# metric rollup aggregators (RollupReducer's ValueAggregators)
_AGGS = {"SUM": "sum", "MIN": "min", "MAX": "max", "COUNT": "sum"}


@dataclass
class SegmentProcessorConfig:
    schema: Schema
    table_config: object | None = None
    # MAP phase ------------------------------------------------------------
    # keep rows where time_column in [window_start, window_end)
    time_column: str | None = None
    window_start: float | None = None
    window_end: float | None = None
    # arbitrary row filter: cols dict -> bool mask (purge / record filter)
    filter_fn: Callable[[dict[str, np.ndarray]], np.ndarray] | None = None
    # partition output by column value hash into N parts (PartitionerConfig)
    partition_column: str | None = None
    num_partitions: int = 1
    # REDUCE phase ---------------------------------------------------------
    merge_type: str = "CONCAT"  # CONCAT | ROLLUP | DEDUP
    # rollup: metric column -> SUM/MIN/MAX (default SUM)
    rollup_aggregates: dict[str, str] = field(default_factory=dict)
    # output --------------------------------------------------------------
    max_rows_per_segment: int = 5_000_000
    segment_name_prefix: str = "processed"


def _segment_columns(seg: ImmutableSegment) -> dict[str, np.ndarray]:
    """Decode a segment back to raw column values (reader-side of the map)."""
    return {name: ci.materialize() for name, ci in seg.columns.items()}


def process_segments(segments: list[ImmutableSegment], cfg: SegmentProcessorConfig) -> list[ImmutableSegment]:
    """Run the full map/reduce over input segments; returns new segments."""
    from pinot_tpu_torch.segment.builder import SegmentBuilder

    # MAP: decode + filter each input segment
    parts: list[dict[str, np.ndarray]] = []
    for seg in segments:
        cols = _segment_columns(seg)
        n = seg.n_docs
        mask = np.ones(n, dtype=bool)
        if cfg.time_column is not None and (cfg.window_start is not None or cfg.window_end is not None):
            t = cols[cfg.time_column].astype(np.float64)
            if cfg.window_start is not None:
                mask &= t >= cfg.window_start
            if cfg.window_end is not None:
                mask &= t < cfg.window_end
        if cfg.filter_fn is not None:
            mask &= np.asarray(cfg.filter_fn(cols), dtype=bool)
        if not mask.all():
            cols = {k: v[mask] for k, v in cols.items()}
        if len(next(iter(cols.values()), [])):
            parts.append(cols)
    if not parts:
        return []

    merged = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}

    # REDUCE
    if cfg.merge_type.upper() in ("ROLLUP", "DEDUP"):
        dims = [c for c in cfg.schema.dimension_columns if c in merged]
        if cfg.time_column and cfg.time_column not in dims and cfg.time_column in merged:
            dims.append(cfg.time_column)
        if cfg.merge_type.upper() == "DEDUP":
            out_cols = _dedup(merged, dims or list(merged))
        else:
            metrics = [c for c in merged if c not in dims]
            how = {m: _AGGS.get(cfg.rollup_aggregates.get(m, "SUM").upper(), "sum") for m in metrics}
            out_cols = _rollup(merged, dims, how) if dims else _agg_all(merged, how)
        merged = {}
        for c, v in out_cols.items():
            orig = next((p[c] for p in parts if c in p), None)
            if orig is not None and orig.dtype != object and v.dtype != orig.dtype:
                v = v.astype(orig.dtype)
            merged[c] = v

    # PARTITION + split into output segments
    builder = SegmentBuilder(cfg.schema, cfg.table_config)
    groups: list[tuple[str, dict[str, np.ndarray]]] = []
    if cfg.partition_column is not None and cfg.num_partitions > 1:
        pc = merged[cfg.partition_column]
        if pc.dtype == object:
            h = np.asarray([hash(x) for x in pc], dtype=np.int64)
        else:
            h = pc.astype(np.int64)
        pid = np.abs(h) % cfg.num_partitions
        for p in range(cfg.num_partitions):
            sel = pid == p
            if sel.any():
                groups.append((f"p{p}", {k: v[sel] for k, v in merged.items()}))
    else:
        groups.append(("", merged))

    out: list[ImmutableSegment] = []
    for tag, cols in groups:
        n = len(next(iter(cols.values())))
        for start in range(0, n, cfg.max_rows_per_segment):
            chunk = {k: v[start : start + cfg.max_rows_per_segment] for k, v in cols.items()}
            name = f"{cfg.segment_name_prefix}{('_' + tag) if tag else ''}_{len(out)}"
            out.append(builder.build(chunk, name))
    return out


# -- the reduce: pandas' groupby / drop_duplicates semantics in numpy ---------


def _nulls(v: np.ndarray) -> np.ndarray:
    """pandas' isna over a segment's column: only a float holds a null (NaN);
    a segment stores a null string as its default value."""
    return np.isnan(v) if v.dtype.kind == "f" else np.zeros(len(v), dtype=bool)


def _factorize(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(codes, uniques): codes rank the values in sorted order (-1 for a
    null); each unique is the first row holding it, as pandas' factorize
    keeps it (so -0.0 and 0.0 are one value, shown as the first seen)."""
    null = _nulls(v)
    rows = np.flatnonzero(~null)
    codes = np.full(len(v), -1, dtype=np.int64)
    if not len(rows):
        return codes, v[:0]
    order = rows[np.argsort(v[rows], kind="stable")]
    s = v[order]
    new = np.ones(len(s), dtype=bool)
    new[1:] = np.asarray(s[1:] != s[:-1], dtype=bool)
    codes[order] = np.cumsum(new) - 1
    return codes, s[new]


def _combine(codes: list[np.ndarray]) -> np.ndarray:
    """One key a row from per-column codes (each >= 0), ranked so that the
    keys sort as the code tuples do."""
    key = np.zeros(len(codes[0]), dtype=np.int64)
    for c in codes:
        key = key * (int(c.max(initial=0)) + 1) + c
        key = np.unique(key, return_inverse=True)[1].astype(np.int64)
    return key


def _dedup(cols: dict[str, np.ndarray], subset: list[str]) -> dict[str, np.ndarray]:
    """drop_duplicates(subset, keep="first"): rows in first-appearance order;
    nulls compare equal."""
    codes = []
    for c in subset:
        code, uniq = _factorize(cols[c])
        codes.append(np.where(code < 0, len(uniq), code))
    _, first = np.unique(_combine(codes), return_index=True)
    keep = np.sort(first)
    return {c: v[keep] for c, v in cols.items()}


def _rollup(cols: dict[str, np.ndarray], dims: list[str], how: dict[str, str]) -> dict[str, np.ndarray]:
    """groupby(dims, as_index=False, sort=True).agg(how)."""
    factors = [_factorize(cols[d]) for d in dims]
    rows = np.flatnonzero(np.logical_and.reduce([code >= 0 for code, _ in factors]))
    gid = _combine([code[rows] for code, _ in factors]) if len(rows) else rows.astype(np.int64)
    ng = int(gid.max()) + 1 if len(gid) else 0
    order = rows[np.argsort(gid, kind="stable")]  # by group, row order within
    counts = np.bincount(gid, minlength=ng)
    starts = np.zeros(ng, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    out = {}
    for d, (code, uniq) in zip(dims, factors):
        out[d] = uniq[code[order[starts]]] if ng else cols[d][:0]
    for m, fn in how.items():
        out[m] = _group_reduce(cols[m][order], starts, counts, fn)
    return out


def _group_reduce(v: np.ndarray, starts: np.ndarray, counts: np.ndarray, fn: str) -> np.ndarray:
    """One of pandas' cython group reductions over rows sorted by group."""
    if not len(starts):
        return v[:0]
    kind = v.dtype.kind
    if kind in "OUS":  # strings (a loaded segment's are objects) and bytes
        return _group_objects(v, starts, counts, fn)
    if fn == "sum":
        if kind == "f":
            return _kahan_sums(v, starts, counts)
        return np.add.reduceat(v.astype(np.int64), starts)
    if kind != "f":
        return (np.minimum if fn == "min" else np.maximum).reduceat(v, starts)
    out = (np.fmin if fn == "min" else np.fmax).reduceat(v, starts)  # NaN skipped; all-NaN gives NaN
    zero = v == 0
    if zero.any():  # pandas keeps the first of equal values: the sign of the first zero
        first = np.minimum.reduceat(np.where(zero, np.arange(len(v)), len(v)), starts)
        hit = (out == 0) & (first < len(v))
        out[hit] = v[first[hit]]
    return out


#: below this many groups still adding, the Kahan loop goes group by group
_KAHAN_VECTOR_MIN = 32


def _kahan_sums(v: np.ndarray, starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """pandas' group_sum for floats: per group, in row order, NaN skipped,
    Kahan-compensated in the column's float type (a compensation that turns
    NaN, from an infinity, resets to 0)."""
    ng = len(starts)
    total = np.zeros(ng, dtype=v.dtype)
    comp = np.zeros(ng, dtype=v.dtype)
    by_count = np.argsort(-counts, kind="stable")
    desc = counts[by_count]
    r = 0
    while r < desc[0]:
        live = int(np.searchsorted(-desc, -r, side="left"))  # groups with more than r rows
        if live < _KAHAN_VECTOR_MIN:
            break
        g = by_count[:live]
        x = v[starts[g] + r]
        ok = ~np.isnan(x)
        g, x = g[ok], x[ok]
        s, c = total[g], comp[g]
        y = x - c
        t = s + y
        c = (t - s) - y
        c[np.isnan(c)] = 0
        total[g], comp[g] = t, c
        r += 1
    scalar = float if v.dtype == np.float64 else v.dtype.type
    for g in by_count[: int(np.searchsorted(-desc, -r, side="left"))].tolist():
        s, c = scalar(total[g]), scalar(comp[g])
        for x in v[starts[g] + r : starts[g] + counts[g]].tolist():
            x = scalar(x)
            if x != x:
                continue
            y = x - c
            t = s + y
            c = (t - s) - y
            if c != c:
                c = scalar(0)
            s = t
        total[g], comp[g] = s, c
    return total


def _group_objects(v: np.ndarray, starts: np.ndarray, counts: np.ndarray, fn: str) -> np.ndarray:
    """String and bytes columns: SUM concatenates in row order, MIN / MAX
    compare as Python does."""
    out = np.empty(len(starts), dtype=object)
    for g, (a, n) in enumerate(zip(starts.tolist(), counts.tolist())):
        vals = v[a : a + n].tolist()
        out[g] = vals[0][:0].join(vals) if fn == "sum" else (min(vals) if fn == "min" else max(vals))
    return out


def _agg_all(cols: dict[str, np.ndarray], how: dict[str, str]) -> dict[str, np.ndarray]:
    """df.agg(how).to_frame().T: pandas' nanops reductions of each whole
    column, then one row whose columns share the dtype pandas' Series
    infers from the scalars."""
    vals = {}
    for m, fn in how.items():
        v = cols[m]
        kind = v.dtype.kind
        if kind in "OUS":
            vals[m] = _group_objects(v, np.zeros(1, dtype=np.int64), np.array([len(v)]), fn)[0]
        elif fn == "sum":
            if kind == "f":
                vals[m] = np.where(np.isnan(v), 0, v).sum(0, dtype=v.dtype)
            else:
                vals[m] = v.sum(0, dtype=np.int64)
        elif kind == "f":
            fill = np.inf if fn == "min" else -np.inf
            nan = np.isnan(v)
            r = getattr(np.where(nan, fill, v), fn)(0)
            vals[m] = v.dtype.type(np.nan) if nan.all() else r
        else:
            vals[m] = getattr(v, fn)(0)
    dtype = _series_dtype(list(vals.values()))
    return {m: np.array([x], dtype=dtype) for m, x in vals.items()}


def _series_dtype(scalars: list) -> np.dtype:
    """The dtype pandas' Series gives a list of NumPy scalars
    (lib.maybe_convert_objects): float if any is a float, else int, at the
    largest item size among them; anything else is object."""
    if not all(isinstance(x, (np.integer, np.floating)) for x in scalars):
        return np.dtype(object)
    size = max(x.dtype.itemsize for x in scalars)
    return np.dtype(f"f{size}" if any(isinstance(x, np.floating) for x in scalars) else f"i{size}")
