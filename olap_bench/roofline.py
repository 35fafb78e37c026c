"""The yardstick of the roofline shares: the card's peak and the least bytes
a query's work needs, counted from the query and the generated data alone.

A share is the least time the card could take (least bytes over the peak
bandwidth) over the time the card's operations took. The least bytes count
what any program answering the query must touch, so a later program that
reads less cannot pass 100%:

- only the segments holding at least one matching row (a perfect pruner
  skips the rest);
- in each, every row of every column the query names, each value at the
  least width its segment's values allow: log2 of the segment's dictionary
  size for a dictionary column, log2 of the segment's value range for a raw
  one (a perfectly bit-packed store), read once;
- the query's result written once, 8 bytes a value.
"""

from __future__ import annotations

import math

import numpy as np

from olap_bench.reference.sql import Evaluator, Node, parse

#: NVIDIA H100 SXM5 data sheet: HBM3 bandwidth, bytes/s (at 700 W)
HBM_BYTES_PER_S = 3.35e12


def _columns(node, out: set) -> None:
    if isinstance(node, Node):
        if node.kind == "col":
            out.add(node.value)
        for a in node.args:
            _columns(a, out)


def _bits(values: np.ndarray) -> float:
    if len(values) == 0:
        return 0.0
    lo, hi = int(values.min()), int(values.max())
    return math.log2(hi - lo + 1)


class LeastBytes:
    """Least bytes of the queries over one generated table (host arrays)
    cut at `cuts` ([start, end) rows of each segment)."""

    def __init__(self, table, cuts: list[tuple[int, int]]):
        self.table = table
        self.cuts = cuts
        self.ev = Evaluator(table)
        self._col_bits: dict[str, list[float]] = {}
        self._memo: dict[tuple, float] = {}

    def column_bits(self, name: str) -> list[float]:
        """Least bits a value of column `name` in each segment."""
        if name not in self._col_bits:
            col = self.table.columns[name]
            out = []
            for s, e in self.cuts:
                part = col.data[s:e]
                if col.dictionary is not None:
                    present = int((np.bincount(part, minlength=len(col.dictionary)) > 0).sum())
                    out.append(math.log2(max(present, 1)))
                else:
                    out.append(_bits(part))
            self._col_bits[name] = out
        return self._col_bits[name]

    def _scan(self, q) -> tuple[np.ndarray, list[int]]:
        """(the matching rows' mask, matching rows in each segment)."""
        mask = self.ev.mask(q.where) if q.where is not None else np.ones(self.table.n_rows, dtype=bool)
        return mask, [int(np.count_nonzero(mask[s:e])) for s, e in self.cuts]

    def program(self, sql: str, result_rows: int) -> float:
        """Least bytes of the whole query: the columns it names in the
        segments with a matching row, and its result rows, 8 bytes a
        value."""
        key = ("program", sql)
        if key not in self._memo:
            q = parse(sql)
            cols: set = set()
            for n, _ in q.select:
                _columns(n, cols)
            _columns(q.where, cols)
            for n in q.group_by:
                _columns(n, cols)
            _, matched = self._scan(q)
            total = sum(
                (e - s) * self.column_bits(c)[i] / 8 for i, (s, e) in enumerate(self.cuts) if matched[i] for c in cols
            )
            self._memo[key] = total + result_rows * len(q.select) * 8
        return self._memo[key]
