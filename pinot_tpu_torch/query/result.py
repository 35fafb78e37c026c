"""Query results: the broker response surface.

Reference parity: BrokerResponseNative / ResultTable (pinot-common/.../response/
broker/ResultTable.java) — column names + data types + row-major values, plus
execution stats (numDocsScanned, totalDocs, timeUsedMs). Field names match
the JAX package's `query/result.py`; its pruning, scan-path, tracing, cache
and cluster fields and its wire form belong to layers not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import numpy as np


@dataclass
class ResultTable:
    columns: list[str]
    rows: list[list[Any]]
    column_types: list[str] = field(default_factory=list)
    num_docs_scanned: int = 0
    total_docs: int = 0
    num_segments_queried: int = 0
    time_used_ms: float = 0.0

    def __post_init__(self):
        self.rows = [[_plain(v) for v in row] for row in self.rows]
        if not self.column_types:
            self.column_types = [_infer_type(self.rows, i) for i in range(len(self.columns))]

    def __repr__(self) -> str:  # human-friendly table
        head = " | ".join(self.columns)
        body = "\n".join(" | ".join(str(v) for v in r) for r in self.rows[:20])
        more = f"\n... ({len(self.rows)} rows)" if len(self.rows) > 20 else ""
        return f"{head}\n{'-' * len(head)}\n{body}{more}"


def _plain(v):
    if isinstance(v, np.generic):
        return v.item()
    return v


def _infer_type(rows: list[list], i: int) -> str:
    for r in rows:
        v = r[i]
        if v is None:
            continue
        if isinstance(v, bool):
            return "BOOLEAN"
        if isinstance(v, int):
            return "LONG"
        if isinstance(v, float):
            return "DOUBLE"
        if isinstance(v, bytes):
            return "BYTES"
        return "STRING"
    return "STRING"
