"""Query results: the broker response surface.

Reference parity: BrokerResponseNative / ResultTable (pinot-common/.../response/
broker/ResultTable.java) — column names + data types + row-major values, plus
execution stats (numDocsScanned, totalDocs, timeUsedMs), the pruning funnel,
the scan-path counts and the trace. Field names match the JAX package's
`query/result.py`; its cache, stream, multistage and cluster fields
(partial results, exceptions, servers queried) come with the layers that set
them.
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
    num_segments_pruned: int = 0
    # pruning funnel: numSegmentsPrunedByServer broken down by reject site;
    # the lumped field above stays their sum
    num_segments_pruned_by_value: int = 0
    num_segments_pruned_by_bloom: int = 0
    num_segments_pruned_by_geo: int = 0
    # scan-path plane (numEntriesScannedInFilter / PostFilter parity):
    # filter-phase entries examined (index-served predicates contribute 0,
    # FULL_SCAN contributes n_docs) and post-filter projection entries
    # (docsMatched x projected columns)
    num_entries_scanned_in_filter: int = 0
    num_entries_scanned_post_filter: int = 0
    # per-query scan attribution summary (query/scan_stats.py wire form)
    scan_profile: dict | None = None
    time_used_ms: float = 0.0
    # the request's span tree, when the query ran under a trace
    trace: dict | None = None
    trace_id: str = ""

    def __post_init__(self):
        self.rows = [[_plain(v) for v in row] for row in self.rows]
        if not self.column_types:
            self.column_types = [_infer_type(self.rows, i) for i in range(len(self.columns))]

    def to_dict(self) -> dict:
        d = {
            "resultTable": {
                "dataSchema": {"columnNames": self.columns, "columnDataTypes": self.column_types},
                "rows": self.rows,
            },
            "numDocsScanned": self.num_docs_scanned,
            "totalDocs": self.total_docs,
            "numSegmentsQueried": self.num_segments_queried,
            "numSegmentsPrunedByServer": self.num_segments_pruned,
            "numSegmentsPrunedByValue": self.num_segments_pruned_by_value,
            "numSegmentsPrunedByBloom": self.num_segments_pruned_by_bloom,
            "numSegmentsPrunedByGeo": self.num_segments_pruned_by_geo,
            "numEntriesScannedInFilter": self.num_entries_scanned_in_filter,
            "numEntriesScannedPostFilter": self.num_entries_scanned_post_filter,
            "timeUsedMs": self.time_used_ms,
        }
        if self.scan_profile is not None:
            d["scanProfile"] = self.scan_profile
        if self.trace is not None:
            d["traceInfo"] = self.trace
        if self.trace_id:
            d["traceId"] = self.trace_id
        return d

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
