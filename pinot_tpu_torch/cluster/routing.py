"""Broker routing: segment pruning + replica instance selection.

Reference parity: BrokerRoutingManager (pinot-broker/.../routing/
BrokerRoutingManager.java:101); instance selectors BalancedInstanceSelector /
ReplicaGroupInstanceSelector / StrictReplicaGroupInstanceSelector
(pinot-broker/.../routing/instanceselector/); AdaptiveServerSelector
(routing/adaptiveserverselector/ — latency-aware replica ranking); the
pruners — ColumnValueSegmentPruner (min/max interval tests),
TimeSegmentPruner, MultiPartitionColumnsSegmentPruner (partition membership
on EQ/IN predicates) — operating here on controller-stored per-segment
stats/partition metadata instead of on-disk metadata; and the
TimeBoundaryManager for hybrid offline+realtime tables
(broker/routing/timeboundary/).
"""

from __future__ import annotations

import itertools
import threading
import zlib

from pinot_tpu_torch.query import ast
from pinot_tpu_torch.query.ast import CompareOp


def _interval(stats: dict, col: str):
    s = stats.get(col)
    if s is None:
        return None
    mn, mx = s.get("min"), s.get("max")
    if mn is None or mx is None:
        return None
    if isinstance(mn, dict) or isinstance(mx, dict):  # bytes columns: skip
        return None
    return mn, mx


def _cmp_overlap(op: CompareOp, lo, hi, v) -> bool:
    try:
        if op == CompareOp.EQ:
            return lo <= v <= hi
        if op == CompareOp.NEQ:
            return True  # only prunable when lo==hi==v; keep conservative
        if op == CompareOp.LT:
            return lo < v
        if op == CompareOp.LTE:
            return lo <= v
        if op == CompareOp.GT:
            return hi > v
        if op == CompareOp.GTE:
            return hi >= v
    except TypeError:
        return True
    return True


def segment_can_match(f: ast.FilterExpr | None, stats: dict) -> bool:
    """Conservative test: False only when the filter PROVABLY matches no doc
    of the segment given column [min,max] stats."""
    if f is None:
        return True
    if isinstance(f, ast.And):
        return all(segment_can_match(c, stats) for c in f.children)
    if isinstance(f, ast.Or):
        return any(segment_can_match(c, stats) for c in f.children)
    if isinstance(f, ast.Compare):
        left, op, right = f.left, f.op, f.right
        if isinstance(left, ast.Literal) and isinstance(right, ast.Identifier):
            from pinot_tpu_torch.query.plan import _FLIP

            left, right, op = right, left, _FLIP[op]
        if isinstance(left, ast.Identifier) and isinstance(right, ast.Literal):
            iv = _interval(stats, left.name)
            if iv is not None:
                v = right.value
                if isinstance(v, str) != isinstance(iv[0], str):
                    return True
                return _cmp_overlap(op, iv[0], iv[1], v)
        return True
    if isinstance(f, ast.Between) and isinstance(f.expr, ast.Identifier) and not f.negated:
        if isinstance(f.low, ast.Literal) and isinstance(f.high, ast.Literal):
            iv = _interval(stats, f.expr.name)
            if iv is not None:
                try:
                    return not (f.high.value < iv[0] or f.low.value > iv[1])
                except TypeError:
                    return True
        return True
    if isinstance(f, ast.In) and isinstance(f.expr, ast.Identifier) and not f.negated:
        iv = _interval(stats, f.expr.name)
        if iv is not None:
            try:
                return any(
                    iv[0] <= v.value <= iv[1] for v in f.values if isinstance(v, ast.Literal)
                )
            except TypeError:
                return True
        return True
    # NOT / LIKE / REGEXP / IsNull: never prune
    return True


class BalancedInstanceSelector:
    """Round-robin replica choice per segment (BalancedInstanceSelector
    parity; the adaptive latency-aware variant plugs in here later)."""

    def __init__(self):
        self._rr = itertools.count()

    def select(
        self, ideal_state: dict[str, dict[str, str]], segments: list[str]
    ) -> tuple[dict[str, list[str]], list[str]]:
        """segment list -> ({server_id: [segments]}, unroutable_segments),
        picking one ONLINE replica per segment. Callers must surface
        unroutable segments as an error, never as silently-missing rows."""
        plan: dict[str, list[str]] = {}
        unroutable: list[str] = []
        for seg in segments:
            replicas = sorted(
                s for s, st in ideal_state.get(seg, {}).items() if st in ("ONLINE", "CONSUMING")
            )
            if not replicas:
                unroutable.append(seg)
                continue
            pick = replicas[next(self._rr) % len(replicas)]
            plan.setdefault(pick, []).append(seg)
        return plan, unroutable


class ReplicaGroupInstanceSelector:
    """Route each query to ONE replica index across all segments
    (ReplicaGroupInstanceSelector parity): minimal fan-out when replicas are
    placed as complete copies. Segments missing from the chosen replica fall
    through to any other ONLINE replica (non-strict)."""

    def __init__(self, strict: bool = False):
        self._rr = itertools.count()
        self.strict = strict

    def select(self, ideal_state, segments):
        group = next(self._rr)
        plan: dict[str, list[str]] = {}
        unroutable: list[str] = []
        for seg in segments:
            replicas = sorted(
                s for s, st in ideal_state.get(seg, {}).items() if st in ("ONLINE", "CONSUMING")
            )
            if not replicas:
                unroutable.append(seg)
                continue
            pick = replicas[group % len(replicas)]
            plan.setdefault(pick, []).append(seg)
        if self.strict and len(plan) > 1:
            # StrictReplicaGroup: every segment must come from the same
            # group index; mixed placement means the grouping is broken
            counts = {s: len(v) for s, v in plan.items()}
            raise RuntimeError(f"strict replica-group routing failed: segments span servers {counts}")
        return plan, unroutable


class AdaptiveServerSelector:
    """Latency-aware replica choice (AdaptiveServerSelector parity, the
    LATENCY strategy): EWMA of observed per-server latency; each segment goes
    to its lowest-score ONLINE replica. Brokers call `record()` after every
    scatter; unobserved servers score 0 (get traffic to gather data)."""

    def __init__(self, alpha: float = 0.3):
        self.alpha = alpha
        self._ewma: dict[str, float] = {}
        self._lock = threading.Lock()

    def record(self, server_id: str, latency_ms: float) -> None:
        with self._lock:
            cur = self._ewma.get(server_id)
            self._ewma[server_id] = (
                latency_ms if cur is None else self.alpha * latency_ms + (1 - self.alpha) * cur
            )

    def score(self, server_id: str) -> float:
        with self._lock:
            return self._ewma.get(server_id, 0.0)

    def select(self, ideal_state, segments):
        plan: dict[str, list[str]] = {}
        unroutable: list[str] = []
        for seg in segments:
            replicas = sorted(
                s for s, st in ideal_state.get(seg, {}).items() if st in ("ONLINE", "CONSUMING")
            )
            if not replicas:
                unroutable.append(seg)
                continue
            pick = min(replicas, key=lambda s: (self.score(s), s))
            plan.setdefault(pick, []).append(seg)
        return plan, unroutable


# -- partition pruning (MultiPartitionColumnsSegmentPruner parity) -----------


def partition_of(value, num_partitions: int) -> int:
    """Stable partition function (Murmur-role; crc32 for strings, modulo for
    ints — matches the builder side writing segment partition metadata)."""
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return int(value) % num_partitions
    return zlib.crc32(str(value).encode()) % num_partitions


def segment_partitions_match(f: ast.FilterExpr | None, partitions: dict) -> bool:
    """False only when every EQ/IN value on a partitioned column hashes
    outside this segment's partition set."""
    if not partitions or f is None:
        return True
    if isinstance(f, ast.And):
        return all(segment_partitions_match(c, partitions) for c in f.children)
    if isinstance(f, ast.Or):
        return any(segment_partitions_match(c, partitions) for c in f.children)
    if isinstance(f, ast.Compare) and f.op == CompareOp.EQ:
        left, right = f.left, f.right
        if isinstance(left, ast.Literal) and isinstance(right, ast.Identifier):
            left, right = right, left
        if isinstance(left, ast.Identifier) and isinstance(right, ast.Literal):
            p = partitions.get(left.name)
            if p:
                return partition_of(right.value, p["numPartitions"]) in set(p["partitionIds"])
        return True
    if isinstance(f, ast.In) and isinstance(f.expr, ast.Identifier) and not f.negated:
        p = partitions.get(f.expr.name)
        if p:
            ids = set(p["partitionIds"])
            return any(
                partition_of(v.value, p["numPartitions"]) in ids
                for v in f.values
                if isinstance(v, ast.Literal)
            )
        return True
    return True


# -- time boundary (hybrid offline+realtime routing) -------------------------


class TimeBoundary:
    """Hybrid-table split (TimeBoundaryManager parity): offline serves
    time <= boundary, realtime serves time > boundary, where boundary is the
    max time value committed to the offline table."""

    def __init__(self, time_column: str, boundary):
        self.time_column = time_column
        self.boundary = boundary

    @staticmethod
    def compute(offline_meta: dict[str, dict], time_column: str) -> "TimeBoundary | None":
        hi = None
        for m in offline_meta.values():
            s = (m.get("stats") or {}).get(time_column)
            if s and isinstance(s.get("max"), (int, float)):
                hi = s["max"] if hi is None else max(hi, s["max"])
        return TimeBoundary(time_column, hi) if hi is not None else None

    def offline_sql(self, sql: str) -> str:
        return _with_time_predicate(sql, f"{self.time_column} <= {self.boundary}")

    def realtime_sql(self, sql: str) -> str:
        return _with_time_predicate(sql, f"{self.time_column} > {self.boundary}")


def _search_outside_quotes(pattern: str, sql: str, start: int = 0):
    """re.search that ignores matches inside single-quoted SQL string
    literals ('' is the escaped quote) — 'WHERE msg = ''over the limit'''
    must not split at the LIMIT inside the literal."""
    import re

    masked = list(sql)
    in_str = False
    for i, ch in enumerate(sql):
        if ch == "'":
            in_str = not in_str  # '' escape toggles twice: net unchanged
        elif in_str:
            masked[i] = "\0"
    return re.search(pattern, "".join(masked[start:]), re.IGNORECASE)


def _with_time_predicate(sql: str, predicate: str) -> str:
    """Inject an AND predicate into the (single-table, v1) query text — the
    string-level analog of attaching the time filter to BrokerRequest."""
    _TAIL = r"\b(GROUP\s+BY|ORDER\s+BY|LIMIT|HAVING)\b"
    m = _search_outside_quotes(r"\bWHERE\b", sql)
    if m:
        # Parenthesize the ORIGINAL predicate too: 'a=1 OR b=2' must become
        # '(boundary) AND (a=1 OR b=2)', otherwise AND binds tighter than OR
        # and the boundary no longer constrains the OR branch (rows in the
        # offline/realtime overlap window would be returned by BOTH legs).
        tail = _search_outside_quotes(_TAIL, sql, m.end())
        end = m.end() + (tail.start() if tail else len(sql) - m.end())
        rest = sql[m.end() : end].strip()
        tail_str = sql[end:].strip()
        out = sql[: m.end()] + f" ({predicate}) AND ({rest})"
        return out + (" " + tail_str if tail_str else "")
    tail = _search_outside_quotes(_TAIL, sql)
    pos = tail.start() if tail else len(sql)
    return sql[:pos].rstrip() + f" WHERE {predicate} " + sql[pos:]
