"""Multistage runtime statistics: per-operator collection, EOS propagation
payloads, broker-side merge, and EXPLAIN ANALYZE rendering.

Reference parity: MultiStageQueryStats / OperatorStats
(pinot-query-runtime/.../plan/MultiStageQueryStats.java,
operator/MultiStageOperator.java registerExecution) — every stage worker
accumulates one record per physical operator, appends the records (plus any
records received from upstream stages) to its trailing EOS block, and the
broker's root stage merges the full set into the per-stage `stageStats` tree
attached to the BrokerResponse.

Operator identity across workers/processes is the operator's preorder index
within its stage's plan tree: build_stage_plan is deterministic, so every
worker (and every participating server in distributed mode) enumerates the
same tree and the broker can merge records by (stage_id, op_id) without
shipping the tree itself.

This is the JAX package's `multistage/stats.py`, unchanged but for its
imports, which point at the port's modules.
"""

from __future__ import annotations

from dataclasses import dataclass

from pinot_tpu_torch.multistage import logical as L


#: reserved record key marking a distributed-trace span subtree riding the
#: EOS stats relay (one record per remote worker; never a stats record)
TRACE_RECORD_KEY = "__traceSubtree__"


def split_stats_payload(payload: list[dict]) -> tuple[list[dict], list[dict]]:
    """Separate operator-stats records from trace-subtree records that share
    the EOS relay channel. Returns (stats_records, trace_subtrees)."""
    stats: list[dict] = []
    subtrees: list[dict] = []
    for rec in payload or []:
        if isinstance(rec, dict) and TRACE_RECORD_KEY in rec:
            subtrees.append(rec[TRACE_RECORD_KEY])
        else:
            stats.append(rec)
    return stats, subtrees


def stats_enabled(options: dict) -> bool:
    """Collection is per-query opt-in (`trace=true`, the reference's query
    option) so the disabled path stays near-zero-cost; EXPLAIN ANALYZE
    forces it on via the internal __collect_stats__ flag."""
    return (
        str(options.get("trace", "")).lower() == "true"
        or bool(options.get("__collect_stats__"))
    )


def _children(node: L.Node):
    for attr in ("input", "left", "right"):
        child = getattr(node, attr, None)
        if isinstance(child, L.Node):
            yield child


def _op_label(node: L.Node) -> str:
    t = type(node).__name__
    if isinstance(node, L.Scan):
        return f"Scan({node.table})"
    if isinstance(node, L.Join):
        return f"Join({node.kind})"
    if isinstance(node, L.Aggregate):
        return f"Aggregate({node.mode})"
    if isinstance(node, L.StageInput):
        return f"StageInput(stage={node.stage_id})"
    if isinstance(node, L.FilterNode):
        return "Filter"
    if isinstance(node, L.SetOp):
        return f"SetOp({node.kind})"
    if isinstance(node, L._RootCollect):
        return "Collect"
    if t == "WindowNode":
        return "Window"
    return t


def _preorder(root: L.Node) -> list[L.Node]:
    out: list[L.Node] = []
    stack = [root]
    while stack:
        n = stack.pop()
        out.append(n)
        stack.extend(reversed(list(_children(n))))
    return out


@dataclass
class OperatorStats:
    """One physical operator's runtime stats on ONE stage worker
    (OperatorStats.java parity: rows/blocks/time plus the TPU build's
    device-vs-host split). wall_ms is inclusive of upstream operators in the
    same stage — the reference times nextBlock() the same way."""

    stage: int
    op: int
    operator: str
    worker: int
    rows: int = 0
    blocks: int = 0
    wall_ms: float = 0.0
    device_ms: float = 0.0
    fallbacks: int = 0

    def to_dict(self) -> dict:
        return {
            "stage": self.stage,
            "op": self.op,
            "operator": self.operator,
            "worker": self.worker,
            "rows": self.rows,
            "blocks": self.blocks,
            "wallMs": round(self.wall_ms, 3),
            "deviceMs": round(self.device_ms, 3),
            "fallbacks": self.fallbacks,
        }


class StageStatsCollector:
    """Per-(stage, worker) accumulator threaded through RunCtx. Collects this
    worker's operator records and relays records received from upstream
    stages' EOS markers, so the full set funnels to the root stage."""

    def __init__(self, stage: L.Stage, worker: int):
        self.stage_id = stage.id
        self.worker = worker
        self._index: dict[int, tuple[int, str]] = {}
        for i, node in enumerate(_preorder(stage.root)):
            self._index[id(node)] = (i, _op_label(node))
        self._ops: dict[int, OperatorStats] = {}
        self.upstream: list[dict] = []  # records relayed from child stages

    def _op(self, node: L.Node) -> OperatorStats:
        i, label = self._index[id(node)]
        op = self._ops.get(i)
        if op is None:
            op = self._ops[i] = OperatorStats(self.stage_id, i, label, self.worker)
        return op

    def record_exec(self, node: L.Node, rows: int, wall_ms: float, blocks: int = 1) -> None:
        op = self._op(node)
        op.rows += int(rows)
        op.blocks += blocks
        op.wall_ms += wall_ms

    def add_blocks(self, node: L.Node, n: int) -> None:
        self._op(node).blocks += int(n)

    def add_device(self, node: L.Node, ms: float) -> None:
        self._op(node).device_ms += ms

    def add_fallback(self, node: L.Node, n: int = 1) -> None:
        self._op(node).fallbacks += n

    def payload(self) -> list[dict]:
        """JSON-able record list for the trailing EOS: own ops + relayed."""
        own = [self._ops[i].to_dict() for i in sorted(self._ops)]
        return own + self.upstream


def merge_stage_stats(payload: list[dict]) -> list[dict]:
    """Broker-side merge (MultiStageStatsTreeBuilder parity): aggregate the
    flat record list by (stage, op) across workers into the `stageStats`
    tree. Tolerates partial payloads — a lost worker's records simply don't
    contribute, and `workers` reports how many actually arrived."""
    by_key: dict[tuple[int, int], dict] = {}
    for rec in payload or []:
        if TRACE_RECORD_KEY in rec:
            continue  # trace subtree riding the same relay; not a stats record
        key = (int(rec["stage"]), int(rec["op"]))
        m = by_key.get(key)
        if m is None:
            m = by_key[key] = {
                "op": key[1],
                "operator": rec.get("operator", "?"),
                "rows": 0,
                "blocks": 0,
                "wallMs": 0.0,
                "maxWallMs": 0.0,
                "deviceMs": 0.0,
                "fallbacks": 0,
                "_workers": set(),
            }
        m["rows"] += int(rec.get("rows", 0))
        m["blocks"] += int(rec.get("blocks", 0))
        m["wallMs"] += float(rec.get("wallMs", 0.0))
        m["maxWallMs"] = max(m["maxWallMs"], float(rec.get("wallMs", 0.0)))
        m["deviceMs"] += float(rec.get("deviceMs", 0.0))
        m["fallbacks"] += int(rec.get("fallbacks", 0))
        m["_workers"].add(rec.get("worker", 0))
    stages: dict[int, list[dict]] = {}
    for (sid, _), m in sorted(by_key.items()):
        m["workers"] = len(m.pop("_workers"))
        m["wallMs"] = round(m["wallMs"], 3)
        m["maxWallMs"] = round(m["maxWallMs"], 3)
        m["deviceMs"] = round(m["deviceMs"], 3)
        stages.setdefault(sid, []).append(m)
    return [{"stage": sid, "operators": ops} for sid, ops in sorted(stages.items())]


def _fmt_stats(m: dict | None) -> str:
    if m is None:
        return " (no stats)"
    extra = ""
    if m["deviceMs"]:
        extra += f", deviceMs={m['deviceMs']}"
    if m["fallbacks"]:
        extra += f", fallbacks={m['fallbacks']}"
    return (
        f" (rows={m['rows']}, blocks={m['blocks']}, wallMs={m['wallMs']}"
        f", workers={m['workers']}{extra})"
    )


def analyze_rows(plan: L.StagePlan, merged: list[dict]) -> list[list]:
    """EXPLAIN ANALYZE rendering: one [Operator, Operator_Id, Parent_Id] row
    per physical operator with the merged runtime stats inline; StageInput
    rows parent the producing stage's subtree, so the whole multi-stage plan
    reads as one tree."""
    idx = {(s["stage"], op["op"]): op for s in merged for op in s["operators"]}
    rows: list[list] = []
    next_id = [0]

    def visit_stage(sid: int, parent_row: int) -> None:
        stage = plan.stages[sid]
        op_of = {id(n): i for i, n in enumerate(_preorder(stage.root))}

        def walk(node: L.Node, parent: int, is_root: bool) -> None:
            rid = next_id[0]
            next_id[0] += 1
            prefix = f"[stage {sid} {stage.dist or 'root'} x{stage.parallelism}] " if is_root else ""
            rows.append(
                [prefix + _op_label(node) + _fmt_stats(idx.get((sid, op_of[id(node)]))), rid, parent]
            )
            for child in _children(node):
                walk(child, rid, False)
            if isinstance(node, L.StageInput):
                visit_stage(node.stage_id, rid)

        walk(stage.root, parent_row, True)

    visit_stage(0, -1)
    return rows
