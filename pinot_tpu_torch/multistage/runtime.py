"""Multistage (v2) runtime: mailboxes, operators, OpChain workers.

Reference parity:
- MailboxService / InMemorySendingMailbox
  (pinot-query-runtime/.../mailbox/MailboxService.java:40) -> in-process
  MailboxService with per-(receiver stage, worker, sender stage) queues.
- BlockExchange strategies (runtime/operator/exchange/BlockExchange.java:50-59)
  -> singleton / hash / broadcast / random senders.
- OpChainSchedulerService (runtime/executor/OpChainSchedulerService.java:37)
  -> one thread per (stage, worker); blocks stream through queues, so stages
  pipeline naturally.
- Operators (runtime/operator/: HashJoinOperator, AggregateOperator,
  SortOperator, WindowAggregateOperator, set ops, LeafStageTransferableBlock-
  Operator) -> columnar numpy implementations for intermediate stages; LEAF
  work runs the single-stage engine on the engine's device: Scan filters run
  the `mask` program (_leaf_filter_mask) and partial aggregates over a Scan
  run the per-segment programs (_try_leaf_device_partial). Aggregation is
  two-phase (partial below the exchange, final above — AggregateOperator
  LEAF/FINAL parity) whenever every function has a mergeable partial.

This is the JAX package's `multistage/runtime.py` without pandas. A block is
a `Block`: positional numpy columns aligned to a logical node's `fields`.
Missing values are NaN in a float column and None in an object column. Every
pandas operation of the reference is written in numpy with pandas' semantics:
merges keep the left order (each left row's matches in right order),
`groupby(sort=False, dropna=False)` numbers groups by first appearance
(`reduce.group_index`), the sort is `sorting.sort_nulls_largest`, reducers
skip missing values, and lists of cells become columns by pandas' dtype
inference (`_column`). The device operators (the sort permutation, the
window scan, the equi-join probe) are torch ops on the engine's device, and
an integer equi-join first tries the hash exchange across the engine's mesh
(`parallel.shuffle.mesh_equi_join`), as the reference does.
"""

from __future__ import annotations

import contextvars
import dataclasses
import queue
import re
import threading
import time as _time
from dataclasses import dataclass, field as dfield

import numpy as np
import torch

from pinot_tpu_torch.multistage import logical as L
from pinot_tpu_torch.multistage.stats import (
    StageStatsCollector,
    analyze_rows,
    merge_stage_stats,
    stats_enabled,
)
from pinot_tpu_torch.query import ast, host_exec
from pinot_tpu_torch.query.context import canonical
from pinot_tpu_torch.query.reduce import group_index
from pinot_tpu_torch.query.result import ResultTable

_EOS = ("__eos__",)


# ---------------------------------------------------------------------------
# Blocks: positional numpy columns
# ---------------------------------------------------------------------------


class Block:
    """A columnar block: positional numpy columns of one length (a block
    without columns has no rows, as an empty DataFrame)."""

    __slots__ = ("cols",)

    def __init__(self, cols):
        self.cols = list(cols)

    def __len__(self) -> int:
        return len(self.cols[0]) if self.cols else 0

    @property
    def width(self) -> int:
        return len(self.cols)

    def take(self, idx) -> "Block":
        """Rows by position (an int array) or by a bool mask."""
        return Block([c[idx] for c in self.cols])

    def slice(self, start: int, stop: "int | None") -> "Block":
        return Block([c[start:stop] for c in self.cols])

    def head_cols(self, k: int) -> "Block":
        return Block(self.cols[:k])


def _empty_block(n_cols: int) -> Block:
    return Block([np.empty(0, dtype=object) for _ in range(n_cols)])


def _is_missing(x) -> bool:
    return x is None or (isinstance(x, float) and x != x)


def isna(col: np.ndarray) -> np.ndarray:
    """pd.isna over a column: NaN in a float column, None / NaN cells of an
    object column."""
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype == object:
        return np.fromiter((_is_missing(x) for x in col), bool, len(col))
    return np.zeros(len(col), dtype=bool)


def _objects(values) -> np.ndarray:
    """An object column of the given cells (no broadcasting of list-like
    cells such as sets and register arrays)."""
    out = np.empty(len(values), dtype=object)
    for i, v in enumerate(values):
        out[i] = v
    return out


def _column(values) -> np.ndarray:
    """A list of cells as a column, with pandas' dtype inference: bools ->
    bool, integers -> int64, numbers with None / NaN -> float64 (NaN),
    anything else (text, sets, arrays, all None) -> object."""
    vals = list(values)
    kinds = set()
    for v in vals:
        if v is None:
            kinds.add("none")
        elif isinstance(v, (bool, np.bool_)):
            kinds.add("b")
        elif isinstance(v, (int, np.integer)):
            kinds.add("i")
        elif isinstance(v, (float, np.floating)):
            kinds.add("f")
        else:
            return _objects(vals)
    if kinds == {"b"}:
        return np.asarray(vals, dtype=bool)
    if kinds == {"i"}:
        return np.asarray(vals, dtype=np.int64)
    if kinds and kinds <= {"i", "f", "none"} and kinds & {"i", "f"}:
        return np.asarray([np.nan if v is None else v for v in vals], dtype=np.float64)
    return _objects(vals)


def _concat_cols(cols: list) -> np.ndarray:
    """One column of several (pd.concat's promotion: numbers widen, anything
    beside text or objects becomes object)."""
    cols = [c.astype(object) if c.dtype.kind in "US" else c for c in cols]
    if len(cols) == 1:
        return cols[0]
    if any(c.dtype == object for c in cols) and not all(c.dtype == object for c in cols):
        return _objects([x for c in cols for x in c.tolist()])
    return np.concatenate(cols)


def concat_blocks(blocks: list) -> Block:
    blocks = list(blocks)
    return Block([_concat_cols([b.cols[i] for b in blocks]) for i in range(blocks[0].width)])


def _missing_like(col: np.ndarray, n: int) -> np.ndarray:
    """n missing cells to extend a column of col's kind, as pandas' outer
    join results get them: NaN (an int column turns float64), None beside a
    text, object or bool column (which turns object)."""
    if col.dtype == object or col.dtype.kind == "b":
        return np.full(n, None, dtype=object)
    return np.full(n, np.nan)


def _to_numeric(col: np.ndarray) -> np.ndarray:
    """pd.to_numeric(errors="coerce"): numbers stay, parseable text parses,
    the rest NaN; int64 when every cell is an integer."""
    if col.dtype != object:
        return col
    out = []
    for x in col.tolist():
        if _is_missing(x):
            out.append(None)
        elif isinstance(x, (bool, int, float, np.number)):
            out.append(x)
        else:
            try:
                out.append(int(x))
            except (TypeError, ValueError):
                try:
                    out.append(float(x))
                except (TypeError, ValueError):
                    out.append(None)
    if not out:
        return np.zeros(0, dtype=np.float64)
    col = _column(out)
    return col if col.dtype != object else np.full(len(out), np.nan)


def _as_f64(col: np.ndarray) -> np.ndarray:
    """Series.to_numpy(float64): missing cells NaN."""
    if col.dtype == object:
        return np.asarray([np.nan if _is_missing(x) else x for x in col.tolist()], dtype=np.float64)
    return col.astype(np.float64)


def to_rows(block: Block) -> list[list]:
    """Rows of Python values, missing cells None (the reference's
    `df.astype(object).where(pd.notna(df), None).values.tolist()`)."""
    cols = [[None if _is_missing(x) else x for x in c.astype(object).tolist()] for c in block.cols]
    return [list(r) for r in zip(*cols)]


# ---------------------------------------------------------------------------
# Mailboxes
# ---------------------------------------------------------------------------


class MailboxService:
    """In-process mailbox fabric: queues keyed by
    (receiver stage, receiver worker, sender stage)."""

    def __init__(self):
        self._queues: dict[tuple, queue.Queue] = {}
        self._lock = threading.Lock()

    def _q(self, recv_stage: int, recv_worker: int, send_stage: int) -> queue.Queue:
        key = (recv_stage, recv_worker, send_stage)
        with self._lock:
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = queue.Queue()
            return q

    def send(self, send_stage: int, recv_stage: int, recv_worker: int, payload) -> None:
        if callable(payload):  # lazily-built frame (trailing EOS with stats)
            payload = payload()
        self._q(recv_stage, recv_worker, send_stage).put(payload)

    #: receive deadline; None blocks forever (in-process engine)
    receive_timeout: float | None = None
    #: per-query Deadline (query.context.Deadline): when set, receives poll
    #: in short slices so cancellation / expiry interrupts a blocked OpChain
    #: within ~0.2 s
    deadline = None

    def _get_one(self, q: queue.Queue, recv_stage: int, recv_worker: int, send_stage: int):
        deadline = self.deadline
        if deadline is None and self.receive_timeout is None:
            return q.get()
        t_start = _time.monotonic()
        where = f"stage {send_stage} -> ({recv_stage}, w{recv_worker})"
        while True:
            if deadline is not None:
                deadline.check(where)
            slice_t = 0.2
            if self.receive_timeout is not None:
                left = self.receive_timeout - (_time.monotonic() - t_start)
                if left <= 0:
                    raise RuntimeError(f"mailbox receive timed out after {self.receive_timeout}s: {where}") from None
                slice_t = min(slice_t, left)
            if deadline is not None:
                rem = deadline.remaining()
                if rem is not None:
                    slice_t = min(slice_t, max(rem, 0.01))
            try:
                return q.get(timeout=slice_t)
            except queue.Empty:
                continue

    def receive_all(
        self,
        recv_stage: int,
        recv_worker: int,
        send_stage: int,
        n_senders: int,
        stats_out: list | None = None,
    ) -> list:
        """Drain blocks from n_senders until each sent EOS. Raises on error.
        An EOS may carry the sender's operator-stats records
        (("__eos__", [records])); they are appended to `stats_out`."""
        from pinot_tpu_torch.common.trace import ServerQueryPhase, phase_timer

        q = self._q(recv_stage, recv_worker, send_stage)
        blocks: list[Block] = []
        eos = 0
        while eos < n_senders:
            with phase_timer(ServerQueryPhase.MAILBOX_RECEIVE_WAIT, role="server"):
                item = self._get_one(q, recv_stage, recv_worker, send_stage)
            if item is _EOS or (isinstance(item, tuple) and item and item[0] == "__eos__"):
                eos += 1
                if stats_out is not None and isinstance(item, tuple) and len(item) > 1 and item[1]:
                    stats_out.extend(item[1])
            elif isinstance(item, tuple) and item and item[0] == "__err__":
                # the marker carries the sender's error code, so a deadline /
                # cancel failure re-raises as its own class
                from pinot_tpu_torch.common.errors import QueryErrorCode
                from pinot_tpu_torch.query.context import QueryCancelledError, QueryTimeoutError

                code = item[2] if len(item) > 2 else None
                msg = f"upstream stage {send_stage} failed: {item[1]}"
                if code == QueryErrorCode.EXECUTION_TIMEOUT:
                    raise QueryTimeoutError(msg)
                if code == QueryErrorCode.QUERY_CANCELLATION:
                    raise QueryCancelledError(msg)
                raise RuntimeError(msg)
            else:
                blocks.append(item)
        return blocks


# ---------------------------------------------------------------------------
# Expression evaluation over blocks
# ---------------------------------------------------------------------------


def _literal_column(v, n: int) -> np.ndarray:
    if isinstance(v, str):
        return np.full(n, v, dtype=object)
    return np.full(n, v)


def eval_expr(expr: ast.Expr, fields: list[L.Field], blk: Block) -> np.ndarray:
    n = len(blk)
    if not isinstance(expr, ast.Literal):
        c = canonical(expr)
        hits = [i for i, f in enumerate(fields) if f.canon == c]
        if len(hits) == 1:
            return blk.cols[hits[0]]
    if isinstance(expr, ast.Identifier):
        return blk.cols[L.resolve(fields, expr.name)]
    if isinstance(expr, ast.Literal):
        return _literal_column(expr.value, n)
    if isinstance(expr, ast.BinaryOp):
        # None cells (null-handling scans, NULL aggregates) coerce to NaN,
        # which propagates and leaves as None at the result boundary
        l = _to_numeric(eval_expr(expr.left, fields, blk))
        r = _to_numeric(eval_expr(expr.right, fields, blk))
        with np.errstate(all="ignore"):
            if expr.op == "+":
                return l + r
            if expr.op == "-":
                return l - r
            if expr.op == "*":
                return l * r
            if expr.op == "/":
                return l.astype(np.float64) / r.astype(np.float64)
            if expr.op == "%":
                return l % r
        raise L.PlanV2Error(f"unknown operator {expr.op}")
    if isinstance(expr, ast.CaseWhen):
        conds = [np.asarray(eval_filter(c, fields, blk), bool) for c, _ in expr.whens]
        vals = [np.asarray(eval_expr(v, fields, blk)) for _, v in expr.whens]
        if expr.else_ is not None:
            default = np.asarray(eval_expr(expr.else_, fields, blk))
        else:
            is_str = any(v.dtype == object or v.dtype.kind in "US" for v in vals)
            default = np.full(n, "null" if is_str else 0, dtype=object if is_str else np.float64)
        if any(v.dtype == object or v.dtype.kind in "US" for v in vals):
            vals = [v.astype(object) for v in vals]
            default = default.astype(object)
        return np.select(conds, vals, default=default)
    if isinstance(expr, ast.FunctionCall):
        from pinot_tpu_torch.query.transforms import (
            DEVICE_FUNCS,
            STRING_FUNCS,
            apply_string_func,
            rewrite_time_convert,
        )

        name = expr.name
        if name in ("timeconvert", "datetimeconvert"):
            rw = rewrite_time_convert(expr)
            if rw is not None:
                return eval_expr(rw, fields, blk)
        if name == "cast":
            v = eval_expr(expr.args[0], fields, blk)
            target = str(expr.args[1].value).upper()
            if target in ("INT", "LONG", "TIMESTAMP", "BOOLEAN"):
                with np.errstate(invalid="ignore"):
                    return np.trunc(_as_f64(v)).astype(np.int64)
            if target in ("FLOAT", "DOUBLE"):
                return _as_f64(v)
            if target == "STRING":
                return _objects([str(x) for x in v.tolist()])
            raise L.PlanV2Error(f"unsupported CAST target {target}")
        if name in DEVICE_FUNCS:
            _, fn = DEVICE_FUNCS[name]
            args = [eval_expr(a, fields, blk) for a in expr.args]
            return np.asarray(fn(np, *args))
        if name in STRING_FUNCS:
            base = eval_expr(expr.args[0], fields, blk)
            lit_args = tuple(a.value for a in expr.args[1:] if isinstance(a, ast.Literal))
            derived, _ = apply_string_func(name, base, lit_args)
            return np.asarray(derived)
    raise L.PlanV2Error(f"unsupported expression in multistage runtime: {expr}")


_CMPS = {
    ast.CompareOp.EQ: lambda a, b: a == b,
    ast.CompareOp.NEQ: lambda a, b: a != b,
    ast.CompareOp.LT: lambda a, b: a < b,
    ast.CompareOp.LTE: lambda a, b: a <= b,
    ast.CompareOp.GT: lambda a, b: a > b,
    ast.CompareOp.GTE: lambda a, b: a >= b,
}


def _isin(v: np.ndarray, vals: list) -> np.ndarray:
    """Series.isin: numbers match numbers by value, text matches text."""
    if v.dtype.kind in "biuf":
        nums = [x for x in vals if isinstance(x, (int, float, np.number)) and not isinstance(x, bool)]
        return np.isin(v, np.asarray(nums, dtype=np.float64)) if nums else np.zeros(len(v), dtype=bool)
    s = set(vals)
    return np.fromiter((x in s for x in v.tolist()), bool, len(v))


def eval_filter(f: ast.FilterExpr, fields: list[L.Field], blk: Block) -> np.ndarray:
    n = len(blk)
    if isinstance(f, ast.And):
        m = eval_filter(f.children[0], fields, blk)
        for c in f.children[1:]:
            m = m & eval_filter(c, fields, blk)
        return m
    if isinstance(f, ast.Or):
        m = eval_filter(f.children[0], fields, blk)
        for c in f.children[1:]:
            m = m | eval_filter(c, fields, blk)
        return m
    if isinstance(f, ast.Not):
        return ~eval_filter(f.child, fields, blk)
    if isinstance(f, ast.Compare):
        l = eval_expr(f.left, fields, blk)
        r = eval_expr(f.right, fields, blk)
        if l.dtype == object or r.dtype == object:
            # a NULL comparison is unknown: the row is filtered. Object
            # columns only, so a stored NaN DOUBLE keeps IEEE semantics
            na = isna(l) | isna(r)
            if na.any():
                out = np.zeros(n, dtype=bool)
                keep = ~na
                with np.errstate(invalid="ignore"):
                    out[keep] = np.asarray(_CMPS[f.op](l[keep], r[keep])).astype(bool)
                return out
        with np.errstate(invalid="ignore"):
            return np.asarray(_CMPS[f.op](l, r)).astype(bool)
    if isinstance(f, ast.DistinctFrom):
        l = eval_expr(f.left, fields, blk)
        r = eval_expr(f.right, fields, blk)
        nl, nr = isna(l), isna(r)
        with np.errstate(invalid="ignore"):
            neq = np.asarray(l != r, dtype=bool)
        m = (neq & ~nl & ~nr) | (nl ^ nr)
        return ~m if f.negated else m
    if isinstance(f, ast.Between):
        v = eval_expr(f.expr, fields, blk)
        lo = eval_expr(f.low, fields, blk)
        hi = eval_expr(f.high, fields, blk)
        with np.errstate(invalid="ignore"):
            m = np.asarray((v >= lo) & (v <= hi), dtype=bool)
        return ~m if f.negated else m
    if isinstance(f, ast.In):
        v = eval_expr(f.expr, fields, blk)
        m = _isin(v, [x.value for x in f.values if isinstance(x, ast.Literal)])
        return ~m if f.negated else m
    if isinstance(f, ast.Like):
        from pinot_tpu_torch.query.plan import _like_to_regex

        rx = re.compile(_like_to_regex(f.pattern))
        v = eval_expr(f.expr, fields, blk)
        m = np.fromiter((rx.fullmatch(str(x)) is not None for x in v.tolist()), bool, n)
        return ~m if f.negated else m
    if isinstance(f, ast.RegexpLike):
        rx = re.compile(f.pattern)
        v = eval_expr(f.expr, fields, blk)
        return np.fromiter((rx.search(str(x)) is not None for x in v.tolist()), bool, n)
    if isinstance(f, ast.IsNull):
        m = isna(eval_expr(f.expr, fields, blk))
        return ~m if f.negated else m
    raise L.PlanV2Error(f"unsupported filter {f}")


# ---------------------------------------------------------------------------
# Key normalization + hashing (consistent across both join sides)
# ---------------------------------------------------------------------------


def _norm_key(col: np.ndarray) -> np.ndarray:
    # all numerics widen to double so INT = DOUBLE joins hash / compare equal
    # on both sides (Pinot widens numeric comparisons the same way)
    if col.dtype.kind in "iubf":
        return col.astype(np.float64)
    return _objects([x if _is_missing(x) else str(x) for x in col.tolist()])


def _key_cols(exprs: list[ast.Expr], fields: list[L.Field], blk: Block) -> list[np.ndarray]:
    return [_norm_key(eval_expr(e, fields, blk)) for e in exprs]


def _hash_partition(keys: list[np.ndarray], n: int) -> np.ndarray:
    """Worker of each row: a deterministic hash of its normalized keys, so
    equal keys on both join sides route to one worker (missing keys hash as
    0, -0.0 as 0.0)."""
    from pinot_tpu_torch.query.sketches import hash_any, murmur_mix32

    n_rows = len(keys[0]) if keys else 0
    if n == 1 or n_rows == 0:
        return np.zeros(n_rows, dtype=np.int64)
    h = np.zeros(n_rows, dtype=np.uint32)
    for k in keys:
        if k.dtype.kind == "f":
            k = np.where(np.isnan(k) | (k == 0.0), 0.0, k)
        else:
            k = _objects([0 if _is_missing(x) else x for x in k.tolist()])
        h = murmur_mix32(h * np.uint32(31) ^ hash_any(k))
    return (h % np.uint32(n)).astype(np.int64)


# ---------------------------------------------------------------------------
# Device paths for intermediate operators (SortOperator / LookupJoinOperator
# parity): engaged for large numeric blocks, numpy otherwise. Counters let
# tests assert which path ran.
# ---------------------------------------------------------------------------

#: minimum rows before a device dispatch beats the host (sync overhead)
DEVICE_SORT_MIN = 1 << 16
DEVICE_JOIN_MIN = 1 << 16

DEVICE_OP_STATS = {"sort": 0, "join": 0, "window": 0}


def sorted_block(blk: Block, by: list[int], descs: list[bool], device="cuda") -> tuple[Block, np.ndarray]:
    """(the block sorted by columns `by`, its permutation): a stable
    multi-key sort on the device above DEVICE_SORT_MIN and the host's
    nulls-largest sort otherwise — the ONE sort the Sort node and the window
    operator share."""
    perm = None
    if len(blk) >= DEVICE_SORT_MIN:
        perm = _device_sort_perm([blk.cols[c] for c in by], descs, device)
    if perm is None:
        from pinot_tpu_torch.common.sorting import sort_nulls_largest

        perm = sort_nulls_largest([blk.cols[c] for c in by], [not d for d in descs])
    return blk.take(perm), perm


def _device_scan_economical(
    ship_bytes: int, readback_bytes: int, host_cost_s: float, round_trips: int = 2, device="cuda"
) -> bool:
    """THE economic gate for device intermediate ops that ship whole columns
    and read results back (sort perms, window scans, join probes): the
    modeled link cost must beat the host cost. Callers run their cheap
    dtype / shape rejections FIRST: pricing the link triggers the one-time
    devlink probe."""
    from pinot_tpu_torch.common.devlink import transfer_cost_s

    return transfer_cost_s(ship_bytes + readback_bytes, round_trips=round_trips, device=device) <= host_cost_s


def _stable_lexsort(keys: list[torch.Tensor]) -> torch.Tensor:
    """np.lexsort's permutation (the LAST key primary) by stable sorts from
    the least significant key."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in keys:
        perm = perm[torch.argsort(k[perm], stable=True)]
    return perm


def _device_sort_perm(keys: list[np.ndarray], descs: list[bool], device="cuda") -> "np.ndarray | None":
    """Stable multi-key sort permutation computed on the device. Returns None
    when a key is non-numeric or float-with-NaN (the host's NaN-last order
    differs) — the caller sorts on the host. DESC uses lossless monotone
    flips: bitwise NOT for ints, negation for floats."""
    prepped = []
    for v, desc in zip(keys, descs):
        if not np.issubdtype(v.dtype, np.number):
            return None
        if np.issubdtype(v.dtype, np.floating):
            if np.isnan(v).any():
                return None
            prepped.append(-v if desc else v)
        else:
            prepped.append(~v if desc else v)
    n = len(keys[0]) if keys else 0
    ship = sum(k.nbytes for k in keys)
    # host mergesort ~ 150ns/row/key; the permutation reads back as int64
    if not _device_scan_economical(ship, 8 * n, 150e-9 * n * max(1, len(keys)) + 2e-3, device=device):
        return None
    perm = _stable_lexsort([torch.from_numpy(np.ascontiguousarray(k)).to(device) for k in reversed(prepped)])
    DEVICE_OP_STATS["sort"] += 1
    return perm.cpu().numpy()


def _segmented_scan(op, start: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of `op` restarting at every set `start` flag, in
    log-step passes: after the pass at distance d each row holds op over the
    (up to 2d) rows ending at it within its partition. Exact for min / max
    and integer sums."""
    f, v = start.clone(), vals.clone()
    n = v.shape[0]
    d = 1
    while d < n:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        nf = f[d:] | f[:-d]
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], nf])
        d *= 2
    return v


def _device_window_cum(fname: str, gk: np.ndarray, v: "np.ndarray | None", n: int, device="cuda") -> "np.ndarray | None":
    """Segmented cumulative window aggregate on the device (rows pre-sorted
    by (partition, order), so partitions are contiguous): running SUM / MIN /
    MAX / COUNT / AVG / ROW_NUMBER with a reset at every partition boundary
    (WindowAggregateOperator parity for the default UNBOUNDED PRECEDING ..
    CURRENT ROW frame). Returns None below the size threshold or for
    non-numeric / NaN inputs (the host's skip-NaN cumulative semantics
    differ) — the host path takes over."""
    if n < DEVICE_SORT_MIN or fname not in ("sum", "avg", "count", "min", "max", "row_number"):
        return None
    if v is not None:
        if not np.issubdtype(v.dtype, np.number):
            return None
        if np.issubdtype(v.dtype, np.floating) and np.isnan(v).any():
            return None
    # host groupby-cumsum ~ 80ns/row; ship keys + values, read one vector back
    ship = gk.nbytes + (v.nbytes if v is not None else 0)
    if not _device_scan_economical(ship, 8 * n, 80e-9 * n + 2e-3, device=device):
        return None
    g = torch.from_numpy(np.ascontiguousarray(gk)).to(device)
    start = torch.cat([torch.ones(1, dtype=torch.bool, device=device), g[1:] != g[:-1]])
    add = torch.add
    if fname in ("row_number", "count"):
        out = _segmented_scan(add, start, torch.ones(n, dtype=torch.int64, device=device))
    else:
        vd = torch.from_numpy(np.ascontiguousarray(v)).to(device)
        if fname == "sum":
            # integer values widen to int64 as a groupby cumsum does (an int32
            # running sum would wrap past 2^31)
            out = _segmented_scan(add, start, vd.to(torch.int64) if not vd.is_floating_point() else vd)
        elif fname == "avg":
            s = _segmented_scan(add, start, vd.to(torch.float64))
            c = _segmented_scan(add, start, torch.ones(n, dtype=torch.float64, device=device))
            out = s / c
        elif fname == "min":
            out = _segmented_scan(torch.minimum, start, vd)
        else:
            out = _segmented_scan(torch.maximum, start, vd)
    DEVICE_OP_STATS["window"] += 1
    return out.cpu().numpy()


#: pair-count blowup guard for device equi-joins (many-to-many keys)
DEVICE_JOIN_MAX_PAIRS = 1 << 25


def _infer_numeric(cells: np.ndarray) -> bool:
    """Every cell an actual number (pandas infer_dtype in integer / floating
    / mixed-integer-float)."""
    return len(cells) > 0 and all(
        isinstance(x, (int, float, np.integer, np.floating)) and not isinstance(x, (bool, np.bool_))
        for x in cells.tolist()
    )


def _join_key_pair(ls: np.ndarray, rs: np.ndarray) -> "tuple[np.ndarray, np.ndarray] | None":
    """Project one join-key column pair onto a COMMON comparable dtype:
    numeric when both sides hold numbers (object cells coerce back to
    float), text when both hold text. Returns None for cross-kind pairs (int
    vs str) so equality matches the host merge: a stringified compare would
    drop 1 vs 1.0 matches and invent 1 vs "1" ones. Null cells may come out
    as NaN; callers mask them with the l_null / r_null sentinels."""

    def as_numeric(v: np.ndarray) -> "np.ndarray | None":
        if v.dtype != object and np.issubdtype(v.dtype, np.number):
            return v
        if v.dtype == object:
            cells = v[~isna(v)]
            if _infer_numeric(cells):
                return _as_f64(v)
        return None

    ln, rn = as_numeric(ls), as_numeric(rs)
    if ln is not None and rn is not None:
        return ln, rn
    if ln is not None or rn is not None:
        return None  # one side numeric, the other text

    def as_str(v: np.ndarray) -> "np.ndarray | None":
        if v.dtype == object:
            cells = v[~isna(v)]
            if len(cells) and not all(isinstance(x, str) for x in cells.tolist()):
                return None  # mixed-content object column: don't stringify
        null = isna(v)
        return np.asarray(["" if m else str(x) for x, m in zip(v.tolist(), null)], dtype=str)

    lstr, rstr = as_str(ls), as_str(rs)
    if lstr is None or rstr is None:
        return None
    return lstr, rstr


def _encode_join_keys(
    lk: list, rk: list, l_null: np.ndarray, r_null: np.ndarray
) -> "tuple[np.ndarray, np.ndarray] | None":
    """Combine N join-key columns into ONE int64 code per row on each side —
    the dictionary-id analog for intermediate blocks, so ANY equi-join
    (multi-key, text keys) rides the device probe.

    Per key: one joint np.unique over both sides gives dense codes equal iff
    the values are equal across sides; codes fold together by cardinality
    strides with a re-compression after every fold (post-compression
    cardinality <= n_l + n_r < 2^31, so the product never overflows int64).
    Null-key rows get sentinel codes that never match. Returns None when a
    key's dtypes can't be joined (mixed int / text object columns)."""
    lcodes: np.ndarray | None = None
    rcodes: np.ndarray | None = None
    for lc_, rc_ in zip(lk, rk):
        pair = _join_key_pair(lc_, rc_)
        if pair is None:
            return None
        lv, rv = pair
        both = np.concatenate([lv, rv])
        both = np.nan_to_num(both) if both.dtype.kind == "f" else both
        _, codes = np.unique(both, return_inverse=True)
        codes = codes.reshape(-1).astype(np.int64)
        card = int(codes.max()) + 1 if len(codes) else 1
        lc, rc = codes[: len(lv)], codes[len(lv) :]
        if lcodes is None:
            lcodes, rcodes = lc, rc
        else:
            comb = np.concatenate([lcodes, rcodes]) * card + codes
            _, comp = np.unique(comb, return_inverse=True)
            comp = comp.reshape(-1).astype(np.int64)
            lcodes, rcodes = comp[: len(lv)], comp[len(lv) :]
    # null keys never match anything (not even other nulls)
    lcodes = np.where(l_null, np.int64(-1), lcodes)
    rcodes = np.where(r_null, np.int64(-2), rcodes)
    return lcodes, rcodes


def _device_join_economical(lk: np.ndarray, rk: np.ndarray, device="cuda") -> bool:
    """Whether shipping both key vectors plus the per-row index readback over
    the measured device link beats a host hash join (~70ns/input row)."""
    readback = 8 * len(lk)  # lo + count index vectors, int32 each
    host_cost = 70e-9 * (len(lk) + len(rk)) + 2e-3
    return _device_scan_economical(lk.nbytes + rk.nbytes, readback, host_cost, round_trips=8, device=device)


def _device_equi_join(
    lk: np.ndarray, rk: np.ndarray, force: bool = False, device="cuda", mesh=None
) -> "tuple[np.ndarray, np.ndarray] | None":
    """General inner equi-join on a numeric key: the hash exchange across
    `mesh`'s slots first (an integer or float64 key), else a direct-address
    or sort+searchsorted probe on `device`, then one vectorized host
    expansion of the match ranges. Handles duplicate build keys. Returns
    (left row indices, right row indices) of matched pairs, or None when
    dtypes / NaNs / the pair count don't fit — or when the measured device
    link makes shipping both sides and reading the indices back slower than
    a host hash join. `force` skips that economic gate."""
    if not (np.issubdtype(lk.dtype, np.number) and np.issubdtype(rk.dtype, np.number)):
        return None
    if not force and not _device_join_economical(lk, rk, device):
        return None
    if (np.issubdtype(lk.dtype, np.floating) and np.isnan(lk).any()) or (
        np.issubdtype(rk.dtype, np.floating) and np.isnan(rk).any()
    ):
        return None
    if len(rk) == 0:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.int64)
    if mesh is not None and (
        (np.issubdtype(lk.dtype, np.integer) and np.issubdtype(rk.dtype, np.integer))
        or (lk.dtype == np.float64 and rk.dtype == np.float64)
    ):
        # the same-mesh HASH exchange tier: repartition both sides by key
        # across the slots and probe per slot. Declines (None) on duplicate
        # build keys or a one-slot mesh; the one-device probe then runs.
        # NaN-free float64 keys bitcast to int64, which keeps equality
        # exactly (-0.0 normalized to +0.0 first).
        from pinot_tpu_torch.parallel import shuffle

        if lk.dtype == np.float64:
            mk_l = np.where(lk == 0.0, 0.0, lk).view(np.int64)
            mk_r = np.where(rk == 0.0, 0.0, rk).view(np.int64)
        else:
            mk_l, mk_r = lk, rk
        mesh_out = shuffle.mesh_equi_join(mk_l, mk_r, mesh)
        if mesh_out is None:
            # the unique-key (build) side may be the LEFT one: probe the
            # other way around and swap the pairs back
            swapped = shuffle.mesh_equi_join(mk_r, mk_l, mesh)
            if swapped is not None:
                mesh_out = (swapped[1], swapped[0])
        if mesh_out is not None:
            DEVICE_OP_STATS["join"] += 1
            DEVICE_OP_STATS["mesh_join"] = DEVICE_OP_STATS.get("mesh_join", 0) + 1
            li, ri = mesh_out
            return li.astype(np.int64), ri.astype(np.int64)
    order = np.argsort(rk, kind="stable")
    srk = rk[order]
    # direct addressing needs BOTH sides integral: a float probe key would
    # truncate through the index cast and match the wrong slot
    span = (
        int(srk[-1]) - int(srk[0]) + 1
        if len(srk) and np.issubdtype(srk.dtype, np.integer) and np.issubdtype(lk.dtype, np.integer)
        else 0
    )
    if 0 < span <= max(16 * len(srk), 1 << 20) and span <= (1 << 25):
        # bounded-span integer keys: a direct-address probe. A scatter-min
        # and a scatter-add build (first index, count) tables over the key
        # span and two gathers probe them: int32 readbacks, no binary search
        rmin, rmax = int(srk[0]), int(srk[-1])
        j_lk = torch.from_numpy(np.ascontiguousarray(lk)).to(device).to(torch.int64)
        j_keys = torch.from_numpy(srk).to(device).to(torch.int64) - rmin
        pos = torch.arange(len(srk), dtype=torch.int32, device=device)
        lo_t = torch.full((span,), len(srk), dtype=torch.int32, device=device)
        lo_t.scatter_reduce_(0, j_keys, pos, "amin", include_self=True)
        cnt_t = torch.zeros(span, dtype=torch.int32, device=device)
        cnt_t.index_add_(0, j_keys, torch.ones(len(srk), dtype=torch.int32, device=device))
        valid = (j_lk >= rmin) & (j_lk <= rmax)
        idx = torch.clamp(j_lk - rmin, 0, span - 1)
        lo = lo_t[idx].cpu().numpy().astype(np.int64)
        # masked on the device: ONE int32 counts readback
        counts = torch.where(valid, cnt_t[idx], 0).cpu().numpy().astype(np.int64)
    else:
        kdt = np.promote_types(lk.dtype, srk.dtype)
        j_srk = torch.from_numpy(np.ascontiguousarray(srk.astype(kdt))).to(device)
        j_lk = torch.from_numpy(np.ascontiguousarray(lk.astype(kdt))).to(device)
        lo = torch.searchsorted(j_srk, j_lk, side="left").cpu().numpy()
        hi = torch.searchsorted(j_srk, j_lk, side="right").cpu().numpy()
        counts = hi - lo
    total = int(counts.sum())
    if total > DEVICE_JOIN_MAX_PAIRS:
        return None  # many-to-many blowup: the host hash join handles it
    lidx, ridx = _expand_ranges(lo, counts, order)
    DEVICE_OP_STATS["join"] += 1
    return lidx, ridx


def _expand_ranges(lo: np.ndarray, counts: np.ndarray, order: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Each left row i with its counts[i] right matches order[lo[i] ...]: the
    (left, right) pairs in left order, each left row's in right order."""
    total = int(counts.sum())
    lidx = np.repeat(np.arange(len(lo), dtype=np.int64), counts)
    starts = np.repeat(lo, counts)
    offs = np.arange(total, dtype=np.int64) - np.repeat(np.cumsum(counts) - counts, counts)
    return lidx, order[starts + offs]


# ---------------------------------------------------------------------------
# Host relational primitives (pandas' semantics)
# ---------------------------------------------------------------------------


def _joint_codes(left: list, right: list) -> tuple[np.ndarray, np.ndarray]:
    """One int64 code per row of each side, equal iff the rows' values are
    equal across the sides (missing values equal each other, as pandas'
    merge and drop_duplicates treat them)."""
    nl = len(left[0]) if left else 0
    if not left:
        return np.zeros(nl, dtype=np.int64), np.zeros(len(right[0]) if right else 0, dtype=np.int64)
    cols = [_concat_cols([a, b]) for a, b in zip(left, right)]
    group, _ = group_index(cols)
    return group[:nl], group[nl:]


def merge_inner(lkeys: list, rkeys: list) -> tuple[np.ndarray, np.ndarray]:
    """pd.merge(how="inner") of two key sets: the (left, right) row pairs in
    left order, each left row's matches in right order."""
    lcode, rcode = _joint_codes(lkeys, rkeys)
    order = np.argsort(rcode, kind="stable")
    srk = rcode[order]
    lo = np.searchsorted(srk, lcode, side="left")
    hi = np.searchsorted(srk, lcode, side="right")
    return _expand_ranges(lo, hi - lo, order)


def _member(lkeys: list, rkeys: list) -> np.ndarray:
    """Whether each left row's values occur among the right rows."""
    lcode, rcode = _joint_codes(lkeys, rkeys)
    return np.isin(lcode, rcode)


def _first_rows(cols: list) -> np.ndarray:
    """drop_duplicates(): the first row of each distinct value tuple, in
    order."""
    if not cols or not len(cols[0]):
        return np.zeros(0, dtype=np.int64)
    _, first = group_index(cols)
    return np.sort(first)


def _cumcount(group: np.ndarray) -> np.ndarray:
    """groupby().cumcount(): each row's rank within its group, in row order."""
    out = np.empty(len(group), dtype=np.int64)
    order = np.argsort(group, kind="stable")
    g = group[order]
    starts = np.r_[0, np.flatnonzero(g[1:] != g[:-1]) + 1]
    run_start = np.repeat(starts, np.diff(np.r_[starts, len(g)]))
    out[order] = np.arange(len(g)) - run_start
    return out


def _grouped(keys: list) -> tuple[np.ndarray, np.ndarray, int]:
    """(group of each row, first row of each group, number of groups) by
    first appearance, missing keys a group of their own."""
    group, first = group_index(keys)
    return group, first, len(first)


def _group_members(group: np.ndarray, n_groups: int) -> list[np.ndarray]:
    """Each group's row positions, in row order."""
    order = np.argsort(group, kind="stable")
    bounds = np.searchsorted(group[order], np.arange(n_groups + 1))
    return [order[bounds[g] : bounds[g + 1]] for g in range(n_groups)]


# ---------------------------------------------------------------------------
# Aggregation over blocks
# ---------------------------------------------------------------------------


def _numeric_cells(col: np.ndarray) -> np.ndarray:
    """A column as numbers for the numeric reducers: object cells coerce, as
    pandas reduces object columns of numbers."""
    return _to_numeric(col) if col.dtype == object else col


def _text_column(col: np.ndarray) -> bool:
    if col.dtype != object:
        return False
    cells = [x for x in col.tolist() if not _is_missing(x)]
    return bool(cells) and all(isinstance(x, str) for x in cells)


def _reduce_values(func: str, vals: np.ndarray, extra: tuple):
    """One group's (or the whole column's) pandas reduction, missing values
    skipped: sum / min / max / mean / nunique / minmaxrange / quantile /
    mode; NaN where nothing is left (sum: min_count=1)."""
    if func in ("min", "max") and _text_column(vals):
        cells = [x for x in vals.tolist() if not _is_missing(x)]
        return (min if func == "min" else max)(cells) if cells else np.nan
    if func in ("distinctcount", "distinctcountbitmap", "distinctcounthll"):
        cells = vals[~isna(vals)]
        return len(set(cells.tolist()))
    v = _numeric_cells(vals)
    if v.dtype.kind == "f":
        v = v[~np.isnan(v)]
    if len(v) == 0:
        return np.nan
    if func == "sum":
        return v.sum()
    if func == "min":
        return v.min()
    if func == "max":
        return v.max()
    if func == "avg":
        return v.astype(np.float64).mean()
    if func == "minmaxrange":
        return v.max() - v.min()
    if func in ("percentile", "percentileest", "percentiletdigest"):
        return float(np.quantile(v.astype(np.float64), extra[0] / 100.0))
    if func == "mode":
        uniq, cnt = np.unique(v, return_counts=True)
        return float(uniq[np.argmax(cnt)])
    raise L.PlanV2Error(f"unsupported aggregation {func} in multistage runtime")


def _agg_groups(func: str, members: list, vals: "np.ndarray | None", extra: tuple, vals2: "np.ndarray | None" = None):
    """The aggregation over each group (row positions in `members`): the
    reference's `_agg_series` over a groupby(sort=False)."""
    from pinot_tpu_torch.query.aggregates import EXT_AGGS

    if func in EXT_AGGS:
        spec = EXT_AGGS[func]
        return _column(
            [
                spec.finalize(spec.compute(vals[m], None if vals2 is None else vals2[m], extra), extra)
                for m in members
            ]
        )
    if func == "count":
        return np.asarray([len(m) for m in members], dtype=np.int64)
    if func == "sum":
        v = _numeric_cells(vals)
        if v.dtype.kind in "iub":
            return np.asarray([v[m].sum() for m in members], dtype=np.int64)
    return _column([_reduce_values(func, vals[m], extra) for m in members])


def _agg_scalar(func: str, s: "np.ndarray | None", extra: tuple, s2: "np.ndarray | None" = None):
    from pinot_tpu_torch.query.aggregates import EXT_AGGS

    if func in EXT_AGGS:
        spec = EXT_AGGS[func]
        return spec.finalize(spec.compute(s, s2, extra), extra)
    if func == "count":
        return len(s)
    if len(s) == 0:
        return np.nan
    if func == "sum":
        v = _numeric_cells(s)
        return (v[~np.isnan(v)] if v.dtype.kind == "f" else v).sum()  # skipna: an all-NaN sum is 0.0
    return _reduce_values(func, s, extra)


# ---------------------------------------------------------------------------
# Node execution
# ---------------------------------------------------------------------------


@dataclass
class RunCtx:
    stage: L.Stage
    worker: int
    mailbox: MailboxService
    stages: dict[int, L.Stage]
    segments: dict[str, list]  # table -> segments
    n_senders: dict[int, int]  # stage id -> parallelism
    # this worker's segment dict already holds ONLY its share, so Scan takes
    # all of them instead of modulo-splitting by worker index
    scan_local_all: bool = False
    # per-query SET options (threaded from StagePlan.options)
    options: dict = dfield(default_factory=dict)
    # per-operator runtime stats accumulator (None = collection disabled)
    stats: StageStatsCollector | None = None
    # where the leaf programs and the device operators run, and the slots the
    # equi-join's hash exchange spans
    device: str = "cuda"
    mesh: object = None


def _leaf_filter_mask(seg, filt, null_on: bool = False, stats=None, node=None, device="cuda") -> np.ndarray:
    """Leaf Scan filter as the single-stage engine's `mask` program on the
    device (LeafStageTransferableBlockOperator.java:87 parity). Falls back
    to the host evaluator for host-only predicates; each side is counted in
    server metrics, and with a StageStatsCollector the device time or the
    fallback is attributed to the owning Scan operator."""
    from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics
    from pinot_tpu_torch.query.kernels import build_fn, plan_inputs
    from pinot_tpu_torch.query.plan import DeviceFallback, PlanError, plan_filter_mask

    t0 = _time.perf_counter() if stats is not None else 0.0
    try:
        # null_on lowers nullable-column predicates to the Kleene tree
        plan = plan_filter_mask(seg, filt, kleene=null_on)
        ds = seg.to_device_cached(device)
        cols, ops = plan_inputs(plan, ds)
        mask = build_fn(plan.spec)(cols, ops, ds.n_docs, ds.padded)[: seg.n_docs].cpu().numpy()
    except (DeviceFallback, PlanError):
        server_metrics().meter(ServerMeter.DEVICE_FALLBACKS).mark()
        if stats is not None:
            stats.add_fallback(node)
        return host_exec.filter_mask_null_aware(seg, filt) if null_on else host_exec.filter_mask(seg, filt)
    server_metrics().meter(ServerMeter.MULTISTAGE_LEAF_DEVICE_SCANS).mark()
    if stats is not None:
        stats.add_device(node, (_time.perf_counter() - t0) * 1e3)
    return mask


def exec_node(node: L.Node, ctx: RunCtx) -> Block:
    """Stats-instrumented dispatch: with a collector, each operator's rows /
    blocks / wall time is recorded around the real execution
    (MultiStageOperator.registerExecution parity)."""
    # operator block boundary = the deadline / cancel enforcement point
    dl = ctx.mailbox.deadline
    if dl is not None:
        dl.check(type(node).__name__)
    st = ctx.stats
    if st is None:
        return _exec_node(node, ctx)
    t0 = _time.perf_counter()
    blk = _exec_node(node, ctx)
    st.record_exec(
        node,
        len(blk),
        (_time.perf_counter() - t0) * 1e3,
        blocks=0 if isinstance(node, L.StageInput) else 1,
    )
    return blk


def _scan(node: L.Scan, ctx: RunCtx) -> Block:
    from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
    from pinot_tpu_torch.common.trace import trace_event
    from pinot_tpu_torch.query.context import null_handling_enabled
    from pinot_tpu_torch.segment.segment import bm_to_bool

    null_on = null_handling_enabled(ctx.options)
    segs = ctx.segments.get(node.table, [])
    mine = segs if ctx.scan_local_all else segs[ctx.worker :: ctx.stage.parallelism]
    frames = []
    for seg in mine:
        if ctx.mailbox.deadline is not None:
            ctx.mailbox.deadline.check(f"scan {seg.name}")
        try:
            FAULTS.maybe_fail("segment.execute")
        except InjectedFault:
            trace_event("fault.injected", point="segment.execute", segment=seg.name)
            raise
        mask = (
            _leaf_filter_mask(seg, node.filter, null_on=null_on, stats=ctx.stats, node=node, device=ctx.device)
            if node.filter is not None
            else None
        )
        valid = seg.extras.get("valid_docs")
        if valid is not None:
            vm = valid(seg.n_docs)
            mask = vm if mask is None else (mask & vm)
        cols = []
        for col in node.columns:
            v = seg.columns[col].materialize()
            if v.dtype.kind in "US":
                v = v.astype(object)  # text is an object column, as in a DataFrame
            if null_on:
                nv = (seg.extras or {}).get("null", {}).get(col)
                if nv is not None:
                    nm = bm_to_bool(nv, seg.n_docs)
                    v = v.astype(object)
                    v[nm] = None  # None cells, not stored placeholders
            cols.append(v[mask] if mask is not None else v)
        frames.append(Block(cols))
    if not frames:
        return _empty_block(len(node.fields))
    return concat_blocks(frames)


def _exec_node(node: L.Node, ctx: RunCtx) -> Block:
    if isinstance(node, L.StageInput):
        blocks = ctx.mailbox.receive_all(
            ctx.stage.id,
            ctx.worker,
            node.stage_id,
            ctx.n_senders[node.stage_id],
            stats_out=ctx.stats.upstream if ctx.stats is not None else None,
        )
        if ctx.stats is not None:
            ctx.stats.add_blocks(node, len(blocks))  # blocks received, not emitted
        blocks = [b for b in blocks if len(b)]
        if not blocks:
            return _empty_block(len(node.fields))
        return concat_blocks(blocks)

    if isinstance(node, L.Scan):
        return _scan(node, ctx)

    if isinstance(node, L._RootCollect):
        return exec_node(node.input, ctx)

    if isinstance(node, L.FilterNode):
        blk = exec_node(node.input, ctx)
        if not len(blk):
            return blk
        return blk.take(eval_filter(node.condition, node.input.fields, blk))

    if isinstance(node, L.Project):
        blk = exec_node(node.input, ctx)
        return Block([eval_expr(e, node.input.fields, blk) for e in node.exprs])

    if isinstance(node, L.Rename):
        return exec_node(node.input, ctx).head_cols(node.n_visible)

    if isinstance(node, L.Aggregate):
        return _exec_aggregate(node, ctx)

    if isinstance(node, L.Distinct):
        blk = exec_node(node.input, ctx)
        return blk.take(_first_rows(blk.cols))

    if isinstance(node, L.Join):
        return _exec_join(node, ctx)

    if isinstance(node, L.WindowNode):
        return _exec_window(node, ctx)

    if isinstance(node, L.Sort):
        blk = exec_node(node.input, ctx)
        if node.keys and len(blk):
            blk, _ = sorted_block(blk, [k for k, _ in node.keys], [d for _, d in node.keys], ctx.device)
        if node.offset or node.limit is not None:
            end = None if node.limit is None else node.offset + node.limit
            blk = blk.slice(node.offset, end)
        if node.drop_hidden_after is not None:
            blk = blk.head_cols(node.drop_hidden_after)
        return blk

    if isinstance(node, L.SetOp):
        return _exec_setop(node, ctx)

    raise L.PlanV2Error(f"cannot execute node {type(node).__name__}")


def _exec_setop(node: L.SetOp, ctx: RunCtx) -> Block:
    l = exec_node(node.left, ctx)
    r = exec_node(node.right, ctx)
    if node.kind == "union":
        out = concat_blocks([l, r])
        return out if node.all else out.take(_first_rows(out.cols))
    if node.all:
        # bag semantics via per-duplicate ordinals: the k-th copy on the left
        # pairs with the k-th copy on the right
        def with_ord(b: Block) -> list:
            if not len(b):
                return b.cols + [np.zeros(0, dtype=np.int64)]
            group, _, _ = _grouped(b.cols)
            return b.cols + [_cumcount(group)]

        hit = _member(with_ord(l), with_ord(r)) if len(l) else np.zeros(0, dtype=bool)
        return l.take(hit if node.kind == "intersect" else ~hit)
    lu = l.take(_first_rows(l.cols))
    ru = r.take(_first_rows(r.cols))
    hit = _member(lu.cols, ru.cols) if len(lu) else np.zeros(0, dtype=bool)
    return lu.take(hit if node.kind == "intersect" else ~hit)


_FILTERED_AGGS = {"count", "sum", "min", "max", "avg"}


def _exec_aggregate(node: L.Aggregate, ctx: RunCtx) -> Block:
    from pinot_tpu_torch.query.context import null_handling_enabled

    null_on = null_handling_enabled(ctx.options)
    if node.mode == "partial":
        # leaf pattern first: Scan input + plain-column keys / args runs the
        # single-stage engine WITHOUT materializing scan rows
        t0 = _time.perf_counter() if ctx.stats is not None else 0.0
        leaf = _try_leaf_device_partial(node, ctx)
        if leaf is not None:
            if ctx.stats is not None:
                ctx.stats.add_device(node, (_time.perf_counter() - t0) * 1e3)
            return leaf
        return _exec_partial_aggregate(node, exec_node(node.input, ctx), null_on)
    if node.mode == "final":
        return _exec_final_aggregate(node, exec_node(node.input, ctx), null_on)
    blk = exec_node(node.input, ctx)
    infields = node.input.fields
    n_groups = len(node.group_exprs)
    if n_groups == 0:
        row = []
        for a in node.aggs:
            sub = blk
            if a.filter is not None and len(blk):
                sub = blk.take(np.asarray(eval_filter(a.filter, infields, blk), bool))
            s = eval_expr(a.arg, infields, sub) if a.arg is not None else np.zeros(len(sub))
            s2 = eval_expr(a.arg2, infields, sub) if a.arg2 is not None else None
            if null_on and a.arg is not None and a.func in ("count", "sum", "min", "max", "avg", "minmaxrange"):
                s = s[~isna(s)]  # null handling: aggregate non-null cells only
            if null_on and a.func == "sum" and len(s) == 0:
                row.append(None)  # all-null / empty SUM -> NULL
                continue
            row.append(_agg_scalar(a.func, s, a.extra, s2))
        return Block([_column([v]) for v in row])
    if not len(blk):
        return _empty_block(len(node.fields))
    keys = [eval_expr(g, infields, blk) for g in node.group_exprs]
    group, first, ng = _grouped(keys)
    members = _group_members(group, ng)
    outs = [k[first] for k in keys]
    for a in node.aggs:
        fm = None
        if a.filter is not None:
            if a.func not in _FILTERED_AGGS:
                raise L.PlanV2Error(f"FILTER(WHERE) on {a.func} inside GROUP BY is not supported")
            fm = np.asarray(eval_filter(a.filter, infields, blk), bool)
        if a.func == "count":
            # the indicator folds in FILTER; under enableNullHandling
            # COUNT(col) counts non-null cells only
            ind = fm if fm is not None else np.ones(len(blk), dtype=bool)
            if a.arg is not None and null_on:
                ind = ind & ~isna(eval_expr(a.arg, infields, blk))
            outs.append(np.bincount(group, weights=ind, minlength=ng).astype(np.int64))
            continue
        v = eval_expr(a.arg, infields, blk) if a.arg is not None else None
        if fm is not None:
            # excluded rows -> NaN; the reducers skip them
            v = np.where(fm, _as_f64(v), np.nan)
        w = eval_expr(a.arg2, infields, blk) if a.arg2 is not None else None
        s = _agg_groups(a.func, members, v, a.extra, w)
        if a.filter is not None and a.func in ("min", "max"):
            # all-NaN groups (FILTER matched no rows): the +/-inf sentinels
            # of the host path and the device kernel
            s = np.where(np.isnan(s), np.inf if a.func == "min" else -np.inf, s)
        outs.append(s)
    return Block(outs)


def _try_leaf_device_partial(node: L.Aggregate, ctx: RunCtx) -> "Block | None":
    """PartialAggregate directly over a Scan with plain-column keys / args:
    the single-stage engine over the worker's segments on the engine's
    device (LeafStageTransferableBlockOperator.java:87 parity — the leaf
    stage IS the single-stage engine), its mergeable group frames the partial
    block. Returns None when the pattern doesn't match (the host partial
    takes over)."""
    scan = node.input
    if not isinstance(scan, L.Scan):
        return None
    for g in node.group_exprs:
        if not isinstance(g, ast.Identifier):
            return None
    for a in node.aggs:
        if a.arg is not None and not isinstance(a.arg, ast.Identifier):
            return None
        if a.arg2 is not None:
            return None
    from pinot_tpu_torch.query.context import QueryContext, QueryType
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.query.plan import DeviceFallback, PlanError
    from pinot_tpu_torch.query.reduce import concat_frames, frame_len, parts_of

    segs = ctx.segments.get(scan.table, [])
    mine = segs if ctx.scan_local_all else segs[ctx.worker :: ctx.stage.parallelism]
    strip = lambda e: ast.Identifier(e.name.split(".", 1)[1]) if "." in e.name else e  # noqa: E731
    aggs = [
        dataclasses.replace(a, arg=strip(a.arg) if isinstance(a.arg, ast.Identifier) else a.arg) for a in node.aggs
    ]
    qctx = QueryContext(
        statement=None,
        table=scan.table,
        query_type=QueryType.GROUP_BY if node.group_exprs else QueryType.AGGREGATION,
        select_items=[],
        aggregations=aggs,
        group_by=[strip(g) for g in node.group_exprs],
        filter=scan.filter,
        having=None,
        order_by=[],
        limit=1 << 30,
        offset=0,
        options=dict(ctx.options),
    )
    qctx.deadline = ctx.mailbox.deadline
    eng = QueryEngine(mine, device=ctx.device)
    try:
        partials, _matched, _scan = eng.partials(qctx, mine)
    except (DeviceFallback, PlanError, NotImplementedError):
        # the planner's declines (a column or type it cannot lower): the host
        # partial takes over. Anything else, a kernel that fails to build or
        # launch included, fails the stage.
        return None
    from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics

    if mine:
        server_metrics().meter(ServerMeter.MULTISTAGE_LEAF_DEVICE_SCANS).mark(len(mine))
    k = len(node.group_exprs)
    if not node.group_exprs:
        # scalar partials: one row of part columns a segment
        rows = []
        for p in partials:
            row = []
            for a, part in zip(node.aggs, p):
                row.extend(part if parts_of(a.func) == 2 else [part])
            rows.append(row)
        if not rows:
            return _empty_block(len(node.fields))
        return Block([_column([r[i] for r in rows]) for i in range(len(node.fields))])
    frames = [f for f in partials if isinstance(f, dict) and frame_len(f)]
    if not frames:
        return _empty_block(len(node.fields))
    out = concat_frames(frames)
    # k0..kN + a{i}p{j} -> positional columns matching node.fields
    order = [f"k{i}" for i in range(k)]
    for i, a in enumerate(node.aggs):
        order.extend(f"a{i}p{j}" for j in range(parts_of(a.func)))
    return Block([out[c] for c in order])


def _exec_partial_aggregate(node: L.Aggregate, blk: Block, null_on: bool = False) -> Block:
    """Host partial over an arbitrary input block: emits the v1 mergeable
    partial layout [keys..., per-agg parts...] (host_exec.group_frame's
    column formats). Under enableNullHandling, COUNT(col) skips null cells
    and SUM emits NaN for all-null input."""
    from pinot_tpu_torch.query.reduce import parts_of

    infields = node.input.fields
    k = len(node.group_exprs)
    if not len(blk):
        return _empty_block(len(node.fields))
    keys = [eval_expr(g, infields, blk) for g in node.group_exprs]
    masks = [np.asarray(eval_filter(a.filter, infields, blk), bool) if a.filter is not None else None for a in node.aggs]
    vals = [eval_expr(a.arg, infields, blk) if a.arg is not None else None for a in node.aggs]

    def partial_cols(idx=None) -> list:
        cols: list = []
        for a, fm, v in zip(node.aggs, masks, vals):
            vv = None if v is None else (v if idx is None else v[idx])
            mm = fm if idx is None else (None if fm is None else fm[idx])
            if vv is not None and mm is not None:
                vv = np.where(mm, _as_f64(vv), np.nan)
            if a.func == "count":
                if null_on and vv is not None:
                    nn = ~isna(vv)  # COUNT(col) skips nulls
                    cols.append(int((nn & mm).sum() if mm is not None else nn.sum()))
                else:
                    cols.append(int(mm.sum()) if mm is not None else (len(blk) if idx is None else len(idx)))
            elif a.func == "sum":
                arr = _as_f64(vv)
                nn = arr[~np.isnan(arr)]
                # NaN partial = "no non-null rows" under null handling
                cols.append(float(nn.sum()) if len(nn) else (float("nan") if null_on else 0.0))
            elif a.func in ("min", "max"):
                arr = _as_f64(vv)
                arr = arr[~np.isnan(arr)]
                if a.func == "min":
                    cols.append(float(arr.min()) if len(arr) else float("inf"))
                else:
                    cols.append(float(arr.max()) if len(arr) else float("-inf"))
            elif a.func == "avg":
                arr = _as_f64(vv)
                cols.append(float(np.nansum(arr)))
                cols.append(int(np.count_nonzero(~np.isnan(arr))))
            elif a.func == "minmaxrange":
                arr = _as_f64(vv)
                arr = arr[~np.isnan(arr)]
                cols.append(float(arr.min()) if len(arr) else float("inf"))
                cols.append(float(arr.max()) if len(arr) else float("-inf"))
            elif a.func in ("distinctcount", "distinctcountbitmap"):
                cols.append(set(vv[~isna(vv)].tolist()))
            elif a.func == "distinctcounthll":
                # registers, the leaf device partial's format
                from pinot_tpu_torch.query.sketches import np_hll_registers

                cols.append(np_hll_registers(vv[~isna(vv)]))
            elif a.func == "percentiletdigest":
                from pinot_tpu_torch.query.aggregates import _td_comp
                from pinot_tpu_torch.query.quantile_sketch import td_from_values

                cols.append(td_from_values(_as_f64(vv[~isna(vv)]), _td_comp(a.extra)))
            else:  # percentile: exact-values partial
                cols.append(_as_f64(vv[~isna(vv)]))
        return cols

    if k == 0:
        return Block([_column([v]) for v in partial_cols()])
    group, first, ng = _grouped(keys)
    rows = [[kc[f] for kc in keys] + partial_cols(m) for f, m in zip(first, _group_members(group, ng))]
    ncols = k + sum(parts_of(a.func) for a in node.aggs)
    return Block([_column([r[i] for r in rows]) for i in range(ncols)])


def _exec_final_aggregate(node: L.Aggregate, blk: Block, null_on: bool = False) -> Block:
    """Merge partial columns per group and finalize. The per-function merge
    is reduce._merge_agg_partials — the SAME table the broker reduce uses —
    so partial formats never drift between the v1 and v2 engines."""
    from functools import reduce as _fold

    from pinot_tpu_torch.query.reduce import _empty_partial, _finalize, _merge_agg_partials, parts_of

    k = len(node.group_exprs)
    if not len(blk):
        if k == 0:
            row = [
                _finalize(a, None if null_on and a.func == "sum" else _empty_partial(a.func, a.extra), null_on)
                for a in node.aggs
            ]
            return Block([_column([v]) for v in row])
        return _empty_block(len(node.fields))

    offs = []
    pos = k
    for a in node.aggs:
        offs.append(pos)
        pos += parts_of(a.func)

    def merge_rows(idx: np.ndarray) -> list:
        out = []
        for a, off in zip(node.aggs, offs):
            if parts_of(a.func) == 2:
                parts = list(zip(blk.cols[off][idx].tolist(), blk.cols[off + 1][idx].tolist()))
            else:
                parts = list(blk.cols[off][idx])
            merged = _fold(lambda x, y, _f=a.func: _merge_agg_partials(_f, x, y, null_on), parts)
            out.append(_finalize(a, merged, null_on))
        return out

    if k == 0:
        return Block([_column([v]) for v in merge_rows(np.arange(len(blk)))])
    keys = blk.cols[:k]
    group, first, ng = _grouped(keys)
    rows = [[kc[f] for kc in keys] + merge_rows(m) for f, m in zip(first, _group_members(group, ng))]
    return Block([_column([r[i] for r in rows]) for i in range(len(node.fields))])


def _join_input_dist(node: L.Node, ctx: RunCtx):
    """Distribution that routed a join input's rows to this worker. Project /
    Filter / Rename don't re-route rows, so walk through them to the
    underlying StageInput; a Scan means co-located leaf data (None). Anything
    else makes the routing indeterminate — callers fail closed on it."""
    while isinstance(node, (L.Project, L.FilterNode, L.Rename)):
        node = node.input
    if isinstance(node, L.StageInput):
        return ctx.stages[node.stage_id].dist
    if isinstance(node, L.Scan):
        return None
    return "indeterminate"


def _exec_join(node: L.Join, ctx: RunCtx) -> Block:
    l = exec_node(node.left, ctx)
    r = exec_node(node.right, ctx)
    nl, nr = len(node.left.fields), len(node.right.fields)
    if len(l) == 0 and l.width == 0:
        l = _empty_block(nl)
    if len(r) == 0 and r.width == 0:
        r = _empty_block(nr)
    keyed = bool(node.left_keys)
    if keyed:
        lk = _key_cols(node.left_keys, node.left.fields, l)
        rk = _key_cols(node.right_keys, node.right.fields, r)
        # a numeric-vs-text key pair: the text side coerces numerically —
        # parseable values compare as numbers, the rest become NaN (a NULL
        # key never matches). Only sound when the rows were NOT routed here
        # by hashing both sides' raw representations: fail loudly there
        # (Calcite rejects the uncasted mixed-type equi-join the same way).
        for i in range(len(lk)):
            lnum, rnum = lk[i].dtype.kind == "f", rk[i].dtype.kind == "f"
            if lnum != rnum:
                ldist = _join_input_dist(node.left, ctx)
                rdist = _join_input_dist(node.right, ctx)
                l_hashy = ldist == L.HASH or ldist == "indeterminate"
                r_hashy = rdist == L.HASH or rdist == "indeterminate"
                if l_hashy and r_hashy:
                    raise L.PlanV2Error(
                        "join key type mismatch (numeric vs string) across hash-"
                        "partitioned inputs; add an explicit CAST on one side"
                    )
                if lnum:
                    rk[i] = _as_f64(_to_numeric(rk[i]))
                else:
                    lk[i] = _as_f64(_to_numeric(lk[i]))
        l_null = np.logical_or.reduce([isna(c) for c in lk]) if len(l) else np.zeros(0, bool)
        r_null = np.logical_or.reduce([isna(c) for c in rk]) if len(r) else np.zeros(0, bool)
    else:
        l_null = np.zeros(len(l), bool)
        r_null = np.zeros(len(r), bool)

    kind = node.kind if node.kind != "cross" else "inner"

    def paired(lidx: np.ndarray, ridx: np.ndarray) -> Block:
        return Block([c[lidx] for c in l.cols] + [c[ridx] for c in r.cols])

    def residual(pairs: Block) -> np.ndarray:
        return np.asarray(eval_filter(node.post_filter, node.fields, pairs), bool)

    def outer(pairs: Block, lidx: np.ndarray, ridx: np.ndarray) -> Block:
        # append unmatched rows null-extended (the ON residual took part in
        # the matching, so a residual-failed row null-extends, not drops)
        parts = [pairs]
        if kind in ("left", "full"):
            lmatched = np.zeros(len(l), dtype=bool)
            lmatched[lidx] = True
            un = l.take(~lmatched)
            parts.append(Block(un.cols + [_missing_like(c, len(un)) for c in r.cols]))
        if kind in ("right", "full"):
            rmatched = np.zeros(len(r), dtype=bool)
            rmatched[ridx] = True
            un = r.take(~rmatched)
            parts.append(Block([_missing_like(c, len(un)) for c in l.cols] + un.cols))
        return concat_blocks(parts)

    # -- device path: ANY equi-keyed join (multi-key / text keys ride the
    # joint dense encoding; inner AND outer kinds) ---------------------------
    if keyed and len(l) >= DEVICE_JOIN_MIN and len(r):
        # one plain numeric key with no nulls: probe the raw values directly
        if (
            len(lk) == 1
            and not l_null.any()
            and not r_null.any()
            and lk[0].dtype != object
            and rk[0].dtype != object
            and np.issubdtype(lk[0].dtype, np.number)
            and np.issubdtype(rk[0].dtype, np.number)
        ):
            enc = (lk[0], rk[0])
        else:
            enc = _encode_join_keys(lk, rk, l_null, r_null)
        dev = _device_equi_join(enc[0], enc[1], device=ctx.device, mesh=ctx.mesh) if enc is not None else None
        if dev is not None:
            lidx, ridx = dev
            pairs = paired(lidx, ridx)
            if node.post_filter is not None and len(pairs):
                fm = residual(pairs)
                pairs, lidx, ridx = pairs.take(fm), lidx[fm], ridx[fm]
            if kind == "inner":
                return pairs
            return outer(pairs, lidx, ridx)

    # -- host hash join (small blocks / unjoinable key dtypes) ---------------
    lsel = np.flatnonzero(~l_null)
    rsel = np.flatnonzero(~r_null)
    if keyed:
        li, ri = merge_inner([c[lsel] for c in lk], [c[rsel] for c in rk])
    else:
        li, ri = _expand_ranges(np.zeros(len(lsel), dtype=np.int64), np.full(len(lsel), len(rsel)), np.arange(len(rsel)))
    lidx, ridx = lsel[li], rsel[ri]
    pairs = paired(lidx, ridx)
    if node.post_filter is not None and len(pairs):
        fm = residual(pairs)
        pairs, lidx, ridx = pairs.take(fm), lidx[fm], ridx[fm]
    if kind == "inner":
        return pairs
    return outer(pairs, lidx, ridx)


_WINDOW_AGGS = {"sum", "min", "max", "avg", "count"}


def _transform(fname: str, group: np.ndarray, ng: int, v: "np.ndarray | None", n: int) -> np.ndarray:
    """groupby(...).transform(fname): each row gets its partition's
    aggregate (sum over no values 0; min / max / mean NaN; count the
    non-null cells)."""
    if fname == "count":
        w = np.ones(n) if v is None else (~isna(v)).astype(np.float64)
        return np.bincount(group, weights=w, minlength=ng).astype(np.int64)[group]
    members = _group_members(group, ng)
    if fname == "sum":
        num = _numeric_cells(v)
        if num.dtype.kind in "iub":
            per = np.asarray([num[m].sum() for m in members], dtype=np.int64)
        else:
            per = np.asarray([np.nansum(num[m]) for m in members], dtype=np.float64)
        return per[group]
    per = _column([_reduce_values(fname, v[m], ()) for m in members])
    return per[group]


def _cum_in_groups(op: str, group_sorted: np.ndarray, v: np.ndarray) -> np.ndarray:
    """groupby(...).cum{sum,min,max} over rows sorted by partition: NaN cells
    are skipped (their own output NaN), integers stay integers."""
    v = _numeric_cells(v)
    out = np.empty(len(v), dtype=np.float64 if v.dtype.kind == "f" else np.int64 if op == "sum" else v.dtype)
    starts = np.r_[0, np.flatnonzero(group_sorted[1:] != group_sorted[:-1]) + 1, len(v)]
    ufunc = {"sum": np.add, "min": np.minimum, "max": np.maximum}[op]
    for a, b in zip(starts[:-1], starts[1:]):
        seg = v[a:b]
        if seg.dtype.kind == "f":
            nan = np.isnan(seg)
            fill = {"sum": 0.0, "min": np.inf, "max": -np.inf}[op]
            acc = ufunc.accumulate(np.where(nan, fill, seg))
            acc = np.where(nan, np.nan, acc)
            if op != "sum":
                # a prefix of NaN cells alone stays NaN, not +/-inf
                acc = np.where(np.isinf(acc) & (acc == fill), np.nan, acc)
        else:
            acc = ufunc.accumulate(seg.astype(np.int64) if op == "sum" else seg)
        out[a:b] = acc
    return out


def _exec_window(node: L.WindowNode, ctx: RunCtx) -> Block:
    blk = exec_node(node.input, ctx)
    infields = node.input.fields
    out = list(blk.cols)
    n = len(blk)
    for wf in node.windows:
        fname = wf.func.name
        if n == 0:
            out.append(np.zeros(0, dtype=np.float64))
            continue
        pcols = [eval_expr(p, infields, blk) for p in wf.partition_by]
        ocols = [eval_expr(o.expr, infields, blk) for o in wf.order_by]
        odesc = [o.desc for o in wf.order_by]
        v = eval_expr(wf.func.args[0], infields, blk) if wf.func.args and not isinstance(wf.func.args[0], ast.Star) else None
        if fname in _WINDOW_AGGS and not ocols:
            if not pcols:
                if fname == "count":
                    res = np.full(n, int((~isna(v)).sum()) if v is not None else n)
                else:
                    res = np.full(n, _agg_scalar(fname, v, ()))
            else:
                group, _, ng = _grouped(pcols)
                res = _transform(fname, group, ng, v, n)
            out.append(res)
            continue
        wblk = Block(pcols + ocols + ([v] if v is not None else []))
        keys = list(range(len(pcols) + len(ocols)))
        # the sort is the window operator's cost center: the shared dispatch
        # (device lexsort above the threshold, the host's otherwise)
        sf, perm = sorted_block(wblk, keys, [False] * len(pcols) + list(odesc), ctx.device)
        sv = sf.cols[-1] if v is not None else None
        if pcols:
            gk, _, ng = _grouped(sf.cols[: len(pcols)])
        else:
            gk, ng = np.zeros(n, dtype=np.int64), 1
        dres = None
        if fname == "row_number" or fname in _WINDOW_AGGS:
            dres = _device_window_cum(fname, gk, sv, n, ctx.device)
        starts = np.r_[True, gk[1:] != gk[:-1]]
        start_idx = np.maximum.accumulate(np.where(starts, np.arange(n), 0))
        rn = np.arange(n) - start_idx + 1
        if dres is not None:
            res = dres
        elif fname == "row_number":
            res = rn
        elif fname in ("rank", "dense_rank"):
            newkey = rn == 1
            ocs = sf.cols[len(pcols) : len(pcols) + len(ocols)]
            if ocs:
                changed = np.zeros(n, dtype=bool)
                for col in ocs:
                    prev = np.roll(col, 1)
                    with np.errstate(invalid="ignore"):
                        neq = np.asarray(col != prev, dtype=bool)
                    changed |= neq & ~(isna(col) & isna(prev))
                changed[0] = True
                newkey = newkey | changed
            if fname == "rank":
                last = np.maximum.accumulate(np.where(newkey, np.arange(n), 0))
                res = rn[last]
            else:
                c = np.cumsum(newkey)
                res = c - c[start_idx] + 1
        elif fname == "count":
            res = rn if sv is None else _cum_in_groups("sum", gk, (~isna(sv)).astype(np.int64))
        elif fname == "avg":
            res = _cum_in_groups("sum", gk, _as_f64(sv)) / _cum_in_groups("sum", gk, np.ones(n))
        elif fname in ("sum", "min", "max"):
            res = _cum_in_groups(fname, gk, sv)
        else:
            raise L.PlanV2Error(f"unsupported window function {fname}")
        back = np.empty_like(res)
        back[perm] = res
        out.append(back)
    return Block(out)


# ---------------------------------------------------------------------------
# Stage workers + engine
# ---------------------------------------------------------------------------


def _send_output(blk: Block, stage: L.Stage, parent_id: int, parent_par: int, mailbox: MailboxService, worker: int, stats=None):
    if stage.dist == L.SINGLETON:
        mailbox.send(stage.id, parent_id, 0, blk)
    elif stage.dist == L.BROADCAST:
        for w in range(parent_par):
            mailbox.send(stage.id, parent_id, w, blk)
    elif stage.dist == L.RANDOM:
        mailbox.send(stage.id, parent_id, worker % parent_par, blk)
    elif stage.dist == L.HASH:
        part = _hash_partition(_key_cols(stage.key_exprs, stage.root.fields, blk), parent_par)
        for w in range(parent_par):
            sub = blk.take(part == w)
            if len(sub):
                mailbox.send(stage.id, parent_id, w, sub)
    else:
        raise L.PlanV2Error(f"unknown distribution {stage.dist}")
    # stats ride the trailing EOS — to parent worker 0 ONLY, last, built at
    # send time (a callable) so it includes what the other sends recorded
    for w in [*range(1, parent_par), 0]:
        if stats and w == 0:
            payload = (lambda: ("__eos__", stats())) if callable(stats) else ("__eos__", stats)
        else:
            payload = _EOS
        mailbox.send(stage.id, parent_id, w, payload)


def run_stage_worker(
    stage: L.Stage,
    w: int,
    mailbox: MailboxService,
    stages: dict[int, L.Stage],
    segments: dict[str, list],
    n_senders: dict[int, int],
    parent_of: dict[int, int],
    scan_local_all: bool = False,
    errors: list | None = None,
    options: dict | None = None,
    device="cuda",
    mesh=None,
    trace_out=None,
) -> None:
    """Run ONE (stage, worker) OpChain to completion: execute the stage
    subtree and ship its output (or an error marker) to every parent worker.
    Shared by the in-process engine and the distributed server runtime.

    trace_out: this worker's common.trace.RequestTrace (distributed remote
    workers only). Its span subtree is appended to the trailing-EOS stats
    payload as a TRACE_RECORD_KEY record for the broker to reassemble."""
    from pinot_tpu_torch.common.trace import InvocationScope

    opts = dict(options or {})
    ctx = RunCtx(
        stage,
        w,
        mailbox,
        stages,
        segments,
        n_senders,
        scan_local_all=scan_local_all,
        options=opts,
        stats=StageStatsCollector(stage, w) if stats_enabled(opts) else None,
        device=device,
        mesh=mesh,
    )
    parent = parent_of[stage.id]
    parent_par = stages[parent].parallelism
    try:
        with InvocationScope(f"stage{stage.id}:w{w}"):
            blk = exec_node(stage.root, ctx)
        stats = ctx.stats.payload() if ctx.stats is not None else None
        if trace_out is not None and stats is not None:
            from pinot_tpu_torch.multistage.stats import TRACE_RECORD_KEY

            base_stats = stats

            def stats_with_subtree():
                # resolved at (re)send time, not here: mailbox fault/retry
                # events recorded DURING the EOS send must make the snapshot
                trace_out.root.duration_ms = trace_out.now_ms()
                return base_stats + [{TRACE_RECORD_KEY: trace_out.subtree()}]

            stats = stats_with_subtree
        _send_output(blk, stage, parent, parent_par, mailbox, w, stats=stats)
    except BaseException as e:  # propagate to receivers, error code intact
        from pinot_tpu_torch.common.errors import QueryErrorCode

        if errors is not None:
            errors.append(e)
        code = int(getattr(e, "error_code", QueryErrorCode.QUERY_EXECUTION))
        for pw in range(parent_par):
            try:
                mailbox.send(stage.id, parent, pw, ("__err__", repr(e), code))
            except Exception:  # best-effort marker; the receiver's own deadline reports the loss
                pass


class MultistageEngine:
    """In-process v2 engine: plans SQL into stages and runs OpChains on
    threads, leaf stages scanning the catalog's segments on `device` ("cuda"
    unless the caller asks for the CPU). `mesh` gives the slots an integer
    equi-join's hash exchange spans.

    Reference parity: QueryDispatcher.submitAndReduce
    (pinot-query-runtime/.../QueryDispatcher.java:128) + worker QueryServer.
    """

    def __init__(
        self,
        catalog: dict[str, list],
        n_workers: int = 2,
        schemas: dict[str, list[str]] | None = None,
        device="cuda",
        mesh=None,
    ):
        """schemas: optional table -> column names, needed for tables whose
        segment list is empty (a valid empty table must plan, not error)."""
        if torch.device(device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("MultistageEngine(device='cuda'): no CUDA device is available; pass device='cpu'")
        self.catalog = dict(catalog)
        self.n_workers = n_workers
        self.schemas = dict(schemas) if schemas else {}
        from pinot_tpu_torch.parallel.mesh import make_mesh

        self.device = str(torch.device(device))
        if mesh is None:
            # every visible card for a CUDA engine (the reference's
            # `jax.devices()`), one slot for any other device
            mesh = make_mesh() if torch.device(device).type == "cuda" else make_mesh(device)
        self.mesh = mesh

    def execute(self, sql: str, stmt=None, deadline=None) -> ResultTable:
        """deadline: optional query.context.Deadline enforced at every
        operator block boundary and mailbox receive."""
        from pinot_tpu_torch.query.sql import parse_sql

        t0 = _time.perf_counter()
        if stmt is None:
            stmt = parse_sql(sql)
        cat = L.Catalog.from_segments(self.catalog, self.schemas)
        plan = L.build_stage_plan(stmt, cat, self.n_workers)
        # singleton-fed stages collapse to one worker BEFORE explain so the
        # reported parallelism matches what runs
        for s in plan.stages.values():
            for inp in s.inputs:
                if plan.stages[inp].dist == L.SINGLETON:
                    s.parallelism = 1
        if getattr(stmt, "explain", False):
            # EXPLAIN PLAN FOR: one row a stage in the [Operator, Operator_Id,
            # Parent_Id] schema (DataSchema.java:70)
            parent_of: dict[int, int] = {}
            for s in plan.stages.values():
                for inp in s.inputs:
                    parent_of[inp] = s.id
            out_rows = [
                [f"[{s.dist or 'root'} x{s.parallelism}] {L._explain(s.root)}", sid, parent_of.get(sid, -1)]
                for sid, s in sorted(plan.stages.items())
            ]
            if plan.rule_stats:
                fired = ", ".join(f"{k}:{v}" for k, v in sorted(plan.rule_stats.items()))
                out_rows.append([f"[rules] {fired}", -1, -1])
            return ResultTable(columns=["Operator", "Operator_Id", "Parent_Id"], rows=out_rows)
        if getattr(stmt, "explain_analyze", False):
            # EXPLAIN ANALYZE: execute with stats collection forced on, then
            # render the plan tree with the merged runtime stats inline
            plan.options["__collect_stats__"] = True
            _, stats_payload = self._run(plan, deadline=deadline)
            merged = merge_stage_stats(stats_payload or [])
            return ResultTable(columns=["Operator", "Operator_Id", "Parent_Id"], rows=analyze_rows(plan, merged))
        blk, stats_payload = self._run(plan, deadline=deadline)
        total_docs = sum(s.n_docs for segs in self.catalog.values() for s in segs)
        result = ResultTable(
            columns=list(plan.visible_names),
            rows=to_rows(blk),
            total_docs=total_docs,
            time_used_ms=(_time.perf_counter() - t0) * 1e3,
        )
        if stats_payload is not None:
            result.stage_stats = merge_stage_stats(stats_payload)
        return result

    def _run(self, plan: L.StagePlan, deadline=None) -> "tuple[Block, list | None]":
        from pinot_tpu_torch.common.trace import _active, active_trace

        mailbox = MailboxService()
        mailbox.deadline = deadline
        parent_of: dict[int, int] = {}
        for s in plan.stages.values():
            for inp in s.inputs:
                parent_of[inp] = s.id
        n_senders = {sid: s.parallelism for sid, s in plan.stages.items()}
        errors: list[BaseException] = []
        trace = active_trace()

        def worker_fn(stage: L.Stage, w: int):
            # in-process workers record straight into the request's trace
            # (plain threads don't inherit the submitting contextvars)
            def run():
                if trace is not None:
                    _active.set(trace)
                run_stage_worker(
                    stage, w, mailbox, plan.stages, self.catalog, n_senders, parent_of,
                    errors=errors, options=plan.options, device=self.device, mesh=self.mesh,
                )

            contextvars.copy_context().run(run)

        threads = []
        for sid in sorted(plan.stages):
            if sid == 0:
                continue
            s = plan.stages[sid]
            for w in range(s.parallelism):
                t = threading.Thread(target=worker_fn, args=(s, w), daemon=True)
                t.start()
                threads.append(t)
        root = plan.stages[0]
        ctx = RunCtx(
            root, 0, mailbox, plan.stages, self.catalog, n_senders, options=plan.options,
            stats=StageStatsCollector(root, 0) if stats_enabled(plan.options) else None,
            device=self.device, mesh=self.mesh,
        )
        try:
            out = exec_node(root.root, ctx)
        finally:
            for t in threads:
                t.join(timeout=30)
        if errors:
            raise errors[0]
        return out, (ctx.stats.payload() if ctx.stats is not None else None)
