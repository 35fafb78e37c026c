"""Funnel aggregation family.

Reference parity: pinot-core/.../query/aggregation/function/funnel/
(FunnelCountAggregationFunction + the bitmap AggregationStrategy /
MergeStrategy) and the windowed FUNNEL_MAX_STEP / FUNNEL_MATCH_STEP /
FUNNEL_STEP_DURATION_STATS family.

Dialect:
    FUNNELCOUNT(STEPS(p1, ..., pK), CORRELATE_BY(col))
    FUNNELCOMPLETECOUNT(STEPS(...), CORRELATE_BY(col))
    FUNNELMAXSTEP(ts_expr, window, STEPS(...), CORRELATE_BY(col))
    FUNNELMATCHSTEP(ts_expr, window, STEPS(...), CORRELATE_BY(col))
    FUNNELSTEPDURATIONSTATS(ts_expr, window, STEPS(...), CORRELATE_BY(col))

Step conditions are predicates (parsed as PredicateExpr function args).

Semantics (set/bitmap strategy for the count variants, matching the
reference's default un-ordered bitmap strategy): step-k count = number of
distinct correlation ids present in ALL of steps 1..k. The windowed variants
order events by timestamp per correlation id and find, per id, the deepest
in-order chain whose steps all lie within `window` time units of the chain's
first step.

This is the JAX package's module of the same name carried over unchanged
(numpy only), so partials built by either package merge with the other's.

Partials:
    count variants    -> list[set] per step (merge = element-wise union)
    windowed variants -> dict corr_id -> (n,2) float64 array [ts, step_bits]
                         (merge = per-key concatenation)
"""

from __future__ import annotations

import numpy as np

FUNNEL_AGGS = {
    "funnelcount",
    "funnelcompletecount",
    "funnelmatchstep",
    "funnelmaxstep",
    "funnelstepdurationstats",
}

WINDOWED = {"funnelmatchstep", "funnelmaxstep", "funnelstepdurationstats"}


def n_steps(extra: tuple) -> int:
    return len(extra[-1])


def is_windowed(func: str) -> bool:
    return func in WINDOWED


# -- per-segment partials ----------------------------------------------------


def segment_partial(seg, a, mask: np.ndarray):
    """Partial over one segment's masked docs."""
    from pinot_tpu_torch.query.host_exec import eval_value, filter_mask

    steps = a.extra[-1]
    if a.func in WINDOWED:
        corr = eval_value(seg, a.arg2)
        ts = np.asarray(eval_value(seg, a.arg), dtype=np.float64)
    else:
        corr = eval_value(seg, a.arg)
        ts = None
    step_masks = [filter_mask(seg, s) & mask for s in steps]
    if ts is None:
        return [set(np.asarray(corr)[m].tolist()) for m in step_masks]
    bits = np.zeros(len(mask), dtype=np.int64)
    for k, m in enumerate(step_masks):
        bits |= m.astype(np.int64) << k
    keep = mask & (bits != 0)
    return events_partial(np.asarray(corr)[keep], ts[keep], bits[keep])


def events_partial(corr: np.ndarray, ts: np.ndarray, bits: np.ndarray) -> dict:
    """corr/ts/bits row-aligned -> dict corr_id -> (n,2) [ts, bits] array."""
    out: dict = {}
    if len(corr) == 0:
        return out
    order = np.argsort(corr, kind="stable")
    corr, ts, bits = corr[order], ts[order], bits[order]
    cuts = np.nonzero(corr[1:] != corr[:-1])[0] + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [len(corr)]])
    for s, e in zip(starts, ends):
        out[corr[s]] = np.column_stack([ts[s:e], bits[s:e].astype(np.float64)])
    return out


# -- merge -------------------------------------------------------------------


def merge(func: str, a, b):
    if func in WINDOWED:
        out = dict(a)
        for k, v in b.items():
            prev = out.get(k)
            out[k] = v if prev is None else np.concatenate([prev, v])
        return out
    return [x | y for x, y in zip(a, b)]


def empty_partial(func: str, extra: tuple):
    if func in WINDOWED:
        return {}
    return [set() for _ in range(n_steps(extra))]


# -- finalize ----------------------------------------------------------------


def _chain(events: np.ndarray, n: int, window: float):
    """Deepest in-order chain within `window` of its first step.
    Returns (max_step, times-of-best-chain list). Events: (m,2) [ts,bits]."""
    ev = events[np.argsort(events[:, 0], kind="stable")]
    # dp[k] = (latest chain-start time reaching step k+1, times tuple)
    starts = [None] * n
    times = [None] * n
    for t, fb in ev:
        b = int(fb)
        for k in range(n - 1, 0, -1):
            if b & (1 << k) and starts[k - 1] is not None and t - starts[k - 1] <= window:
                if starts[k] is None or starts[k - 1] > starts[k]:
                    starts[k] = starts[k - 1]
                    times[k] = times[k - 1] + [t]
        if b & 1:
            if starts[0] is None or t > starts[0]:
                starts[0] = t
                times[0] = [t]
    for k in range(n - 1, -1, -1):
        if starts[k] is not None:
            return k + 1, times[k]
    return 0, []


def finalize(func: str, p, extra: tuple):
    n = n_steps(extra)
    if func == "funnelcount":
        out = []
        inter = None
        for s in p:
            inter = set(s) if inter is None else (inter & s)
            out.append(len(inter))
        return out
    if func == "funnelcompletecount":
        inter = None
        for s in p:
            inter = set(s) if inter is None else (inter & s)
        return len(inter) if inter is not None else 0
    window = float(extra[1])
    if func == "funnelmaxstep":
        best = 0
        for ev in p.values():
            k, _ = _chain(ev, n, window)
            best = max(best, k)
            if best == n:
                break
        return best
    if func == "funnelmatchstep":
        best = 0
        for ev in p.values():
            k, _ = _chain(ev, n, window)
            best = max(best, k)
            if best == n:
                break
        return [1 if best >= k else 0 for k in range(1, n + 1)]
    # funnelstepdurationstats: mean duration of each step transition over the
    # ids that completed it (reference returns a serialized stats object; we
    # emit the mean-durations array)
    sums = np.zeros(max(n - 1, 0), dtype=np.float64)
    counts = np.zeros(max(n - 1, 0), dtype=np.int64)
    for ev in p.values():
        k, ts = _chain(ev, n, window)
        for j in range(min(k, n) - 1):
            sums[j] += ts[j + 1] - ts[j]
            counts[j] += 1
    return [float(sums[j] / counts[j]) if counts[j] else 0.0 for j in range(max(n - 1, 0))]
