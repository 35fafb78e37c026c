"""Bounded-size mergeable quantile sketches: t-digest and KLL.

Reference parity: PercentileTDigestAggregationFunction (pinot-core/.../query/
aggregation/function/PercentileTDigestAggregationFunction.java:60, backed by
com.tdunning.math.stats.MergingDigest) and PercentileKLLAggregationFunction
(PercentileKLLAggregationFunction.java:66, backed by Apache DataSketches
KllDoublesSketch). Both partials here are O(compression)/O(k) regardless of
input size, merge associatively, and match the published error bounds —
replacing the round-3 exact-raw-values stand-ins whose partials grew with
the data.

This is the JAX package's module of the same name carried over unchanged
(numpy only), so partials built by either package merge with the other's.

Representation choices (host-side numpy; these functions are the *partial
format contract* shared by the scalar, grouped, v2, and MV paths):

  t-digest partial: (compression, total_n, min, max, means[::f64], weights[::f64])
  KLL partial:      (k, total_n, min, max, levels: tuple[np.ndarray, ...])
                    level i items carry weight 2^i
"""

from __future__ import annotations

import math

import numpy as np

TD_DEFAULT_COMPRESSION = 100.0  # MergingDigest default used by Pinot
KLL_DEFAULT_K = 200  # DataSketches KllDoublesSketch default


# ---------------------------------------------------------------------------
# t-digest (merging digest, k1 scale function)
# ---------------------------------------------------------------------------


def _k1(q: np.ndarray | float, comp: float):
    """Scale function k1(q) = (δ/2π)·asin(2q−1): tight centroids at the
    tails, wide in the middle — the function MergingDigest uses."""
    return comp / (2.0 * math.pi) * np.arcsin(2.0 * np.clip(q, 0.0, 1.0) - 1.0)


def td_create(comp: float = TD_DEFAULT_COMPRESSION):
    return (float(comp), 0.0, math.inf, -math.inf, np.zeros(0), np.zeros(0))


def _td_merge_pass(comp, mn, mx, means, weights):
    """One merging pass, fully vectorized (the clustering variant of the
    merging digest): sort centroids, bucket them by ⌊k1(q_left)⌋, and
    coalesce each bucket into one weighted-mean centroid. Monotonicity of
    k1 guarantees every bucket's k-width ≤ 1, which is the t-digest size
    invariant; np.add.reduceat does the per-bucket sums without a Python
    loop (the greedy scan was ~5s per 1M rows)."""
    if len(means) == 0:
        return (comp, 0.0, mn, mx, means, weights)
    order = np.argsort(means, kind="mergesort")
    m = means[order].astype(np.float64)
    w = weights[order].astype(np.float64)
    total = float(w.sum())
    cum = np.cumsum(w)
    q_left = (cum - w) / total
    kb = np.floor(_k1(q_left, comp))
    starts = np.flatnonzero(np.concatenate([[True], kb[1:] != kb[:-1]]))
    sum_w = np.add.reduceat(w, starts)
    sum_mw = np.add.reduceat(m * w, starts)
    return (comp, total, mn, mx, sum_mw / sum_w, sum_w)


def td_from_values(values: np.ndarray, comp: float = TD_DEFAULT_COMPRESSION):
    """Build a digest from a batch of raw values (one merge pass — the
    batched MergingDigest construction)."""
    v = np.asarray(values, dtype=np.float64)
    v = v[~np.isnan(v)]
    if len(v) == 0:
        return td_create(comp)
    return _td_merge_pass(float(comp), float(v.min()), float(v.max()), v, np.ones(len(v)))


def td_merge(a, b):
    """Associative merge: concatenate centroid sets, re-run the merge pass."""
    ca, _na, mna, mxa, ma, wa = a
    cb, _nb, mnb, mxb, mb, wb = b
    comp = max(ca, cb)
    return _td_merge_pass(
        comp, min(mna, mnb), max(mxa, mxb), np.concatenate([ma, mb]), np.concatenate([wa, wb])
    )


def td_quantile(d, pct: float) -> float:
    """Quantile estimate with linear interpolation between centroid midpoints
    (MergingDigest.quantile)."""
    comp, n, mn, mx, means, weights = d
    q = pct / 100.0
    if len(means) == 0:
        return float("-inf")  # Pinot default for empty input
    if len(means) == 1:
        return float(means[0])
    target = q * n
    # centroid midpoint cumulative positions
    cum = np.cumsum(weights) - weights / 2.0
    if target <= cum[0]:
        # interpolate min -> first centroid
        lo_w = weights[0] / 2.0
        t = target / lo_w if lo_w > 0 else 0.0
        return float(mn + t * (means[0] - mn))
    if target >= cum[-1]:
        hi_w = weights[-1] / 2.0
        t = (n - target) / hi_w if hi_w > 0 else 0.0
        return float(mx - t * (mx - means[-1]))
    j = int(np.searchsorted(cum, target, side="right"))
    c0, c1 = cum[j - 1], cum[j]
    t = (target - c0) / (c1 - c0) if c1 > c0 else 0.0
    return float(means[j - 1] + t * (means[j] - means[j - 1]))


def td_serialize(d) -> bytes:
    """Little-endian layout: [compression:f64][n:f64][min:f64][max:f64]
    [count:i64][means:f64*count][weights:f64*count]."""
    comp, n, mn, mx, means, weights = d
    head = np.asarray([comp, n, mn, mx], dtype="<f8").tobytes()
    cnt = np.asarray([len(means)], dtype="<i8").tobytes()
    return head + cnt + means.astype("<f8").tobytes() + weights.astype("<f8").tobytes()


def td_deserialize(raw: bytes):
    comp, n, mn, mx = np.frombuffer(raw[:32], dtype="<f8")
    cnt = int(np.frombuffer(raw[32:40], dtype="<i8")[0])
    means = np.frombuffer(raw[40 : 40 + 8 * cnt], dtype="<f8").copy()
    weights = np.frombuffer(raw[40 + 8 * cnt : 40 + 16 * cnt], dtype="<f8").copy()
    return (float(comp), float(n), float(mn), float(mx), means, weights)


# ---------------------------------------------------------------------------
# KLL (Karnin-Lang-Liberty) doubles sketch
# ---------------------------------------------------------------------------

_KLL_C = 2.0 / 3.0  # capacity decay per level below the top
_KLL_MIN_CAP = 8


def _kll_cap(k: int, depth_from_top: int) -> int:
    return max(_KLL_MIN_CAP, int(math.ceil(k * (_KLL_C**depth_from_top))))


def kll_create(k: int = KLL_DEFAULT_K):
    return (int(k), 0, math.inf, -math.inf, (np.zeros(0),))


def _kll_compress(k, n, mn, mx, levels):
    """Compact bottom-up while any level exceeds its capacity. Every
    compaction sorts the level and keeps alternating items at doubled
    weight (deterministic offset keyed on the level count for
    reproducibility — DataSketches uses a random bit; the rank error bound
    is the same in expectation)."""
    levels = [np.asarray(l, dtype=np.float64) for l in levels]
    while True:
        h = len(levels)
        total = sum(len(l) for l in levels)
        cap_total = sum(_kll_cap(k, h - 1 - i) for i in range(h))
        if total <= cap_total:
            break
        # lowest level over its individual capacity (or level 0 by default)
        target = 0
        for i in range(h):
            if len(levels[i]) > _kll_cap(k, h - 1 - i):
                target = i
                break
        lv = np.sort(levels[target])
        if len(lv) < 2:
            # cannot halve a single item; grow a level instead
            levels.append(np.zeros(0))
            continue
        off = (len(lv) + h) & 1  # deterministic alternating offset
        kept = lv[off::2]
        levels[target] = np.zeros(0)
        if target + 1 == h:
            levels.append(kept)
        else:
            levels[target + 1] = np.concatenate([levels[target + 1], kept])
    return (k, n, mn, mx, tuple(levels))


def kll_from_values(values: np.ndarray, k: int = KLL_DEFAULT_K):
    v = np.asarray(values, dtype=np.float64)
    v = v[~np.isnan(v)]
    if len(v) == 0:
        return kll_create(k)
    return _kll_compress(int(k), int(len(v)), float(v.min()), float(v.max()), (v,))


def kll_merge(a, b):
    ka, na, mna, mxa, la = a
    kb, nb, mnb, mxb, lb = b
    k = min(ka, kb) if na and nb else (ka if na else kb)  # DataSketches: smaller k wins
    h = max(len(la), len(lb))
    levels = []
    for i in range(h):
        xa = la[i] if i < len(la) else np.zeros(0)
        xb = lb[i] if i < len(lb) else np.zeros(0)
        levels.append(np.concatenate([np.asarray(xa, np.float64), np.asarray(xb, np.float64)]))
    return _kll_compress(int(k), int(na + nb), min(mna, mnb), max(mxa, mxb), tuple(levels))


def kll_quantile(s, pct: float) -> float:
    k, n, mn, mx, levels = s
    if n == 0:
        return float("-inf")
    vals = []
    wts = []
    for i, lv in enumerate(levels):
        if len(lv):
            vals.append(np.asarray(lv, np.float64))
            wts.append(np.full(len(lv), 1 << i, dtype=np.float64))
    v = np.concatenate(vals)
    w = np.concatenate(wts)
    order = np.argsort(v, kind="mergesort")
    v = v[order]
    w = w[order]
    cum = np.cumsum(w)
    target = (pct / 100.0) * cum[-1]
    j = int(np.searchsorted(cum, target, side="left"))
    j = min(j, len(v) - 1)
    return float(v[j])


def kll_serialize(s) -> bytes:
    k, n, mn, mx, levels = s
    head = np.asarray([k, n, len(levels)], dtype="<i8").tobytes()
    head += np.asarray([mn, mx], dtype="<f8").tobytes()
    for lv in levels:
        head += np.asarray([len(lv)], dtype="<i8").tobytes()
        head += np.asarray(lv, dtype="<f8").tobytes()
    return head


def kll_deserialize(raw: bytes):
    k, n, h = (int(x) for x in np.frombuffer(raw[:24], dtype="<i8"))
    mn, mx = (float(x) for x in np.frombuffer(raw[24:40], dtype="<f8"))
    off = 40
    levels = []
    for _ in range(h):
        cnt = int(np.frombuffer(raw[off : off + 8], dtype="<i8")[0])
        off += 8
        levels.append(np.frombuffer(raw[off : off + 8 * cnt], dtype="<f8").copy())
        off += 8 * cnt
    return (k, n, mn, mx, tuple(levels))
