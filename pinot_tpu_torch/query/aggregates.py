"""Extended aggregation function registry.

Reference parity: the long tail of pinot-core/.../query/aggregation/function/
(94 AggregationFunction classes). Each entry defines the mergeable-partial
contract the engine's three execution sites share (per-segment scalar
aggregation, per-segment group-by frames, broker reduce):

    compute(values, values2, extra) -> partial     # over one segment's rows
    merge(a, b) -> partial                          # associative+commutative
    finalize(partial, extra) -> result value
    empty(extra) -> partial                         # zero-row identity

This is the JAX package's module of the same name carried over unchanged
(numpy only), so partials built by either package merge with the other's.

Partials are single objects (scalars, tuples, ndarrays, sets), stored in one
group-by frame column — mergeable across segments, servers, and devices.

Functions covered (reference class in parens):
  variance/stddev (VarianceAggregationFunction — Welford-merge via power sums),
  covar_pop/covar_samp (CovarianceAggregationFunction), skewness/kurtosis
  (FourthMomentAggregationFunction), firstwithtime/lastwithtime
  (FirstWithTimeAggregationFunction:40), distinctsum/distinctavg
  (DistinctSumAggregationFunction), bool_and/bool_or
  (BoolAndAggregationFunction), histogram (HistogramAggregationFunction),
  percentilekll (PercentileKLLAggregationFunction — real KLL compactor
  sketch, quantile_sketch.py), distinctcounttheta
  (DistinctCountThetaSketchAggregationFunction — KMV bottom-k sketch),
  distinctcounthllplus/cpc/ull (distinct_sketch.py: dense HLL++, FM85/PCSA
  bit matrix, and Ertl UltraLogLog with an ML estimator),
  segmentpartitioneddistinctcount
  (SegmentPartitionedDistinctCountAggregationFunction).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import numpy as np

from pinot_tpu_torch.query.distinct_sketch import (
    cpc_estimate,
    cpc_matrix,
    cpc_merge,
    hllplus_estimate,
    hllplus_merge,
    hllplus_registers,
    ull_estimate,
    ull_merge,
    ull_registers,
)
from pinot_tpu_torch.query.quantile_sketch import (
    kll_create,
    kll_from_values,
    kll_merge,
    kll_quantile,
    kll_serialize,
    td_create,
    td_from_values,
    td_merge,
    td_quantile,
    td_serialize,
)
from pinot_tpu_torch.query.sketches import hash_any, murmur_mix32, np_hll_registers, hll_estimate

THETA_K = 4096  # KMV bottom-k size (Pinot theta default nominal entries)


@dataclass(frozen=True)
class AggSpec:
    n_args: int  # number of value-expression arguments (1 or 2)
    compute: Callable[[np.ndarray | None, np.ndarray | None, tuple], Any]
    merge: Callable[[Any, Any], Any]
    finalize: Callable[[Any, tuple], Any]
    empty: Callable[[tuple], Any]


def _f64(v) -> np.ndarray:
    return np.asarray(v, dtype=np.float64)


# -- moments: variance / stddev / skewness / kurtosis ------------------------
# partial = central moments (n, mean, M2[, M3[, M4]]) merged with Chan's
# parallel algorithm — numerically stable for data with large mean/spread
# ratios (epoch millis, big IDs), matching Pinot's VarianceAggregationFunction
# merge-by-moments approach.


def _moments_compute(order: int):
    def compute(v, _v2, _extra):
        x = _f64(v)
        n = len(x)
        if n == 0:
            return (0.0,) * (order + 1)
        mean = float(x.mean())
        d = x - mean
        parts = [float(n), mean, float(np.sum(d * d))]
        if order >= 3:
            parts.append(float(np.sum(d**3)))
        if order >= 4:
            parts.append(float(np.sum(d**4)))
        return tuple(parts)

    return compute


def _moments_merge(a, b):
    na = a[0]
    nb = b[0]
    if na == 0:
        return b
    if nb == 0:
        return a
    n = na + nb
    d = b[1] - a[1]
    mean = a[1] + d * nb / n
    m2 = a[2] + b[2] + d * d * na * nb / n
    out = [n, mean, m2]
    if len(a) >= 4:
        m3 = (
            a[3]
            + b[3]
            + d**3 * na * nb * (na - nb) / (n * n)
            + 3 * d * (na * b[2] - nb * a[2]) / n
        )
        out.append(m3)
    if len(a) >= 5:
        m4 = (
            a[4]
            + b[4]
            + d**4 * na * nb * (na * na - na * nb + nb * nb) / n**3
            + 6 * d * d * (na * na * b[2] + nb * nb * a[2]) / (n * n)
            + 4 * d * (na * b[3] - nb * a[3]) / n
        )
        out.append(m4)
    return tuple(out)


def _var_finalize(sample: bool):
    def fin(p, _extra):
        n, _mean, m2 = p[0], p[1], p[2]
        if n < (2.0 if sample else 1.0):
            return float("nan") if n == 0 or sample else 0.0
        return m2 / (n - 1) if sample else m2 / n

    return fin


def _std_finalize(sample: bool):
    vf = _var_finalize(sample)

    def fin(p, extra):
        v = vf(p, extra)
        return float(np.sqrt(v)) if v == v and v >= 0 else float("nan")

    return fin


def _skew_finalize(p, _extra):
    n, _mean, m2s, m3s = p
    if n < 1:
        return float("nan")
    m2 = m2s / n
    m3 = m3s / n
    return float(m3 / m2**1.5) if m2 > 0 else float("nan")


def _kurt_finalize(p, _extra):
    n, _mean, m2s, _m3s, m4s = p
    if n < 1:
        return float("nan")
    m2 = m2s / n
    m4 = m4s / n
    return float(m4 / (m2 * m2)) if m2 > 0 else float("nan")


# -- covariance --------------------------------------------------------------
# partial = (n, mean_x, mean_y, C) with C = sum((x-mx)(y-my)); Chan-style merge


def _covar_compute(v, v2, _extra):
    x, y = _f64(v), _f64(v2)
    n = len(x)
    if n == 0:
        return (0.0, 0.0, 0.0, 0.0)
    mx, my = float(x.mean()), float(y.mean())
    return (float(n), mx, my, float(np.sum((x - mx) * (y - my))))


def _covar_merge(a, b):
    na, nb = a[0], b[0]
    if na == 0:
        return b
    if nb == 0:
        return a
    n = na + nb
    dx = b[1] - a[1]
    dy = b[2] - a[2]
    return (
        n,
        a[1] + dx * nb / n,
        a[2] + dy * nb / n,
        a[3] + b[3] + dx * dy * na * nb / n,
    )


def _covar_finalize(sample: bool):
    def fin(p, _extra):
        n, _mx, _my, c = p
        if n < (2.0 if sample else 1.0):
            return float("nan")
        return c / (n - 1) if sample else c / n

    return fin


# -- first/last with time ----------------------------------------------------
# partial = (value, time) or None


def _fwt_compute(pick_last: bool):
    def compute(v, times, _extra):
        t = _f64(times)
        if len(t) == 0:
            return None
        i = int(np.argmax(t)) if pick_last else int(np.argmin(t))
        val = v[i]
        return (val.item() if hasattr(val, "item") else val, float(t[i]))

    return compute


def _fwt_merge(pick_last: bool):
    def merge(a, b):
        if a is None:
            return b
        if b is None:
            return a
        if pick_last:
            return a if a[1] >= b[1] else b
        return a if a[1] <= b[1] else b

    return merge


def _fwt_finalize(p, _extra):
    return p[0] if p is not None else None


# -- distinct sum / avg ------------------------------------------------------


def _set_compute(v, _v2, _extra):
    return set(np.asarray(v).tolist())


def _distinctsum_finalize(p, _extra):
    return float(sum(p)) if p else 0.0


def _distinctavg_finalize(p, _extra):
    return float(sum(p)) / len(p) if p else float("nan")


# -- booleans ----------------------------------------------------------------


def _bool_compute(all_mode: bool):
    def compute(v, _v2, _extra):
        x = np.asarray(v).astype(bool)
        if len(x) == 0:
            return None
        return bool(x.all()) if all_mode else bool(x.any())

    return compute


def _bool_merge(all_mode: bool):
    def merge(a, b):
        if a is None:
            return b
        if b is None:
            return a
        return (a and b) if all_mode else (a or b)

    return merge


# -- histogram ---------------------------------------------------------------
# extra = (lo, hi, n_bins); partial = int64 counts vector; result = list


def _hist_compute(v, _v2, extra):
    lo, hi, bins = float(extra[0]), float(extra[1]), int(extra[2])
    x = _f64(v)
    if hi <= lo:
        c = np.zeros(bins, dtype=np.int64)
        c[0] = len(x)
        return c
    b = np.clip(((x - lo) * (bins / (hi - lo))).astype(np.int64), 0, bins - 1)
    return np.bincount(b, minlength=bins).astype(np.int64)


# -- theta sketch (KMV bottom-k) ---------------------------------------------
# partial = sorted uint64 array of the k smallest hashes


def _hash64(values: np.ndarray) -> np.ndarray:
    h1 = hash_any(values)
    h2 = murmur_mix32(h1 ^ np.uint32(0x9E3779B9))
    return (h1.astype(np.uint64) << np.uint64(32)) | h2.astype(np.uint64)


def _theta_compute(v, _v2, _extra):
    h = np.unique(_hash64(np.asarray(v)))
    return h[:THETA_K]


def _theta_merge(a, b):
    u = np.union1d(a, b)
    return u[:THETA_K]


def _theta_finalize(p, _extra):
    k = len(p)
    if k < THETA_K:
        return k  # exact below sketch capacity
    theta = float(p[-1]) / float(2**64)
    return int(round((k - 1) / theta))


# -- theta sketch set algebra -------------------------------------------------
# DistinctCountThetaSketchAggregationFunction parity: filtered sketches plus
# a post-aggregation set expression SET_UNION/SET_INTERSECT/SET_DIFF($1..$N).
# KMV semantics: a sketch is (sorted uint64 hashes, theta); theta for a
# bottom-k sketch is its largest retained hash when full, else 1.0 (exact).


def _theta_theta(s: np.ndarray) -> float:
    return float(s[-1]) / float(2**64) if len(s) >= THETA_K else 1.0


def _theta_cut(a: np.ndarray, b: np.ndarray, theta: float | None):
    th = min(_theta_theta(a), _theta_theta(b)) if theta is None else theta
    cut = np.uint64(int(th * 2**64) - 1) if th < 1.0 else np.uint64(2**64 - 1)
    return a[a <= cut], b[b <= cut]


def theta_union(a: np.ndarray, b: np.ndarray, theta: float | None = None) -> np.ndarray:
    a, b = _theta_cut(a, b, theta)
    return np.union1d(a, b)


def theta_intersect(a: np.ndarray, b: np.ndarray, theta: float | None = None) -> np.ndarray:
    a, b = _theta_cut(a, b, theta)
    return np.intersect1d(a, b)


def theta_diff(a: np.ndarray, b: np.ndarray, theta: float | None = None) -> np.ndarray:
    a, b = _theta_cut(a, b, theta)
    return np.setdiff1d(a, b)


def theta_estimate(s: np.ndarray, theta: float | None = None) -> int:
    th = _theta_theta(s) if theta is None else theta
    if th >= 1.0:
        return int(len(s))
    return int(round(len(s) / th))


def eval_theta_expression(expr: str, sketches: list[np.ndarray]) -> int:
    """Evaluate SET_UNION/SET_INTERSECT/SET_DIFF over $1..$N placeholders
    (nested calls allowed) and estimate the resulting cardinality. Internally
    every node is (hashes, theta): set ops can shrink the hash set below
    capacity while theta stays < 1, so theta is tracked explicitly."""
    import re as _re

    tokens = _re.findall(
        r"SET_UNION|SET_INTERSECT|SET_DIFF|\$\d+|\(|\)|,", expr.upper().replace(" ", "")
    )
    pos = 0

    def peek() -> str:
        return tokens[pos] if pos < len(tokens) else ""

    def take() -> str:
        nonlocal pos
        if pos >= len(tokens):
            raise ValueError(f"truncated theta expression {expr!r}")
        tok = tokens[pos]
        pos += 1
        return tok

    _OPS = {"SET_UNION": theta_union, "SET_INTERSECT": theta_intersect, "SET_DIFF": theta_diff}

    def parse() -> tuple[np.ndarray, float]:
        tok = take()
        if tok.startswith("$"):
            idx = int(tok[1:]) - 1
            if not 0 <= idx < len(sketches):
                raise ValueError(
                    f"theta expression references ${idx + 1} but only {len(sketches)} filters exist"
                )
            s = sketches[idx]
            return s, _theta_theta(s)
        if tok not in _OPS:
            raise ValueError(f"bad theta expression token {tok!r} in {expr!r}")
        if take() != "(":
            raise ValueError(f"expected '(' after {tok} in {expr!r}")
        args = [parse()]
        while peek() == ",":
            take()
            args.append(parse())
        if take() != ")":
            raise ValueError(f"expected ')' in {expr!r}")
        th = min(a_th for _, a_th in args)
        hashes, _ = args[0]
        for other, _ in args[1:]:
            hashes = _OPS[tok](hashes, other, th)
        if tok == "SET_UNION" and len(hashes) > THETA_K:
            hashes = hashes[:THETA_K]
            th = min(th, _theta_theta(hashes))
        return hashes, th

    hashes, th = parse()
    if pos != len(tokens):
        raise ValueError(f"trailing tokens in theta expression {expr!r}")
    return theta_estimate(hashes, th)


_THETA_PARAM_KEYS = {
    "nominalentries",
    "samplingprobability",
    "accumulatorthreshold",
    "intermediatebuffersize",
}


def parse_theta_extra(extra: tuple) -> tuple[list[str], list[str], str | None]:
    """Classify DISTINCTCOUNTTHETASKETCH trailing string args into
    (params, filter predicates, post-aggregation set expression)."""
    import re as _re

    params: list[str] = []
    filters: list[str] = []
    postagg: str | None = None
    for s in extra:
        stripped = s.strip()
        if _re.match(r"(?i)^SET_(UNION|INTERSECT|DIFF)\s*\(", stripped):
            postagg = stripped
        elif (
            _re.fullmatch(r"\s*\w+\s*=\s*[\w.]+\s*", stripped)
            and stripped.split("=")[0].strip().lower() in _THETA_PARAM_KEYS
        ):
            params.append(stripped)
        else:
            filters.append(stripped)
    return params, filters, postagg


def _theta_is_multi(p) -> bool:
    return isinstance(p, tuple) and len(p) == 2 and p[0] == "multi"


def _theta_merge_any(a, b):
    am, bm = _theta_is_multi(a), _theta_is_multi(b)
    if am or bm:
        if not am:
            a = ("multi", [np.zeros(0, np.uint64)] * len(b[1]))
        if not bm:
            b = ("multi", [np.zeros(0, np.uint64)] * len(a[1]))
        return ("multi", [_theta_merge(x, y) for x, y in zip(a[1], b[1])])
    return _theta_merge(a, b)


def _theta_finalize_any(p, extra):
    if _theta_is_multi(p):
        _params, _filters, postagg = parse_theta_extra(extra)
        if postagg:
            return eval_theta_expression(postagg, p[1])
        return theta_estimate(p[1][0]) if p[1] else 0
    return _theta_finalize(p, extra)


# -- HLL-family stand-ins ----------------------------------------------------


def _hll_compute(v, _v2, _extra):
    return np_hll_registers(np.asarray(v))


def _hll_finalize(p, _extra):
    return hll_estimate(np.asarray(p))


# -- segment-partitioned distinct count --------------------------------------
# partial = per-segment distinct count (int); merge = sum (assumes values are
# partitioned by segment, the function's documented contract)


def _spdc_compute(v, _v2, _extra):
    return int(len(np.unique(np.asarray(v))))


# -- smart variants ----------------------------------------------------------
# DistinctCountSmartHLLAggregationFunction: exact set until a threshold, HLL
# registers beyond; PercentileSmartTDigestAggregationFunction: exact values
# until a threshold, then a bounded quantile summary.

SMART_HLL_THRESHOLD = 100_000


def _smarthll_compute(v, _v2, _extra):
    s = set(np.asarray(v).tolist())
    if len(s) > SMART_HLL_THRESHOLD:
        return np_hll_registers(np.asarray(list(s)))
    return s


def _smarthll_regs(p):
    return p if not isinstance(p, (set, frozenset)) else np_hll_registers(np.asarray(list(p)))


def _smarthll_merge(a, b):
    if isinstance(a, (set, frozenset)) and isinstance(b, (set, frozenset)):
        u = a | b
        if len(u) > SMART_HLL_THRESHOLD:
            return np_hll_registers(np.asarray(list(u)))
        return u
    return np.maximum(_smarthll_regs(a), _smarthll_regs(b))


def _smarthll_finalize(p, _extra):
    return len(p) if isinstance(p, (set, frozenset)) else hll_estimate(np.asarray(p))


# -- raw sketch variants -----------------------------------------------------
# DistinctCountRaw*/PercentileRaw* return the SERIALIZED sketch (hex string)
# instead of the estimate, for client-side merging.


def _hex(arr: np.ndarray) -> str:
    return np.ascontiguousarray(arr).tobytes().hex()


# -- frequent items (Misra-Gries summary) ------------------------------------
# FrequentLongs/StringsSketchAggregationFunction: partial = value -> count
# dict capped at maxMapSize (extra[0]); deterministic decrement-on-overflow.


def _freq_cap(counts: dict, cap: int) -> dict:
    """Batch Misra-Gries reduction: subtract the (cap+1)-th largest count
    from every entry and drop non-positives. Counts become underestimates
    with error bounded by n/cap (the sketch's documented guarantee)."""
    if len(counts) <= cap:
        return counts
    thresh = sorted(counts.values(), reverse=True)[cap]
    return {k: c - thresh for k, c in counts.items() if c > thresh}


# partial = (cap, counts) so merges honor the query's maxMapSize without
# access to `extra` (AggSpec merge takes only the two partials)


def _freq_compute(v, _v2, extra):
    cap = int(extra[0]) if extra else 64
    vals, counts = np.unique(np.asarray(v), return_counts=True)
    d = {(int(k) if isinstance(k, (np.integer, int)) else str(k)): int(c) for k, c in zip(vals, counts)}
    return (cap, _freq_cap(d, cap))


def _freq_merge(a, b):
    cap = max(a[0], b[0])
    out = dict(a[1])
    for k, c in b[1].items():
        out[k] = out.get(k, 0) + c
    return (cap, _freq_cap(out, cap))


def _freq_finalize(p, extra):
    cap, counts = p
    top = sorted(counts.items(), key=lambda kv: (-kv[1], str(kv[0])))[:cap]
    return {str(k): int(c) for k, c in top}


# -- expr min/max ------------------------------------------------------------
# ExprMinMaxAggregationFunction (parent/child pair in the reference): EXPRMIN
# (projCol, measureCol) returns projCol's value on the row where measureCol is
# minimal. partial = (measure, projection) or None; ties keep the first seen.


def _exprmm_compute(pick_max: bool):
    def compute(v, v2, _extra):
        m = _f64(v2)
        if len(m) == 0:
            return None
        i = int(np.argmax(m)) if pick_max else int(np.argmin(m))
        val = v[i]
        return (float(m[i]), val.item() if hasattr(val, "item") else val)

    return compute


def _exprmm_merge(pick_max: bool):
    def merge(a, b):
        if a is None:
            return b
        if b is None:
            return a
        if pick_max:
            return a if a[0] >= b[0] else b
        return a if a[0] <= b[0] else b

    return merge


def _exprmm_finalize(p, _extra):
    return p[1] if p is not None else None


# -- integer-sum tuple sketch family ------------------------------------------
# DistinctCountIntegerTupleSketch / SumValuesIntegerSumTupleSketch /
# AvgValueIntegerSumTupleSketch (+Raw). The reference consumes pre-serialized
# sketches from BYTES columns; here (as with our theta KMV) the sketch is built
# from raw (key, value) columns: partial = (sorted uint64 key hashes bottom-k,
# aligned int64 value sums). Same key twice -> values sum (integer-sum mode).


def _tuple_pack(h: np.ndarray, vals: np.ndarray):
    uh, inv = np.unique(h, return_inverse=True)
    sums = np.zeros(len(uh), dtype=np.int64)
    np.add.at(sums, inv, vals.astype(np.int64))
    return uh[:THETA_K], sums[:THETA_K]


def _tuple_compute(v, v2, _extra):
    h = _hash64(np.asarray(v))
    vals = np.asarray(v2, dtype=np.int64) if v2 is not None else np.ones(len(h), np.int64)
    return _tuple_pack(h, vals)


def _tuple_merge(a, b):
    return _tuple_pack(np.concatenate([a[0], b[0]]), np.concatenate([a[1], b[1]]))


def _tuple_theta(p) -> float:
    return _theta_theta(p[0])


def _tuple_distinct_finalize(p, _extra):
    k = len(p[0])
    th = _tuple_theta(p)
    if th >= 1.0:
        return k
    return int(round((k - 1) / th))


def _tuple_sum_finalize(p, _extra):
    return int(round(float(p[1].sum()) / _tuple_theta(p)))


def _tuple_avg_finalize(p, _extra):
    return int(round(float(p[1].mean()))) if len(p[1]) else 0


def _tuple_raw_finalize(p, _extra):
    return _hex(np.asarray(p[0], dtype=np.uint64)) + ":" + _hex(np.asarray(p[1], dtype=np.int64))


_TUPLE_EMPTY = lambda e: (np.zeros(0, np.uint64), np.zeros(0, np.int64))  # noqa: E731


# -- ST_UNION -----------------------------------------------------------------
# StUnionAggregationFunction unions geometries (JTS) from a BYTES column. The
# framework keeps geo as lat/lng numerics or WKT strings, so the union is the
# distinct value set, rendered as WKT: POINT entries collapse into one
# MULTIPOINT; anything else becomes a GEOMETRYCOLLECTION of the raw members.


def _stunion_finalize(p, _extra):
    import re as _re

    if not p:
        return "GEOMETRYCOLLECTION EMPTY"
    vals = sorted(str(x) for x in p)
    pts = [_re.fullmatch(r"(?i)\s*POINT\s*\(([^)]+)\)\s*", v) for v in vals]
    if all(m is not None for m in pts):
        return "MULTIPOINT (" + ", ".join("(" + m.group(1).strip() + ")" for m in pts) + ")"
    if all(_re.fullmatch(r"-?\d+(\.\d+)?", v) for v in vals):
        return "MULTIPOINT (" + ", ".join("(" + v + " 0)" for v in vals) + ")"
    return "GEOMETRYCOLLECTION (" + ", ".join(vals) + ")"


# -- array / list collection aggregations -------------------------------------
# ArrayAgg / ListAgg (ARRAYAGG(col, 'dataType'[, distinct]), LISTAGG(col,
# separator)): partial = python list of values, merged by concatenation.


def _collect_compute(v, _v2, _extra):
    return list(np.asarray(v).tolist())


def _arrayagg_finalize(p, extra):
    distinct = len(extra) > 1 and str(extra[1]).lower() in ("true", "1")
    vals = list(dict.fromkeys(p)) if distinct else p
    dt = str(extra[0]).upper() if extra else "DOUBLE"
    if dt in ("INT", "LONG", "TIMESTAMP", "BOOLEAN"):
        return [int(x) for x in vals]
    if dt in ("FLOAT", "DOUBLE"):
        return [float(x) for x in vals]
    return [str(x) for x in vals]


def _listagg_finalize(p, extra):
    sep = str(extra[0]) if extra else ","
    return sep.join(str(x) for x in p)


# -- element-wise MV array sums ------------------------------------------------
# SumArrayLong / SumArrayDouble: element-wise vector sum over an MV column;
# shorter arrays pad with zero (the reference requires equal lengths).


def _sumarray_compute(dtype):
    def compute(v, _v2, _extra):
        # int64 accumulation keeps long arithmetic exact (values above 2^53
        # would lose precision in a float64 accumulator)
        out = np.zeros(0, dtype=dtype)
        for arr in v:
            a = np.asarray(arr, dtype=dtype)
            if len(a) > len(out):
                out = np.pad(out, (0, len(a) - len(out)))
            out[: len(a)] += a
        return out

    return compute


def _sumarray_merge(a, b):
    if len(a) < len(b):
        a, b = b, a
    a = a.copy()
    a[: len(b)] += b.astype(a.dtype)
    return a


# -- fourth moment -------------------------------------------------------------
# FourthMomentAggregationFunction: SQL FOURTHMOMENT(col) returns the central
# fourth moment m4 = sum((x-mean)^4)/n (the building block kurtosis shares).


def _m4_finalize(p, _extra):
    n = p[0]
    return float(p[4] / n) if n else float("nan")


# -- sum with full precision -------------------------------------------------
# SumPrecisionAggregationFunction: BigDecimal accumulation — python ints are
# arbitrary precision, so integer inputs sum exactly; floats use math.fsum.


def _sumprecision_compute(v, _v2, _extra):
    x = np.asarray(v)
    if np.issubdtype(x.dtype, np.integer):
        return int(x.astype(object).sum()) if len(x) else 0
    import math

    return math.fsum(x.astype(np.float64))


# -- idset -------------------------------------------------------------------
# IdSetAggregationFunction: collects the distinct id set; the reference
# returns a serialized IdSet — we emit the sorted id list.


# ---------------------------------------------------------------------------

# shared specs for the HLL-register stand-in families (AggSpec is frozen, so
# multiple SQL names can share one instance): estimate-returning and
# hex-serialized-raw variants
_HLL_SPEC = AggSpec(
    1,
    _hll_compute,
    lambda a, b: np.maximum(a, b),
    _hll_finalize,
    lambda e: np_hll_registers(np.zeros(0)),
)
_RAW_HLL_SPEC = AggSpec(
    1,
    _hll_compute,
    lambda a, b: np.maximum(a, b),
    lambda p, e: _hex(np.asarray(p, dtype=np.int8)),
    lambda e: np_hll_registers(np.zeros(0)),
)


def _kll_k(extra: tuple) -> int:
    """PERCENTILEKLL(col, pct[, k]) — k rides behind the percentile."""
    from pinot_tpu_torch.query.quantile_sketch import KLL_DEFAULT_K

    return int(extra[1]) if len(extra) > 1 and extra[1] else KLL_DEFAULT_K


def _td_comp(extra: tuple) -> float:
    """PERCENTILETDIGEST(col, pct[, compression])."""
    from pinot_tpu_torch.query.quantile_sketch import TD_DEFAULT_COMPRESSION

    return float(extra[1]) if len(extra) > 1 and extra[1] else TD_DEFAULT_COMPRESSION


def _hpp_p(extra: tuple) -> int:
    """DISTINCTCOUNTHLLPLUS(col[, p[, sp]])."""
    from pinot_tpu_torch.query.distinct_sketch import HLLPLUS_P

    return int(extra[0]) if extra and extra[0] else HLLPLUS_P


_HLLPLUS_SPEC = AggSpec(
    1,
    lambda v, _v2, e: hllplus_registers(np.asarray(v), _hpp_p(e)),
    hllplus_merge,
    lambda p, e: hllplus_estimate(p),
    lambda e: hllplus_registers(np.zeros(0), _hpp_p(e)),
)
_RAW_HLLPLUS_SPEC = AggSpec(
    1,
    lambda v, _v2, e: hllplus_registers(np.asarray(v), _hpp_p(e)),
    hllplus_merge,
    lambda p, e: _hex(np.asarray(p, dtype=np.int8)),
    lambda e: hllplus_registers(np.zeros(0), _hpp_p(e)),
)
_ULL_SPEC = AggSpec(
    1,
    lambda v, _v2, e: ull_registers(np.asarray(v)),
    ull_merge,
    lambda p, e: ull_estimate(p),
    lambda e: ull_registers(np.zeros(0)),
)
_RAW_ULL_SPEC = AggSpec(
    1,
    lambda v, _v2, e: ull_registers(np.asarray(v)),
    ull_merge,
    lambda p, e: _hex(np.asarray(p, dtype=np.int16)),
    lambda e: ull_registers(np.zeros(0)),
)
_CPC_SPEC = AggSpec(
    1,
    lambda v, _v2, e: cpc_matrix(np.asarray(v)),
    cpc_merge,
    lambda p, e: cpc_estimate(p),
    lambda e: cpc_matrix(np.zeros(0)),
)
_RAW_CPC_SPEC = AggSpec(
    1,
    lambda v, _v2, e: cpc_matrix(np.asarray(v)),
    cpc_merge,
    lambda p, e: _hex(np.asarray(p, dtype=np.uint64)),
    lambda e: cpc_matrix(np.zeros(0)),
)

EXT_AGGS: dict[str, AggSpec] = {
    "distinctcountsmarthll": AggSpec(1, _smarthll_compute, _smarthll_merge, _smarthll_finalize, lambda e: set()),
    "percentilesmarttdigest": AggSpec(
        1,
        lambda v, _v2, e: td_from_values(_f64(v), _td_comp(e)),
        td_merge,
        lambda p, e: td_quantile(p, e[0]),
        lambda e: td_create(_td_comp(e)),
    ),
    "sumprecision": AggSpec(1, _sumprecision_compute, lambda a, b: a + b, lambda p, e: p, lambda e: 0),
    "idset": AggSpec(
        1,
        _set_compute,
        lambda a, b: a | b,
        lambda p, e: sorted(str(x) for x in p),
        lambda e: set(),
    ),
    "frequentlongssketch": AggSpec(1, _freq_compute, _freq_merge, _freq_finalize, lambda e: (int(e[0]) if e else 64, {})),
    "frequentstringssketch": AggSpec(1, _freq_compute, _freq_merge, _freq_finalize, lambda e: (int(e[0]) if e else 64, {})),
    "distinctcountrawhll": _RAW_HLL_SPEC,
    "distinctcountrawthetasketch": AggSpec(
        1,
        _theta_compute,
        _theta_merge,
        lambda p, e: _hex(np.asarray(p, dtype=np.uint64)),
        lambda e: np.zeros(0, np.uint64),
    ),
    "percentilerawest": AggSpec(
        1,
        lambda v, _v2, e: td_from_values(_f64(v), _td_comp(e)),
        td_merge,
        lambda p, e: td_serialize(p).hex(),
        lambda e: td_create(_td_comp(e)),
    ),
    "percentilerawtdigest": AggSpec(
        1,
        lambda v, _v2, e: td_from_values(_f64(v), _td_comp(e)),
        td_merge,
        lambda p, e: td_serialize(p).hex(),
        lambda e: td_create(_td_comp(e)),
    ),
    "variance": AggSpec(1, _moments_compute(2), _moments_merge, _var_finalize(False), lambda e: (0.0, 0.0, 0.0)),
    "var_pop": AggSpec(1, _moments_compute(2), _moments_merge, _var_finalize(False), lambda e: (0.0, 0.0, 0.0)),
    "var_samp": AggSpec(1, _moments_compute(2), _moments_merge, _var_finalize(True), lambda e: (0.0, 0.0, 0.0)),
    "stddev_pop": AggSpec(1, _moments_compute(2), _moments_merge, _std_finalize(False), lambda e: (0.0, 0.0, 0.0)),
    "stddev_samp": AggSpec(1, _moments_compute(2), _moments_merge, _std_finalize(True), lambda e: (0.0, 0.0, 0.0)),
    "skewness": AggSpec(
        1, _moments_compute(3), _moments_merge, _skew_finalize, lambda e: (0.0, 0.0, 0.0, 0.0)
    ),
    "kurtosis": AggSpec(
        1, _moments_compute(4), _moments_merge, _kurt_finalize, lambda e: (0.0, 0.0, 0.0, 0.0, 0.0)
    ),
    "covar_pop": AggSpec(2, _covar_compute, _covar_merge, _covar_finalize(False), lambda e: (0.0,) * 4),
    "covar_samp": AggSpec(2, _covar_compute, _covar_merge, _covar_finalize(True), lambda e: (0.0,) * 4),
    "firstwithtime": AggSpec(2, _fwt_compute(False), _fwt_merge(False), _fwt_finalize, lambda e: None),
    "lastwithtime": AggSpec(2, _fwt_compute(True), _fwt_merge(True), _fwt_finalize, lambda e: None),
    "distinctsum": AggSpec(1, _set_compute, lambda a, b: a | b, _distinctsum_finalize, lambda e: set()),
    "distinctavg": AggSpec(1, _set_compute, lambda a, b: a | b, _distinctavg_finalize, lambda e: set()),
    "bool_and": AggSpec(1, _bool_compute(True), _bool_merge(True), lambda p, e: p, lambda e: None),
    "bool_or": AggSpec(1, _bool_compute(False), _bool_merge(False), lambda p, e: p, lambda e: None),
    "histogram": AggSpec(
        1,
        _hist_compute,
        lambda a, b: a + b,
        lambda p, e: [int(x) for x in p],
        lambda e: np.zeros(int(e[2]), dtype=np.int64),
    ),
    "percentilekll": AggSpec(
        1,
        lambda v, _v2, e: kll_from_values(_f64(v), _kll_k(e)),
        kll_merge,
        lambda p, e: kll_quantile(p, e[0]),
        lambda e: kll_create(_kll_k(e)),
    ),
    "distinctcounttheta": AggSpec(1, _theta_compute, _theta_merge_any, _theta_finalize_any, lambda e: np.zeros(0, np.uint64)),
    "arrayagg": AggSpec(1, _collect_compute, lambda a, b: a + b, _arrayagg_finalize, lambda e: []),
    "listagg": AggSpec(1, _collect_compute, lambda a, b: a + b, _listagg_finalize, lambda e: []),
    "sum0": AggSpec(
        1,
        lambda v, _v2, e: float(_f64(v).sum()),
        lambda a, b: a + b,
        lambda p, e: float(p),
        lambda e: 0.0,  # Calcite SUM0: empty input -> 0, not null/default
    ),
    "sumarraylong": AggSpec(
        1,
        _sumarray_compute(np.int64),
        _sumarray_merge,
        lambda p, e: [int(x) for x in p],
        lambda e: np.zeros(0, dtype=np.int64),
    ),
    "sumarraydouble": AggSpec(
        1,
        _sumarray_compute(np.float64),
        _sumarray_merge,
        lambda p, e: [float(x) for x in p],
        lambda e: np.zeros(0, dtype=np.float64),
    ),
    "fourthmoment": AggSpec(
        1, _moments_compute(4), _moments_merge, _m4_finalize, lambda e: (0.0,) * 5
    ),
    "exprmin": AggSpec(2, _exprmm_compute(False), _exprmm_merge(False), _exprmm_finalize, lambda e: None),
    "exprmax": AggSpec(2, _exprmm_compute(True), _exprmm_merge(True), _exprmm_finalize, lambda e: None),
    "distinctcounttuplesketch": AggSpec(2, _tuple_compute, _tuple_merge, _tuple_distinct_finalize, _TUPLE_EMPTY),
    "distinctcountrawintegersumtuplesketch": AggSpec(2, _tuple_compute, _tuple_merge, _tuple_raw_finalize, _TUPLE_EMPTY),
    "sumvaluesintegersumtuplesketch": AggSpec(2, _tuple_compute, _tuple_merge, _tuple_sum_finalize, _TUPLE_EMPTY),
    "avgvalueintegersumtuplesketch": AggSpec(2, _tuple_compute, _tuple_merge, _tuple_avg_finalize, _TUPLE_EMPTY),
    "fasthll": _HLL_SPEC,
    "stunion": AggSpec(1, _set_compute, lambda a, b: a | b, _stunion_finalize, lambda e: set()),
    "percentilerawkll": AggSpec(
        1,
        lambda v, _v2, e: kll_from_values(_f64(v), _kll_k(e)),
        kll_merge,
        lambda p, e: kll_serialize(p).hex(),
        lambda e: kll_create(_kll_k(e)),
    ),
    "distinctcountrawhllplus": _RAW_HLLPLUS_SPEC,
    "distinctcountrawull": _RAW_ULL_SPEC,
    "distinctcountrawcpcsketch": _RAW_CPC_SPEC,
    "distinctcounthllplus": _HLLPLUS_SPEC,
    "distinctcountcpc": _CPC_SPEC,
    "distinctcountcpcsketch": _CPC_SPEC,  # SQL alias (DISTINCTCOUNTCPCSKETCH)
    "distinctcountull": _ULL_SPEC,
    "segmentpartitioneddistinctcount": AggSpec(1, _spdc_compute, lambda a, b: a + b, lambda p, e: int(p), lambda e: 0),
}


def exact_percentile(values: np.ndarray, pct: float) -> float:
    """Pinot PercentileAggregationFunction: value at (int)((len-1)*pct/100).
    Used by the exact PERCENTILE path (reduce.py)."""
    if len(values) == 0:
        return float("-inf")
    v = np.sort(np.asarray(values, dtype=np.float64))
    return float(v[int((len(v) - 1) * pct / 100.0)])


# funcs whose second SQL argument is a value expression (not a literal extra)
TWO_ARG_AGGS = {f for f, s in EXT_AGGS.items() if s.n_args == 2}
