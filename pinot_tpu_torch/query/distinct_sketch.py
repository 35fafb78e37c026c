"""Distinct-count sketches that are genuinely distinct algorithms from the
engine's core HLL (sketches.py: 32-bit hash, log2m=11, classic bias
correction):

  HLL++  — 64-bit hashing, p=14 dense registers, linear-counting switch at
           the published per-precision threshold (the empirical bias-table
           interpolation of the paper is omitted; docstring-honest ~1% bias
           in the crossover band). Reference:
           DistinctCountHLLPlusAggregationFunction (pinot-core/.../function/
           DistinctCountHLLPlusAggregationFunction.java, backed by
           zetasketch-style HyperLogLogPlus).
  ULL    — Ertl's UltraLogLog register structure (max rank + two trailing
           indicator bits per register) with a maximum-likelihood estimator
           solved by vectorized Newton/bisection over the Poisson model.
           Reference: DistinctCountULLAggregationFunction (backed by
           dynatrace-oss hash4j UltraLogLog).
  CPC    — the uncompressed probabilistic-counting core of CPC: an FM85
           (PCSA) bit matrix, row-OR merge, mean-lowest-zero-bit estimator
           with linear-counting small-range correction. The entropy-coded
           compression layer of the DataSketches CPC format is NOT
           implemented — partials are a fixed m×64-bit matrix. Reference:
           DistinctCountCPCSketchAggregationFunction (pinot-core/.../function/
           DistinctCountCPCSketchAggregationFunction.java:54).

This is the JAX package's module of the same name carried over unchanged
(numpy only), so partials built by either package merge with the other's.

All partials are fixed-size ndarrays; merges are elementwise max / OR —
associative, commutative, idempotent.
"""

from __future__ import annotations

import math

import numpy as np

HLLPLUS_P = 14  # Pinot DEFAULT_HLL_PLUS_SP=0, p=14
ULL_P = 12
CPC_LGK = 10  # 1024 rows x 64 bits = 8KB partial


def hash64(values: np.ndarray) -> np.ndarray:
    """64-bit splitmix64 finalizer over a type-stable 64-bit projection of
    the values (strings via the shared 32-bit content hash widened, numerics
    via their bit pattern)."""
    from pinot_tpu_torch.query.sketches import hash_values_host

    values = np.asarray(values)
    if values.dtype == object or values.dtype.kind in ("U", "S"):
        z = hash_values_host(values).astype(np.uint64)
    elif values.dtype.kind == "f":
        z = np.ascontiguousarray(values.astype(np.float64)).view(np.uint64)
    else:
        z = values.astype(np.int64).view(np.uint64)
    z = (z + np.uint64(0x9E3779B97F4A7C15)).astype(np.uint64)
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return (z ^ (z >> np.uint64(31))).astype(np.uint64)


def _rank_of(h: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """(register index from the top p bits, 1-based position of the first
    1-bit in the remaining 64-p bits, capped at 64-p+1)."""
    idx = (h >> np.uint64(64 - p)).astype(np.int64)
    w = (h << np.uint64(p)).astype(np.uint64)
    maxrank = 64 - p + 1
    # nlz via float64 log2 is unsafe above 2^53; use bit-length through
    # successive shifts instead: rank = 64 - bit_length(w) + 1
    bl = np.zeros(len(w), dtype=np.int64)
    cur = w.copy()
    for shift in (32, 16, 8, 4, 2, 1):
        mask = cur >= (np.uint64(1) << np.uint64(shift))
        bl[mask] += shift
        cur[mask] >>= np.uint64(shift)
    bl[cur > 0] += 1
    rank = np.where(w == 0, maxrank, 64 - bl + 1).astype(np.int64)
    return idx, np.minimum(rank, maxrank)


# ---------------------------------------------------------------------------
# HLL++ (dense)
# ---------------------------------------------------------------------------

# linear-counting thresholds from the HLL++ paper (Heule et al.), per p
_HLLPP_THRESHOLD = {10: 900, 11: 1800, 12: 3100, 13: 6500, 14: 11500, 15: 22000, 16: 50000}


def hllplus_registers(values: np.ndarray, p: int = HLLPLUS_P) -> np.ndarray:
    m = 1 << p
    regs = np.zeros(m, dtype=np.int8)
    if len(values) == 0:
        return regs
    idx, rank = _rank_of(hash64(values), p)
    np.maximum.at(regs, idx, rank.astype(np.int8))
    return regs


def hllplus_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.maximum(a, b)


def hllplus_estimate(regs: np.ndarray) -> int:
    m = len(regs)
    p = int(math.log2(m))
    alpha = 0.7213 / (1.0 + 1.079 / m)
    raw = alpha * m * m / np.sum(np.exp2(-regs.astype(np.float64)))
    zeros = int(np.count_nonzero(regs == 0))
    if zeros:
        lc = m * math.log(m / zeros)
        if lc <= _HLLPP_THRESHOLD.get(p, 5 * m):
            return int(round(lc))
    return int(round(raw))


# ---------------------------------------------------------------------------
# ULL (UltraLogLog)
# ---------------------------------------------------------------------------


def _ull_state(q: np.ndarray, b1: np.ndarray, b0: np.ndarray) -> np.ndarray:
    return (q.astype(np.int64) << 2 | b1.astype(np.int64) << 1 | b0.astype(np.int64)).astype(
        np.int16
    )


def ull_registers(values: np.ndarray, p: int = ULL_P) -> np.ndarray:
    """Register = (q=max rank seen) with two indicator bits for ranks q-1 and
    q-2 (Ertl's ULL structure). Built directly from per-register rank
    statistics: q = max rank, b1/b0 = whether q-1 / q-2 appeared."""
    m = 1 << p
    regs = np.zeros(m, dtype=np.int16)
    if len(values) == 0:
        return regs
    idx, rank = _rank_of(hash64(values), p)
    qmax = np.zeros(m, dtype=np.int64)
    np.maximum.at(qmax, idx, rank)
    # presence bitset per register for ranks q-1 / q-2: scatter rank hits
    # into a (m, 2) presence table relative to the register's final q
    b1 = np.zeros(m, dtype=bool)
    b0 = np.zeros(m, dtype=bool)
    hit1 = rank == (qmax[idx] - 1)
    hit0 = rank == (qmax[idx] - 2)
    np.logical_or.at(b1, idx[hit1], True)
    np.logical_or.at(b0, idx[hit0], True)
    mask = qmax > 0
    out = np.zeros(m, dtype=np.int16)
    out[mask] = _ull_state(qmax[mask], b1[mask], b0[mask])[...]
    return out


def _ull_decode(regs: np.ndarray):
    q = (regs >> 2).astype(np.int64)
    b1 = ((regs >> 1) & 1).astype(bool)
    b0 = (regs & 1).astype(bool)
    return q, b1, b0


def _ull_rank_seen(q, b1, b0, r):
    """Whether rank r is recorded as seen by a register state (ranks below
    q-2 are absorbed/unknown -> False, exactly the information ULL keeps)."""
    return (r == q) | ((r == q - 1) & b1) | ((r == q - 2) & b0)


def ull_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    qa, b1a, b0a = _ull_decode(a)
    qb, b1b, b0b = _ull_decode(b)
    q = np.maximum(qa, qb)
    nb1 = _ull_rank_seen(qa, b1a, b0a, q - 1) | _ull_rank_seen(qb, b1b, b0b, q - 1)
    nb0 = _ull_rank_seen(qa, b1a, b0a, q - 2) | _ull_rank_seen(qb, b1b, b0b, q - 2)
    out = _ull_state(q, nb1, nb0)
    out[q == 0] = 0
    return out


def ull_estimate(regs: np.ndarray) -> int:
    """Maximum-likelihood cardinality under the Poisson model. Per register
    with state (q, b1, b0), the log-likelihood at rate λ = n/m:

        ranks j>q unseen:          -λ·2^-q
        rank q seen:               log(1 - e^(-λ·2^-q))
        rank q-1 (if q≥2):         b1 ? log(1-e^(-λ·2^-(q-1))) : -λ·2^-(q-1)
        rank q-2 (if q≥3):         b0 ? log(1-e^(-λ·2^-(q-2))) : -λ·2^-(q-2)
        empty register:            -λ

    The total is concave in λ; 60 bisection steps on dll/dλ give machine
    precision. Vectorized over registers, so the estimate costs O(m) per
    iteration."""
    m = len(regs)
    q, b1, b0 = _ull_decode(regs)
    nonempty = q > 0
    n_empty = int(m - np.count_nonzero(nonempty))
    if not nonempty.any():
        return 0
    qn = q[nonempty].astype(np.float64)
    # (weight, seen) pairs: unseen tail 2^-q always; the three observed slots
    w_seen = [np.exp2(-qn)]
    seen_masks = [np.ones(len(qn), dtype=bool)]
    for off, bits in ((1, b1[nonempty]), (2, b0[nonempty])):
        valid = qn - off >= 1
        w = np.where(valid, np.exp2(-(qn - off)), 0.0)
        w_seen.append(w)
        seen_masks.append(bits & valid)
    w_tail = np.exp2(-qn)  # ranks above q
    # unseen slots among the two indicator positions
    w_unseen = w_tail.copy()
    for off, bits in ((1, b1[nonempty]), (2, b0[nonempty])):
        valid = qn - off >= 1
        w_unseen = w_unseen + np.where(valid & ~bits, np.exp2(-(qn - off)), 0.0)
    # absorbed low ranks j <= q-3 contribute nothing observable

    def dll(lam: float) -> float:
        # d/dλ of total log-likelihood
        total = -n_empty  # each empty register: -λ -> derivative -1
        total -= float(np.sum(w_unseen))
        for w, sm in zip(w_seen, seen_masks):
            ws = w[sm]
            if len(ws):
                x = lam * ws
                total += float(np.sum(ws * np.exp(-x) / -np.expm1(-x)))
        return total

    lo, hi = 1e-9, 1e9
    for _ in range(80):
        mid = math.sqrt(lo * hi)
        if dll(mid) > 0:
            lo = mid
        else:
            hi = mid
    return int(round(math.sqrt(lo * hi) * m))


# ---------------------------------------------------------------------------
# CPC core (FM85 / PCSA bit matrix)
# ---------------------------------------------------------------------------

_PCSA_PHI = 0.77351


def cpc_matrix(values: np.ndarray, lgk: int = CPC_LGK) -> np.ndarray:
    m = 1 << lgk
    rows = np.zeros(m, dtype=np.uint64)
    if len(values) == 0:
        return rows
    idx, rank = _rank_of(hash64(values), lgk)
    bits = (np.uint64(1) << (rank - 1).astype(np.uint64)).astype(np.uint64)
    np.bitwise_or.at(rows, idx, bits)
    return rows


def cpc_merge(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a | b


def cpc_estimate(rows: np.ndarray) -> int:
    """Maximum-likelihood estimate over the full bit matrix. Under the
    Poisson model, bit (row, j) is set with probability 1 - e^(-λ·2^-(j+1))
    where λ = n/m, independently per cell — so only the per-rank set-bit
    counts c_j matter:

        ll(λ) = Σ_j [ c_j·log(1 - e^(-λ·w_j)) - (m - c_j)·λ·w_j ],  w_j = 2^-(j+1)

    Concave in λ; bisection on dll/dλ converges to machine precision. Using
    every bit (not just the lowest-zero index of the classic PCSA estimator)
    removes the small/mid-range bias, so no linear-counting switch is
    needed."""
    m = len(rows)
    if not int(np.count_nonzero(rows)):
        return 0
    # per-rank set-bit counts across rows
    c = np.array(
        [int(np.count_nonzero(rows & (np.uint64(1) << np.uint64(j)))) for j in range(64)],
        dtype=np.float64,
    )
    w = np.exp2(-(np.arange(64, dtype=np.float64) + 1.0))

    def dll(lam: float) -> float:
        x = lam * w
        with np.errstate(over="ignore"):
            seen = c * w * np.exp(-x) / -np.expm1(-x)
        return float(np.sum(seen) - np.sum((m - c) * w))

    lo, hi = 1e-9, 1e12
    for _ in range(80):
        mid = math.sqrt(lo * hi)
        if dll(mid) > 0:
            lo = mid
        else:
            hi = mid
    return int(round(math.sqrt(lo * hi) * m))
