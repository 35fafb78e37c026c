"""HyperLogLog for DISTINCTCOUNTHLL: host hashing and the device register update.

Reference parity: DistinctCountHLLAggregationFunction (pinot-core/.../query/
aggregation/function/DistinctCountHLLAggregationFunction.java, default
log2m=12) and PercentileEstAggregationFunction. This is the JAX package's
`query/sketches.py`: the same hash, the same register index and rank, the
same estimate, so registers built by either package merge with the other's,
and the same fixed-bin histogram for PERCENTILEEST.

 * Registers are a dense (m,) int32 vector per (segment, agg); the per-doc
   update is hash -> (register index, rank) -> scatter-max. Merges are
   elementwise max.
 * Dictionary-encoded columns hash their dictionary VALUES on the host
   (cardinality-sized, `hash_values_host` / `hash_any`) and the device gathers
   the hash by dict id, so strings never reach the device. Raw numeric columns
   hash on the device through `mix32`, by value for integers and by the two
   32-bit words of the float64 bit pattern for floats.

torch has no uint32 arithmetic that wraps on CUDA, so the device mixer keeps
each 32-bit word in an int64 tensor and multiplies in 16-bit halves: every
intermediate stays below 2^49 and the low 32 bits are the uint32 product's.
"""

from __future__ import annotations

import zlib

import numpy as np

HLL_LOG2M = 12  # Pinot default log2m
HLL_M = 1 << HLL_LOG2M
EST_BINS = 4096

_M32 = 0xFFFFFFFF
_C1 = 0x85EBCA6B
_C2 = 0xC2B2AE35


def murmur_mix32(x: np.ndarray) -> np.ndarray:
    """murmur3 fmix32 over uint32 (numpy, host side)."""
    h = x.astype(np.uint32)
    h ^= h >> 16
    h = (h * np.uint32(_C1)) & np.uint32(_M32)
    h ^= h >> 13
    h = (h * np.uint32(_C2)) & np.uint32(_M32)
    h ^= h >> 16
    return h


def hash_values_host(values: np.ndarray) -> np.ndarray:
    """Hash arbitrary dictionary values to uint32 (host, cardinality-sized):
    crc32 of the bytes or the UTF-8 text, then fmix32."""
    out = np.empty(len(values), dtype=np.uint32)
    for i, v in enumerate(values):
        b = bytes(v) if isinstance(v, (bytes, bytearray)) else str(v).encode("utf-8")
        out[i] = zlib.crc32(b) & _M32
    return murmur_mix32(out)


def hash_any(values: np.ndarray) -> np.ndarray:
    """Hash values to uint32 with type-stable schemes: strings/bytes via crc,
    numerics via their bit pattern, matching the device mixers, so one
    logical value hashes identically through a dictionary gather or a raw
    device column."""
    values = np.asarray(values)
    if values.dtype == object or values.dtype.kind in ("U", "S"):
        return hash_values_host(values)
    if values.dtype.kind == "f":
        bits = np.ascontiguousarray(values.astype(np.float64)).view(np.uint32).reshape(-1, 2)
        return murmur_mix32(bits[:, 0] ^ murmur_mix32(bits[:, 1]))
    v = values.astype(np.int64)
    lo32 = (v & _M32).astype(np.uint32)
    hi32 = ((v >> 32) & _M32).astype(np.uint32)
    return murmur_mix32(lo32 ^ murmur_mix32(hi32))


def hll_estimate(registers: np.ndarray) -> int:
    """Bias-corrected HLL cardinality estimate from a register vector."""
    m = len(registers)
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-registers.astype(np.float64)))
    zeros = int((registers == 0).sum())
    if est <= 2.5 * m and zeros > 0:
        est = m * np.log(m / zeros)
    return int(round(est))


def np_hll_registers(values: np.ndarray, log2m: int = HLL_LOG2M) -> np.ndarray:
    """Host (numpy) HLL register build over raw values: the same registers the
    device update gives for the same values."""
    if len(values) == 0:
        return np.zeros(1 << log2m, dtype=np.int32)
    h = hash_any(values)
    m = 1 << log2m
    idx = (h >> (32 - log2m)).astype(np.int64)
    w = (h << np.uint32(log2m)).astype(np.uint32)
    maxrank = 32 - log2m + 1
    with np.errstate(divide="ignore"):
        lg = np.where(w > 0, np.floor(np.log2(np.maximum(w, 1).astype(np.float64))), 0)
    rank = np.where(w == 0, maxrank, np.minimum(31 - lg + 1, maxrank)).astype(np.int32)
    regs = np.zeros(m, dtype=np.int32)
    np.maximum.at(regs, idx, rank)
    return regs


def np_est_hist(values: np.ndarray, lo: float, hi: float) -> np.ndarray:
    """Fixed-bin histogram counts over the engine's global [lo, hi] bounds,
    the one binning formula every PERCENTILEEST partial producer shares."""
    v = np.asarray(values, dtype=np.float64)
    if hi > lo:
        b = np.clip(((v - lo) * (EST_BINS / (hi - lo))).astype(np.int64), 0, EST_BINS - 1)
        return np.bincount(b, minlength=EST_BINS).astype(np.int64)
    counts = np.zeros(EST_BINS, dtype=np.int64)
    counts[0] = len(v)
    return counts


def hist_estimate(counts: np.ndarray, lo: float, hi: float, pct: float) -> float:
    """Percentile estimate from a fixed-bin histogram (inclusive-rank rule,
    matching sorted-array index (len-1)*pct/100): the containing bin's
    midpoint."""
    total = int(counts.sum())
    if total == 0:
        return float("-inf")
    if hi <= lo:
        return float(lo)
    target = int((total - 1) * pct / 100.0)
    cum = np.cumsum(counts)
    b = int(np.searchsorted(cum, target + 1))
    width = (hi - lo) / len(counts)
    return float(lo + (b + 0.5) * width)


# ---------------------------------------------------------------------------
# device side: uint32 words held in int64 tensors
# ---------------------------------------------------------------------------


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32), in 16-bit halves of c: no
    intermediate passes 2^49."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 of int64 tensors holding uint32 words (jnp_mix32's
    counterpart)."""
    h = h ^ (h >> 16)
    h = _mul32(h, _C1)
    h = h ^ (h >> 13)
    h = _mul32(h, _C2)
    return h ^ (h >> 16)


def hash_device(v: torch.Tensor) -> torch.Tensor:
    """Per-doc uint32 hash (int64 tensor) of numeric values, `hash_any`'s
    numeric schemes: floats by the two words of their float64 bits (low word
    first), integers by the two words of their int64 value."""
    import torch  # the segment store imports this module in processes without torch

    if v.dtype.is_floating_point:
        words = v.to(torch.float64).contiguous().view(torch.int32).reshape(-1, 2).to(torch.int64) & _M32
        lo, hi = words[:, 0], words[:, 1]
    else:
        v = v.to(torch.int64)
        lo, hi = v & _M32, (v >> 32) & _M32
    return mix32(lo ^ mix32(hi))


def hll_ranks(hashes: torch.Tensor, mask: torch.Tensor, log2m: int = HLL_LOG2M):
    """(register index, masked rank) per hash: rank = leading zeros of the
    32 - log2m low bits + 1, capped at 32 - log2m + 1. The leading zeros come
    from the exact bit length (frexp's exponent) where the reference takes
    floor(log2(float64)); both are exact for 32-bit words."""
    import torch

    idx = hashes >> (32 - log2m)
    w = (hashes << log2m) & _M32
    bit_len = torch.frexp(w.to(torch.float64)).exponent.to(torch.int64)
    maxrank = 32 - log2m + 1
    rank = torch.where(w == 0, maxrank, torch.clamp(33 - bit_len, max=maxrank))
    return idx, torch.where(mask, rank, 0).to(torch.int32)


def hll_update(hashes: torch.Tensor, mask: torch.Tensor, log2m: int = HLL_LOG2M) -> torch.Tensor:
    """Per-doc HLL register update: the (m,) int32 register vector."""
    import torch

    idx, rank = hll_ranks(hashes, mask, log2m)
    out = torch.zeros(1 << log2m, dtype=torch.int32, device=hashes.device)
    return out.scatter_reduce_(0, idx, rank, "amax", include_self=True)


def hll_update_grouped(
    hashes: torch.Tensor, mask: torch.Tensor, gid: torch.Tensor, ng: int, log2m: int = HLL_LOG2M
) -> torch.Tensor:
    """Per-group HLL registers: an (ng, m) int32 matrix by one scatter-max at
    flat index gid * m + idx. Docs whose gid lies outside [0, ng) are dropped,
    as JAX's scatter drops them."""
    import torch

    idx, rank = hll_ranks(hashes, mask, log2m)
    ok = (gid >= 0) & (gid < ng)
    m = 1 << log2m
    flat = torch.where(ok, gid, 0).to(torch.int64) * m + idx
    out = torch.zeros(ng * m, dtype=torch.int32, device=hashes.device)
    out.scatter_reduce_(0, flat, torch.where(ok, rank, 0), "amax", include_self=True)
    return out.view(ng, m)
