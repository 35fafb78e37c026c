"""The native host library: segment-file codecs, bitmap algebra, hashing,
HLL registers and the host aggregation loops, as C++ bound with ctypes, with
the JAX package's numpy and pure-Python fallbacks.

The JAX package's `native/__init__.py`, whole: fixed-bit packing
(`bits_needed`, `bitpack` / `bitunpack`), LZ4 (`lz4_compress` /
`lz4_decompress`, `_lz4_decompress_py`), the dlopen'd system chunk codecs
(`codec_available`, `chunk_compress` / `chunk_decompress`), dense bitmaps
(`bm_*`), `hash64` / `hash_bytes`, `hll_update` / `hll_merge` /
`hll_estimate`, `masked_stats`, the `group_*` loops, `hash_group_ids` and
`crc32`, over its own copy of the C++ (`csrc/pinot_native.cpp`, the
reference's functions unchanged), so a segment file written by either
package decodes in the other and each function gives the reference's bits.
The library builds with g++ at first use (never at import) into
`pinot_tpu_torch/_build/`, named by a digest of its source and flags. As in
the reference: where it cannot build, every function but LZ4's compressor
takes its numpy / zlib fallback, LZ4 writes nothing (the store keeps such
chunks raw) and reads through the pure-Python decoder; zstd / zlib / snappy
load with dlopen and are optional (a missing one stores raw). No environment
switch forces the fallbacks: tests set `_STATE` to `[None, True]`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import zlib
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "pinot_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
#: [the loaded library or None, whether a load was tried]
_STATE: list = [None, False]


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libpinot_native-{digest}.so"


def _build_and_load():
    target = _library_path()
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private file renamed into place: concurrent first builds never
        # tear the library
        fd, tmp = tempfile.mkstemp(prefix=".pinot_native-", suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", tmp, "-ldl"], check=True, capture_output=True, timeout=300)
            os.replace(tmp, target)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    lib = ctypes.CDLL(str(target))
    if lib.pt_abi_version() != 1:
        return None
    _declare(lib)
    return lib


def _native():
    """The library, built and loaded at the first call; None where it
    cannot be built (no g++), as the reference's fallbacks expect."""
    with _LOCK:
        if not _STATE[1]:
            try:
                _STATE[0] = _build_and_load()
            except (OSError, subprocess.SubprocessError):
                _STATE[0] = None
            _STATE[1] = True
        return _STATE[0]


def _declare(lib) -> None:
    i64, i32, u32 = ctypes.c_int64, ctypes.c_int32, ctypes.c_uint32
    p = ctypes.c_void_p
    lib.pt_bitpack_words.restype = i64
    lib.pt_bitpack_words.argtypes = [i64, i32]
    lib.pt_bitpack32.restype = None
    lib.pt_bitpack32.argtypes = [p, i64, i32, p]
    lib.pt_bitunpack32.restype = None
    lib.pt_bitunpack32.argtypes = [p, i64, i32, p]
    lib.pt_lz4_compress_bound.restype = i64
    lib.pt_lz4_compress_bound.argtypes = [i64]
    lib.pt_lz4_compress.restype = i64
    lib.pt_lz4_compress.argtypes = [p, i64, p, i64]
    lib.pt_lz4_decompress.restype = i64
    lib.pt_lz4_decompress.argtypes = [p, i64, p, i64]
    # system chunk codecs (dlopen'd zstd / zlib / snappy; -2 = unavailable)
    for name, has_level in (("pt_zstd", True), ("pt_gzip", True), ("pt_snappy", False)):
        getattr(lib, f"{name}_bound").restype = i64
        getattr(lib, f"{name}_bound").argtypes = [i64]
        comp = getattr(lib, f"{name}_compress")
        comp.restype = i64
        comp.argtypes = [p, i64, p, i64] + ([i32] if has_level else [])
        dec = getattr(lib, f"{name}_decompress")
        dec.restype = i64
        dec.argtypes = [p, i64, p, i64]
    for nm in ("pt_bm_and", "pt_bm_or", "pt_bm_andnot"):
        fn = getattr(lib, nm)
        fn.restype = None
        fn.argtypes = [p, p, p, i64]
    lib.pt_bm_not.restype = None
    lib.pt_bm_not.argtypes = [p, p, i64]
    lib.pt_bm_cardinality.restype = i64
    lib.pt_bm_cardinality.argtypes = [p, i64]
    lib.pt_bm_extract.restype = i64
    lib.pt_bm_extract.argtypes = [p, i64, p, i64]
    lib.pt_bm_from_indices.restype = None
    lib.pt_bm_from_indices.argtypes = [p, i64, p, i64]
    lib.pt_hash64.restype = None
    lib.pt_hash64.argtypes = [p, i64, p]
    lib.pt_hash_bytes.restype = None
    lib.pt_hash_bytes.argtypes = [p, p, i64, p]
    lib.pt_hll_update.restype = None
    lib.pt_hll_update.argtypes = [p, p, i64, i32, p]
    lib.pt_hll_merge.restype = None
    lib.pt_hll_merge.argtypes = [p, p, i64]
    lib.pt_hll_estimate.restype = ctypes.c_double
    lib.pt_hll_estimate.argtypes = [p, i32]
    lib.pt_masked_stats_f64.restype = None
    lib.pt_masked_stats_f64.argtypes = [p, p, i64, p]
    for nm in ("pt_group_sum_f64", "pt_group_min_f64", "pt_group_max_f64"):
        fn = getattr(lib, nm)
        fn.restype = None
        fn.argtypes = [p, p, p, i64, p]
    lib.pt_group_count.restype = None
    lib.pt_group_count.argtypes = [p, p, i64, p]
    lib.pt_hash_group_ids.restype = i64
    lib.pt_hash_group_ids.argtypes = [p, i64, p, p, i64, p]
    lib.pt_crc32.restype = u32
    lib.pt_crc32.argtypes = [p, i64, u32]


def available() -> bool:
    """True when the C++ library built and loaded."""
    return _native() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


def _mask_arg(mask):
    """(pointer, array to keep alive) of an optional mask as uint8 bytes."""
    if mask is None:
        return ctypes.c_void_p(0), None
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    return _ptr(m), m


def _bytes_view(data) -> np.ndarray:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return np.frombuffer(data, dtype=np.uint8)
    return np.ascontiguousarray(data).view(np.uint8)


# -- fixed-bit packing -------------------------------------------------------


def bits_needed(cardinality: int) -> int:
    """Bits per value for dict ids in [0, cardinality)."""
    return max(1, int(cardinality - 1).bit_length()) if cardinality > 1 else 1


def bitpack(ids: np.ndarray, bits: int) -> np.ndarray:
    """Pack uint32 / int32 values of `bits` significant bits into uint64
    words, LSB first."""
    ids = np.ascontiguousarray(ids, dtype=np.uint32)
    n = len(ids)
    out = np.zeros((n * bits + 63) // 64, dtype=np.uint64)
    lib = _native()
    if lib is not None:
        lib.pt_bitpack32(_ptr(ids), n, bits, _ptr(out))
        return out
    # an (n, bits) bit matrix scatter-ORed into the words
    pos = (np.arange(n, dtype=np.int64) * bits)[:, None] + np.arange(bits)[None, :]
    shift = (pos & 63).ravel().astype(np.uint64)
    bitmat = ((ids[:, None] >> np.arange(bits, dtype=np.uint32)[None, :]) & np.uint32(1)).astype(np.uint64)
    np.bitwise_or.at(out, (pos >> 6).ravel(), bitmat.ravel() << shift)
    return out


def bitunpack(words: np.ndarray, n: int, bits: int) -> np.ndarray:
    """Inverse of bitpack: the n uint32 values."""
    words = np.ascontiguousarray(words, dtype=np.uint64)
    out = np.empty(n, dtype=np.uint32)
    lib = _native()
    if lib is not None:
        lib.pt_bitunpack32(_ptr(words), n, bits, _ptr(out))
        return out
    pos = (np.arange(n, dtype=np.int64) * bits)[:, None] + np.arange(bits)[None, :]
    bitvals = (words[pos >> 6] >> (pos & 63).astype(np.uint64)) & np.uint64(1)
    out[:] = (bitvals.astype(np.uint32) << np.arange(bits, dtype=np.uint32)[None, :]).sum(axis=1, dtype=np.uint32)
    return out


# -- LZ4 block codec ---------------------------------------------------------


def lz4_compress(data) -> bytes:
    """LZ4-block-compress bytes; raises RuntimeError without the library
    (callers choose codec 'raw' then)."""
    buf = _bytes_view(data)
    lib = _native()
    if lib is None:
        raise RuntimeError("native lz4 unavailable")
    cap = lib.pt_lz4_compress_bound(len(buf))
    out = np.empty(cap, dtype=np.uint8)
    k = lib.pt_lz4_compress(_ptr(buf), len(buf), _ptr(out), cap)
    if k < 0:
        raise RuntimeError("lz4 compress failed")
    return out[:k].tobytes()


def lz4_decompress(data: bytes, raw_len: int) -> bytes:
    lib = _native()
    if lib is None:
        out_b = _lz4_decompress_py(bytes(data), raw_len)
        if len(out_b) != raw_len:
            raise RuntimeError(f"lz4 decompress: got {len(out_b)}, want {raw_len}")
        return out_b
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(raw_len, dtype=np.uint8)
    k = lib.pt_lz4_decompress(_ptr(buf), len(buf), _ptr(out), raw_len)
    if k != raw_len:
        raise RuntimeError(f"lz4 decompress: got {k}, want {raw_len}")
    return out.tobytes()


# -- system chunk codecs (ZSTD / GZIP / Snappy) ------------------------------
# ChunkCompressionType parity (ZSTANDARD, GZIP, SNAPPY) through dlopen'd
# system libraries. A reading host must have the codec a segment was written
# with, except lz4 (the pure-Python decoder) and gzip (stdlib zlib).

_CODEC_LEVELS = {"zstd": 3, "gzip": 6}


def codec_available(codec: str) -> bool:
    """True when `codec` can round-trip on this host."""
    if codec == "raw":
        return True
    lib = _native()
    if lib is None:
        return False
    if codec == "lz4":
        return True
    if codec not in ("zstd", "gzip", "snappy"):
        return False
    return int(getattr(lib, f"pt_{codec}_bound")(1)) > 0


def chunk_compress(data: bytes, codec: str) -> bytes:
    """Compress with the named codec ('lz4' / 'zstd' / 'gzip' / 'snappy')."""
    if codec == "lz4":
        return lz4_compress(data)
    lib = _native()
    if lib is None:
        raise RuntimeError(f"native {codec} unavailable")
    buf = np.frombuffer(data, dtype=np.uint8)
    cap = int(getattr(lib, f"pt_{codec}_bound")(len(buf)))
    if cap < 0:
        raise RuntimeError(f"{codec} library unavailable")
    out = np.empty(max(cap, 16), dtype=np.uint8)
    args = [_ptr(buf), len(buf), _ptr(out), len(out)]
    if codec in _CODEC_LEVELS:
        args.append(_CODEC_LEVELS[codec])
    k = int(getattr(lib, f"pt_{codec}_compress")(*args))
    if k < 0:
        raise RuntimeError(f"{codec} compress failed ({k})")
    return out[:k].tobytes()


def chunk_decompress(data: bytes, raw_len: int, codec: str) -> bytes:
    """Decompress `codec`-encoded bytes to exactly raw_len."""
    if codec == "raw":
        return bytes(data)
    if codec == "lz4":
        return lz4_decompress(data, raw_len)
    lib = _native()
    if lib is None or int(getattr(lib, f"pt_{codec}_bound")(1)) < 0:
        if codec == "gzip":
            # stdlib zlib reads the zlib-format stream pt_gzip_compress writes
            out_b = zlib.decompress(bytes(data))
            if len(out_b) != raw_len:
                raise RuntimeError(f"gzip decompress: got {len(out_b)}, want {raw_len}")
            return out_b
        raise RuntimeError(f"native {codec} unavailable")
    buf = np.frombuffer(data, dtype=np.uint8)
    out = np.empty(max(raw_len, 1), dtype=np.uint8)
    k = int(getattr(lib, f"pt_{codec}_decompress")(_ptr(buf), len(buf), _ptr(out), raw_len))
    if k != raw_len:
        raise RuntimeError(f"{codec} decompress: got {k}, want {raw_len}")
    return out[:raw_len].tobytes()


def _lz4_decompress_py(src: bytes, cap: int) -> bytes:
    """Pure-Python LZ4 block decoder: a segment written with the native
    codec stays readable where the library cannot be built."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        token = src[i]
        i += 1
        llen = token >> 4
        if llen == 15:
            while True:
                if i >= n:
                    raise RuntimeError("lz4: truncated literal length")
                b = src[i]
                i += 1
                llen += b
                if b != 255:
                    break
        if i + llen > n or len(out) + llen > cap:
            raise RuntimeError("lz4: literal overrun")
        out += src[i : i + llen]
        i += llen
        if i >= n:
            break
        if i + 2 > n:
            raise RuntimeError("lz4: truncated offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise RuntimeError("lz4: bad offset")
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                if i >= n:
                    raise RuntimeError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        if len(out) + mlen > cap:
            raise RuntimeError("lz4: match overrun")
        start = len(out) - offset
        for j in range(mlen):  # byte by byte: overlapping matches replicate
            out.append(out[start + j])
    return bytes(out)


# -- dense bitmaps -----------------------------------------------------------


def bm_words(n_docs: int) -> int:
    return (n_docs + 63) // 64


def bm_and(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _native()
    if lib is not None:
        out = np.empty_like(a)
        lib.pt_bm_and(_ptr(a), _ptr(b), _ptr(out), len(a))
        return out
    return a & b


def bm_or(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _native()
    if lib is not None:
        out = np.empty_like(a)
        lib.pt_bm_or(_ptr(a), _ptr(b), _ptr(out), len(a))
        return out
    return a | b


def bm_andnot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _native()
    if lib is not None:
        out = np.empty_like(a)
        lib.pt_bm_andnot(_ptr(a), _ptr(b), _ptr(out), len(a))
        return out
    return a & ~b


def bm_not(a: np.ndarray) -> np.ndarray:
    lib = _native()
    if lib is not None:
        out = np.empty_like(a)
        lib.pt_bm_not(_ptr(a), _ptr(out), len(a))
        return out
    return ~a


def bm_cardinality(a: np.ndarray) -> int:
    lib = _native()
    if lib is not None:
        return int(lib.pt_bm_cardinality(_ptr(a), len(a)))
    return int(np.unpackbits(a.view(np.uint8)).sum())


def bm_extract(a: np.ndarray, cap: int | None = None) -> np.ndarray:
    """Bitmap -> sorted int32 doc ids."""
    if cap is None:
        cap = bm_cardinality(a)
    out = np.empty(cap, dtype=np.int32)
    lib = _native()
    if lib is not None:
        k = lib.pt_bm_extract(_ptr(a), len(a), _ptr(out), cap)
        return out[:k]
    bits = np.unpackbits(a.view(np.uint8), bitorder="little")
    idx = np.nonzero(bits)[0].astype(np.int32)
    return idx[:cap]


def bm_from_indices(idx: np.ndarray, n_docs: int) -> np.ndarray:
    nwords = bm_words(n_docs)
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    lib = _native()
    if lib is not None:
        out = np.empty(nwords, dtype=np.uint64)
        lib.pt_bm_from_indices(_ptr(idx), len(idx), _ptr(out), nwords)
        return out
    bits = np.zeros(nwords * 64, dtype=np.uint8)
    bits[idx] = 1
    return np.packbits(bits, bitorder="little").view(np.uint64)


def bm_from_bool(mask: np.ndarray) -> np.ndarray:
    """Bool mask -> uint64-word bitmap (padded with zeros)."""
    nwords = bm_words(len(mask))
    bits = np.zeros(nwords * 64, dtype=np.uint8)
    bits[: len(mask)] = mask.astype(np.uint8)
    return np.packbits(bits, bitorder="little").view(np.uint64)


def bm_to_bool(a: np.ndarray, n_docs: int) -> np.ndarray:
    return np.unpackbits(a.view(np.uint8), bitorder="little")[:n_docs].astype(bool)


# -- hashing -----------------------------------------------------------------


def hash64(vals: np.ndarray) -> np.ndarray:
    """splitmix64 over int64/uint64 values."""
    v = np.ascontiguousarray(vals).view(np.uint64) if vals.dtype != np.uint64 else np.ascontiguousarray(vals)
    out = np.empty(len(v), dtype=np.uint64)
    lib = _native()
    if lib is not None:
        lib.pt_hash64(_ptr(v), len(v), _ptr(out))
        return out
    x = v + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def hash_bytes(blob: bytes, offsets: np.ndarray) -> np.ndarray:
    """FNV-1a + splitmix finalizer over var-length slices blob[off[i]:off[i+1]]."""
    n = len(offsets) - 1
    out = np.empty(n, dtype=np.uint64)
    data = np.frombuffer(blob, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    lib = _native()
    if lib is not None:
        lib.pt_hash_bytes(_ptr(data), _ptr(offsets), n, _ptr(out))
        return out
    FNV_OFF, FNV_P = np.uint64(1469598103934665603), np.uint64(1099511628211)
    for i in range(n):
        h = FNV_OFF
        for byte in data[offsets[i] : offsets[i + 1]]:
            h = np.uint64((int(h) ^ int(byte)) * int(FNV_P) & 0xFFFFFFFFFFFFFFFF)
        out[i] = h
    return hash64(out)


# -- HLL ---------------------------------------------------------------------


def hll_update(hashes: np.ndarray, mask: np.ndarray | None, p: int, regs: np.ndarray) -> None:
    hashes = np.ascontiguousarray(hashes, dtype=np.uint64)
    lib = _native()
    if lib is not None:
        mptr, _keep = _mask_arg(mask)
        lib.pt_hll_update(_ptr(hashes), mptr, len(hashes), p, _ptr(regs))
        return
    h = hashes if mask is None else hashes[np.asarray(mask, bool)]
    idx = (h & np.uint64((1 << p) - 1)).astype(np.int64)
    rest = h >> np.uint64(p)
    # count trailing zeros of rest (+1); rest==0 -> 64-p+1
    rho = np.full(len(h), 64 - p + 1, dtype=np.uint8)
    nz = rest != 0
    lowbit = rest[nz] & (~rest[nz] + np.uint64(1))
    rho[nz] = (np.log2(lowbit.astype(np.float64)) + 1).astype(np.uint8)
    np.maximum.at(regs, idx, rho)


def hll_merge(src: np.ndarray, acc: np.ndarray) -> None:
    lib = _native()
    if lib is not None:
        lib.pt_hll_merge(_ptr(src), _ptr(acc), len(src))
        return
    np.maximum(acc, src, out=acc)


def hll_estimate(regs: np.ndarray, p: int) -> float:
    lib = _native()
    if lib is not None:
        return float(lib.pt_hll_estimate(_ptr(regs), p))
    m = 1 << p
    s = np.ldexp(1.0, -regs.astype(np.int32)).sum()
    alpha = {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1.0 + 1.079 / m))
    e = alpha * m * m / s
    zeros = int((regs == 0).sum())
    if e <= 2.5 * m and zeros:
        e = m * np.log(m / zeros)
    return float(e)


# -- aggregation loops -------------------------------------------------------


def masked_stats(v: np.ndarray, mask: np.ndarray | None) -> tuple[float, float, float, int]:
    """(sum, min, max, count) over masked values."""
    v = np.ascontiguousarray(v, dtype=np.float64)
    lib = _native()
    if lib is not None:
        out = np.empty(4, dtype=np.float64)
        mptr, _keep = _mask_arg(mask)
        lib.pt_masked_stats_f64(_ptr(v), mptr, len(v), _ptr(out))
        return float(out[0]), float(out[1]), float(out[2]), int(out[3])
    sel = v if mask is None else v[np.asarray(mask, bool)]
    if len(sel) == 0:
        return 0.0, float("inf"), float("-inf"), 0
    return float(sel.sum()), float(sel.min()), float(sel.max()), int(len(sel))


def group_sum(v: np.ndarray, gid: np.ndarray, mask: np.ndarray | None, n_groups: int) -> np.ndarray:
    v = np.ascontiguousarray(v, dtype=np.float64)
    gid = np.ascontiguousarray(gid, dtype=np.int32)
    acc = np.zeros(n_groups, dtype=np.float64)
    lib = _native()
    if lib is not None:
        mptr, _keep = _mask_arg(mask)
        lib.pt_group_sum_f64(_ptr(v), _ptr(gid), mptr, len(v), _ptr(acc))
        return acc
    sel = slice(None) if mask is None else np.asarray(mask, bool)
    np.add.at(acc, gid[sel], v[sel])
    return acc


def group_count(gid: np.ndarray, mask: np.ndarray | None, n_groups: int) -> np.ndarray:
    gid = np.ascontiguousarray(gid, dtype=np.int32)
    acc = np.zeros(n_groups, dtype=np.int64)
    lib = _native()
    if lib is not None:
        mptr, _keep = _mask_arg(mask)
        lib.pt_group_count(_ptr(gid), mptr, len(gid), _ptr(acc))
        return acc
    sel = slice(None) if mask is None else np.asarray(mask, bool)
    np.add.at(acc, gid[sel], 1)
    return acc


def group_min(v: np.ndarray, gid: np.ndarray, mask: np.ndarray | None, n_groups: int) -> np.ndarray:
    v = np.ascontiguousarray(v, dtype=np.float64)
    gid = np.ascontiguousarray(gid, dtype=np.int32)
    acc = np.full(n_groups, np.inf, dtype=np.float64)
    lib = _native()
    if lib is not None:
        mptr, _keep = _mask_arg(mask)
        lib.pt_group_min_f64(_ptr(v), _ptr(gid), mptr, len(v), _ptr(acc))
        return acc
    sel = slice(None) if mask is None else np.asarray(mask, bool)
    np.minimum.at(acc, gid[sel], v[sel])
    return acc


def group_max(v: np.ndarray, gid: np.ndarray, mask: np.ndarray | None, n_groups: int) -> np.ndarray:
    v = np.ascontiguousarray(v, dtype=np.float64)
    gid = np.ascontiguousarray(gid, dtype=np.int32)
    acc = np.full(n_groups, -np.inf, dtype=np.float64)
    lib = _native()
    if lib is not None:
        mptr, _keep = _mask_arg(mask)
        lib.pt_group_max_f64(_ptr(v), _ptr(gid), mptr, len(v), _ptr(acc))
        return acc
    sel = slice(None) if mask is None else np.asarray(mask, bool)
    np.maximum.at(acc, gid[sel], v[sel])
    return acc


def hash_group_ids(keys: np.ndarray) -> tuple[np.ndarray, int]:
    """Assign dense group ids (first-seen order) to uint64 hashed keys.

    High-cardinality group-by fallback (NoDictionary*GroupKeyGenerator analog).
    Returns (gid int32 array, n_groups).
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    n = len(keys)
    lib = _native()
    if lib is not None:
        cap = 1
        while cap < 2 * max(n, 1):
            cap <<= 1
        slot_keys = np.empty(cap, dtype=np.uint64)
        slot_gids = np.empty(cap, dtype=np.int32)
        gid = np.empty(n, dtype=np.int32)
        ng = lib.pt_hash_group_ids(_ptr(keys), n, _ptr(slot_keys), _ptr(slot_gids), cap, _ptr(gid))
        return gid, int(ng)
    uniq, gid = np.unique(keys, return_inverse=True)
    # np.unique orders by value, not first-seen; remap to first-seen order
    first = np.full(len(uniq), n, dtype=np.int64)
    np.minimum.at(first, gid, np.arange(n))
    order = np.argsort(first, kind="stable")
    remap = np.empty(len(uniq), dtype=np.int32)
    remap[order] = np.arange(len(uniq), dtype=np.int32)
    return remap[gid].astype(np.int32), len(uniq)


# -- crc ---------------------------------------------------------------------


def crc32(data, seed: int = 0) -> int:
    buf = _bytes_view(data)
    lib = _native()
    if lib is not None:
        return int(lib.pt_crc32(_ptr(buf), len(buf), seed))
    return zlib.crc32(buf.tobytes(), seed)
