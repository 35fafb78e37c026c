"""Segment-file codecs: fixed-bit packing, LZ4 and the dlopen'd system chunk
codecs, and CRC32, as C++ bound with ctypes, with the JAX package's numpy
and pure-Python fallbacks.

The codec half of the JAX package's `native/__init__.py` (`bits_needed`,
`bitpack` / `bitunpack`, `lz4_compress` / `lz4_decompress`,
`codec_available`, `chunk_compress` / `chunk_decompress`,
`_lz4_decompress_py`, `crc32`) over its own copy of the C++
(`csrc/segment_codecs.cpp`, the codec functions of the reference's
`pinot_native.cpp` unchanged), so a segment file written by either package
decodes in the other bit for bit. The library builds with g++ at first use
(never at import) into `pinot_tpu_torch/_build/`, named by a digest of its
source. As in the reference: where it cannot build, packing and CRC32 take
numpy / zlib, LZ4 writes nothing (the store keeps such chunks raw) and reads
through the pure-Python decoder; zstd / zlib / snappy load with dlopen and are
optional (a missing one stores raw).
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

_SRC = Path(__file__).resolve().parent / "csrc" / "segment_codecs.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_LOCK = threading.Lock()
#: [the loaded library or None, whether a load was tried]
_STATE: list = [None, False]


def _library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"libsegment_codecs-{digest}.so"


def _build_and_load():
    target = _library_path()
    if not target.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # a private file renamed into place: concurrent first builds never
        # tear the library
        fd, tmp = tempfile.mkstemp(prefix=".segment_codecs-", suffix=".so", dir=_BUILD_DIR)
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
    """The codec library, built and loaded at the first call; None where it
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
    lib.pt_crc32.restype = u32
    lib.pt_crc32.argtypes = [p, i64, u32]


def available() -> bool:
    """True when the C++ library built and loaded."""
    return _native() is not None


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.c_void_p)


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


# -- crc ---------------------------------------------------------------------


def crc32(data, seed: int = 0) -> int:
    buf = _bytes_view(data)
    lib = _native()
    if lib is not None:
        return int(lib.pt_crc32(_ptr(buf), len(buf), seed))
    return zlib.crc32(buf.tobytes(), seed)
