"""DataTable wire format: versioned, typed binary serde for query partials.

Reference parity: DataTableImplV4 (pinot-common/.../datatable/
DataTableImplV4.java:51-82 — versioned header, typed columnar payload,
custom-object serde registry) and the DataBlock zero-copy serde
(pinot-common/.../datablock/ZeroCopyDataBlockSerde). The server's partial
results cross the wire in this format instead of pickle: decoding is pure
data (no code execution), the layout is versioned, and numpy buffers are
written contiguously so the hot path is one memcpy per column.

Version 2 (current) is iovec-style: `encode_segments()` returns a list of
bytes-like segments — small header fields coalesced into scratch buffers,
large column payloads appended as zero-copy memoryviews over the source
arrays — which callers hand to `BufferedWriter.writelines()` (the writev
analog) without ever concatenating. String columns are vectorized both
ways: encode factorizes to a dictionary (uniques + int32 codes) when the
column compresses, else writes one NUL-joined utf8 blob; decode is one
`str.split` or one fancy-index take instead of a per-item Python loop.
Version 1 payloads (per-value BytesIO stream, per-item string loop) still
decode; `encode_v1` is kept for compatibility tests and version-negotiation
fallback.

Supported values: None, bool, int, float, str, bytes, list, tuple, set,
dict, numpy scalars/arrays (object arrays encode element-wise), and frames
(encoded columnar: the DataBlock analog).

This is the JAX package's `common/datatable.py` without pandas. Where the
reference encodes a DataFrame, the port encodes a `Frame`: the dict of
equal-length numpy columns its engine produces (query/reduce.py), marked so
the encoder can tell it from a plain dict. A Frame encodes to the bytes the
reference writes for the equal DataFrame, and a DataFrame on the wire
decodes to a Frame; string columns factorize in first-appearance order, as
pandas' hashtable does, so the bytes agree there too.
"""

from __future__ import annotations

import struct
from io import BytesIO

import numpy as np

from pinot_tpu_torch.common.errors import QueryErrorCode

MAGIC = b"PTDT"
VERSION = 2
#: versions this decoder accepts (version negotiation: a v2 node still
#: reads v1 payloads from an old peer mid-rollout)
DECODE_VERSIONS = (1, 2)

#: single-segment / single-field ceiling: every length on the wire is u32
_MAX_LEN = 0xFFFFFFFF

_T_NONE = 0
_T_BOOL = 1
_T_INT = 2
_T_FLOAT = 3
_T_STR = 4
_T_BYTES = 5
_T_LIST = 6
_T_TUPLE = 7
_T_SET = 8
_T_DICT = 9
_T_NDARRAY = 10
_T_OBJARRAY = 11
_T_DATAFRAME = 12
_T_STRARRAY = 13  # v1: per-item byte-length array + concatenated utf8 blob
_T_STRBLOB = 14  # v2: one utf8 blob, NUL-joined (mode 0) or char-offset (mode 1)
_T_STRDICT = 15  # v2: dictionary-encoded strings — uniques blob + int32 codes


class DataTableError(ValueError):
    """Wire datatable (de)serialization failure. Registered with the error
    registry so a frame error escaping a server/broker HTTP boundary rides
    as a typed DATA_TABLE_SERIALIZATION code, not an anonymous 500."""

    error_code = QueryErrorCode.DATA_TABLE_SERIALIZATION


_U32 = struct.Struct("<I")
_U32x2 = struct.Struct("<II")


class _SegWriter:
    """Iovec accumulator. Small writes coalesce into a scratch bytearray;
    large bytes-like payloads (column buffers, blobs) are appended as-is —
    zero-copy views that stay alive via the segment list. `segments()`
    yields what `writelines()` / `b"".join()` consume directly."""

    __slots__ = ("_segs", "_scratch")

    #: below this, appending a dedicated iovec segment costs more than the
    #: memcpy into scratch (syscall/iteration overhead per segment)
    INLINE_CUTOFF = 4096

    def __init__(self):
        self._segs: list = []
        self._scratch = bytearray()

    def raw(self, b) -> None:
        if isinstance(b, memoryview):
            # flatten to a 1-d byte view: every consumer of the segment list
            # (Content-Length, stream frame prefixes) totals `len(s)`, and on
            # a multi-dimensional view len() is shape[0], not nbytes
            if b.ndim != 1 or b.itemsize != 1:
                b = b.cast("B")
            size = b.nbytes
        else:
            size = len(b)
        if size >= self.INLINE_CUTOFF:
            if self._scratch:
                self._segs.append(self._scratch)
                self._scratch = bytearray()
            self._segs.append(b)
        else:
            self._scratch += b

    def u8(self, v: int) -> None:
        self._scratch.append(v)

    def u32(self, v: int) -> None:
        if v > _MAX_LEN:
            raise DataTableError("DataTable field exceeds u32 length limit (>4 GB)")
        self._scratch += _U32.pack(v)

    def s(self, s: str) -> None:
        b = s.encode()
        self.u32(len(b))
        self.raw(b)

    def segments(self) -> list:
        if self._scratch:
            self._segs.append(self._scratch)
            self._scratch = bytearray()
        return self._segs


class Frame(dict):
    """A frame on the wire: column name -> equal-length numpy array. The
    engine's group, DISTINCT and selection partials are plain dicts of this
    shape; the server marks them (and a decoded DataFrame comes back) as a
    Frame so they travel under the DataFrame tag, as the reference's do."""


def _frame_column(col) -> np.ndarray:
    """The column as `DataFrame(...)[col].to_numpy()` gives it: a numpy
    string column becomes an object array of str, as pandas stores it."""
    col = np.asarray(col)
    if col.dtype.kind in "US":
        return col.astype(object)
    return col


def _factorize_str(flat: np.ndarray):
    """(codes int64, uniques object) for an all-str object array, else None.

    Uniques come in first-appearance order, as pandas' StringHashTable
    gives them, so the encoded dictionary is the reference's byte for
    byte."""
    lst = flat.tolist()
    index: dict = {}
    codes = np.empty(len(lst), dtype=np.int64)
    for i, x in enumerate(lst):
        if not isinstance(x, str):
            return None
        c = index.get(x)
        if c is None:
            c = index[x] = len(index)
        codes[i] = c
    uniques = np.empty(len(index), dtype=object)
    uniques[:] = list(index)
    return codes, uniques


def _encode_obj_array(out: _SegWriter, v: np.ndarray) -> None:
    flat = v.ravel()
    n = flat.size
    lst = None
    if n >= 64:
        fact = _factorize_str(flat)
        if fact is not None:
            codes, uniques = fact
            if 2 * len(uniques) <= n:
                # dictionary-encoded: decode is one fancy-index take that
                # shares the uniques' PyUnicode objects — no per-item alloc
                out.u8(_T_STRDICT)
                out.u32(v.ndim)
                for d in v.shape:
                    out.u32(d)
                _encode_str_blob(out, uniques.tolist())
                out.u32(n)
                out.raw(memoryview(np.ascontiguousarray(codes, dtype=np.int32)).cast("B"))
            else:
                out.u8(_T_STRBLOB)
                out.u32(v.ndim)
                for d in v.shape:
                    out.u32(d)
                _encode_str_blob(out, flat.tolist())
            return
    else:
        lst = flat.tolist()
        if lst and all(isinstance(x, str) for x in lst):
            out.u8(_T_STRBLOB)
            out.u32(v.ndim)
            for d in v.shape:
                out.u32(d)
            _encode_str_blob(out, lst)
            return
    out.u8(_T_OBJARRAY)
    out.u32(v.ndim)
    for d in v.shape:
        out.u32(d)
    for item in lst if lst is not None else flat.tolist():
        _encode_value(out, item)


def _encode_str_blob(out: _SegWriter, lst: list) -> None:
    """One utf8 blob for a flat list of str. Mode 0 (NUL separators, decode
    is a single split) when no element contains NUL; mode 1 (uint32 char
    lengths, offsets rebuilt via np.cumsum) otherwise."""
    n = len(lst)
    joined = "\x00".join(lst)
    if joined.count("\x00") == max(n - 1, 0):
        out.u8(0)
        out.u32(n)
        blob = joined.encode()
        out.u32(len(blob))
        out.raw(blob)
    else:
        out.u8(1)
        out.u32(n)
        lengths = np.fromiter((len(s) for s in lst), dtype=np.uint32, count=n)
        out.raw(memoryview(lengths).cast("B"))
        blob = "".join(lst).encode()
        out.u32(len(blob))
        out.raw(blob)


def _encode_value(out: _SegWriter, v) -> None:
    if v is None:
        out.u8(_T_NONE)
    elif isinstance(v, (bool, np.bool_)):
        out.u8(_T_BOOL)
        out.u8(1 if v else 0)
    elif isinstance(v, (int, np.integer)):
        out.u8(_T_INT)
        out.raw(struct.pack("<q", int(v)))
    elif isinstance(v, (float, np.floating)):
        out.u8(_T_FLOAT)
        out.raw(struct.pack("<d", float(v)))
    elif isinstance(v, str):
        out.u8(_T_STR)
        out.s(v)
    elif isinstance(v, (bytes, bytearray)):
        out.u8(_T_BYTES)
        out.u32(len(v))
        out.raw(v)
    elif isinstance(v, Frame):
        out.u8(_T_DATAFRAME)
        out.u32(len(v))
        for col, arr in v.items():
            out.s(str(col))
            _encode_value(out, _frame_column(arr))
    elif isinstance(v, np.ndarray):
        if v.dtype == object:
            _encode_obj_array(out, v)
        else:
            out.u8(_T_NDARRAY)
            out.s(v.dtype.str)  # includes endianness, e.g. '<i8'
            out.u32(v.ndim)
            for d in v.shape:
                out.u32(d)
            # guard BEFORE ascontiguousarray: a broadcast view can claim
            # petabytes of logical bytes without owning them
            if v.nbytes > _MAX_LEN:
                raise DataTableError("DataTable field exceeds u32 length limit (>4 GB)")
            data = v if v.flags.c_contiguous else np.ascontiguousarray(v)
            out.u32(data.nbytes)
            # uint8 view: no intermediate tobytes() copy, and unlike a raw
            # memoryview cast it also handles datetime64/timedelta64
            # (dtype 'M'/'m' can't export a buffer directly); cast("B")
            # flattens so len(segment) == nbytes for n-d arrays
            out.raw(memoryview(data.view(np.uint8)).cast("B"))
    elif isinstance(v, (list, tuple, set)):
        tag = _T_LIST if isinstance(v, list) else _T_TUPLE if isinstance(v, tuple) else _T_SET
        out.u8(tag)
        items = sorted(v, key=repr) if isinstance(v, set) else v
        out.u32(len(items))
        for item in items:
            _encode_value(out, item)
    elif isinstance(v, dict):
        out.u8(_T_DICT)
        out.u32(len(v))
        for k, val in v.items():
            _encode_value(out, k)
            _encode_value(out, val)
    else:
        raise DataTableError(f"unsupported type for DataTable encoding: {type(v).__name__}")


def encode_segments(value) -> list:
    """Serialize to a list of bytes-like segments (header + zero-copy column
    views). Hand to `writelines()` for a gather-write; `sum(len(s) for s in
    segs)` is the Content-Length. Segments reference the source arrays —
    keep the value alive until the write completes."""
    out = _SegWriter()
    out.raw(MAGIC)
    out.raw(struct.pack("<H", VERSION))
    _encode_value(out, value)
    return out.segments()


def encode(value) -> bytes:
    """Serialize any supported partial-result structure to one buffer."""
    segs = encode_segments(value)
    if len(segs) == 1:
        return bytes(segs[0])
    return b"".join(segs)


# ---------------------------------------------------------------------------
# v1 encoder — kept for version-negotiation fallback and backward-decode
# tests. Layout is identical to the historical VERSION=1 wire format.
# ---------------------------------------------------------------------------


def _w_u32(out: BytesIO, v: int) -> None:
    out.write(_U32.pack(v))


def _w_str(out: BytesIO, s: str) -> None:
    b = s.encode()
    _w_u32(out, len(b))
    out.write(b)


def _encode_value_v1(out: BytesIO, v) -> None:
    if v is None:
        out.write(bytes([_T_NONE]))
    elif isinstance(v, (bool, np.bool_)):
        out.write(bytes([_T_BOOL, 1 if v else 0]))
    elif isinstance(v, (int, np.integer)):
        out.write(bytes([_T_INT]))
        out.write(struct.pack("<q", int(v)))
    elif isinstance(v, (float, np.floating)):
        out.write(bytes([_T_FLOAT]))
        out.write(struct.pack("<d", float(v)))
    elif isinstance(v, str):
        out.write(bytes([_T_STR]))
        _w_str(out, v)
    elif isinstance(v, (bytes, bytearray)):
        out.write(bytes([_T_BYTES]))
        _w_u32(out, len(v))
        out.write(v)
    elif isinstance(v, Frame):
        out.write(bytes([_T_DATAFRAME]))
        _w_u32(out, len(v))
        for col, arr in v.items():
            _w_str(out, str(col))
            _encode_value_v1(out, _frame_column(arr))
    elif isinstance(v, np.ndarray):
        if v.dtype == object:
            flat = v.ravel()
            if flat.size and all(isinstance(x, str) for x in flat):
                out.write(bytes([_T_STRARRAY]))
                _w_u32(out, v.ndim)
                for d in v.shape:
                    _w_u32(out, d)
                encoded = [x.encode() for x in flat]
                lengths = np.asarray([len(b) for b in encoded], dtype=np.uint32)
                out.write(lengths.tobytes())
                blob = b"".join(encoded)
                _w_u32(out, len(blob))
                out.write(blob)
                return
            out.write(bytes([_T_OBJARRAY]))
            _w_u32(out, v.ndim)
            for d in v.shape:
                _w_u32(out, d)
            for item in flat:
                _encode_value_v1(out, item)
        else:
            out.write(bytes([_T_NDARRAY]))
            _w_str(out, v.dtype.str)
            _w_u32(out, v.ndim)
            for d in v.shape:
                _w_u32(out, d)
            data = np.ascontiguousarray(v)
            _w_u32(out, data.nbytes)
            out.write(memoryview(data.view(np.uint8)))
    elif isinstance(v, (list, tuple, set)):
        tag = _T_LIST if isinstance(v, list) else _T_TUPLE if isinstance(v, tuple) else _T_SET
        out.write(bytes([tag]))
        items = sorted(v, key=repr) if isinstance(v, set) else v
        _w_u32(out, len(items))
        for item in items:
            _encode_value_v1(out, item)
    elif isinstance(v, dict):
        out.write(bytes([_T_DICT]))
        _w_u32(out, len(v))
        for k, val in v.items():
            _encode_value_v1(out, k)
            _encode_value_v1(out, val)
    else:
        raise DataTableError(f"unsupported type for DataTable encoding: {type(v).__name__}")


def encode_v1(value) -> bytes:
    """Serialize in the legacy VERSION=1 layout (per-value BytesIO stream).
    Used by compatibility tests and as the negotiation fallback for peers
    that predate v2."""
    out = BytesIO()
    out.write(MAGIC)
    out.write(struct.pack("<H", 1))
    _encode_value_v1(out, value)
    return out.getvalue()


# ---------------------------------------------------------------------------
# decode — shared across versions; v2-only tags simply never appear in v1
# payloads. Every length/count is bounds-checked against the remaining
# buffer BEFORE allocation, so adversarial payloads fail with DataTableError
# instead of MemoryError/struct.error.
# ---------------------------------------------------------------------------


class _Reader:
    """Cursor over the payload as a memoryview: numeric column decodes are
    ZERO-COPY views into the received buffer (ZeroCopyDataBlockSerde
    analog) — the payload stays alive as long as any decoded array does."""

    __slots__ = ("buf", "pos")

    def __init__(self, buf):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise DataTableError("truncated DataTable payload")
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return _U32.unpack(self.take(4))[0]

    def s(self) -> str:
        return _utf8(self.take(self.u32()))

    def count(self, n: int, unit: int = 1) -> int:
        """Validate a declared element count against the bytes actually
        remaining (each element needs >= `unit` bytes) before allocating."""
        if n * unit > len(self.buf) - self.pos:
            raise DataTableError("truncated DataTable payload")
        return n

    def shape(self) -> tuple:
        ndim = self.u32()
        if ndim > 32:  # numpy's own dimension limit
            raise DataTableError("corrupt DataTable payload: bad ndim")
        return tuple(self.u32() for _ in range(ndim))


def _utf8(b) -> str:
    try:
        return bytes(b).decode()
    except UnicodeDecodeError as e:
        raise DataTableError(f"corrupt DataTable payload: invalid utf-8 ({e})") from e


def _shape_size(r: _Reader, shape: tuple, unit: int = 1) -> int:
    n = 1
    for d in shape:
        n *= d
    return r.count(n, unit)


def _decode_str_blob(r: _Reader):
    mode = r.u8()
    n = r.count(r.u32())
    if mode == 0:
        text = _utf8(r.take(r.u32()))
        if n == 0:
            if text:
                raise DataTableError("corrupt DataTable payload: non-empty blob for empty array")
            return []
        parts = text.split("\x00")
        if len(parts) != n:
            raise DataTableError("corrupt DataTable payload: string blob separator mismatch")
        return parts
    if mode == 1:
        lengths = np.frombuffer(r.take(4 * n), dtype=np.uint32)
        text = _utf8(r.take(r.u32()))
        ends = np.cumsum(lengths, dtype=np.int64)
        if n and ends[-1] != len(text):
            raise DataTableError("corrupt DataTable payload: string blob length mismatch")
        starts = ends - lengths
        return [text[s:e] for s, e in zip(starts.tolist(), ends.tolist())]
    raise DataTableError(f"unknown DataTable string-blob mode {mode}")


def _obj_array(parts: list, shape: tuple) -> np.ndarray:
    arr = np.empty(len(parts), dtype=object)
    arr[:] = parts
    return arr.reshape(shape)


def _decode_value(r: _Reader):
    tag = r.u8()
    if tag == _T_NONE:
        return None
    if tag == _T_BOOL:
        return r.u8() != 0
    if tag == _T_INT:
        return struct.unpack("<q", r.take(8))[0]
    if tag == _T_FLOAT:
        return struct.unpack("<d", r.take(8))[0]
    if tag == _T_STR:
        return r.s()
    if tag == _T_BYTES:
        return bytes(r.take(r.u32()))
    if tag == _T_LIST:
        return [_decode_value(r) for _ in range(r.count(r.u32()))]
    if tag == _T_TUPLE:
        return tuple(_decode_value(r) for _ in range(r.count(r.u32())))
    if tag == _T_SET:
        return {_decode_value(r) for _ in range(r.count(r.u32()))}
    if tag == _T_DICT:
        return {_decode_value(r): _decode_value(r) for _ in range(r.count(r.u32(), 2))}
    if tag == _T_NDARRAY:
        try:
            dt = np.dtype(r.s())
        except (TypeError, ValueError, UnicodeDecodeError) as e:
            raise DataTableError(f"corrupt DataTable payload: bad dtype ({e})") from None
        shape = r.shape()
        data = r.take(r.u32())
        try:
            # zero-copy: a read-only view over the receive buffer; consumers
            # that mutate must copy
            return np.frombuffer(data, dtype=dt).reshape(shape)
        except (TypeError, ValueError) as e:
            raise DataTableError(f"corrupt DataTable payload: bad array ({e})") from None
    if tag == _T_STRARRAY:
        shape = r.shape()
        n = _shape_size(r, shape, 4)
        lengths = np.frombuffer(r.take(4 * n), dtype=np.uint32)
        blob = bytes(r.take(r.u32()))
        ends = np.cumsum(lengths, dtype=np.int64)
        if n and ends[-1] != len(blob):
            raise DataTableError("corrupt DataTable payload: string blob length mismatch")
        starts = ends - lengths
        return _obj_array(
            [_utf8(blob[s:e]) for s, e in zip(starts.tolist(), ends.tolist())], shape
        )
    if tag == _T_STRBLOB:
        shape = r.shape()
        parts = _decode_str_blob(r)
        if not _shape_matches(parts, shape):
            raise DataTableError("corrupt DataTable payload: string array shape mismatch")
        return _obj_array(parts, shape)
    if tag == _T_STRDICT:
        shape = r.shape()
        parts = _decode_str_blob(r)
        uniq = np.empty(len(parts), dtype=object)
        uniq[:] = parts
        n = r.count(r.u32(), 4)
        codes = np.frombuffer(r.take(4 * n), dtype=np.int32)
        if n and (codes.max(initial=0) >= len(uniq) or codes.min(initial=0) < 0):
            raise DataTableError("corrupt DataTable payload: string dictionary code out of range")
        # fancy-index take: the decoded array shares the dictionary's
        # PyUnicode objects — a pointer copy, no per-item materialization
        try:
            return uniq[codes].reshape(shape)
        except ValueError as e:
            raise DataTableError(f"corrupt DataTable payload: bad string array ({e})") from None
    if tag == _T_OBJARRAY:
        shape = r.shape()
        n = _shape_size(r, shape)
        arr = np.empty(n, dtype=object)
        for i in range(n):
            arr[i] = _decode_value(r)
        try:
            return arr.reshape(shape)
        except ValueError as e:
            raise DataTableError(f"corrupt DataTable payload: bad array ({e})") from None
    if tag == _T_DATAFRAME:
        data = {}
        for _ in range(r.count(r.u32())):
            name = r.s()
            data[name] = _decode_value(r)
        lens = {len(c) if isinstance(c, np.ndarray) and c.ndim == 1 else -1 for c in data.values()}
        if len(lens) > 1 or -1 in lens:
            raise DataTableError("corrupt DataTable payload: bad DataFrame (columns of unequal length)")
        # numeric columns stay zero-copy views over the receive buffer
        return Frame(data)
    raise DataTableError(f"unknown DataTable tag {tag}")


def _shape_matches(parts: list, shape: tuple) -> bool:
    n = 1
    for d in shape:
        n *= d
    return n == len(parts)


def decode(payload):
    """Decode a v1 or v2 payload (bytes-like). Raises DataTableError — and
    only DataTableError — on any malformed input."""
    buf = memoryview(payload)
    if len(buf) < 6:
        raise DataTableError("truncated DataTable payload")
    if bytes(buf[:4]) != MAGIC:
        raise DataTableError("bad DataTable magic")
    version = buf[4] | (buf[5] << 8)
    if version not in DECODE_VERSIONS:
        raise DataTableError(f"unsupported DataTable version {version}")
    r = _Reader(buf)
    r.pos = 6
    return _decode_value(r)
