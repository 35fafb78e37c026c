"""Input-format record readers: CSV, JSON/JSONL, Parquet, ORC, Avro (gated).

Reference parity: pinot-plugins/pinot-input-format/ RecordReader impls
(CSVRecordReader, JSONRecordReader, ParquetRecordReader, ORCRecordReader,
AvroRecordReader, ProtoBufRecordReader...). A RecordReader iterates rows as
plain dicts (GenericRow analog) and also exposes a columnar fast path
(`read_columns`) because the segment builder is columnar end-to-end —
row-by-row iteration exists for SPI parity and streaming ingestion reuse.

This is the JAX package's `io/readers.py` without pandas: Parquet and ORC
columns convert through pyarrow's own `to_numpy` to the dtypes and values
the reference's pandas conversion gives. pyarrow, fastavro and protobuf stay
optional imports inside the readers that need them.
"""

from __future__ import annotations

import csv
import io
import json
import struct
from pathlib import Path
from typing import Any, Iterator

import numpy as np


class RecordReader:
    """Iterate rows as dicts; `read_columns()` returns name -> np.ndarray."""

    def __iter__(self) -> Iterator[dict[str, Any]]:
        raise NotImplementedError

    def read_columns(self) -> dict[str, np.ndarray]:
        rows = list(self)
        if not rows:
            return {}
        cols: dict[str, list] = {k: [] for k in rows[0]}
        for r in rows:
            for k in cols:
                cols[k].append(r.get(k))
        return {k: _np_col(v) for k, v in cols.items()}

    def close(self) -> None:
        pass


def _np_col(values: list) -> np.ndarray:
    arr = np.asarray(values)
    if arr.dtype.kind in "OU":
        # try numeric promotion; fall back to object strings
        try:
            return np.asarray(values, dtype=np.int64)
        except (ValueError, TypeError, OverflowError):
            pass
        try:
            return np.asarray(values, dtype=np.float64)
        except (ValueError, TypeError):
            return np.asarray([None if v is None else str(v) for v in values], dtype=object)
    return arr


class CSVRecordReader(RecordReader):
    """CSVRecordReader parity: header row, configurable delimiter; numeric
    fields promote by column (whole-column inference, not per-cell)."""

    def __init__(self, path: str | Path | None = None, *, text: str | None = None, delimiter: str = ","):
        self._path = path
        self._text = text
        self._delimiter = delimiter

    def _reader(self):
        f = io.StringIO(self._text) if self._text is not None else open(self._path, newline="")
        return f, csv.DictReader(f, delimiter=self._delimiter)

    def __iter__(self):
        f, rd = self._reader()
        try:
            for row in rd:
                yield {k: _parse_scalar(v) for k, v in row.items()}
        finally:
            f.close()

    def read_columns(self) -> dict[str, np.ndarray]:
        f, rd = self._reader()
        try:
            cols: dict[str, list] = {k: [] for k in rd.fieldnames or []}
            for row in rd:
                for k in cols:
                    cols[k].append(row.get(k))
            return {k: _np_col_csv(v) for k, v in cols.items()}
        finally:
            f.close()


def _parse_scalar(v):
    if v is None or v == "":
        return None
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def _np_col_csv(values: list) -> np.ndarray:
    try:
        return np.asarray(values, dtype=np.int64)
    except (ValueError, TypeError):
        pass
    try:
        return np.asarray(values, dtype=np.float64)
    except (ValueError, TypeError):
        return np.asarray(values, dtype=object)


class JSONRecordReader(RecordReader):
    """JSONRecordReader parity: a JSON array of objects, or JSON-lines.
    Nested objects/lists stay as JSON strings (the json_index consumes them)."""

    def __init__(self, path: str | Path | None = None, *, text: str | None = None):
        self._path = path
        self._text = text

    def _rows(self) -> list[dict]:
        text = self._text if self._text is not None else Path(self._path).read_text()
        text = text.strip()
        if not text:
            return []
        if text.startswith("["):
            return json.loads(text)
        return [json.loads(line) for line in text.splitlines() if line.strip()]

    def __iter__(self):
        for r in self._rows():
            yield {k: (json.dumps(v) if isinstance(v, (dict, list)) else v) for k, v in r.items()}


class ParquetRecordReader(RecordReader):
    """ParquetRecordReader parity via pyarrow (columnar native path)."""

    def __init__(self, path: str | Path):
        import pyarrow.parquet as pq

        self._table = pq.read_table(path)

    def read_columns(self) -> dict[str, np.ndarray]:
        return {name: _arrow_to_numpy(self._table.column(name)) for name in self._table.column_names}

    def __iter__(self):
        cols = self.read_columns()
        names = list(cols)
        n = len(next(iter(cols.values()))) if cols else 0
        for i in range(n):
            yield {k: cols[k][i] for k in names}


def _arrow_to_numpy(col) -> np.ndarray:
    """One pyarrow column as the reference's `to_pandas().to_numpy()` gives
    it under pandas 3: numerics, booleans and timestamps as pyarrow converts
    them (a null int makes the column float64 with NaN; a null bool makes it
    object with None); strings as objects with NaN for null (pandas' string
    dtype); dates as objects of datetime.date."""
    import pyarrow as pa

    t = col.type
    if pa.types.is_date(t):
        return np.asarray(col.to_pylist(), dtype=object)
    out = col.to_numpy(zero_copy_only=False)
    if pa.types.is_string(t) or pa.types.is_large_string(t) or pa.types.is_string_view(t):
        out = np.array(out, dtype=object)
        out[col.is_null().to_numpy(zero_copy_only=False)] = np.nan
    return out


class ORCRecordReader(ParquetRecordReader):
    """ORCRecordReader parity via pyarrow.orc."""

    def __init__(self, path: str | Path):
        from pyarrow import orc

        self._table = orc.read_table(path)


class AvroRecordReader(RecordReader):
    """AvroRecordReader parity. Gated on fastavro: without it, raises
    ImportError with guidance (plugin model — register a real impl when
    available)."""

    def __init__(self, path: str | Path):
        try:
            import fastavro  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "Avro input requires fastavro (not installed); "
                "convert to parquet/jsonl or register a custom reader"
            ) from e
        self._path = path

    def __iter__(self):
        import fastavro

        with open(self._path, "rb") as f:
            yield from fastavro.reader(f)


class ProtobufRecordReader(RecordReader):
    """ProtoBufRecordReader parity: length-delimited protobuf messages
    decoded through a caller-supplied message class (the descriptor stands in
    for Pinot's descriptorFile config). google.protobuf is imported when the
    file is read; only the message class is caller-provided."""

    def __init__(self, path: str | Path, message_cls=None):
        if message_cls is None:
            raise ValueError(
                "protobuf input requires message_cls (the generated Message class; "
                "ProtoBufRecordReader's descriptorFile analog)"
            )
        self._path = path
        self._cls = message_cls

    def __iter__(self):
        from google.protobuf.internal.decoder import _DecodeVarint32

        buf = Path(self._path).read_bytes()
        pos = 0
        while pos < len(buf):
            size, pos = _DecodeVarint32(buf, pos)
            msg = self._cls()
            msg.ParseFromString(buf[pos : pos + size])
            pos += size
            yield {f.name: getattr(msg, f.name) for f in msg.DESCRIPTOR.fields}


#: TBinaryProtocol wire type ids (the public Thrift binary encoding)
_T_STOP, _T_BOOL, _T_BYTE, _T_DOUBLE = 0, 2, 3, 4
_T_I16, _T_I32, _T_I64, _T_STRING = 6, 8, 10, 11
_T_STRUCT, _T_MAP, _T_SET, _T_LIST = 12, 13, 14, 15


class ThriftRecordReader(RecordReader):
    """ThriftRecordReader parity: back-to-back TBinaryProtocol structs
    decoded by a clean-room reader of the PUBLIC Thrift binary encoding
    (field header = type:1B + id:2B BE; values big-endian; strings
    len-prefixed; containers typed+counted). The reference resolves field
    NAMES through a generated thrift class (thriftClass config of
    pinot-plugins/pinot-input-format/pinot-thrift); the binary wire format
    carries only field IDs, so this reader takes the id->name map directly
    (`field_map`) — or a thrift class exposing `thrift_spec`, from which the
    map is derived."""

    def __init__(self, path: str | Path, field_map: dict[int, str] | None = None, thrift_cls=None):
        if field_map is None and thrift_cls is not None:
            spec = getattr(thrift_cls, "thrift_spec", None)
            field_map = {}
            if isinstance(spec, dict):
                # thriftpy2 shape: {fid: (ttype, name, ...)}
                for fid, entry in spec.items():
                    if entry and len(entry) > 1 and isinstance(entry[1], str):
                        field_map[int(fid)] = entry[1]
            elif isinstance(spec, (list, tuple)):
                # Apache Thrift generated shape: (None, (fid, ttype, name, ...), ...)
                for entry in spec:
                    if entry and len(entry) > 2 and isinstance(entry[2], str):
                        field_map[int(entry[0])] = entry[2]
        if not field_map:
            raise ValueError(
                "thrift input requires field_map={field_id: name} (or a thrift "
                "class with thrift_spec) — the binary protocol carries ids only"
            )
        self._path = path
        self._fields = dict(field_map)

    def __iter__(self):
        buf = Path(self._path).read_bytes()
        pos = 0
        while pos < len(buf):
            row, pos = _thrift_read_struct(buf, pos)
            yield {self._fields.get(fid, f"field_{fid}"): v for fid, v in row}


def _thrift_unpack(fmt: str, buf: bytes, pos: int, width: int):
    """Bounds-checked fixed-width read: a value that runs past the end of the
    file is corruption (truncated download, bad offset), not a crash —
    struct.error from unpack_from must never leak to callers as-is."""
    if pos + width > len(buf):
        raise ValueError(f"corrupt thrift data: truncated value at offset {pos}")
    try:
        return struct.unpack_from(fmt, buf, pos)[0]
    except struct.error as e:  # pragma: no cover - bounds check above covers it
        raise ValueError(f"corrupt thrift data: truncated value at offset {pos}") from e


def _thrift_byte(buf: bytes, pos: int) -> int:
    """Bounds-checked single-byte read (wire-type / element-type bytes)."""
    if pos >= len(buf):
        raise ValueError(f"corrupt thrift data: truncated value at offset {pos}")
    return buf[pos]


def _thrift_len(buf: bytes, pos: int, width: int = 1) -> int:
    """Validated length/count prefix: negative or past-end values are file
    corruption — fail loudly instead of looping backwards (negative length
    would move pos backwards forever) or yielding a truncated last row.
    `width` is the minimum encoded size of one element, so an absurd count
    of wide elements is rejected at the prefix instead of spinning through
    per-element reads to the eventual truncation error."""
    n = _thrift_unpack(">i", buf, pos, 4)
    if n < 0 or pos + 4 + n * width > len(buf):
        raise ValueError(f"corrupt thrift data: length {n} at offset {pos}")
    return n


#: minimum encoded bytes per value of each wire type (variable-width types
#: count their own mandatory prefix: string 4B length, list/set 1B etype +
#: 4B count, map 2B types + 4B count, struct 1B STOP)
_T_MIN_WIDTH = {
    _T_BOOL: 1, _T_BYTE: 1, _T_DOUBLE: 8, _T_I16: 2, _T_I32: 4, _T_I64: 8,
    _T_STRING: 4, _T_STRUCT: 1, _T_LIST: 5, _T_SET: 5, _T_MAP: 6,
}


def _thrift_read_value(buf: bytes, pos: int, ftype: int):
    if ftype == _T_BOOL:
        return _thrift_byte(buf, pos) != 0, pos + 1
    if ftype == _T_BYTE:
        return _thrift_unpack(">b", buf, pos, 1), pos + 1
    if ftype == _T_DOUBLE:
        return _thrift_unpack(">d", buf, pos, 8), pos + 8
    if ftype == _T_I16:
        return _thrift_unpack(">h", buf, pos, 2), pos + 2
    if ftype == _T_I32:
        return _thrift_unpack(">i", buf, pos, 4), pos + 4
    if ftype == _T_I64:
        return _thrift_unpack(">q", buf, pos, 8), pos + 8
    if ftype == _T_STRING:
        n = _thrift_len(buf, pos)
        raw = buf[pos + 4 : pos + 4 + n]
        try:
            return raw.decode("utf-8"), pos + 4 + n
        except UnicodeDecodeError:
            return raw, pos + 4 + n  # BINARY shares the wire type
    if ftype == _T_STRUCT:
        fields, pos = _thrift_read_struct(buf, pos)
        return dict(fields), pos
    if ftype in (_T_LIST, _T_SET):
        etype = _thrift_byte(buf, pos)
        n = _thrift_len(buf, pos + 1, _T_MIN_WIDTH.get(etype, 1))
        pos += 5
        out = []
        for _ in range(n):
            v, pos = _thrift_read_value(buf, pos, etype)
            out.append(v)
        return out, pos
    if ftype == _T_MAP:
        ktype, vtype = _thrift_byte(buf, pos), _thrift_byte(buf, pos + 1)
        n = _thrift_len(
            buf, pos + 2, _T_MIN_WIDTH.get(ktype, 1) + _T_MIN_WIDTH.get(vtype, 1)
        )
        pos += 6
        out = {}
        for _ in range(n):
            k, pos = _thrift_read_value(buf, pos, ktype)
            v, pos = _thrift_read_value(buf, pos, vtype)
            out[k] = v
        return out, pos
    raise ValueError(f"unsupported thrift wire type {ftype} at offset {pos}")


def _thrift_read_struct(buf: bytes, pos: int) -> tuple[list, int]:
    fields = []
    while True:
        if pos >= len(buf):
            raise ValueError(f"corrupt thrift data: struct truncated at offset {pos}")
        ftype = buf[pos]
        pos += 1
        if ftype == _T_STOP:
            return fields, pos
        fid = _thrift_unpack(">h", buf, pos, 2)
        pos += 2
        v, pos = _thrift_read_value(buf, pos, ftype)
        fields.append((fid, v))


class CLPRecordReader(RecordReader):
    """CLP (Compressed Log Processing) reader parity: free-text log lines
    split into logtype (the template with variables blanked), dictionary
    variables, and encoded numeric variables — the three-column encoding
    CLPLogRecordReader emits (pinot-plugins/pinot-input-format/pinot-clp-log/).
    """

    _VAR = None  # compiled lazily

    def __init__(self, path: str | Path | None = None, *, text: str | None = None):
        self._path = path
        self._text = text

    @classmethod
    def encode_line(cls, line: str) -> dict[str, Any]:
        import re as _re

        if cls._VAR is None:
            # CLP variable heuristic: any token containing a digit becomes a
            # variable; the whole dotted/dashed token matches at once so IPs,
            # versions, and timestamps stay intact
            cls._VAR = _re.compile(r"(?<![\w.:/\-])[\w./:\-]*\d[\w./:\-]*")
            cls._INT = _re.compile(r"-?(?:0|[1-9]\d*)")
            cls._FLT = _re.compile(r"-?\d+\.\d+")
        dict_vars: list[str] = []
        encoded_vars: list[float] = []

        def repl(m):
            tok = m.group(0)
            # float-encode ONLY when the decode path reproduces the token
            # exactly (leading zeros, IPs, ints past 2^53, '-0', and ids with
            # separators all stay dictionary vars)
            if cls._INT.fullmatch(tok):
                f = float(tok)
                if str(int(f)) == tok:
                    encoded_vars.append(f)
                    return "\\f"
            elif (
                cls._FLT.fullmatch(tok)
                and repr(float(tok)) == tok
                and not float(tok).is_integer()
            ):
                encoded_vars.append(float(tok))
                return "\\f"
            dict_vars.append(tok)
            return "\\d"

        # pre-escape literal backslashes so placeholder markers in the
        # ORIGINAL text ("regex \\d matched") never collide with ours
        logtype = cls._VAR.sub(repl, line.rstrip("\n").replace("\\", "\\\\"))
        return {
            "logtype": logtype,
            "dictionaryVars": dict_vars,
            "encodedVars": encoded_vars,
        }

    @classmethod
    def decode_row(cls, row: dict[str, Any]) -> str:
        """Reassemble the original line from the three columns."""
        out = []
        d = iter(row["dictionaryVars"])
        e = iter(row["encodedVars"])
        i = 0
        s = row["logtype"]
        while i < len(s):
            if s.startswith("\\\\", i):
                out.append("\\")
                i += 2
            elif s.startswith("\\d", i):
                out.append(next(d))
                i += 2
            elif s.startswith("\\f", i):
                v = float(next(e))
                # integral floats were encoded from exact int tokens (guard in
                # encode): int formatting restores them even past 1e16
                out.append(str(int(v)) if v.is_integer() else str(v))
                i += 2
            else:
                out.append(s[i])
                i += 1
        return "".join(out)

    def __iter__(self):
        if self._text is not None:
            lines = self._text.splitlines()
        else:
            lines = Path(self._path).read_text().splitlines()
        for line in lines:
            if line.strip():
                yield self.encode_line(line)


_BY_EXT = {
    ".csv": CSVRecordReader,
    ".json": JSONRecordReader,
    ".jsonl": JSONRecordReader,
    ".ndjson": JSONRecordReader,
    ".parquet": ParquetRecordReader,
    ".orc": ORCRecordReader,
    ".avro": AvroRecordReader,
    ".pb": ProtobufRecordReader,
    ".thrift": ThriftRecordReader,
    ".log": CLPRecordReader,
    ".clp": CLPRecordReader,
}


def open_record_reader(path: str | Path, fmt: str | None = None) -> RecordReader:
    """Factory by explicit format name or file extension
    (RecordReaderFactory parity)."""
    if fmt is not None:
        key = "." + fmt.lower().lstrip(".")
    else:
        key = Path(str(path)).suffix.lower()
    cls = _BY_EXT.get(key)
    if cls is None:
        raise ValueError(f"no RecordReader for format {key!r} (have {sorted(_BY_EXT)})")
    return cls(path)
