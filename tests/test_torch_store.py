"""The port's segment store, loader and codecs against the JAX package's.

One table exercises every index type and column kind: single- and
multi-value columns, STRING / INT / LONG / DOUBLE / JSON / BYTES, a null
vector, a star tree, and bloom, inverted, range, text, JSON, geo, vector
(exact and HNSW), FST and map indexes. Each package builds it from the same
seeded numpy columns and writes it:

- the two files are byte for byte the same under every chunk codec this
  host has (raw, lz4, zstd, gzip, snappy), so the footer's fileCrc and each
  chunk's codec agree;
- a file written by either package loads in the other to the same columns,
  dictionaries, stats, null vectors and `extras` (every index), and the
  loaded segments answer the same queries through both engines;
- a corrupted byte raises SegmentCorruptedError in both; the store's fault
  point and the atomic write behave as the reference's;
- lz4 round-trips through the port's C++ and its pure-Python decoder, and
  compresses to the reference's bytes.

Tolerance: none; every comparison is exact.
"""

import dataclasses
import math

import numpy as np
import pytest

from pinot_tpu import native as jnative
from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import FieldSpec as JFS
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
from pinot_tpu.common.config import StarTreeIndexConfig as JStarTreeIndexConfig
from pinot_tpu.common.config import TableConfig as JTableConfig
from pinot_tpu.common.errors import SegmentCorruptedError as JSegmentCorruptedError
from pinot_tpu.common.faults import FAULTS as JFAULTS
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu.segment import load_segment as jload
from pinot_tpu.segment import store as jstore
from pinot_tpu.segment.builder import write_segment as jwrite
from pinot_tpu_torch import native
from pinot_tpu_torch.common import DataType, FieldSpec, IndexingConfig, Schema, TableConfig
from pinot_tpu_torch.common.config import StarTreeIndexConfig
from pinot_tpu_torch.common.durability import atomic_write_bytes
from pinot_tpu_torch.common.errors import SegmentCorruptedError
from pinot_tpu_torch.common.faults import FAULTS, TornWriteFault
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.segment import SegmentBuilder, load_segment, write_segment
from pinot_tpu_torch.segment import store

CODECS = ["raw", "lz4", "zstd", "gzip", "snappy"]
N_DOCS = 3000
WORDS = ["espresso", "latte", "tea", "juice", "bagel", "muffin"]


def rich_schema(DT, S, FS, name="t"):
    s = S.build(
        name,
        dimensions=[
            ("city", DT.STRING),
            ("code", DT.INT),
            ("descr", DT.STRING),
            ("attrs", DT.JSON),
            ("payload", DT.BYTES),
        ],
        metrics=[("revenue", DT.DOUBLE), ("clicks", DT.LONG), ("lat", DT.DOUBLE), ("lng", DT.DOUBLE)],
    )
    s.add(FS("tags", DT.STRING, single_value=False))
    s.add(FS("nums", DT.INT, single_value=False))
    s.add(FS("emb", DT.FLOAT, single_value=False))
    return s


def rich_config(IC, TC, ST, name="t", vector_type="EXACT"):
    return TC(
        name,
        indexing=IC(
            bloom_filter_columns=["city", "code"],
            inverted_index_columns=["city"],
            range_index_columns=["code", "clicks"],
            text_index_columns=["descr"],
            json_index_columns=["attrs"],
            geo_index_columns=[["lat", "lng"]],
            vector_index_columns=["emb"],
            vector_index_type=vector_type,
            fst_index_columns=["city"],
            map_index_columns=["attrs"],
            null_handling=True,
            star_tree_configs=[ST(["city"], ["SUM__clicks", "COUNT__*"])],
        ),
    )


def rich_data(seed=7, n=N_DOCS, lat0=37.0, lng0=-122.5):
    rng = np.random.default_rng(seed)
    data = {
        "city": np.array(["sf", "nyc", "tokyo", "berlin"], dtype=object)[rng.integers(0, 4, n)],
        "code": rng.integers(0, 500, n).astype(np.int32),
        "descr": np.asarray([" ".join(rng.choice(WORDS, size=3, replace=False)) for _ in range(n)], dtype=object),
        "attrs": np.asarray(
            ['{"color": "%s", "size": %d}' % (["red", "green", "blue"][i % 3], i % 5) for i in range(n)], dtype=object
        ),
        "payload": np.array([bytes([i, 0, i]) for i in range(9)], dtype=object)[rng.integers(0, 9, n)],
        "revenue": rng.normal(100.0, 20.0, n).astype(object),
        "clicks": rng.integers(0, 10_000, n).astype(np.int64),
        "lat": rng.uniform(lat0, lat0 + 1.0, n),
        "lng": rng.uniform(lng0, lng0 + 1.0, n),
        "tags": np.empty(n, dtype=object),
        "nums": np.empty(n, dtype=object),
        "emb": rng.normal(size=(n, 8)).astype(np.float32),
    }
    data["revenue"][rng.random(n) < 0.05] = None
    data["tags"][:] = [list(rng.choice(["a", "b", "c", "d"], size=rng.integers(0, 3), replace=False)) for _ in range(n)]
    data["nums"][:] = [rng.integers(0, 50, rng.integers(0, 4)).tolist() for _ in range(n)]
    return data


def build_pair(data, name="s0", vector_type="EXACT", table="t"):
    """(reference segment, port segment) of the same rows."""
    ref = JBuilder(
        rich_schema(JDT, JSchema, JFS, table),
        rich_config(JIndexingConfig, JTableConfig, JStarTreeIndexConfig, table, vector_type),
    ).build(data, name)
    port = SegmentBuilder(
        rich_schema(DataType, Schema, FieldSpec, table),
        rich_config(IndexingConfig, TableConfig, StarTreeIndexConfig, table, vector_type),
    ).build(data, name)
    return ref, port


@pytest.fixture(scope="module")
def rich():
    return build_pair(rich_data())


@pytest.fixture(scope="module")
def rich_hnsw():
    return build_pair(rich_data(seed=8, n=800), vector_type="HNSW")


def _values(a):
    """An array's values in a dtype-free form (string dictionaries are
    fixed-width in a fresh build and object arrays after a load)."""
    a = np.asarray(a)
    return a.tolist() if a.dtype.kind in "OUS" else a


def assert_same(a, b, path="seg"):
    """Deep equality of two packages' structures: same class names, equal
    fields; arrays of equal dtype and values (string and object arrays by
    value); NaN equal to NaN."""
    if a is None or b is None:
        assert a is None and b is None, (path, a, b)
        return
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        va, vb = _values(a), _values(b)
        if isinstance(va, list) or isinstance(vb, list):
            assert list(va) == list(vb) if not isinstance(va, np.ndarray) else va.tolist() == vb, path
        else:
            assert va.dtype == vb.dtype and va.shape == vb.shape, (path, va.dtype, vb.dtype, va.shape, vb.shape)
            np.testing.assert_array_equal(va, vb, err_msg=path)
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and set(a) == set(b), (path, sorted(a), sorted(b))
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
        return
    if isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), (path, a, b)
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
        return
    if dataclasses.is_dataclass(a) or hasattr(a, "__dict__") and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, (path, type(a), type(b))
        fa = {k: v for k, v in vars(a).items() if not k.startswith("_")}
        fb = {k: v for k, v in vars(b).items() if not k.startswith("_")}
        assert_same(fa, fb, path)
        return
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        assert math.isnan(b), path
        return
    assert a == b, (path, a, b)


def assert_same_segment(got, want, extras: bool = True):
    """Columns (forward, dictionary, stats, MV lengths) and, with `extras`,
    the null vectors and every index. A freshly built index keeps build-time
    fields a loaded one lacks (H3Index.centers), so whole extras are held
    between segments loaded from one file."""
    assert (got.name, got.n_docs) == (want.name, want.n_docs)
    assert got.schema.to_json() == want.schema.to_json()
    assert list(got.columns) == list(want.columns)
    for c, ci in want.columns.items():
        gi = got.columns[c]
        assert_same(gi.forward, ci.forward, f"{c}.forward")
        assert (gi.dictionary is None) == (ci.dictionary is None), c
        if ci.dictionary is not None:
            assert_same(gi.dictionary.values, ci.dictionary.values, f"{c}.dictionary")
        assert gi.stats.to_dict() == ci.stats.to_dict(), c
        assert_same(gi.lens, ci.lens, f"{c}.lens")
    if extras:
        assert sorted(got.extras) == sorted(want.extras)
        assert_same(got.extras, want.extras, "extras")


def _write_ref(seg, out, codec, monkeypatch):
    monkeypatch.setenv("PINOT_TPU_CHUNK_CODEC", codec)
    return jwrite(seg, out)


def _need(codec):
    if not native.codec_available(codec):
        pytest.skip(f"{codec} is not available on this host")


# -- files ----------------------------------------------------------------------


@pytest.mark.parametrize("codec", CODECS)
def test_files_are_byte_identical(rich, codec, tmp_path, monkeypatch):
    """The same segment written by either package: the same bytes, so the
    same fileCrc, and the same codec in every chunk."""
    _need(codec)
    ref, port = rich
    a = _write_ref(ref, tmp_path / "ref", codec, monkeypatch)
    b = write_segment(port, tmp_path / "port", codec=codec)
    ra, rb = (a / store.SEGMENT_FILE).read_bytes(), (b / store.SEGMENT_FILE).read_bytes()
    assert ra == rb
    assert store.segment_file_crc(b) == jstore.segment_file_crc(a) == jstore.verify_segment_file(b)
    assert store.verify_segment_file(a) == store.segment_file_crc(a)
    entries = store.SegmentFileReader(b / store.SEGMENT_FILE).entries
    used = {e["codec"] for e in entries.values()}
    assert used == ({"raw"} if codec == "raw" else {"raw", codec})
    assert {k: e["codec"] for k, e in entries.items()} == {
        k: e["codec"] for k, e in jstore.SegmentFileReader(a / store.SEGMENT_FILE).entries.items()
    }


@pytest.mark.parametrize("codec", CODECS)
def test_reference_file_loads_in_port(rich, codec, tmp_path, monkeypatch):
    """The reference's file loads in the port as in the reference (every
    index equal), with the columns of the port's own build."""
    _need(codec)
    ref, port = rich
    f = _write_ref(ref, tmp_path, codec, monkeypatch)
    loaded = load_segment(f)
    assert_same_segment(loaded, jload(f))
    assert_same_segment(loaded, port, extras=False)


@pytest.mark.parametrize("codec", CODECS)
def test_port_file_loads_in_reference(rich, codec, tmp_path):
    _need(codec)
    ref, port = rich
    f = write_segment(port, tmp_path, codec=codec)
    loaded = jload(f)
    assert_same_segment(load_segment(f), loaded)
    assert_same_segment(loaded, ref, extras=False)


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_npz_layout_loads_across(rich, direction, tmp_path):
    ref, port = rich
    d = jwrite(ref, tmp_path, fmt="npz") if direction == "reference_to_port" else write_segment(port, tmp_path, fmt="npz")
    assert_same_segment(load_segment(d), jload(d))
    assert_same_segment(load_segment(d), port, extras=False)
    assert (tmp_path / "s0" / "metadata.json").exists() and not (tmp_path / "s0" / store.SEGMENT_FILE).exists()


def test_hnsw_segment_loads_across(rich_hnsw, tmp_path):
    """HNSW graphs rebuild on load from the persisted vectors in both."""
    ref, port = rich_hnsw
    assert type(port.extras["vector"]["emb"]).__name__ == "HnswIndex"
    for d in (jwrite(ref, tmp_path / "r"), write_segment(port, tmp_path / "p")):
        assert_same_segment(load_segment(d), jload(d))
    assert_same(port.extras["vector"], ref.extras["vector"], "hnsw")


def test_build_and_write(tmp_path):
    data = rich_data(seed=3, n=500)
    d = SegmentBuilder(
        rich_schema(DataType, Schema, FieldSpec), rich_config(IndexingConfig, TableConfig, StarTreeIndexConfig)
    ).build_and_write(data, "bw", tmp_path)
    want = JBuilder(
        rich_schema(JDT, JSchema, JFS), rich_config(JIndexingConfig, JTableConfig, JStarTreeIndexConfig)
    ).build_and_write(data, "bw", tmp_path / "ref")
    assert (d / store.SEGMENT_FILE).read_bytes() == (want / store.SEGMENT_FILE).read_bytes()


STORE_QUERIES = [
    "SELECT city, SUM(clicks), COUNT(*) FROM t GROUP BY city ORDER BY city",
    "SET enableNullHandling = true; SELECT city, SUM(revenue), COUNT(revenue) FROM t GROUP BY city ORDER BY city",
    "SELECT tags, COUNT(*), MAX(code) FROM t GROUP BY tags ORDER BY tags",
    "SELECT SUMMV(nums), COUNTMV(tags), MINMV(nums) FROM t WHERE code < 300",
    "SELECT COUNT(*) FROM t WHERE TEXT_MATCH(descr, 'tea') AND revenue IS NOT NULL",
]


@pytest.mark.parametrize("sql", STORE_QUERIES)
def test_loaded_segments_answer_alike(rich, sql, tmp_path):
    """The port's engine over the reference's file and the reference's
    engine over the port's file give the same rows (a DOUBLE sum at rtol
    1e-12: the two packages add in different orders)."""
    ref, port = rich
    want = JEngine([jload(write_segment(port, tmp_path / "p"))]).execute(sql)
    got = QueryEngine([load_segment(jwrite(ref, tmp_path / "r"))], device="cpu").execute(sql)
    assert got.columns == want.columns and len(got.rows) == len(want.rows)
    for g, w in zip(got.rows, want.rows):
        for x, y in zip(g, w):
            assert type(x) is type(y) and (x == y or math.isclose(x, y, rel_tol=1e-12)), (sql, g, w)
    assert got.num_docs_scanned == want.num_docs_scanned > 0


# -- integrity ------------------------------------------------------------------


@pytest.mark.parametrize("where", ["header", "entry", "index", "footer"])
def test_corrupted_byte_raises_in_both(rich, where, tmp_path):
    """One flipped byte: both packages' verify and open raise their
    SegmentCorruptedError (a ValueError); the same position, the same
    verdict."""
    _, port = rich
    d = write_segment(port, tmp_path)
    f = d / store.SEGMENT_FILE
    raw = bytearray(f.read_bytes())
    index_off = int(np.frombuffer(bytes(raw[-store.FOOTER_V3 : -store.FOOTER_V3 + 8]), dtype="<u8")[0])
    pos = {"header": 3, "entry": 4096, "index": index_off + 10, "footer": len(raw) - 12}[where]
    raw[pos] ^= 0x40
    f.write_bytes(bytes(raw))
    for verify, reader, err in (
        (store.verify_segment_file, lambda: store.SegmentFileReader(f), SegmentCorruptedError),
        (jstore.verify_segment_file, lambda: jstore.SegmentFileReader(f), JSegmentCorruptedError),
    ):
        with pytest.raises(err):
            verify(f)
        with pytest.raises(err):
            reader()
    with pytest.raises(SegmentCorruptedError):
        load_segment(d)
    assert issubclass(SegmentCorruptedError, ValueError)
    assert SegmentCorruptedError.error_code == JSegmentCorruptedError.error_code


def test_entry_crc_checked_on_read(rich, tmp_path):
    """With the whole-file check skipped, a damaged entry still fails its
    own CRC when decoded, in both packages."""
    _, port = rich
    f = write_segment(port, tmp_path, codec="raw") / store.SEGMENT_FILE
    e = store.SegmentFileReader(f).entries["fwd::clicks"]
    raw = bytearray(f.read_bytes())
    raw[e["off"] + 5] ^= 0x01
    f.write_bytes(bytes(raw))
    with pytest.raises(SegmentCorruptedError, match="CRC mismatch on entry"):
        store.SegmentFileReader(f, verify=False).read("fwd::clicks")
    with pytest.raises(JSegmentCorruptedError, match="CRC mismatch on entry"):
        jstore.SegmentFileReader(f, verify=False).read("fwd::clicks")
    store.SegmentFileReader(f, verify=False).read("fwd::code")  # the others still decode


def test_expected_crc_and_bytes(rich, tmp_path):
    _, port = rich
    f = write_segment(port, tmp_path) / store.SEGMENT_FILE
    raw = f.read_bytes()
    crc = store.segment_file_crc(f)
    assert store.verify_segment_bytes(raw, expected_crc=crc) == jstore.verify_segment_bytes(raw, expected_crc=crc) == crc
    with pytest.raises(SegmentCorruptedError, match="cluster metadata"):
        store.verify_segment_bytes(raw, expected_crc=crc ^ 1)
    with pytest.raises(SegmentCorruptedError, match="not a PTSEG"):
        store.verify_segment_bytes(b"x" * 64)


@pytest.fixture
def faults():
    FAULTS.reset()
    JFAULTS.reset()
    yield
    FAULTS.reset()
    JFAULTS.reset()


def test_storage_read_fault_point(rich, tmp_path, faults):
    """A bitflip injected at `storage.read` surfaces as the typed error, as
    in the reference."""
    _, port = rich
    d = write_segment(port, tmp_path)
    FAULTS.configure({"storage.read": {"mode": "bitflip", "offset": 40}})
    JFAULTS.configure({"storage.read": {"mode": "bitflip", "offset": 40}})
    with pytest.raises(SegmentCorruptedError):
        load_segment(d)
    with pytest.raises(JSegmentCorruptedError):
        jload(d)
    FAULTS.reset()
    assert load_segment(d).n_docs == N_DOCS


def test_torn_write_leaves_no_segment_file(rich, tmp_path, faults):
    """A write killed mid-way leaves the old file (here: none) and a torn tmp
    sibling, never a torn segment.ptseg."""
    _, port = rich
    FAULTS.configure({"storage.write": {"mode": "torn", "offset": 100}})
    with pytest.raises(TornWriteFault):
        write_segment(port, tmp_path)
    d = tmp_path / "s0"
    assert not (d / store.SEGMENT_FILE).exists()
    assert [p.name for p in d.iterdir()][0].startswith(".segment.ptseg.tmp.")
    FAULTS.reset()
    target = tmp_path / "x.bin"
    atomic_write_bytes(target, b"abc")
    assert target.read_bytes() == b"abc"


# -- codecs ---------------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(5)
    return {
        "empty": b"",
        "short": b"abc",
        "random": rng.integers(0, 256, 70_000, dtype=np.uint8).tobytes(),
        "ids": rng.integers(0, 40, 100_000).astype(np.int32).tobytes(),
        "runs": b"pinot" * 20_000 + bytes(range(256)) * 40,
        "zeros": bytes(1 << 17),
    }


@pytest.mark.parametrize("name", list(_payloads()))
def test_lz4_round_trips_through_cpp_and_python(name):
    data = _payloads()[name]
    assert native.available()
    comp = native.lz4_compress(data)
    assert comp == jnative.lz4_compress(data)
    assert native.lz4_decompress(comp, len(data)) == data
    assert native._lz4_decompress_py(comp, len(data)) == data
    assert jnative.lz4_decompress(comp, len(data)) == data
    assert native.crc32(data) == jnative.crc32(data)


@pytest.mark.parametrize("codec", ["zstd", "gzip", "snappy"])
def test_system_codecs_match_reference(codec):
    _need(codec)
    data = _payloads()["runs"]
    comp = native.chunk_compress(data, codec)
    assert comp == jnative.chunk_compress(data, codec)
    assert native.chunk_decompress(comp, len(data), codec) == data
    assert native.codec_available(codec) == jnative.codec_available(codec)


@pytest.mark.parametrize("bits", [1, 2, 5, 9, 13, 17, 24, 31])
def test_bitpack_matches_reference(bits):
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 1 << bits, 10_001).astype(np.uint32)
    packed = native.bitpack(ids, bits)
    np.testing.assert_array_equal(packed, jnative.bitpack(ids, bits))
    np.testing.assert_array_equal(native.bitunpack(packed, len(ids), bits), ids)
    assert native.bits_needed(1 << bits) == jnative.bits_needed(1 << bits) == bits


def test_fallbacks_without_the_library(rich, tmp_path, monkeypatch):
    """Where the library cannot be built the reference's fallbacks hold:
    numpy packing and zlib's CRC give the same results, lz4 is not offered
    (chunks stay raw) and an lz4 file still loads through the Python
    decoder."""
    _, port = rich
    lz4_dir = write_segment(port, tmp_path / "lz4")
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 1000, 5000).astype(np.uint32)
    data = _payloads()["runs"]
    with_lib = (native.bitpack(ids, 10), native.crc32(data))
    monkeypatch.setattr(native, "_STATE", [None, True])
    assert not native.available() and not native.codec_available("lz4") and native.codec_available("raw")
    np.testing.assert_array_equal(native.bitpack(ids, 10), with_lib[0])
    np.testing.assert_array_equal(native.bitunpack(with_lib[0], len(ids), 10), ids)
    assert native.crc32(data) == with_lib[1]
    assert_same_segment(load_segment(lz4_dir), jload(lz4_dir))
    raw_dir = write_segment(port, tmp_path / "raw")
    assert {e["codec"] for e in store.SegmentFileReader(raw_dir / store.SEGMENT_FILE).entries.values()} == {"raw"}
