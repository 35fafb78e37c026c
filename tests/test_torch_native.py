"""The port's native host library against the JAX package's.

The corpus is tests/test_native.py's 20 cases. Each runs twice: with both
libraries built ("built": the port's copy of the C++ against the
reference's), and with both modules on their numpy / zlib / pure-Python
fallbacks ("fallback": the port's `_STATE` set to no library, the
reference's `_lib` to None). In each mode every output of the port is
bit-equal to the reference's on the same seeded inputs, and the reference
test's own checks hold for the port. The last cases hold the port's library
bit-equal to its own fallbacks wherever the C++ and numpy compute the same
bits (integers, bitmaps, hashes, HLL registers; float sums of integers).
"""

import zlib

import numpy as np
import pytest

from pinot_tpu import native as R
from pinot_tpu_torch import native as P


@pytest.fixture(params=["built", "fallback"])
def mode(request, monkeypatch):
    """Both packages with their library, or both on their fallbacks."""
    assert P.available() and R.available(), "g++ builds both libraries here"
    if request.param == "fallback":
        monkeypatch.setattr(P, "_STATE", [None, True])
        monkeypatch.setattr(R, "_lib", None)
    return request.param


def same(a, b):
    """Bit-equal arrays (dtype and bytes) or equal scalars / bytes."""
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, float):
        return isinstance(b, float) and np.float64(a).tobytes() == np.float64(b).tobytes()
    return type(a) is type(b) and a == b


def both(fn):
    """fn(module) for the reference and the port; asserts them bit-equal and
    returns the port's."""
    r, p = fn(R), fn(P)
    assert same(r, p), (r, p)
    return p


def test_native_available(mode):
    assert P.available() == R.available() == (mode == "built")


@pytest.mark.parametrize("bits", [1, 3, 7, 8, 13, 17, 24, 31])
def test_bitpack_roundtrip(mode, bits):
    n = 10_001
    ids = np.random.default_rng(bits).integers(0, 1 << bits, n).astype(np.uint32)
    packed = both(lambda m: m.bitpack(ids, bits))
    assert packed.dtype == np.uint64 and len(packed) == (n * bits + 63) // 64
    np.testing.assert_array_equal(both(lambda m: m.bitunpack(packed, n, bits)), ids)


def test_bitpack_matches_fallback(mode, monkeypatch):
    ids = np.random.default_rng(1).integers(0, 1000, 4097).astype(np.uint32)
    bits = both(lambda m: m.bits_needed(1000))
    packed = both(lambda m: m.bitpack(ids, bits))
    monkeypatch.setattr(P, "_STATE", [None, True])
    np.testing.assert_array_equal(P.bitpack(ids, bits), packed)
    np.testing.assert_array_equal(P.bitunpack(packed, len(ids), bits), ids)


def _payloads():
    rng = np.random.default_rng(2)
    return [
        b"",
        b"a",
        b"hello world " * 400,
        bytes(rng.integers(0, 256, 10_000, dtype=np.uint8)),  # incompressible
        bytes(rng.integers(0, 4, 50_000, dtype=np.uint8)),  # compressible
        b"\x00" * 100_000,
    ]


@pytest.mark.parametrize("i", range(6))
def test_lz4_roundtrip(mode, i):
    payload = _payloads()[i]
    if mode == "fallback":
        # no compressor without the library (the store keeps chunks raw)
        for m in (R, P):
            with pytest.raises(RuntimeError, match="native lz4 unavailable"):
                m.lz4_compress(payload)
        return
    comp = both(lambda m: m.lz4_compress(payload))
    assert both(lambda m: m.lz4_decompress(comp, len(payload))) == payload


def test_lz4_python_fallback_decodes_native_output(mode, monkeypatch):
    payloads = [b"hello world " * 400, bytes(np.random.default_rng(3).integers(0, 5, 30_000, dtype=np.uint8))]
    comps = [_lz4_with_library(p) if mode == "fallback" else both(lambda m: m.lz4_compress(p)) for p in payloads]
    monkeypatch.setattr(P, "_STATE", [None, True])
    monkeypatch.setattr(R, "_lib", None)
    for payload, comp in zip(payloads, comps):
        assert both(lambda m: m.lz4_decompress(comp, len(payload))) == payload


def test_lz4_compresses_repetitive_data(mode):
    payload = b"abcdefgh" * 10_000
    if mode == "fallback":
        assert not P.codec_available("lz4") and not R.codec_available("lz4")
        return
    assert len(both(lambda m: m.lz4_compress(payload))) < len(payload) // 10


def test_lz4_corruption_detected_or_divergent(mode):
    # a flipped byte either breaks the stream (RuntimeError) or yields wrong
    # bytes, the same in both packages; a truncated stream raises in both
    payload = b"some data to compress " * 100
    comp = _lz4_with_library(payload)
    bad = bytearray(comp)
    bad[len(bad) // 2] ^= 0xFF
    outs = []
    for m in (R, P):
        try:
            outs.append(m.lz4_decompress(bytes(bad), len(payload)))
        except RuntimeError as e:
            outs.append(type(e))
    assert outs[0] == outs[1] and outs[1] != payload
    for m in (R, P):
        with pytest.raises(RuntimeError):
            m.lz4_decompress(comp[: len(comp) // 2], len(payload))


def _lz4_with_library(payload):
    """LZ4 bytes from the port's library while the modules are on their
    fallbacks (the fallback cannot compress)."""
    saved = P._STATE
    P._STATE = [None, False]
    try:
        return P.lz4_compress(payload)
    finally:
        P._STATE = saved


def test_bitmap_algebra(mode):
    rng = np.random.default_rng(4)
    n = 1000
    a_bool, b_bool = rng.random(n) < 0.3, rng.random(n) < 0.5
    a = both(lambda m: m.bm_from_bool(a_bool))
    b = both(lambda m: m.bm_from_bool(b_bool))
    assert both(lambda m: m.bm_words(n)) == len(a)
    np.testing.assert_array_equal(both(lambda m: m.bm_to_bool(m.bm_and(a, b), n)), a_bool & b_bool)
    np.testing.assert_array_equal(both(lambda m: m.bm_to_bool(m.bm_or(a, b), n)), a_bool | b_bool)
    np.testing.assert_array_equal(both(lambda m: m.bm_to_bool(m.bm_andnot(a, b), n)), a_bool & ~b_bool)
    np.testing.assert_array_equal(both(lambda m: m.bm_to_bool(m.bm_not(a), n)), ~a_bool)
    for op in ("bm_and", "bm_or", "bm_andnot"):
        both(lambda m: getattr(m, op)(a, b))
    both(lambda m: m.bm_not(a))
    assert both(lambda m: m.bm_cardinality(a)) == int(a_bool.sum())


def test_bitmap_extract_and_from_indices(mode):
    n = 5000
    mask = np.random.default_rng(5).random(n) < 0.1
    bm = both(lambda m: m.bm_from_bool(mask))
    ids = both(lambda m: m.bm_extract(bm))
    np.testing.assert_array_equal(ids, np.nonzero(mask)[0].astype(np.int32))
    both(lambda m: m.bm_extract(bm, cap=7))
    np.testing.assert_array_equal(both(lambda m: m.bm_from_indices(ids, n)), bm)


def test_hash64_dispersion_and_determinism(mode):
    vals = np.arange(10_000, dtype=np.int64)
    h1 = both(lambda m: m.hash64(vals))
    np.testing.assert_array_equal(h1, P.hash64(vals))
    assert len(np.unique(h1)) == len(vals)
    both(lambda m: m.hash64(vals.view(np.uint64)))
    both(lambda m: m.hash64(np.random.default_rng(6).integers(-(1 << 62), 1 << 62, 5000)))


def test_hash_bytes(mode):
    strings = [b"alpha", b"beta", b"", b"alpha", b"gamma" * 10]
    blob = b"".join(strings)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in strings])]).astype(np.int64)
    h = both(lambda m: m.hash_bytes(blob, offsets))
    assert h[0] == h[3]
    assert len({int(x) for x in (h[0], h[1], h[2], h[4])}) == 4


def test_hll_estimate_accuracy(mode):
    p = 12
    true_n = 50_000
    hashes = both(lambda m: m.hash64(np.arange(true_n, dtype=np.int64)))

    def regs_of(m, parts):
        out = []
        for lo, hi in parts:
            r = np.zeros(1 << p, dtype=np.uint8)
            m.hll_update(hashes[lo:hi], None, p, r)
            out.append(r)
        return out

    regs = both(lambda m: regs_of(m, [(0, true_n)])[0])
    est = both(lambda m: m.hll_estimate(regs, p))
    assert abs(est - true_n) / true_n < 0.05

    def merged(m):
        r1, r2 = regs_of(m, [(0, true_n // 2), (true_n // 2, true_n)])
        m.hll_merge(r2, r1)
        return r1

    np.testing.assert_array_equal(both(merged), regs)


def test_hll_mask(mode):
    p = 10
    hashes = both(lambda m: m.hash64(np.arange(1000, dtype=np.int64)))
    mask = np.zeros(1000, dtype=bool)
    mask[:10] = True

    def run(m):
        regs = np.zeros(1 << p, dtype=np.uint8)
        m.hll_update(hashes, mask, p, regs)
        return regs

    regs = both(run)
    assert 5 <= both(lambda m: m.hll_estimate(regs, p)) <= 15


def test_masked_stats(mode):
    rng = np.random.default_rng(7)
    v = rng.normal(size=10_000)
    mask = rng.random(10_000) < 0.4
    s, mn, mx, cnt = both(lambda m: m.masked_stats(v, mask))
    sel = v[mask]
    assert cnt == len(sel) and np.isclose(s, sel.sum())
    assert mn == sel.min() and mx == sel.max()
    both(lambda m: m.masked_stats(v, None))
    assert both(lambda m: m.masked_stats(v, np.zeros(len(v), bool))) == (0.0, float("inf"), float("-inf"), 0)


def test_group_aggregations(mode):
    rng = np.random.default_rng(8)
    n, ng = 20_000, 37
    gid = rng.integers(0, ng, n).astype(np.int32)
    v = rng.normal(size=n)
    mask = rng.random(n) < 0.7
    ref_sum = np.zeros(ng)
    np.add.at(ref_sum, gid[mask], v[mask])
    np.testing.assert_allclose(both(lambda m: m.group_sum(v, gid, mask, ng)), ref_sum)
    ref_cnt = np.zeros(ng, dtype=np.int64)
    np.add.at(ref_cnt, gid[mask], 1)
    np.testing.assert_array_equal(both(lambda m: m.group_count(gid, mask, ng)), ref_cnt)
    gmin = both(lambda m: m.group_min(v, gid, mask, ng))
    gmax = both(lambda m: m.group_max(v, gid, mask, ng))
    for g in range(ng):
        sel = v[mask & (gid == g)]
        if len(sel):
            assert gmin[g] == sel.min() and gmax[g] == sel.max()
    for fn in ("group_sum", "group_min", "group_max"):
        both(lambda m: getattr(m, fn)(v, gid, None, ng + 3))
    both(lambda m: m.group_count(gid, None, ng + 3))


def test_hash_group_ids_first_seen_order(mode):
    keys = np.array([5, 9, 5, 7, 9, 9, 1], dtype=np.uint64)
    gid, ng = both(lambda m: m.hash_group_ids(keys))
    assert ng == 4
    np.testing.assert_array_equal(gid, [0, 1, 0, 2, 1, 1, 3])
    assert both(lambda m: m.hash_group_ids(np.zeros(0, dtype=np.uint64)))[1] == 0


def test_hash_group_ids_large(mode):
    keys = both(lambda m: m.hash64(np.random.default_rng(9).integers(0, 5000, 100_000).astype(np.int64)))
    gid, ng = both(lambda m: m.hash_group_ids(keys))
    assert ng == len(np.unique(keys))
    remap = {}
    for k, g in zip(keys[:1000].tolist(), gid[:1000].tolist()):
        assert remap.setdefault(k, g) == g


def test_crc32_matches_zlib(mode):
    data = bytes(np.random.default_rng(10).integers(0, 256, 10_000, dtype=np.uint8))
    assert both(lambda m: m.crc32(data)) == zlib.crc32(data)
    assert both(lambda m: m.crc32(data, seed=123)) == zlib.crc32(data, 123)
    assert both(lambda m: m.crc32(np.frombuffer(data, dtype=np.uint32))) == zlib.crc32(data)


def test_chunk_codecs_roundtrip(mode):
    data = np.random.default_rng(1).integers(0, 40, 200_000).astype(np.int32).tobytes()
    for codec in ("lz4", "zstd", "gzip", "snappy"):
        assert both(lambda m: m.codec_available(codec)) == (P.codec_available(codec))
        if not P.codec_available(codec):
            continue
        comp = both(lambda m: m.chunk_compress(data, codec))
        assert both(lambda m: m.chunk_decompress(comp, len(data), codec)) == data
        assert len(comp) < len(data)


def test_segment_store_zstd_codec(mode, tmp_path, monkeypatch):
    """A zstd segment written by each package is the same file, and the
    query over it the same answer."""
    from pinot_tpu.common import DataType as RDataType
    from pinot_tpu.common import Schema as RSchema
    from pinot_tpu.query import QueryEngine as RQueryEngine
    from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder
    from pinot_tpu.segment import load_segment as r_load
    from pinot_tpu.segment import write_segment as r_write
    from pinot_tpu_torch.common import DataType, Schema
    from pinot_tpu_torch.query import QueryEngine
    from pinot_tpu_torch.segment import SegmentBuilder, load_segment, write_segment
    from pinot_tpu_torch.segment.store import SEGMENT_FILE, SegmentFileReader

    if not P.codec_available("zstd"):
        assert not R.codec_available("zstd")
        return
    monkeypatch.setenv("PINOT_TPU_CHUNK_CODEC", "zstd")
    rng = np.random.default_rng(2)
    n = 50_000
    data = {
        "k": np.array([f"k{i % 40}" for i in range(n)], dtype=object),
        "v": rng.integers(0, 1000, n).astype(np.int64),
    }
    r_dir = r_write(RSegmentBuilder(RSchema.build("t", dimensions=[("k", RDataType.STRING)],
                                                  metrics=[("v", RDataType.LONG)])).build(dict(data), "s0"),
                    tmp_path / "r")
    p_dir = write_segment(SegmentBuilder(Schema.build("t", dimensions=[("k", DataType.STRING)],
                                                      metrics=[("v", DataType.LONG)])).build(dict(data), "s0"),
                          tmp_path / "p", codec="zstd")
    assert "zstd" in {e["codec"] for e in SegmentFileReader(p_dir / SEGMENT_FILE).entries.values()}
    assert (p_dir / SEGMENT_FILE).read_bytes() == (r_dir / SEGMENT_FILE).read_bytes()
    sql = "SELECT SUM(v) FROM t WHERE k = 'k7'"
    got = QueryEngine([load_segment(p_dir)], device="cpu").execute(sql).rows
    assert got == RQueryEngine([r_load(r_dir)]).execute(sql).rows
    assert got[0][0] == float(data["v"][data["k"] == "k7"].sum())


# -- the port's library against its own fallbacks ----------------------------


def _hll_regs(m, hashes, mask, p):
    regs = np.zeros(1 << p, dtype=np.uint8)
    m.hll_update(hashes, mask, p, regs)
    return regs


@pytest.mark.parametrize(
    "name",
    ["bitmaps", "hash64", "hash_bytes", "hash_group_ids", "hll", "masked_stats", "group_loops"],
)
def test_library_equals_its_fallback(name, monkeypatch):
    """Where the C++ and numpy compute the same bits (chip_smoke's check on
    the card's host, at its table's size), the port's library equals its
    own fallback: integer-valued float64 sums are exact in any order."""
    rng = np.random.default_rng(11)
    n, ng = 3000, 50
    a, b = rng.random(n) < 0.4, rng.random(n) < 0.6
    ints = rng.integers(-(1 << 40), 1 << 40, n)
    strings = [f"h{i:04d}".encode() for i in rng.integers(0, 1000, 200)]
    blob = b"".join(strings)
    offsets = np.concatenate([[0], np.cumsum([len(s) for s in strings])]).astype(np.int64)
    v = rng.integers(0, 1 << 31, n).astype(np.float64)
    gid = rng.integers(0, ng, n).astype(np.int32)

    def run():
        if name == "bitmaps":
            x, y = P.bm_from_bool(a), P.bm_from_bool(b)
            out = (P.bm_and(x, y), P.bm_or(x, y), P.bm_andnot(x, y), P.bm_not(x), P.bm_extract(x),
                   P.bm_from_indices(np.flatnonzero(b), n))
            return out + (P.bm_cardinality(x),)
        if name == "hash64":
            return P.hash64(ints)
        if name == "hash_bytes":
            return P.hash_bytes(blob, offsets)
        if name == "hash_group_ids":
            return P.hash_group_ids(P.hash64(ints % 97))
        if name == "hll":
            regs = _hll_regs(P, P.hash64(ints), a, 12)
            acc = _hll_regs(P, P.hash64(ints), b, 12)
            P.hll_merge(regs, acc)
            return regs, acc, P.hll_estimate(acc, 12)
        if name == "masked_stats":
            return P.masked_stats(v, a), P.masked_stats(v, None)
        return (P.group_sum(v, gid, a, ng), P.group_count(gid, a, ng), P.group_min(v, gid, a, ng),
                P.group_max(v, gid, None, ng))

    built = run()
    monkeypatch.setattr(P, "_STATE", [None, True])
    assert same(built, run())
