"""The port's DataTable wire format against the JAX package's, byte for byte.

The corpus is `tests/test_datatable.py`'s. A frame goes into the port as a
`Frame` (its dict of numpy columns) and into the reference as the equal
pandas DataFrame; both must write the same bytes, in v2 and in v1, and each
package must decode the other's payloads.
"""

import numpy as np
import pandas as pd
import pytest

from pinot_tpu.common import datatable as ref
from pinot_tpu_torch.common import datatable as port
from pinot_tpu_torch.common.datatable import DataTableError, Frame


def _frame_cases():
    """(name, columns) frames: the fixed frames of the reference's tests and
    its seeded dtype matrix."""
    cases = [
        ("kvf", {"k": np.array(["a", "b"], dtype=object), "v": np.array([1, 2], dtype=np.int64), "f": np.array([1.5, 2.5])}),
        ("v1", {"k": np.array(["a", "b", "a"], dtype=object), "v": np.array([1.0, 2.0, 3.0])}),
        ("empty_cols", {"a": np.array([], dtype=np.int64), "s": np.array([], dtype=object)}),
        ("dict_strings", {"k": np.array([f"key{i % 97}" for i in range(5000)], dtype=object), "v": np.arange(5000)}),
        ("unicode_strings", {"k": np.array([f"key{i % 97}" for i in range(5000)]), "v": np.arange(5000)}),
        ("adversarial", {"k": np.array(["aa", "bb", "cc"] * 40, dtype=object), "v": np.arange(120, dtype=np.int64)}),
    ]
    rng = np.random.default_rng(42)
    dtypes = [np.int8, np.int32, np.int64, np.uint16, np.float32, np.float64, np.bool_]
    words = np.array(["alpha", "béta", "g\x00mma", "", "delta" * 40], dtype=object)
    for case in range(25):
        n = int(rng.integers(0, 300))
        cols = {}
        for c in range(int(rng.integers(1, 5))):
            kind = int(rng.integers(0, 5))
            if kind == 0:
                dt = dtypes[int(rng.integers(0, len(dtypes)))]
                cols[f"n{c}"] = rng.integers(0, 100, n).astype(dt)
            elif kind == 1:
                cols[f"t{c}"] = rng.integers(0, 10**9, n).astype("datetime64[ns]")
            elif kind == 2:
                cols[f"d{c}"] = rng.integers(0, 10**6, n).astype("timedelta64[us]")
            elif kind == 3:
                cols[f"s{c}"] = words[rng.integers(0, len(words), n)]
            else:
                mixed = np.empty(n, dtype=object)
                mixed[:] = [("w%d" % i, None, i)[i % 3] for i in range(n)]
                cols[f"m{c}"] = mixed
        cases.append((f"matrix{case}", cols))
    return cases


FRAMES = _frame_cases()

VALUES = [
    None,
    True,
    False,
    42,
    -(2**62),
    3.5,
    "héllo",
    b"\x00\xff",
    [1, "a", None],
    (1, (2, 3)),
    {1, "x", 2.5},
    {"k": [1, 2], ("t", 1): "v"},
    np.int64(7),
    np.float64(2.5),
    np.array(["x", None, "z"], dtype=object),
    np.array([f"w{i % 5}" for i in range(200)], dtype=object),
    np.array([f"w{i}" for i in range(200)], dtype=object),
    np.array(["a\x00b", "c"] * 40, dtype=object),
    [3, 12.5, {"a", "b"}, (1.0, 2), np.arange(16, dtype=np.float64)],
    {"a": [1, 2.5, "x"], ("t",): {3, 4}},
    np.arange(20, dtype=np.float32).reshape(4, 5),
    np.arange(5000 * 4).reshape(5000, 4).astype("<M8[ns]"),
    [np.arange(12).reshape(3, 4), np.arange(12).reshape(3, 4).T],
] + [
    (np.arange(12, dtype=dt).reshape(3, 4) if dt != np.bool_ else np.ones((3, 4), bool))
    for dt in (np.int32, np.int64, np.float32, np.float64, np.uint8, np.bool_)
]


def _pd(cols):
    return pd.DataFrame(cols)


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_value_bytes_equal(i):
    v = VALUES[i]
    assert port.encode(v) == ref.encode(v)
    assert port.encode_v1(v) == ref.encode_v1(v)
    assert b"".join(port.encode_segments(v)) == port.encode(v)


@pytest.mark.parametrize("name", [n for n, _ in FRAMES])
def test_frame_bytes_equal(name):
    cols = dict(FRAMES)[name]
    assert port.encode(Frame(cols)) == ref.encode(_pd(cols))
    assert port.encode_v1(Frame(cols)) == ref.encode_v1(_pd(cols))
    # a frame nested in a partial list (the server's response shape)
    assert port.encode([Frame(cols), 3]) == ref.encode([_pd(cols), 3])


def test_empty_frame_bytes_equal():
    assert port.encode(Frame()) == ref.encode(pd.DataFrame())
    assert isinstance(port.decode(ref.encode(pd.DataFrame())), Frame)


@pytest.mark.parametrize("name", [n for n, _ in FRAMES])
def test_frames_cross_decode(name):
    """The port decodes the reference's DataFrame payloads into Frames with
    equal columns; the reference decodes the port's into the equal
    DataFrame. v1 payloads too."""
    cols = dict(FRAMES)[name]
    for enc in (ref.encode, ref.encode_v1):
        got = port.decode(enc(_pd(cols)))
        assert isinstance(got, Frame) and list(got) == list(cols)
        for c in cols:
            want = np.asarray(cols[c])
            assert got[c].dtype == (object if want.dtype.kind in "US" else want.dtype)
            assert got[c].tolist() == want.tolist()
    for enc in (port.encode, port.encode_v1):
        pd.testing.assert_frame_equal(ref.decode(enc(Frame(cols))), _pd(cols), check_index_type=False)


@pytest.mark.parametrize("i", range(len(VALUES)))
def test_values_cross_decode(i):
    v = VALUES[i]
    for enc, dec in ((ref.encode, port.decode), (ref.encode_v1, port.decode), (port.encode, ref.decode)):
        got, want = dec(enc(v)), ref.decode(ref.encode(v))
        if isinstance(want, np.ndarray):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert got.tolist() == want.tolist()
        elif isinstance(want, list) and any(isinstance(x, np.ndarray) for x in want):
            assert [x.tolist() if isinstance(x, np.ndarray) else x for x in got] == [
                x.tolist() if isinstance(x, np.ndarray) else x for x in want
            ]
        else:
            assert got == want


def test_errors_match_reference():
    with pytest.raises(DataTableError, match="magic"):
        port.decode(b"XXXX\x01\x00\x00")
    with pytest.raises(DataTableError, match="version"):
        port.decode(b"PTDT\xff\x00\x00")
    with pytest.raises(DataTableError, match="truncated"):
        port.decode(port.encode([1, 2, 3])[:-2])
    with pytest.raises(DataTableError, match="unsupported type"):
        port.encode(object())
    with pytest.raises(DataTableError, match="DataFrame"):
        # a frame whose columns disagree in length cannot be a DataFrame
        port.decode(port.encode(Frame(a=np.arange(3), b=np.arange(2))))


def test_over_4gb_guard():
    """The u32 length guard fires before any copy: a broadcast view claims
    8 GiB it does not own."""
    big = np.broadcast_to(np.zeros(1, dtype=np.int64), (1 << 29, 2))
    with pytest.raises(DataTableError, match="4 GB"):
        port.encode(big)


def test_2d_segment_lengths_are_bytes():
    """The n-d memoryview fix: every segment is a flat byte view, so the
    segments' lengths total the payload's."""
    for dtype in ("<f8", "<i4", "<M8[ns]"):
        arr = np.arange(5000 * 4).reshape(5000, 4).astype(dtype)
        for v in (arr, {"col": arr}, Frame(col=arr[:, 0]), [arr, arr.T, arr[:2]]):
            segs = port.encode_segments(v)
            assert sum(len(s) for s in segs) == len(port.encode(v))
            assert all(memoryview(s).ndim == 1 and memoryview(s).itemsize == 1 for s in segs)


def test_adversarial_payloads_raise_only_datatable_error():
    rng = np.random.default_rng(7)
    frame = Frame(dict(FRAMES)["adversarial"])
    payloads = [port.encode(frame), port.encode([1, "x", np.arange(10)]), port.encode({"a": (1, 2)})]
    for payload in payloads:
        for cut in rng.integers(0, len(payload), 40):
            try:
                port.decode(payload[: int(cut)])
            except DataTableError:
                pass
        for _ in range(60):
            mutated = bytearray(payload)
            for pos in rng.integers(0, len(payload), int(rng.integers(1, 4))):
                mutated[int(pos)] ^= int(rng.integers(1, 256))
            try:
                port.decode(bytes(mutated))
            except DataTableError:
                pass
    with pytest.raises(DataTableError):
        port.decode(port.encode([1])[:7] + b"\xff\xff\xff\xff")


def test_numeric_decode_is_zero_copy():
    arr = np.arange(100_000, dtype=np.int64)
    payload = port.encode(Frame(v=arr))
    out = port.decode(payload)["v"]
    assert not out.flags.writeable
    iface = out.__array_interface__["data"][0]
    base = np.frombuffer(memoryview(payload), dtype=np.uint8).__array_interface__["data"][0]
    assert base <= iface < base + len(payload)
