"""The port's segment layer against the JAX package's: the builder array for
array (forward, dictionary, stats, an MV column's lens), carrying a reference
segment across with segment_from_numpy, and the staging dtype policy and
padding of to_device (an MV column's flat values and owning docs too)."""

import json

import numpy as np
import pytest
import torch

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common import TableConfig as JTableConfig
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, IndexingConfig, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from pinot_tpu_torch.segment.segment import DOC_PAD, padded_len

COLUMNS = [
    # (name, type name, role)
    ("region", "STRING", "dim"),
    ("year", "INT", "dim"),
    ("shipdate", "LONG", "dim"),
    ("rating", "DOUBLE", "dim"),
    ("flag", "BOOLEAN", "dim"),
    ("quantity", "INT", "metric"),
    ("revenue", "LONG", "metric"),
    ("bigval", "LONG", "metric"),
    ("discount", "DOUBLE", "metric"),
    ("weight", "FLOAT", "metric"),
    ("ts", "TIMESTAMP", "metric"),
]


def _schema(DT, S):
    return S.build(
        "t",
        dimensions=[(c, DT[t]) for c, t, r in COLUMNS if r == "dim"],
        metrics=[(c, DT[t]) for c, t, r in COLUMNS if r == "metric"],
    )


def _data(seed, n):
    rng = np.random.default_rng(seed)
    regions = np.array(["ASIA", "EUROPE", "AFRICA", "AMERICA", "MIDDLE EAST", "é-region"], dtype=object)
    return {
        "region": regions[rng.integers(0, len(regions), n)],
        "year": rng.integers(1992, 1999, n).astype(np.int32),
        "shipdate": rng.integers(19920101, 19981231, n).astype(np.int64),
        "rating": np.round(rng.uniform(0, 5, n), 1),
        "flag": rng.integers(0, 2, n).astype(np.int32),
        "quantity": rng.integers(-50, 51, n).astype(np.int32),
        "revenue": rng.integers(100, 600_000, n).astype(np.int64),
        # exceeds int32: stays int64 on the device
        "bigval": rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64),
        "discount": np.round(rng.uniform(0, 0.1, n), 3),
        "weight": rng.uniform(0, 10, n).astype(np.float32),
        "ts": np.sort(rng.integers(1_600_000_000_000, 1_700_000_000_000, n)).astype(np.int64),
    }


def describe(seg) -> dict:
    """A reference segment as segment_from_numpy's plain-data description,
    its star-tree tables included."""
    desc = {
        "name": seg.name,
        "schema": seg.schema.to_json(),
        "n_docs": seg.n_docs,
        "columns": {
            c: {
                "forward": ci.forward,
                "dictionary": None if ci.dictionary is None else ci.dictionary.values,
                "stats": ci.stats.to_dict(),
                **({"lens": ci.lens} if ci.lens is not None else {}),
            }
            for c, ci in seg.columns.items()
        },
    }
    if seg.extras.get("null"):
        desc["null"] = dict(seg.extras["null"])
    if seg.extras.get("startree"):
        desc["startree"] = [
            {
                "dimensions": st.dimensions,
                "function_column_pairs": st.function_column_pairs,
                "n_rows": st.n_rows,
                "arrays": st.arrays,
            }
            for st in seg.extras["startree"]
        ]
    return desc


def _assert_same_segment(ref, port):
    assert port.n_docs == ref.n_docs
    assert list(port.columns) == list(ref.columns)
    for c, rci in ref.columns.items():
        pci = port.columns[c]
        assert pci.forward.dtype == rci.forward.dtype, c
        assert np.array_equal(pci.forward, rci.forward), c
        assert (pci.dictionary is None) == (rci.dictionary is None), c
        if rci.dictionary is not None:
            assert pci.dictionary.values.dtype == rci.dictionary.values.dtype, c
            assert np.array_equal(pci.dictionary.values, rci.dictionary.values), c
        assert pci.stats.to_dict() == rci.stats.to_dict(), c
        assert (pci.lens is None) == (rci.lens is None), c
        if rci.lens is not None:
            assert pci.lens.dtype == rci.lens.dtype and np.array_equal(pci.lens, rci.lens), c


@pytest.fixture(scope="module")
def pair():
    data = _data(11, 5000)
    ref = JBuilder(_schema(JDT, JSchema)).build(data, "seg0")
    port = SegmentBuilder(_schema(DataType, Schema)).build(data, "seg0")
    return data, ref, port


def test_schema_json_roundtrip():
    js = _schema(JDT, JSchema).to_json()
    assert json.loads(_schema(DataType, Schema).to_json()) == json.loads(js)
    assert Schema.from_json(js).to_json() == js


def test_builder_matches_reference(pair):
    _, ref, port = pair
    _assert_same_segment(ref, port)


@pytest.mark.parametrize("seed,n", [(1, 1), (2, 1024), (3, 1500), (4, 4097)])
def test_builder_matches_reference_at_sizes(seed, n):
    data = _data(seed, n)
    ref = JBuilder(_schema(JDT, JSchema)).build(data, "s")
    port = SegmentBuilder(_schema(DataType, Schema)).build(data, "s")
    _assert_same_segment(ref, port)


def test_no_dictionary_override_matches_reference():
    data = _data(5, 3000)
    ref = JBuilder(
        _schema(JDT, JSchema), JTableConfig("t", indexing=type(JTableConfig("t").indexing)(no_dictionary_columns=["year"], dictionary_columns=["quantity"]))
    ).build(data, "s")
    port = SegmentBuilder(
        _schema(DataType, Schema),
        TableConfig("t", IndexingConfig(no_dictionary_columns=["year"], dictionary_columns=["quantity"])),
    ).build(data, "s")
    assert port.columns["year"].dictionary is None and port.columns["quantity"].dictionary is not None
    _assert_same_segment(ref, port)


def test_row_input_and_nulls_match_reference():
    rows = [{"region": "ASIA", "year": 1995, "quantity": None}, {"region": None, "year": 1996, "quantity": 4}]
    cols = [("region", "STRING", "dim"), ("year", "INT", "dim"), ("quantity", "INT", "metric")]

    def schema(DT, S):
        return S.build("r", dimensions=[(c, DT[t]) for c, t, r in cols if r == "dim"],
                       metrics=[(c, DT[t]) for c, t, r in cols if r == "metric"])

    ref = JBuilder(schema(JDT, JSchema)).build(rows, "s")
    port = SegmentBuilder(schema(DataType, Schema)).build(rows, "s")
    _assert_same_segment(ref, port)


def test_null_vectors_match_reference():
    """Under `null_handling` the builder keeps each column's null vector, the
    bitmap the reference keeps, byte for byte, and segment_from_numpy carries
    the reference's across; without it no vector is kept."""
    from pinot_tpu.common.config import IndexingConfig as JIndexingConfig

    rng = np.random.default_rng(8)
    n = 300
    data = _data(9, n)
    for c in ("region", "year", "revenue", "discount"):
        v = data[c].astype(object)
        v[rng.random(n) < 0.2] = None
        data[c] = v
    ref = JBuilder(_schema(JDT, JSchema), JTableConfig("t", indexing=JIndexingConfig(null_handling=True))).build(data, "s")
    built = SegmentBuilder(_schema(DataType, Schema), TableConfig("t", IndexingConfig(null_handling=True))).build(data, "s")
    carried = segment_from_numpy(describe(ref))
    assert sorted(ref.extras["null"]) == ["discount", "region", "revenue", "year"]
    for port in (built, carried):
        _assert_same_segment(ref, port)
        assert sorted(port.extras["null"]) == sorted(ref.extras["null"])
        for c, bm in ref.extras["null"].items():
            assert port.extras["null"][c].dtype == bm.dtype and np.array_equal(port.extras["null"][c], bm), c
            assert np.array_equal(port.null_mask({c}), np.asarray([x is None for x in data[c]])), c
    # a nullable LONG column holds int64 min at its nulls: staged as int64
    assert built.to_device("cpu").arrays["revenue"].dtype == torch.int64
    assert "null" not in SegmentBuilder(_schema(DataType, Schema)).build(data, "s").extras


def test_segment_from_numpy_carries_reference_across(pair):
    _, ref, _ = pair
    port = segment_from_numpy(describe(ref))
    assert port.name == ref.name
    _assert_same_segment(ref, port)
    assert port.schema.to_json() == ref.schema.to_json()


def test_segment_from_numpy_rejects_bad_descriptions(pair):
    _, ref, _ = pair
    desc = describe(ref)
    desc["columns"]["year"] = dict(desc["columns"]["year"], forward=desc["columns"]["year"]["forward"][:10])
    with pytest.raises(ValueError, match="year"):
        segment_from_numpy(desc)
    desc = describe(ref)
    del desc["columns"]["region"]
    with pytest.raises(ValueError, match="region"):
        segment_from_numpy(desc)


def test_to_device_matches_reference_staging(pair):
    _, ref, port = pair
    jdev = ref.to_device()
    dev = port.to_device("cpu")
    assert dev.padded == jdev.padded == padded_len(ref.n_docs)
    assert dev.device == torch.device("cpu")
    assert set(dev.arrays) == set(jdev.arrays)
    for c, t in dev.arrays.items():
        want = np.asarray(jdev.arrays[c])
        got = t.numpy()
        assert got.dtype == want.dtype, c
        assert np.array_equal(got, want), c


def test_to_device_dtype_policy_and_padding(pair):
    _, _, port = pair
    dev = port.to_device("cpu")
    n, pad = port.n_docs, dev.padded
    assert pad % DOC_PAD == 0 and pad >= n
    expect = {
        "region": torch.int32,  # dict ids
        "revenue": torch.int32,  # int64 narrowed: stats fit int32
        "ts": torch.int64,  # int64 kept: stats exceed int32
        "bigval": torch.int64,
        "discount": torch.float64,  # DOUBLE stays f64
        "weight": torch.float32,
        "quantity": torch.int32,
    }
    for c, dt in expect.items():
        t = dev.arrays[c]
        assert t.dtype == dt, c
        assert t.shape == (pad,)
        assert not t[n:].any(), c  # zero tail
        assert np.array_equal(t[:n].numpy(), port.columns[c].forward.astype(t.numpy().dtype)), c


def test_to_device_cached_is_per_device(pair):
    _, _, port = pair
    a = port.to_device_cached("cpu")
    assert port.to_device_cached(torch.device("cpu")) is a
    assert port.to_device("cpu") is not a


def test_default_staging_device_is_the_card(pair):
    _, _, port = pair
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default stages there")
    with pytest.raises((RuntimeError, AssertionError)):
        port.to_device()


@pytest.mark.parametrize(
    "indexing",
    [
        dict(inverted_index_columns=["year"]),
        dict(range_index_columns=["year"]),
        dict(bloom_filter_columns=["year"]),
        dict(text_index_columns=["region"]),
        dict(vector_index_columns=["v"]),
        dict(fst_index_columns=["region"]),
        dict(json_index_columns=["region"]),
    ],
)
def test_unsupported_table_config_raises(indexing):
    """Each index field the builder refused until the indexes were ported:
    now both packages build the same index from the same rows, field for
    field (a vector column the schema lacks builds nothing in either)."""
    from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
    from test_torch_store import assert_same

    data = _data(3, 900)
    ref = JBuilder(_schema(JDT, JSchema), JTableConfig("t", indexing=JIndexingConfig(**indexing))).build(data, "s0")
    port = SegmentBuilder(_schema(DataType, Schema), TableConfig("t", IndexingConfig(**indexing))).build(data, "s0")
    assert sorted(port.extras) == sorted(ref.extras)
    assert_same(port.extras, ref.extras, "extras")
    assert bool(port.extras) == (next(iter(indexing)) != "vector_index_columns")


def _mv_schema(DT, S, FS):
    schema = S("mv")
    schema.add(FS("tags", DT.STRING, single_value=False))
    schema.add(FS("nums", DT.LONG, single_value=False))
    schema.add(FS("big", DT.LONG, single_value=False))
    schema.add(FS("score", DT.DOUBLE, single_value=False))
    schema.add(FS("none", DT.INT, single_value=False))
    return schema


def _mv_data(n=700, seed=5):
    """Per-doc lists (some empty, one None) of a STRING, a LONG that fits
    int32, a LONG past int32, a DOUBLE and an always-empty INT column."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5, n)
    words = np.array([f"w{i}" for i in range(30)], dtype=object)
    cols = {
        "tags": [list(words[rng.integers(0, 30, k)]) for k in lens],
        "nums": [rng.integers(-5, 100, k).tolist() for k in lens[::-1]],
        "big": [rng.integers(-(1 << 40), 1 << 40, k).tolist() for k in lens],
        "score": [np.round(rng.uniform(0, 1, k), 2).tolist() for k in lens[::-1]],
        "none": [[] for _ in lens],
    }
    cols["tags"][3] = None
    data = {}
    for c, lists in cols.items():
        data[c] = np.empty(n, dtype=object)
        for i, v in enumerate(lists):
            data[c][i] = v
    return data


def test_multi_value_column_raises():
    """An MV column builds, carries and stages as the reference's (see
    _check_mv_segment); its numeric columns dictionary-encoded."""
    _check_mv_segment(raw=False)


def test_multi_value_raw_columns_match_reference():
    """The same with the numeric MV columns raw (no dictionary)."""
    _check_mv_segment(raw=True)


def _check_mv_segment(raw: bool):
    """An MV column builds as the reference's (flat forward, dictionary,
    stats, lens; no null vector, never sorted), carries across with
    segment_from_numpy, and stages as the reference stages it: the flat
    values (int64 narrowed where it fits) and "{col}!docs", both padded to
    padded_len(n_values), padding docids at the padded doc count."""
    from pinot_tpu.common import FieldSpec as JFS
    from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
    from pinot_tpu_torch.common import FieldSpec

    table = raw
    raw = ["nums", "big", "score", "none"] if raw else []
    jcfg = JTableConfig("mv", indexing=JIndexingConfig(no_dictionary_columns=raw))
    cfg = TableConfig("mv", IndexingConfig(no_dictionary_columns=raw))
    data = _mv_data()
    ref = JBuilder(_mv_schema(JDT, JSchema, JFS), jcfg).build(data, "mv0")
    port = SegmentBuilder(_mv_schema(DataType, Schema, FieldSpec), cfg).build(data, "mv0")
    _assert_same_segment(ref, port)
    assert all(ci.is_mv and not ci.stats.is_sorted for ci in port.columns.values())
    assert "null" not in port.extras
    for got in (port, segment_from_numpy(describe(ref))):
        _assert_same_segment(ref, got)
        jdev, dev = ref.to_device(), got.to_device("cpu")
        assert set(dev.arrays) == set(jdev.arrays) == {c for c in ref.columns} | {f"{c}!docs" for c in ref.columns}
        for c, t in dev.arrays.items():
            want = np.asarray(jdev.arrays[c])
            assert t.numpy().dtype == want.dtype and np.array_equal(t.numpy(), want), c
    dev = port.to_device("cpu")
    # raw: a LONG past int32 stays int64, one that fits narrows to int32;
    # dictionary-encoded, both stage int32 ids
    assert dev.arrays["big"].dtype == (torch.int64 if table else torch.int32)
    assert dev.arrays["nums"].dtype == torch.int32
    n_values = int(port.columns["tags"].lens.sum())
    docs = dev.arrays["tags!docs"].numpy()
    assert len(docs) == padded_len(n_values) and (docs[n_values:] == dev.padded).all()
    assert list(port.columns["tags"].materialize([2])[0]) == data["tags"][2]
