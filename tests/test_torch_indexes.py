"""The port's segment indexes and the queries they serve, against the JAX
package's.

- Each index class is built from the same seeded data in both packages: its
  fields are equal and so are its probes (bloom membership, inverted posting
  lists, range slices, FST prefix / regex ids, text search, JSON paths, the
  geo grid's and H3's bbox distance and candidates, exact vector and HNSW
  top-k from the same seed, map-index value columns), and the SPI's
  registrations agree.
- TEXT_MATCH, JSON_MATCH, VECTOR_SIMILARITY, ST_WITHIN_DISTANCE, LIKE /
  REGEXP_LIKE over an FST, MAP_VALUE over a map index, bloom- and geo-pruned
  queries and the scan-path classes (INVERTED / RANGE / FST / TEXT / JSON /
  VECTOR / GEO_INDEX) give the reference's rows and stats (the scan profile,
  the pruning funnel, the entry counts) through the port's engine over the
  segments it built and over the reference's files it loaded, on the device
  path and on the host executor.

Tolerance: none, except an AVG at rtol 1e-12.
"""

import json
import math

import numpy as np
import pytest

from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import host_exec as jhost_exec
from pinot_tpu.query import plan as jplan
from pinot_tpu.query import scan_stats as jscan_stats
from pinot_tpu.segment import h3 as jh3
from pinot_tpu.segment import index_spi as jindex_spi
from pinot_tpu.segment import indexes as J
from pinot_tpu.segment import load_segment as jload
from pinot_tpu.segment.builder import write_segment as jwrite
from pinot_tpu_torch.common.segment_heat import HEAT
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import host_exec
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.query import scan_stats
from pinot_tpu_torch.segment import h3, index_spi
from pinot_tpu_torch.segment import indexes as P
from pinot_tpu_torch.segment import load_segment, write_segment
from test_torch_pruner import STATS
from test_torch_store import assert_same, build_pair, rich_data

AVG_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _clean():
    HEAT.reset()
    scan_stats.configure(True)
    jscan_stats.configure(True)
    yield
    HEAT.reset()


# -- the index classes ------------------------------------------------------------


def _probe_values():
    return ["sf", "nyc", "paris", "", "tokyo", 3, 17, 499, 500, -1, 2.5]


def test_bloom_filter():
    rng = np.random.default_rng(1)
    for vals in (
        np.array(sorted({f"k{i}" for i in rng.integers(0, 5000, 800)}), dtype=object),
        np.unique(rng.integers(0, 500, 300)).astype(np.int64),
    ):
        got, want = P.BloomFilter.build(vals), J.BloomFilter.build(vals)
        assert_same(got, want, "bloom")
        for v in list(vals[:50]) + _probe_values() + [f"k{i}" for i in range(5000, 5100)]:
            assert got.might_contain(v) == want.might_contain(v), v
            if v in set(vals.tolist()):
                assert got.might_contain(v)


def test_inverted_index():
    ids = np.random.default_rng(2).integers(0, 50, 5000).astype(np.int32)
    got, want = P.InvertedIndex.build(ids, 53), J.InvertedIndex.build(ids, 53)
    assert_same(got, want, "inverted")
    for i in range(53):
        np.testing.assert_array_equal(got.postings(i), want.postings(i))
        np.testing.assert_array_equal(got.postings(i), np.flatnonzero(ids == i))
    for many in ([1, 7, 49], [], [52], list(range(0, 50, 3))):
        np.testing.assert_array_equal(got.postings_for_many(np.asarray(many)), want.postings_for_many(np.asarray(many)))


@pytest.mark.parametrize("dtype", [np.int64, np.float64])
def test_range_index(dtype):
    vals = np.random.default_rng(3).integers(-100, 100, 4000).astype(dtype)
    got, want = P.RangeIndex.build(vals), J.RangeIndex.build(vals)
    assert_same(got, want, "range")
    for lo, hi, li, hi_i in ((-5, 5, True, True), (-5, 5, False, False), (0, 0, True, True), (50, -50, True, True),
                             (-1000, 1000, True, False), (99, 99, False, True), (10.5, 20.5, True, True)):
        np.testing.assert_array_equal(got.docs_in_range(lo, hi, li, hi_i), want.docs_in_range(lo, hi, li, hi_i))


def test_text_index():
    data = rich_data(seed=4, n=1500)
    got, want = P.TextIndex.build(data["descr"]), J.TextIndex.build(data["descr"])
    assert_same(got, want, "text")
    for q in ("espresso", "latte AND tea", "juice OR bagel", "tea muffin", "lat*", '"latte tea"', "missing",
              "espresso OR latte AND tea", '"--"', ""):
        np.testing.assert_array_equal(got.search(q), want.search(q), err_msg=q)


def test_json_index():
    docs = np.asarray(
        [
            '{"a": {"b": "x"}, "tags": ["red", "blue"], "n": 5}',
            '{"a": {"b": "y"}, "tags": ["red"]}',
            '{"a": {"c": 1}}',
            "not json at all {",
        ]
        + ['{"color": "%s", "size": %d}' % (["red", "green", "blue"][i % 3], i % 5) for i in range(300)],
        dtype=object,
    )
    got, want = P.JsonIndex.build(docs), J.JsonIndex.build(docs)
    assert_same(got, want, "json")
    for q in ("\"$.a.b\"='x'", "\"$.tags[*]\"='red'", '"$.a.b" IS NOT NULL', '"$.a.c" IS NULL',
              "\"$.a.b\"='x' OR \"$.a.c\"='1'", "\"$.tags[*]\"='red' AND \"$.tags[*]\"='blue'", "\"$.n\"='5'",
              "\"$.color\"='red' AND \"$.size\"='3'"):
        np.testing.assert_array_equal(got.match(q), want.match(q), err_msg=q)


def test_geo_grid_and_h3_indexes():
    rng = np.random.default_rng(3)
    lat, lng = rng.uniform(37.0, 38.0, 1000), rng.uniform(-122.5, -121.5, 1000)
    pairs = (
        (P.GeoGridIndex.build("lat", "lng", lat, lng, res_deg=0.25), J.GeoGridIndex.build("lat", "lng", lat, lng, res_deg=0.25)),
        (h3.H3Index.build("lat", "lng", lat, lng), jh3.H3Index.build("lat", "lng", lat, lng)),
    )
    for got, want in pairs:
        assert_same(got, want, type(got).__name__)
        for qlat, qlng, r in ((37.5, -122.0, 20_000.0), (0.0, 0.0, 1e6), (37.0, -122.5, 500.0), (-33.8, 151.2, 5e4)):
            assert got.min_distance_m(qlat, qlng) == want.min_distance_m(qlat, qlng)
            np.testing.assert_array_equal(got.candidate_docs(qlat, qlng, r), want.candidate_docs(qlat, qlng, r))
    assert P.haversine_m(lat[:5], lng[:5], 1.0, 2.0).tolist() == J.haversine_m(lat[:5], lng[:5], 1.0, 2.0).tolist()


@pytest.mark.parametrize("kind", ["VectorIndex", "HnswIndex"])
def test_vector_indexes(kind):
    rng = np.random.default_rng(5)
    vecs = rng.normal(size=(600, 16)).astype(np.float32)
    got, want = getattr(P, kind).build(vecs), getattr(J, kind).build(vecs)
    assert_same(got, want, kind)
    for k in (1, 5, 10, 600):
        q = rng.normal(size=16).astype(np.float32)
        np.testing.assert_array_equal(got.top_k(q, k), want.top_k(q, k))


def test_fst_index():
    vals = np.asarray(sorted(f"user_{i:04d}" for i in range(500)) + ["zebra", "\U0001f600x"], dtype=object)
    got, want = P.FstIndex.build(vals), J.FstIndex.build(vals)
    assert_same(got, want, "fst")
    for prefix in ("user_00", "user_", "zz", "", "\U0001f600"):
        assert got.prefix_id_range(prefix) == want.prefix_id_range(prefix)
    for pat, full in ((r"user_00.*", True), (r"user_.*9$", False), (r"user_0\.1.*", True), ("z", False), (".*", True)):
        np.testing.assert_array_equal(got.matching_ids(pat, full), want.matching_ids(pat, full))


def test_map_index():
    docs = np.asarray(
        [json.dumps({"color": ["red", "green", "blue"][i % 3], "size": i % 4}) for i in range(400)]
        + ["not json", "", '{"color": null}', '["list"]'],
        dtype=object,
    )
    got, want = P.MapIndex.build(docs), J.MapIndex.build(docs)
    assert_same(got, want, "map")
    for key in ("color", "size", "absent"):
        assert got.value_column(key).tolist() == want.value_column(key).tolist()


def test_index_spi_registrations():
    assert index_spi.registered_index_types() == jindex_spi.registered_index_types()
    for name in index_spi.registered_index_types():
        assert index_spi.get_index_type(name).target_key == jindex_spi.get_index_type(name).target_key


def test_custom_index_plugin_survives_write_and_load(tmp_path):
    """A plugin index type registered in both packages builds, persists its
    declaration and rebuilds on load, across the packages."""
    from pinot_tpu.common import DataType as JDT
    from pinot_tpu.common import Schema as JSchema
    from pinot_tpu.common.config import TableConfig as JTableConfig
    from pinot_tpu.segment import SegmentBuilder as JBuilder
    from pinot_tpu_torch.common import DataType, Schema, TableConfig
    from pinot_tpu_torch.segment import SegmentBuilder

    def count_build(seg, col, _cfg):
        return int(len(seg.columns[col].forward))

    index_spi.register_index_type(index_spi.IndexTypeSpec("count_test", count_build))
    jindex_spi.register_index_type(jindex_spi.IndexTypeSpec("count_test", count_build))
    data = {"v": np.arange(10, dtype=np.int64)}
    port = SegmentBuilder(Schema.build("t", metrics=[("v", DataType.LONG)]), TableConfig("t", extra={"customIndexes": {"count_test": ["v"]}})).build(data, "s0")
    ref = JBuilder(JSchema.build("t", metrics=[("v", JDT.LONG)]), JTableConfig("t", extra={"customIndexes": {"count_test": ["v"]}})).build(data, "s0")
    assert port.extras["count_test"] == ref.extras["count_test"] == {"v": 10}
    assert port.extras["__custom_indexes__"] == ref.extras["__custom_indexes__"]
    assert load_segment(jwrite(ref, tmp_path / "r")).extras["count_test"] == {"v": 10}
    assert jload(write_segment(port, tmp_path / "p")).extras["count_test"] == {"v": 10}


# -- queries over the indexes -------------------------------------------------------


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """Two segments of the rich table (the second far from the first's
    lat / lng, with another city set for the bloom filters), as pairs of
    (reference engine, port engine) by mode: "built", each package over the
    segments it built; "loaded", each over the segments it loaded from the
    other's files; "host", the port over the reference's files and the
    reference over its own, for the forced host executor. Each engine owns
    its segments, so both sides of a pair see the same memo state (an FST
    counts its probe entries only on a cache miss)."""
    d = tmp_path_factory.mktemp("idx")
    a = rich_data(seed=7, n=2000)
    b = rich_data(seed=9, n=1500, lat0=-34.0, lng0=150.5)
    b["city"] = np.array(["sydney", "perth", "sf"], dtype=object)[np.arange(1500) % 3]
    refs, ports = zip(*(build_pair(x, f"s{i}") for i, x in enumerate((a, b))))
    ref_files = [jwrite(s, d / "ref") for s in refs]
    port_files = [write_segment(s, d / "port") for s in ports]
    return {
        "built": (JEngine(list(refs)), QueryEngine(list(ports), device="cpu")),
        "loaded": (JEngine([jload(f) for f in port_files]), QueryEngine([load_segment(f) for f in ref_files], device="cpu")),
        "host": (JEngine([jload(f) for f in ref_files]), QueryEngine([load_segment(f) for f in ref_files], device="cpu")),
    }


def _vec_literal(v):
    return "ARRAY[" + ",".join(f"{x:.6f}" for x in v) + "]"


_Q = rich_data(seed=7, n=2000)["emb"][7]

QUERIES = [
    "SELECT COUNT(*) FROM t WHERE TEXT_MATCH(descr, 'espresso')",
    "SELECT city, COUNT(*) FROM t WHERE TEXT_MATCH(descr, 'latte AND tea') AND clicks > 5000 GROUP BY city ORDER BY city",
    "SELECT COUNT(*), SUM(clicks) FROM t WHERE JSON_MATCH(attrs, '\"$.color\"=''red''')",
    "SELECT COUNT(*) FROM t WHERE JSON_MATCH(attrs, '\"$.size\"=''3''') OR city = 'tokyo'",
    "SELECT COUNT(*) FROM t WHERE ST_WITHIN_DISTANCE(lat, lng, 37.5, -122.0, 20000)",
    "SELECT COUNT(*) FROM t WHERE ST_WITHIN_DISTANCE(lat, lng, 60.0, 10.0, 50000)",
    f"SELECT city, clicks FROM t WHERE VECTOR_SIMILARITY(emb, {_vec_literal(_Q)}, 5) ORDER BY clicks LIMIT 50",
    "SELECT COUNT(*) FROM t WHERE city LIKE 's%'",  # the star tree answers it
    "SELECT COUNT(*), MAX(code) FROM t WHERE city LIKE 's%'",
    "SELECT city, MIN(clicks) FROM t WHERE REGEXP_LIKE(city, 'o') GROUP BY city ORDER BY city",
    "SELECT COUNT(*) FROM t WHERE MAP_VALUE(attrs, 'color') = 'red'",
    "SELECT COUNT(*) FROM t WHERE city = 'paris'",
    "SELECT COUNT(*), SUM(clicks) FROM t WHERE city = 'perth'",
    "SELECT SUM(clicks) FROM t WHERE city IN ('sf', 'nyc')",
    "SELECT COUNT(*) FROM t WHERE code BETWEEN 10 AND 99",
    "SELECT code, COUNT(*) FROM t WHERE code = 42 GROUP BY code",
    "SELECT COUNT(*) FROM t WHERE clicks > 9000",
    "SELECT COUNT(*) FROM t WHERE revenue IS NULL",
    "SELECT city, SUM(clicks) FROM t GROUP BY city ORDER BY city",
    "SELECT tags, COUNT(*) FROM t GROUP BY tags ORDER BY tags",
    "SELECT COUNT(*), AVG(clicks) FROM t WHERE TEXT_MATCH(descr, 'bagel') AND code < 250",
]


def assert_same_result(got, want, sql, approx=()):
    assert got.columns == want.columns, sql
    assert len(got.rows) == len(want.rows), (sql, got.rows, want.rows)
    for g, w in zip(got.rows, want.rows):
        for c, (x, y) in enumerate(zip(g, w)):
            assert type(x) is type(y), (sql, g, w)
            assert math.isclose(x, y, rel_tol=AVG_RTOL) if c in approx else x == y, (sql, g, w)
    for f in STATS:
        assert getattr(got, f) == getattr(want, f), (sql, f, getattr(got, f), getattr(want, f))


@pytest.mark.parametrize("mode", ["built", "loaded"])
@pytest.mark.parametrize("sql", QUERIES)
def test_index_queries_match_reference(tables, sql, mode):
    ref, port = tables[mode]
    approx = (1,) if "AVG" in sql else ()
    assert_same_result(port.execute(sql), ref.execute(sql), sql, approx)


@pytest.mark.parametrize("sql", QUERIES)
def test_index_queries_on_the_host_executor(tables, sql, monkeypatch):
    """Both engines with every segment forced to the host executor (its
    planner raising DeviceFallback, as tests/test_query_fuzz.py forces it)."""
    ref, port = tables["host"]
    from pinot_tpu.query import engine as jengine
    from pinot_tpu_torch.query import engine as engine_mod

    def fail(*a, **k):
        raise plan_mod.DeviceFallback("forced host")

    def jfail(*a, **k):
        raise jplan.DeviceFallback("forced host")

    monkeypatch.setattr(engine_mod, "plan_segment", fail)
    monkeypatch.setattr(jengine, "plan_segment", jfail)
    approx = (1,) if "AVG" in sql else ()
    assert_same_result(port.execute(sql), ref.execute(sql), sql, approx)


def test_pruned_counts_by_index(tables):
    """The bloom filter prunes the segment without 'paris' (and the one
    without 'perth'); the geo index prunes the segment far from the probe:
    both packages count the same."""
    for sql, field in (
        ("SELECT COUNT(*) FROM t WHERE city = 'paris'", "num_segments_pruned_by_bloom"),
        ("SELECT COUNT(*) FROM t WHERE city = 'perth'", "num_segments_pruned_by_bloom"),
        ("SELECT COUNT(*) FROM t WHERE ST_WITHIN_DISTANCE(lat, lng, 37.5, -122.0, 20000)", "num_segments_pruned_by_geo"),
    ):
        for ref, port in (tables["built"], tables["loaded"]):
            want = ref.execute(sql)
            assert getattr(want, field) >= 1, (sql, field)
            assert getattr(port.execute(sql), field) == getattr(want, field), (sql, field)


def test_scan_classes_of_index_predicates(tables):
    """Every index path appears in the port's scan profile as in the
    reference's."""
    ref, port = tables["built"]
    seen = set()
    for sql in QUERIES:
        got = port.execute(sql).scan_profile["predicates"]
        assert got == ref.execute(sql).scan_profile["predicates"], sql
        seen |= {k.rsplit(":", 1)[1] for k in got}
    assert {"INVERTED_INDEX", "RANGE_INDEX", "FST_INDEX", "TEXT_INDEX", "JSON_INDEX", "VECTOR_INDEX", "GEO_INDEX"} <= seen


def test_explain_names_the_index_paths(tables):
    ref, port = tables["built"]
    for sql in QUERIES[:8]:
        want = ref.execute("EXPLAIN PLAN FOR " + sql)
        got = port.execute("EXPLAIN PLAN FOR " + sql)
        assert got.rows == want.rows, sql


def test_predicate_masks_and_docmask_plan(tables):
    """The host probe gives the reference's masks, and the planner lowers an
    index predicate to a `docmask` operand of the segment's padded length."""
    ref, port = tables["built"]
    from pinot_tpu.query.sql import parse_sql as jparse
    from pinot_tpu_torch.query.sql import parse_sql

    for seg, jseg in zip(port.segments, ref.segments):
        for sql in QUERIES[:7]:
            f = parse_sql(sql).where
            jf = jparse(sql).where
            while not hasattr(f, "name") or f.__class__.__name__ != "PredicateFunction":
                f, jf = f.children[0], jf.children[0]
            if f.name == "st_within_distance":
                continue
            got = host_exec.predicate_function_mask(seg, f)
            np.testing.assert_array_equal(got, jhost_exec.predicate_function_mask(jseg, jf))
            spec = plan_mod.plan_segment(seg, port.make_context(sql)).spec
            assert "docmask" in repr(spec), sql
