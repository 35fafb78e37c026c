"""Multi-value columns in the port against the JAX package on the CPU.

Every query of tests/test_mv.py, and more of the same table (MV group keys
beside SV ones, FILTERed and null-handling MV aggregations, the host-only
*MV family, the array transforms), runs through the reference's QueryEngine
and the port's over the same rows: one segment built by each package's
builder, the reference's segment carried across with segment_from_numpy, the
rows split into 4 segments, and both engines forced to their host
executors. The rows, their Python types and numDocsScanned must be equal; a
selected MV cell, a numpy array in the reference's rows, is compared as the
list of its Python values, which is what the port returns.

The per-segment programs of the MV tags (`mv_any`, `mv_count`,
`mv_distinct_ids`, `mv_sum|min|max|avg`, `groups_mv`, `groups_mv2`) are held
against the reference's `build_fn` output for output, after both planners
emitted the same spec; the planners' DeviceFallback sites for MV shapes
must agree word for word.

Tolerance: equal, except an AVG, held at rtol 1e-12.
"""

import math

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import FieldSpec as JFS
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
from pinot_tpu.common.config import TableConfig as JTableConfig
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query import plan as jplan
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, FieldSpec, IndexingConfig, Schema, TableConfig
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import plan as plan_mod
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from pinot_tpu_torch.segment.segment import DOC_PAD
from test_mv import _mk_data
from test_torch_kernels import _run_jax, _run_port
from test_torch_segment import describe

AVG_RTOL = 1e-12


def _schema(DT, S, FS):
    schema = S.build("t", dimensions=[("year", DT.INT)], metrics=[])
    schema.add(FS("tags", DT.STRING, single_value=False))
    schema.add(FS("nums", DT.LONG, single_value=False))
    return schema


def _split(data, parts):
    n = len(next(iter(data.values())))
    edges = np.linspace(0, n, parts + 1).astype(int)
    return [{c: v[a:b] for c, v in data.items()} for a, b in zip(edges[:-1], edges[1:])]


def _engines(data, schema_fn=_schema, parts=4, raw=()):
    """(reference engines, port engines) by mode over `data`: "built" (each
    package's builder, one segment), "carried" (the reference's segment
    through segment_from_numpy), "split" (`parts` segments of the rows) and
    "host" (one segment, both engines forced to the host executor)."""
    jcfg = JTableConfig("t", indexing=JIndexingConfig(no_dictionary_columns=list(raw)))
    cfg = TableConfig("t", IndexingConfig(no_dictionary_columns=list(raw)))
    jb, pb = JBuilder(schema_fn(JDT, JSchema, JFS), jcfg), SegmentBuilder(schema_fn(DataType, Schema, FieldSpec), cfg)
    jseg = jb.build(data, "s0")
    jparts = [jb.build(d, f"p{i}") for i, d in enumerate(_split(data, parts))]
    ref = {"one": JEngine([jseg]), "split": JEngine(jparts)}
    port = {
        "built": QueryEngine([pb.build(data, "s0")], device="cpu"),
        "carried": QueryEngine([segment_from_numpy(describe(jseg))], device="cpu"),
        "split": QueryEngine([pb.build(d, f"p{i}") for i, d in enumerate(_split(data, parts))], device="cpu"),
        "host": QueryEngine([segment_from_numpy(describe(jseg))], device="cpu"),
    }
    return ref, port


@pytest.fixture(scope="module")
def mv():
    """tests/test_mv.py's fixture: 4000 docs, seed 3."""
    return _engines(_mk_data())


def _forced_host(monkeypatch):
    def no_device(*a, **k):
        raise jplan.DeviceFallback("forced host")

    def no_device_port(*a, **k):
        raise plan_mod.DeviceFallback("forced host")

    monkeypatch.setattr("pinot_tpu.query.engine.plan_segment", no_device)
    monkeypatch.setattr("pinot_tpu_torch.query.engine.plan_segment", no_device_port)


def _cell(x):
    """A reference cell as the port gives it: an MV cell (a numpy array) as
    the list of its Python values."""
    return x.tolist() if isinstance(x, np.ndarray) else x


def _assert_same(a, b, where, rtol=0.0):
    assert type(a) is type(b), (where, a, b)
    if isinstance(a, list):
        assert len(a) == len(b), (where, a, b)
        for x, y in zip(a, b):
            _assert_same(x, y, where, rtol)
    elif isinstance(a, float) and a == a:
        assert a == b or math.isclose(a, b, rel_tol=rtol), (where, a, b)
    else:
        assert a == b or (a != a and b != b), (where, a, b)


def _assert_result(got, want):
    """Equal rows, Python types and numDocsScanned; an AVG column (its name
    holds "avg") within AVG_RTOL."""
    assert got.columns == want.columns
    assert len(got.rows) == len(want.rows), (got.rows, want.rows)
    rtols = [AVG_RTOL if "avg" in c.lower() else 0.0 for c in want.columns]
    for r, (g, w) in enumerate(zip(got.rows, want.rows)):
        for c, (x, y, rtol) in enumerate(zip(g, w, rtols)):
            _assert_same(x, _cell(y), (r, c), rtol)
    assert got.num_docs_scanned == want.num_docs_scanned


def _check(ref, port, mode, sql, monkeypatch):
    """The port's answer in `mode` against the reference's."""
    if mode == "host":
        _forced_host(monkeypatch)
    want = (ref["split"] if mode == "split" else ref["one"]).execute(sql)
    got = port[mode].execute(sql)
    _assert_result(got, want)
    return got


MODES = ["built", "carried", "split", "host"]

#: every query of tests/test_mv.py
TEST_MV = [
    "SELECT COUNT(*) FROM t WHERE tags = 'tag3'",
    "SELECT COUNT(*) FROM t WHERE tags <> 'tag3'",
    "SELECT COUNT(*) FROM t WHERE tags IN ('tag1', 'tag7')",
    "SELECT COUNT(*) FROM t WHERE tags NOT IN ('tag1', 'tag7')",
    "SELECT COUNT(*) FROM t WHERE nums BETWEEN 90 AND 99",
    "SELECT COUNT(*) FROM t WHERE nums > 95",
    "SELECT COUNT(*) FROM t WHERE tags = 'tag0' AND year >= 2021",
    "SELECT COUNTMV(nums), SUMMV(nums) FROM t",
    "SELECT MINMV(nums), MAXMV(nums), AVGMV(nums) FROM t",
    "SELECT SUMMV(nums) FROM t WHERE year = 2020",
    "SELECT DISTINCTCOUNTMV(tags) FROM t",
    "SELECT year, COUNTMV(nums), SUMMV(nums) FROM t GROUP BY year ORDER BY year LIMIT 10",
    "SELECT COUNT(*) FROM t WHERE tags = 'tag5'",
    "SELECT COUNTMV(nums), SUMMV(nums), MINMV(nums), MAXMV(nums) FROM t WHERE nums < 50",
    "SELECT year, AVGMV(nums) FROM t GROUP BY year ORDER BY year LIMIT 10",
    "SELECT year, SUMMV(nums) FILTER (WHERE year >= 2020), COUNTMV(tags) FROM t GROUP BY year ORDER BY year LIMIT 10",
    "SELECT SUMMV(nums) FROM t",
    "SELECT tags, year FROM t LIMIT 5",
    "SELECT COUNT(*) FROM t WHERE nums >= 0",
    "SELECT SUM(CASE WHEN year > 2020 THEN 1 ELSE 0 END) FROM t WHERE nums = 2",
    "SELECT tags, COUNT(*), SUM(year) FROM t WHERE year >= 2020 GROUP BY tags ORDER BY tags LIMIT 50",
    "SELECT year, tags, COUNT(*) FROM t GROUP BY year, tags ORDER BY year, tags LIMIT 200",
    "SELECT tags, nums, COUNT(*) FROM t GROUP BY tags, nums ORDER BY COUNT(*) DESC, tags, nums LIMIT 5",
    "SELECT tags, nums, COUNT(*), SUM(year) FROM t WHERE year >= 2019 GROUP BY tags, nums ORDER BY tags, nums LIMIT 300",
    "SELECT DISTINCT tags FROM t ORDER BY tags LIMIT 50",
]

#: more shapes of the same table: MV keys beside SV keys, FILTERs gathered to
#: value space, several presence spaces, null handling, the host-routed ones
MORE = [
    "SELECT COUNT(*) FROM t WHERE nums > 95 AND nums < 3",
    "SELECT COUNT(*), SUM(year) FROM t WHERE tags NOT IN ('tag1', 'tag7') AND year >= 2021",
    "SELECT COUNT(*) FROM t WHERE NOT (tags = 'tag2' OR nums <= 10)",
    "SELECT COUNT(*) FROM t WHERE tags BETWEEN 'tag1' AND 'tag3' OR nums IN (5, 7, 11)",
    "SELECT tags, COUNT(*), SUM(year), MAX(year) FROM t WHERE year >= 2020 GROUP BY tags "
    "ORDER BY COUNT(*) DESC, tags LIMIT 20",
    "SELECT tags, COUNT(*) FILTER (WHERE year = 2020), SUM(year) FILTER (WHERE year > 2019), MIN(year) "
    "FROM t GROUP BY tags ORDER BY tags",
    "SELECT tags, DISTINCTCOUNT(year), AVG(year) FROM t WHERE nums < 60 GROUP BY tags ORDER BY tags",
    "SELECT nums, tags, year, COUNT(*) FROM t GROUP BY nums, tags, year ORDER BY COUNT(*) DESC, nums, tags, year LIMIT 10",
    "SELECT tags, nums, SUM(year) FILTER (WHERE year >= 2021), MAX(year) FROM t GROUP BY tags, nums "
    "ORDER BY tags, nums LIMIT 50",
    "SELECT DISTINCT tags, year FROM t WHERE year > 2020 ORDER BY tags, year LIMIT 30",
    "SELECT DISTINCTCOUNTMV(tags), DISTINCTCOUNTMV(nums), DISTINCTCOUNT(year), COUNTMV(tags) FROM t WHERE nums < 30",
    "SELECT year, COUNTMV(tags), MAXMV(nums) FILTER (WHERE tags = 'tag2'), MINMV(nums), SUMMV(nums) "
    "FROM t GROUP BY year ORDER BY year",
    "SELECT tags, COUNT(*) FROM t GROUP BY tags HAVING COUNT(*) > 1000 ORDER BY tags",
    "SELECT tags, nums, year FROM t WHERE tags = 'tag4' AND year = 2020 LIMIT 10",
    "SELECT year, DISTINCTCOUNTMV(tags) FROM t GROUP BY year ORDER BY year",
    "SELECT tags, SUMMV(nums) FROM t GROUP BY tags ORDER BY tags LIMIT 20",
    "SELECT tags, MINMV(nums), MAXMV(nums), AVGMV(nums), COUNTMV(nums), MINMAXRANGEMV(nums) FROM t "
    "GROUP BY tags ORDER BY tags",
    "SELECT tags, year, nums FROM t ORDER BY year DESC LIMIT 7",
    # a WHERE that leaves no doc (and that no segment pruning decides)
    "SET enableNullHandling = true; SELECT SUMMV(nums), MINMV(nums), AVGMV(nums), COUNTMV(nums), SUM(year) FROM t "
    "WHERE year + 0 = 1900",
    # the same WHERE in the form the pruner decides (year's min/max excludes
    # 1900): every segment pruned, SUMMV and SUM NULL as in the reference
    "SET enableNullHandling = true; SELECT SUMMV(nums), MINMV(nums), AVGMV(nums), COUNTMV(nums), SUM(year) FROM t "
    "WHERE year = 1900",
    "SET enableNullHandling = true; SELECT year, SUMMV(nums) FILTER (WHERE year = 2020), MAXMV(nums) FROM t "
    "GROUP BY year ORDER BY year",
]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", TEST_MV + MORE)
def test_mv_queries_match_reference(mv, sql, mode, monkeypatch):
    ref, port = mv
    _check(ref, port, mode, sql, monkeypatch)


@pytest.mark.parametrize(
    "sql, executor",
    [
        ("SELECT COUNT(*) FROM t WHERE tags = 'tag3'", "device"),
        ("SELECT tags, nums, COUNT(*) FROM t GROUP BY tags, nums ORDER BY COUNT(*) DESC, tags, nums LIMIT 5", "device"),
        ("SELECT DISTINCTCOUNTMV(tags) FROM t", "device"),
        ("SELECT tags, year FROM t LIMIT 5", "host"),
        ("SELECT tags, SUMMV(nums) FROM t GROUP BY tags ORDER BY tags LIMIT 20", "host"),
    ],
)
def test_mv_queries_take_the_reference_executor(mv, sql, executor):
    _, port = mv
    eng = port["built"]
    eng.segment_modes.clear()
    eng.execute(sql)
    assert dict(eng.segment_modes) == {executor: 1}


def test_selected_mv_cells_are_python_lists(mv):
    _, port = mv
    data = _mk_data()
    rows = port["built"].execute("SELECT tags, nums, year FROM t LIMIT 5").rows
    for i, (tags, nums, year) in enumerate(rows):
        assert tags == list(data["tags"][i]) and all(type(t) is str for t in tags)
        assert nums == list(data["nums"][i]) and all(type(x) is int for x in nums)
        assert type(year) is int


def test_range_merge_skips_mv_columns(mv):
    """`nums > 95 AND nums < 3` holds for a doc through two of its values:
    the optimizer must not merge it into an empty range."""
    ref, port = mv
    sql = "SELECT COUNT(*) FROM t WHERE nums > 95 AND nums < 3"
    eng = port["built"]
    assert eng.mv_columns() == {"tags", "nums"}
    assert type(eng.make_context(sql).filter).__name__ == "And"
    got = eng.execute(sql).rows[0][0]
    data = _mk_data()
    want = sum(1 for v in data["nums"] if any(x > 95 for x in v) and any(x < 3 for x in v))
    assert got == want == ref["one"].execute(sql).rows[0][0] > 0
    # a segment appended later joins the set
    eng2 = QueryEngine([], device="cpu")
    eng2.segments.append(eng.segments[0])
    assert eng2.mv_columns() == {"tags", "nums"}


# -- the per-segment programs against the reference's ------------------------

PROGRAMS = [
    "SELECT COUNT(*) FROM t WHERE tags = 'tag3'",  # mv_any over in range ids
    "SELECT COUNT(*) FROM t WHERE tags NOT IN ('tag1', 'tag7') AND nums BETWEEN 10 AND 20",  # not(mv_any)
    "SELECT COUNTMV(nums), SUMMV(nums), MINMV(nums), MAXMV(nums), AVGMV(nums) FROM t WHERE year = 2020",
    "SELECT DISTINCTCOUNTMV(tags), DISTINCTCOUNTMV(nums), DISTINCTCOUNT(year) FROM t WHERE nums < 30",
    "SELECT year, COUNTMV(nums), SUMMV(nums), MINMV(nums), MAXMV(nums), AVGMV(nums) FROM t GROUP BY year",
    "SELECT year, SUMMV(nums) FILTER (WHERE year >= 2020), COUNTMV(tags) FROM t GROUP BY year",
    "SELECT tags, COUNT(*), SUM(year), MAX(year), DISTINCTCOUNT(year) FROM t WHERE year >= 2020 GROUP BY tags",
    "SELECT tags, COUNT(*) FILTER (WHERE year = 2020), MIN(year) FROM t GROUP BY tags",
    "SELECT tags, nums, COUNT(*), SUM(year) FROM t GROUP BY tags, nums",
    "SELECT nums, year, tags, COUNT(*), MAX(year) FILTER (WHERE year > 2019) FROM t GROUP BY nums, year, tags",
    "SELECT DISTINCT tags FROM t",
]


@pytest.mark.parametrize("sql", PROGRAMS)
def test_programs_match_reference(mv, sql):
    """Both planners emit one spec with equal operands; the port's program
    gives the reference's outputs, leaf for leaf."""
    ref, port = mv
    jseg, seg = ref["one"].segments[0], port["carried"].segments[0]
    jplan_ = jplan.plan_segment(jseg, ref["one"].make_context(sql))
    plan = plan_mod.plan_segment(seg, port["carried"].make_context(sql))
    assert plan.spec == jplan_.spec and plan.columns == jplan_.columns
    assert len(plan.operands) == len(jplan_.operands)
    for a, b in zip(plan.operands, jplan_.operands):
        assert np.asarray(a).dtype == np.asarray(b).dtype and np.array_equal(a, b)
    got = _run_port(seg, plan.spec, plan.columns, plan.operands)
    want = _run_jax(jseg, jplan_.spec, jplan_.columns, jplan_.operands)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        assert np.array_equal(g, w, equal_nan=True)


#: (sql, how the context is changed before planning) of the planners'
#: DeviceFallback and PlanError sites for MV shapes
PLAN_SITES = [
    ("SELECT tags, year FROM t LIMIT 5", None),  # MV selection
    ("SELECT year FROM t ORDER BY tags LIMIT 5", None),  # MV ORDER BY
    ("SELECT year, tags FROM t ORDER BY tags, year LIMIT 5", None),  # MV multi-key ORDER BY
    ("SELECT SUM(nums) FROM t", None),  # MV in value context
    ("SELECT year, DISTINCTCOUNTMV(tags) FROM t GROUP BY year", None),
    ("SELECT tags, SUMMV(nums) FROM t GROUP BY tags", None),  # *MV under an MV key
    ("SELECT tags, nums, COUNTMV(nums) FILTER (WHERE year = 2020) FROM t GROUP BY tags, nums", None),
    ("SELECT tags, nums, year, COUNT(*) FROM t GROUP BY tags, nums, year", "three"),  # 3 MV keys
    ("SELECT tags, COUNT(*) FROM t GROUP BY tags", "repeat"),  # a repeated MV key
    ("SELECT SUMMV(tags) FROM t", None),  # a string MV column
    ("SELECT SUMMV(year) FROM t", None),  # an SV column
    ("SELECT COUNTMV(year + 1) FROM t", None),
    ("SELECT year, COUNTMV(nums), MINMV(nums) FROM t GROUP BY year", None),
    ("SELECT COUNT(*) FROM t WHERE nums IN (1, 2) AND tags <> 'tag9'", None),
]


@pytest.mark.parametrize("sql, change", PLAN_SITES)
def test_plan_sites_match_reference(mv, sql, change):
    ref, port = mv
    jctx, ctx = ref["one"].make_context(sql), port["carried"].make_context(sql)
    for c in (jctx, ctx):
        if change == "three":
            c.group_by = [c.group_by[0], c.group_by[1], c.group_by[0]]
        elif change == "repeat":
            c.group_by = [c.group_by[0], c.group_by[0]]
    jseg, seg = ref["one"].segments[0], port["carried"].segments[0]
    try:
        want = jplan.plan_segment(jseg, jctx).spec
    except (jplan.DeviceFallback, jplan.PlanError) as e:
        exc = plan_mod.DeviceFallback if isinstance(e, jplan.DeviceFallback) else plan_mod.PlanError
        with pytest.raises(exc) as got:
            plan_mod.plan_segment(seg, ctx)
        assert str(got.value) == str(e)
        return
    assert plan_mod.plan_segment(seg, ctx).spec == want


@pytest.mark.parametrize("knob", ["pairs", "groups"])
def test_budget_fallbacks_match_reference(mv, knob, monkeypatch):
    """Past the pair budget of groups_mv2, and past MAX_DENSE_GROUPS (a
    high-cardinality MV key), both planners fall back with the same words,
    and the host executors give the same rows."""
    ref, port = mv
    if knob == "pairs":
        monkeypatch.setattr(jplan._Lowering, "MAX_MV2_PAIRS", 1 << 12)
        monkeypatch.setattr(plan_mod._Lowering, "MAX_MV2_PAIRS", 1 << 12)
        sql = "SELECT tags, nums, COUNT(*), SUM(year) FROM t GROUP BY tags, nums ORDER BY tags, nums LIMIT 40"
        words = "two-MV-key pair space"
    else:
        monkeypatch.setattr(jplan, "MAX_DENSE_GROUPS", 8)
        monkeypatch.setattr(plan_mod, "MAX_DENSE_GROUPS", 8)
        sql = "SELECT tags, COUNT(*), MAX(year) FROM t GROUP BY tags ORDER BY tags"
        words = "high-cardinality MV GROUP BY"
    jseg, seg = ref["one"].segments[0], port["carried"].segments[0]
    with pytest.raises(jplan.DeviceFallback, match=words) as want:
        jplan.plan_segment(jseg, ref["one"].make_context(sql))
    with pytest.raises(plan_mod.DeviceFallback) as got:
        plan_mod.plan_segment(seg, port["carried"].make_context(sql))
    assert str(got.value) == str(want.value)
    eng = port["carried"]
    eng.segment_modes.clear()
    _assert_result(eng.execute(sql), ref["one"].execute(sql))
    assert dict(eng.segment_modes) == {"host": 1}


# -- the trouble cases ---------------------------------------------------------


def _edge_schema(DT, S, FS):
    schema = S.build("t", dimensions=[("year", DT.INT)], metrics=[])
    schema.add(FS("tags", DT.STRING, single_value=False))
    schema.add(FS("big", DT.LONG, single_value=False))
    schema.add(FS("none", DT.INT, single_value=False))
    return schema


def _edge_data(n, seed, lens=None):
    """`tags`, a raw LONG `big` past int32 (some values), and `none`, empty
    in every doc. With `lens` every MV list has that length."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 4, n) if lens is None else np.full(n, lens)
    words = np.array([f"w{i:02d}" for i in range(20)], dtype=object)
    data = {"year": rng.integers(2018, 2024, n).astype(np.int32)}
    for c in ("tags", "big", "none"):
        data[c] = np.empty(n, dtype=object)
    for i in range(n):
        data["tags"][i] = list(words[rng.integers(0, 20, k[i])])
        data["big"][i] = rng.integers(-(1 << 40), 1 << 40, k[-1 - i]).tolist()
        data["none"][i] = []
    # the last doc (the last real doc of a segment of DOC_PAD docs, where the
    # padding docids clip to) matches the queries below
    data["tags"][-1] = ["w07", "w03"]
    data["year"][-1] = 2023
    return data


EDGE = [
    "SELECT COUNT(*) FROM t WHERE tags = 'w07'",
    "SELECT COUNT(*) FROM t WHERE tags <> 'w07'",
    "SELECT COUNT(*) FROM t WHERE none = 3",
    "SELECT COUNT(*) FROM t WHERE none <> 3",
    "SELECT COUNT(*) FROM t WHERE big > 0 AND big < -1000",
    "SELECT COUNTMV(none), SUMMV(none), MINMV(none), MAXMV(none), DISTINCTCOUNTMV(none) FROM t",
    "SELECT COUNTMV(big), SUMMV(big), MINMV(big), MAXMV(big), AVGMV(big) FROM t WHERE tags = 'w07'",
    "SELECT year, COUNTMV(big), SUMMV(big), MINMV(big), MAXMV(big), AVGMV(big) FROM t GROUP BY year ORDER BY year",
    "SELECT tags, COUNT(*), MAX(year), SUM(year) FROM t WHERE year = 2023 GROUP BY tags ORDER BY tags",
    "SELECT none, COUNT(*) FROM t GROUP BY none",
    "SELECT tags, none, COUNT(*) FROM t GROUP BY tags, none",
    "SELECT tags, year, COUNTMV(none) FROM t GROUP BY tags, year ORDER BY tags, year LIMIT 20",
    "SELECT DISTINCT none FROM t",
]


@pytest.fixture(scope="module", params=[DOC_PAD, 1000, "full"])
def edge(request):
    """A segment of exactly DOC_PAD docs (its padding docids clip onto its
    last real doc), one of 1000, and one of DOC_PAD docs whose MV columns
    have 2 values a doc (no value padding)."""
    n, lens = (DOC_PAD, 2) if request.param == "full" else (request.param, None)
    return _engines(_edge_data(n, 17, lens), _edge_schema, parts=3, raw=("big",))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("sql", EDGE)
def test_edge_cases_match_reference(edge, sql, mode, monkeypatch):
    ref, port = edge
    _check(ref, port, mode, sql, monkeypatch)


def test_long_mv_past_int32_stays_int64(edge):
    _, port = edge
    seg = port["built"].segments[0]
    assert seg.columns["big"].dictionary is None
    assert str(seg.to_device_cached("cpu").arrays["big"].dtype) == "torch.int64"


# -- the host-only *MV family, the array functions ------------------------------

EXT_MV = [
    "PERCENTILEMV(nums, 50)",
    "PERCENTILEESTMV(nums, 75)",
    "PERCENTILETDIGESTMV(nums, 90)",
    "PERCENTILEKLLMV(nums, 25)",
    "PERCENTILERAWESTMV(nums, 50)",
    "PERCENTILERAWTDIGESTMV(nums, 50)",
    "PERCENTILERAWKLLMV(nums, 50)",
    "DISTINCTSUMMV(nums)",
    "DISTINCTAVGMV(nums)",
    "DISTINCTCOUNTBITMAPMV(tags)",
    "DISTINCTCOUNTHLLMV(tags)",
    "DISTINCTCOUNTHLLPLUSMV(nums)",
    "DISTINCTCOUNTRAWHLLMV(tags)",
    "DISTINCTCOUNTRAWHLLPLUSMV(nums)",
    "MINMAXRANGEMV(nums)",
    "SUMARRAYLONG(nums)",
    "SUMARRAYDOUBLE(nums)",
]


@pytest.mark.parametrize("form", ["scalar", "grouped", "filtered", "mv_key"])
@pytest.mark.parametrize("agg", EXT_MV)
def test_ext_mv_aggregations_match_reference(mv, agg, form, monkeypatch):
    sql = {
        "scalar": f"SELECT {agg} FROM t WHERE year >= 2019",
        "grouped": f"SELECT year, {agg} FROM t GROUP BY year ORDER BY year",
        "filtered": f"SELECT year, {agg} FILTER (WHERE year <> 2020), COUNT(*) FROM t GROUP BY year ORDER BY year",
        "mv_key": f"SELECT tags, {agg} FROM t GROUP BY tags ORDER BY tags",
    }[form]
    ref, port = mv
    _check(ref, port, "split", sql, monkeypatch)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT ARRAYLENGTH(nums), CARDINALITY(tags), ARRAYSUM(nums), ARRAYMIN(nums), ARRAYMAX(nums), "
        "ARRAYAVERAGE(nums) FROM t LIMIT 12",
        "SELECT COUNT(*), SUM(ARRAYLENGTH(tags)) FROM t WHERE ARRAYLENGTH(nums) > 2",
        "SELECT year, MAX(ARRAYSUM(nums)) FROM t GROUP BY year ORDER BY year",
    ],
)
def test_array_functions_match_reference(mv, sql, monkeypatch):
    ref, port = mv
    for mode in ("built", "split"):
        _check(ref, port, mode, sql, monkeypatch)
