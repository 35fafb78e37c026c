"""Random queries through the port and the JAX package, drawn from
tests/test_query_fuzz.py's generator: aggregations (DISTINCTCOUNTHLL among
them), group-bys with HAVING and ORDER BY, SELECTION, SELECTION ORDER BY and
DISTINCT, with random filters, over 4 segments of a mixed-type table, one of
them a single doc. The port runs on device="cpu" over its own segments built
from the same arrays. Rows must be equal, with the reference's Python types
and row order, and so must numDocsScanned; only float values may differ,
within rtol 1e-12 (DOUBLE sums add in another order).

Some shapes the generator draws have no device lowering (GROUP BY on a raw
column, DISTINCTCOUNT of a raw column, a float key among several ORDER BY
keys, ...): both packages answer those segments with their host executors.
A query the port still raises NotImplementedError on is counted and
skipped, not failed, only if it is a shape listed in UNPORTED and the skips
stay within MAX_SKIPPED of a run; both are empty now, so every query runs.

The generator draws FILTER (WHERE), CASE, IN over a raw column, a column
compared with a column and DEVICE_FUNCS transforms, and a second test runs
it under `SET enableNullHandling = true` over a table whose m1, m2 and d1
are null on a seeded 15% of the docs (null vectors kept). A third test draws
over a table with two multi-value columns beside single-value ones (a STRING
`tags` and an INT `vals`, 0-3 values a doc): MV any-match predicates and
exclusions, the *MV aggregations, GROUP BY and DISTINCT over one or two MV
keys, and selections of MV cells (a numpy array in the reference's rows, a
list in the port's, compared value for value). A fourth draws day ranges
over a time-partitioned table (8 segments, rows sorted by day), with and
without null handling: there the pruning funnel and the scan-path entry
counts must be equal too, and about half of the segments prune."""

import math

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import FieldSpec as JFS
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
from pinot_tpu.common.config import TableConfig as JTableConfig
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, FieldSpec, IndexingConfig, Schema, TableConfig
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.segment import SegmentBuilder

STR_VALS = [f"s{i:02d}" for i in range(15)]
SIZES = [2000, 1500, 1, 2500]

#: what the port raises on, by the words of its message (nothing now)
UNPORTED: tuple[str, ...] = ()
#: largest share of a run's queries the port may skip
MAX_SKIPPED = 0.0


def _data(seed, n):
    rng = np.random.default_rng(seed)
    return {
        "d1": np.asarray(STR_VALS, dtype=object)[rng.integers(0, len(STR_VALS), n)],
        "d2": np.asarray(["x", "y", "z"], dtype=object)[rng.integers(0, 3, n)],
        "k": rng.integers(0, 50, n).astype(np.int32),
        "m1": rng.integers(-100, 1000, n).astype(np.int64),
        "m2": np.round(rng.normal(0, 50, n), 4),
    }


def _schema(DT, S):
    return S.build(
        "f",
        dimensions=[("d1", DT.STRING), ("d2", DT.STRING), ("k", DT.INT)],
        metrics=[("m1", DT.LONG), ("m2", DT.DOUBLE)],
    )


def _with_nulls(seed, d):
    rng = np.random.default_rng(seed)
    out = dict(d)
    for c in ("m1", "m2", "d1"):
        v = d[c].astype(object)
        v[rng.random(len(v)) < 0.15] = None
        out[c] = v
    return out


@pytest.fixture(scope="module")
def engines():
    datas = [_data(97 + i, n) for i, n in enumerate(SIZES)]
    ref = JEngine([JBuilder(_schema(JDT, JSchema)).build(d, f"f{i}") for i, d in enumerate(datas)])
    port = QueryEngine(
        [SegmentBuilder(_schema(DataType, Schema)).build(d, f"f{i}") for i, d in enumerate(datas)], device="cpu"
    )
    return ref, port


@pytest.fixture(scope="module")
def null_engines():
    datas = [_with_nulls(300 + i, _data(97 + i, n)) for i, n in enumerate(SIZES)]
    jcfg = JTableConfig("f", indexing=JIndexingConfig(null_handling=True))
    cfg = TableConfig("f", IndexingConfig(null_handling=True))
    ref = JEngine([JBuilder(_schema(JDT, JSchema), jcfg).build(d, f"f{i}") for i, d in enumerate(datas)])
    port = QueryEngine(
        [SegmentBuilder(_schema(DataType, Schema), cfg).build(d, f"f{i}") for i, d in enumerate(datas)], device="cpu"
    )
    return ref, port


def _mv_data(seed, n):
    rng = np.random.default_rng(seed)
    d = _data(seed, n)
    out = {"d1": d["d1"], "k": d["k"], "m1": d["m1"]}
    for c, draw in (("tags", lambda m: list(np.asarray(STR_VALS, dtype=object)[rng.integers(0, 8, m)])),
                    ("vals", lambda m: rng.integers(0, 40, m).tolist())):
        out[c] = np.empty(n, dtype=object)
        for i, m in enumerate(rng.integers(0, 4, n)):
            out[c][i] = draw(int(m))
    return out


def _mv_schema(DT, S, FS):
    schema = S.build("f", dimensions=[("d1", DT.STRING), ("k", DT.INT)], metrics=[("m1", DT.LONG)])
    schema.add(FS("tags", DT.STRING, single_value=False))
    schema.add(FS("vals", DT.INT, single_value=False))
    return schema


TP_SEGMENTS = 8


@pytest.fixture(scope="module")
def tp_engines():
    """The mixed-type table with a `day` column (0-99), its rows sorted by
    day and cut into TP_SEGMENTS segments: a time-partitioned table, where
    about half of the segments fall out of a day range."""
    rng = np.random.default_rng(700)
    data = _data(701, 8000)
    data["day"] = np.sort(rng.integers(0, 100, 8000)).astype(np.int32)
    cut = np.linspace(0, 8000, TP_SEGMENTS + 1).astype(int)
    datas = [{c: v[a:b] for c, v in data.items()} for a, b in zip(cut[:-1], cut[1:])]

    def schema(DT, S):
        return S.build(
            "f",
            dimensions=[("d1", DT.STRING), ("d2", DT.STRING), ("k", DT.INT), ("day", DT.INT)],
            metrics=[("m1", DT.LONG), ("m2", DT.DOUBLE)],
        )

    ref = JEngine([JBuilder(schema(JDT, JSchema)).build(d, f"f{i}") for i, d in enumerate(datas)])
    port = QueryEngine([SegmentBuilder(schema(DataType, Schema)).build(d, f"f{i}") for i, d in enumerate(datas)], device="cpu")
    return ref, port


def _day_filter(rng) -> str:
    """A range over the sorted day column, ANDed with a random filter half
    of the time: the min/max pruner drops the segments it excludes."""
    d = int(rng.integers(-5, 105))
    p = [
        f"day = {d}",
        f"day < {d}",
        f"day >= {d}",
        f"day BETWEEN {d} AND {d + int(rng.integers(0, 25))}",
        f"day IN ({d}, {d + 37})",
        f"{d} > day",
        f"day > {d} OR day < {d - 60}",
    ][rng.integers(0, 7)]
    return f"{p} AND ({_filter(rng)})" if rng.random() < 0.5 else p


@pytest.fixture(scope="module")
def mv_engines():
    datas = [_mv_data(500 + i, n) for i, n in enumerate(SIZES)]
    ref = JEngine([JBuilder(_mv_schema(JDT, JSchema, JFS)).build(d, f"f{i}") for i, d in enumerate(datas)])
    port = QueryEngine(
        [SegmentBuilder(_mv_schema(DataType, Schema, FieldSpec)).build(d, f"f{i}") for i, d in enumerate(datas)],
        device="cpu",
    )
    return ref, port


# -- generator ---------------------------------------------------------------


def _predicate(rng) -> str:
    kind = rng.integers(0, 10)
    if kind == 6:  # IN over a raw column: the sorted probe
        vs = sorted({int(v) for v in rng.integers(-100, 1000, int(rng.integers(1, 6)))})
        return f"m1 {'NOT ' if rng.random() < 0.3 else ''}IN ({', '.join(map(str, vs))})"
    if kind == 7:  # a column compared with a column
        return ["m1 > k * 10", "m2 < m1", "k >= m2 + 20", "m1 - m2 <> k"][rng.integers(0, 4)]
    if kind == 8:  # a predicate over a transform
        return [f"ABS(m2) < {int(rng.integers(1, 80))}", f"MOD(m1, 7) = {int(rng.integers(0, 7))}",
                f"ROUND(m2) >= {int(rng.integers(-40, 40))}", "SQRT(ABS(m1)) > 12"][rng.integers(0, 4)]
    if kind == 9:
        return f"CASE WHEN k < 25 THEN m1 ELSE m2 END > {int(rng.integers(-50, 500))}"
    if kind == 0:
        return f"d1 = '{STR_VALS[rng.integers(0, len(STR_VALS))]}'"
    if kind == 1:
        return f"k {['<', '>=', '<>'][rng.integers(0, 3)]} {int(rng.integers(0, 50))}"
    if kind == 2:
        lo = int(rng.integers(-100, 500))
        return f"m1 BETWEEN {lo} AND {lo + int(rng.integers(1, 400))}"
    if kind == 3:
        vs = sorted(set(STR_VALS[i] for i in rng.integers(0, len(STR_VALS), 3)))
        return f"d1 IN ({', '.join(repr(v) for v in vs)})"
    if kind == 4:
        return f"m2 > {float(np.round(rng.normal(0, 30), 2))}"
    return f"d2 <> '{['x', 'y', 'z'][rng.integers(0, 3)]}'"


def _filter(rng) -> str:
    n = int(rng.integers(1, 4))
    preds = [_predicate(rng) for _ in range(n)]
    if n == 1:
        return preds[0]
    return f" {'AND' if rng.random() < 0.6 else 'OR'} ".join(f"({p})" for p in preds)


AGGS = [
    "COUNT(*)",
    "SUM(m1)",
    "MIN(m1)",
    "MAX(m2)",
    "AVG(m2)",
    "MINMAXRANGE(k)",
    "DISTINCTCOUNT(k)",
    "DISTINCTCOUNT(d1)",
    "DISTINCTCOUNTHLL(d1)",
    "DISTINCTCOUNTHLL(m1)",
    "DISTINCTCOUNTHLL(m2)",
    # FILTER (WHERE), CASE and transforms
    "SUM(m1) FILTER (WHERE k < 20)",
    "COUNT(*) FILTER (WHERE d2 = 'x')",
    "MAX(m2) FILTER (WHERE m1 > 300)",
    "AVG(m1) FILTER (WHERE m2 > 0)",
    "DISTINCTCOUNT(d1) FILTER (WHERE k > 10)",
    "SUM(CASE WHEN k < 10 THEN m1 WHEN k < 30 THEN m2 ELSE 1 END)",
    "MIN(CASE WHEN d2 = 'y' THEN m2 END)",
    "SUM(ABS(m2))",
    "MAX(SQRT(ABS(m1)))",
    "MIN(ROUND(m2 / 3))",
    "SUM(MOD(m1, 11))",
    "DISTINCTCOUNT(m1)",  # a raw column: the reference's host executor
]
KEYS = [["d1"], ["d2"], ["k"], ["d1", "d2"], ["d2", "k"], ["k", "d1", "d2"]]
COLS = ["d1", "d2", "k", "m1", "m2", "$docId"]


def _pick(rng, items, lo, hi):
    return [items[i] for i in rng.choice(len(items), size=int(rng.integers(lo, hi + 1)), replace=False)]


def _limit(rng) -> str:
    lim = f" LIMIT {int(rng.integers(1, 60))}"
    return lim + (f" OFFSET {int(rng.integers(1, 20))}" if rng.random() < 0.3 else "")


def _query(rng, filt=None) -> str:
    kind = rng.integers(0, 5)
    where = f" WHERE {(filt or _filter)(rng)}" if rng.random() < 0.85 else ""
    if kind == 0:
        return f"SELECT {', '.join(_pick(rng, AGGS, 1, 3))} FROM f{where}"
    if kind == 1:
        keys, aggs = KEYS[rng.integers(0, len(KEYS))], _pick(rng, AGGS[:-1], 1, 2)
        sql = f"SELECT {', '.join(keys + aggs)} FROM f{where} GROUP BY {', '.join(keys)}"
        if rng.random() < 0.3:
            sql += f" HAVING COUNT(*) > {int(rng.integers(0, 40))}"
        obs = [f"{aggs[0]} DESC"] + keys if rng.random() < 0.5 else keys
        return sql + f" ORDER BY {', '.join(obs)} LIMIT {int(rng.integers(1, 400))}"
    if kind == 2:
        return f"SELECT {', '.join(_pick(rng, COLS, 1, 4))} FROM f{where}{_limit(rng)}"
    if kind == 3:
        obs = [f"{c}{' DESC' if rng.random() < 0.5 else ''}" for c in _pick(rng, COLS[:-1], 1, 2)]
        return f"SELECT {', '.join(_pick(rng, COLS, 1, 3))} FROM f{where} ORDER BY {', '.join(obs)}{_limit(rng)}"
    keys = _pick(rng, ["d1", "d2", "k"], 1, 3)
    order = ""
    if rng.random() < 0.6:
        obs = _pick(rng, keys, 1, len(keys))
        order = " ORDER BY " + ", ".join(f"{c}{' DESC' if rng.random() < 0.5 else ''}" for c in obs)
    return f"SELECT DISTINCT {', '.join(keys)} FROM f{where}{order}{_limit(rng)}"


def _mv_predicate(rng) -> str:
    kind = rng.integers(0, 8)
    tag = f"'{STR_VALS[rng.integers(0, 9)]}'"
    if kind == 0:
        return f"tags = {tag}"
    if kind == 1:
        return f"tags <> {tag}"  # an exclusion: no value equals
    if kind == 2:
        vs = sorted(set(STR_VALS[i] for i in rng.integers(0, 9, 2)))
        return f"tags {'NOT ' if rng.random() < 0.4 else ''}IN ({', '.join(repr(v) for v in vs)})"
    if kind == 3:
        lo = int(rng.integers(0, 40))
        return f"vals BETWEEN {lo} AND {lo + int(rng.integers(0, 10))}"
    if kind == 4:
        return f"vals {['<', '>', '>=', '<>'][rng.integers(0, 4)]} {int(rng.integers(0, 40))}"
    if kind == 5:
        return f"k {['<', '>='][rng.integers(0, 2)]} {int(rng.integers(0, 50))}"
    if kind == 6:
        return f"d1 = '{STR_VALS[rng.integers(0, len(STR_VALS))]}'"
    return f"m1 > {int(rng.integers(-100, 1000))}"


MV_AGGS = [
    "COUNT(*)",
    "COUNTMV(vals)",
    "SUMMV(vals)",
    "MINMV(vals)",
    "MAXMV(vals)",
    "AVGMV(vals)",
    "COUNTMV(tags)",
    "SUM(m1)",
    "MAX(k)",
    "AVG(m1)",
    "DISTINCTCOUNT(k)",
    "SUMMV(vals) FILTER (WHERE k < 25)",
    "DISTINCTCOUNTMV(tags)",  # last: scalar only on the device
]
MV_KEYS = [["tags"], ["vals"], ["tags", "d1"], ["k", "vals"], ["tags", "vals"], ["vals", "tags", "k"], ["d1"]]
MV_COLS = ["tags", "vals", "d1", "k", "m1"]


def _mv_query(rng) -> str:
    kind = rng.integers(0, 4)
    n = int(rng.integers(1, 3))
    preds = [_mv_predicate(rng) for _ in range(n)]
    cond = f" {'AND' if rng.random() < 0.6 else 'OR'} ".join(f"({p})" for p in preds)
    where = f" WHERE {cond}" if rng.random() < 0.8 else ""
    if kind == 0:
        return f"SELECT {', '.join(_pick(rng, MV_AGGS, 1, 4))} FROM f{where}"
    if kind == 1:
        keys, aggs = MV_KEYS[rng.integers(0, len(MV_KEYS))], _pick(rng, MV_AGGS, 1, 3)
        sql = f"SELECT {', '.join(keys + aggs)} FROM f{where} GROUP BY {', '.join(keys)}"
        obs = [f"{aggs[0]} DESC"] + keys if rng.random() < 0.5 else keys
        return sql + f" ORDER BY {', '.join(obs)} LIMIT {int(rng.integers(1, 300))}"
    if kind == 2:
        return f"SELECT {', '.join(_pick(rng, MV_COLS, 1, 3))} FROM f{where}{_limit(rng)}"
    keys = MV_KEYS[rng.integers(0, len(MV_KEYS))]
    return f"SELECT DISTINCT {', '.join(keys)} FROM f{where} ORDER BY {', '.join(keys)}{_limit(rng)}"


#: STRING columns of the null-handling table that hold nulls
NULL_TEXT = ("d1",)


def _same(a, b) -> bool:
    if isinstance(b, np.ndarray):
        b = b.tolist()  # a selected MV cell of the reference
    if type(a) is not type(b):
        return False
    if isinstance(a, float):
        return a == b or (a != a and b != b) or math.isclose(a, b, rel_tol=1e-12)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


@pytest.mark.parametrize("seed", range(5))
def test_random_queries_match_reference(engines, seed):
    _run_random(engines, np.random.default_rng(1000 + seed), 40, "")


@pytest.mark.parametrize("seed", range(3))
def test_random_null_handling_queries_match_reference(null_engines, seed):
    _run_random(null_engines, np.random.default_rng(2000 + seed), 30, "SET enableNullHandling = true; ")


@pytest.mark.parametrize("seed", range(3))
def test_random_mv_queries_match_reference(mv_engines, seed):
    _run_random(mv_engines, np.random.default_rng(3000 + seed), 30, "", _mv_query)


@pytest.mark.parametrize("prefix", ["", "SET enableNullHandling = true; "])
@pytest.mark.parametrize("seed", range(3))
def test_random_pruned_queries_match_reference(tp_engines, seed, prefix):
    """Day ranges over the time-partitioned table: rows, numDocsScanned, the
    pruning funnel and the scan-path entry counts equal the reference's on
    every query; the queries prune about half of the segments."""
    _, port = tp_engines
    port.segment_modes.clear()
    _run_random(tp_engines, np.random.default_rng(4000 + seed), 30, prefix, lambda rng: _query(rng, _day_filter), stats=True)
    pruned, total = port.segment_modes["pruned"], sum(port.segment_modes.values())
    assert 0.25 < pruned / total < 0.75, (pruned, total)


#: the stats fields the time-partitioned run holds equal
SCAN_STATS = ("num_segments_pruned", "num_segments_pruned_by_value", "num_segments_pruned_by_bloom",
              "num_segments_pruned_by_geo", "num_entries_scanned_in_filter", "num_entries_scanned_post_filter")


def _run_random(engines, rng, n_queries, prefix, query=_query, stats=False):
    ref, port = engines
    skipped = []
    for _ in range(n_queries):
        sql = prefix + query(rng)
        want = ref.execute(sql)
        try:
            got = port.execute(sql)
        except NotImplementedError as e:
            assert any(name in str(e) for name in UNPORTED), (sql, e)
            skipped.append(sql)
            continue
        assert got.columns == want.columns, sql
        assert len(got.rows) == len(want.rows), (sql, got.rows[:3], want.rows[:3])
        # a selected null STRING cell: None, where the reference's pandas 3
        # frames give NaN (its "str" dtype's missing value; ROADMAP Queue C)
        text = [prefix and c in NULL_TEXT for c in got.columns]
        for g, w in zip(got.rows, want.rows):
            assert all(_same(a, b) or (t and a is None and _same(float("nan"), b)) for a, b, t in zip(g, w, text)), (
                sql, g, w)
        assert got.num_docs_scanned == want.num_docs_scanned, sql
        for f in SCAN_STATS if stats else ():
            assert getattr(got, f) == getattr(want, f), (sql, f)
    assert len(skipped) <= MAX_SKIPPED * n_queries, skipped
