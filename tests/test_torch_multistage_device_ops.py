"""The port's device operators of the multistage engine against the JAX
package's: every case of tests/test_multistage_device_ops.py.

The sort permutation, the segmented window scan and the equi-join probe run
as torch ops on the port's engine device (the CPU here), with the size
thresholds patched down in both packages so the device paths engage at test
scale. Engagement (`DEVICE_OP_STATS`) is asserted on the port. Both
packages' link profiles are pinned (`devlink`), so no test depends on a
timed probe. Rows equal the reference's as in tests/test_torch_multistage.py
(in order where ORDER BY defines one, else as a multiset; a float cell at
rtol 1e-12).
"""

import numpy as np
import pytest

from pinot_tpu.common import devlink as jdevlink
from pinot_tpu.multistage import MultistageEngine as JEngine
from pinot_tpu.multistage import rules as jrules
from pinot_tpu.multistage import runtime as jruntime
from pinot_tpu_torch.common import devlink
from pinot_tpu_torch.multistage import logical as L
from pinot_tpu_torch.multistage import rules, runtime
from pinot_tpu_torch.query.sql import parse_sql
from test_torch_multistage import both_segments, check, port_engine

N_FACT = 5000
N_DIM = 300
LOCAL_LINK = (1e-4, 5e9)  # a co-located card's order: 0.1 ms, 5 GB/s
TUNNEL_LINK = (0.07, 15e6)  # a tunneled attachment: 70 ms, 15 MB/s


def _dim_schema(DT, S):
    return S.build("dim", dimensions=[("did", DT.INT), ("dname", DT.STRING)], metrics=[("weight", DT.LONG)])


def _fact_schema(DT, S):
    return S.build("fact", dimensions=[("fid", DT.INT), ("fdid", DT.INT)], metrics=[("val", DT.LONG)])


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    dim = {
        "did": np.arange(N_DIM, dtype=np.int32),
        "dname": np.asarray([f"d_{i:03d}" for i in range(N_DIM)], dtype=object),
        "weight": rng.integers(1, 50, N_DIM).astype(np.int64),
    }
    fact = {
        "fid": np.arange(N_FACT, dtype=np.int32),
        "fdid": rng.integers(0, N_DIM + 40, N_FACT).astype(np.int32),
        "val": rng.integers(1, 1000, N_FACT).astype(np.int64),
    }
    return dim, fact


@pytest.fixture(scope="module")
def engines(data):
    dim, fact = data
    d = both_segments(_dim_schema, dim, "dim_0")
    f = both_segments(_fact_schema, fact, "fact_0")
    return (
        JEngine({"dim": [d[0]], "fact": [f[0]]}, n_workers=2),
        port_engine({"dim": [d[1]], "fact": [f[1]]}, n_workers=2),
    )


@pytest.fixture(autouse=True)
def low_thresholds(monkeypatch):
    for mod in (runtime, jruntime):
        monkeypatch.setattr(mod, "DEVICE_SORT_MIN", 64)
        monkeypatch.setattr(mod, "DEVICE_JOIN_MIN", 64)
    monkeypatch.setattr(jdevlink, "_profile", LOCAL_LINK)
    monkeypatch.setitem(devlink._profiles, "cpu", LOCAL_LINK)
    for k in ("sort", "join", "window"):
        monkeypatch.setitem(runtime.DEVICE_OP_STATS, k, 0)
    yield


def _pin_untransposed_plan(monkeypatch):
    """Keep the general join operator on a many-to-many key:
    AggregateJoinTranspose would rewrite COUNT(*) over the self-join into a
    unique-build-side join."""
    for mod in (rules, jrules):
        monkeypatch.setattr(mod, "PHYSICAL_RULES", [r for r in mod.PHYSICAL_RULES if r.name != "AggregateJoinTranspose"])


@pytest.mark.parametrize(
    "sql,ordered,op",
    [
        ("SELECT fid, val FROM fact ORDER BY val DESC, fid LIMIT 50", True, "sort"),
        ("SELECT d.dname, f.val FROM fact f JOIN dim d ON f.fdid = d.did ORDER BY f.val DESC, d.dname LIMIT 40", True, "join"),
        ("SELECT d.dname, SUM(f.val) FROM fact f JOIN dim d ON f.fdid = d.did GROUP BY d.dname ORDER BY d.dname LIMIT 500", True, "join"),
        ("SELECT dim.did FROM dim JOIN dim AS d2 ON dim.dname = d2.dname LIMIT 10000", False, "join"),
        ("SELECT f2.val FROM fact JOIN fact AS f2 ON fact.fid = f2.fid AND fact.fdid = f2.fdid LIMIT 10000", False, "join"),
        ("SELECT fact.fid, dim.weight FROM fact LEFT JOIN dim ON fact.fdid = dim.did LIMIT 10000", False, "join"),
        ("SELECT COUNT(*) FROM fact f LEFT JOIN dim d ON f.fdid = d.did WHERE d.did IS NULL", True, None),
    ],
)
def test_device_operator_queries_match_reference(engines, sql, ordered, op):
    """The device sort, the lookup join (unique build key: the exchange),
    the join feeding a group-by, the text-keyed and two-key joins (the
    joint dense encoding), the LEFT OUTER join on the device and the
    broadcast LEFT JOIN's unmatched rows."""
    before = dict(runtime.DEVICE_OP_STATS)
    check(engines, sql, ordered)
    if op is not None:
        assert runtime.DEVICE_OP_STATS[op] > before[op], sql


def test_lookup_join_rides_the_exchange(engines):
    before = runtime.DEVICE_OP_STATS.get("mesh_join", 0)
    check(engines, "SELECT d.dname, f.val FROM fact f JOIN dim d ON f.fdid = d.did ORDER BY f.val DESC, d.dname LIMIT 40", True)
    assert runtime.DEVICE_OP_STATS.get("mesh_join", 0) > before


def test_duplicate_build_keys_device_join(engines, monkeypatch):
    """A self-join on a NON-unique key rides the general device join
    (sort + range probe + expansion)."""
    _pin_untransposed_plan(monkeypatch)
    before = runtime.DEVICE_OP_STATS["join"]
    check(engines, "SELECT COUNT(*) FROM fact a JOIN fact b ON a.fdid = b.fdid", True)
    assert runtime.DEVICE_OP_STATS["join"] > before


def test_many_to_many_blowup_falls_back(engines, monkeypatch):
    """A pair count past the guard falls back to the host join."""
    _pin_untransposed_plan(monkeypatch)
    monkeypatch.setattr(runtime, "DEVICE_JOIN_MAX_PAIRS", 10)
    monkeypatch.setattr(jruntime, "DEVICE_JOIN_MAX_PAIRS", 10)
    before = runtime.DEVICE_OP_STATS["join"]
    check(engines, "SELECT COUNT(*) FROM fact a JOIN fact b ON a.fdid = b.fdid", True)
    assert runtime.DEVICE_OP_STATS["join"] == before


@pytest.mark.parametrize(
    "sql,counts,broadcast",
    [
        (
            "SELECT d.dname, SUM(f.val) FROM fact f JOIN dim d ON f.fdid = d.did GROUP BY d.dname ORDER BY d.dname LIMIT 500",
            {"fact": N_FACT, "dim": N_DIM},
            True,
        ),
        ("SELECT COUNT(*) FROM fact a JOIN fact b ON a.fdid = b.fdid", {"fact": N_FACT}, False),
    ],
)
def test_cost_based_broadcast_plan(sql, counts, broadcast):
    """The small build side is broadcast, balanced sides hash: the same
    stage plans as the reference's."""
    from pinot_tpu.multistage import logical as JL
    from pinot_tpu.query.sql import parse_sql as jparse

    cols = {"fact": ["fid", "fdid", "val"], "dim": ["did", "dname", "weight"]}
    cols = {t: c for t, c in cols.items() if t in counts}
    plan = L.build_stage_plan(parse_sql(sql), L.Catalog(cols, row_counts=counts), n_workers=2)
    jplan = JL.build_stage_plan(jparse(sql), JL.Catalog(cols, row_counts=counts), n_workers=2)
    assert repr(plan) == repr(jplan)
    assert ("broadcast" in [s.dist for s in plan.stages.values() if s.dist]) == broadcast


def test_device_window_sort_engages(engines):
    """The window's sort and the outer ORDER BY both sort on the device."""
    before = runtime.DEVICE_OP_STATS["sort"]
    check(
        engines,
        "SELECT fid, val, ROW_NUMBER() OVER (PARTITION BY fdid ORDER BY val DESC) FROM fact ORDER BY fid LIMIT 100",
        True,
    )
    assert runtime.DEVICE_OP_STATS["sort"] >= before + 2


def test_string_sort_falls_back(engines):
    before = runtime.DEVICE_OP_STATS["sort"]
    check(engines, "SELECT dname FROM dim ORDER BY dname DESC LIMIT 5", True)
    assert runtime.DEVICE_OP_STATS["sort"] == before


def test_device_join_null_keys_never_match():
    """Null join keys match nothing on the device path, null-vs-null too."""
    from pinot_tpu.common.config import IndexingConfig as JIC
    from pinot_tpu.common.config import TableConfig as JTC
    from pinot_tpu_torch.common.config import IndexingConfig, TableConfig

    k = np.asarray([1, 2, None, None] * 40, dtype=object)
    v = np.arange(160, dtype=np.int64)
    schema = lambda DT, S: S.build("n", dimensions=[("k", DT.INT)], metrics=[("v", DT.LONG)])  # noqa: E731
    segs = both_segments(
        schema,
        {"k": k, "v": v},
        "n0",
        table_config=(JTC("n", indexing=JIC(null_handling=True)), TableConfig("n", indexing=IndexingConfig(null_handling=True))),
    )
    ref = JEngine({"n": [segs[0]]}, n_workers=2)
    port = port_engine({"n": [segs[1]]}, n_workers=2)
    before = runtime.DEVICE_OP_STATS["join"]
    sql = "SET enableNullHandling = true; SELECT n.v FROM n JOIN n AS n2 ON n.k = n2.k LIMIT 100000"
    got = check((ref, port), sql, False)
    assert runtime.DEVICE_OP_STATS["join"] > before
    assert len(got.rows) == 80 * 40


def test_join_cross_dtype_numeric_keys_match():
    """An object-dtype numeric key (a null-handling scan's) joins a plain
    int64 key by VALUE (1.0 == 1); int vs text keys are refused."""
    lk = [np.array([1.0, 2.0, None], dtype=object)]
    rk = [np.asarray([1, 2, 3], dtype=np.int64)]
    lcodes, rcodes = runtime._encode_join_keys(lk, rk, np.array([False, False, True]), np.zeros(3, bool))
    assert lcodes[0] == rcodes[0] and lcodes[1] == rcodes[1] and lcodes[2] < 0
    assert (
        runtime._encode_join_keys(
            [np.array([1, 2], dtype=object)], [np.array(["1", "2"], dtype=object)], np.zeros(2, bool), np.zeros(2, bool)
        )
        is None
    )


@pytest.mark.parametrize("fn", ["SUM", "MIN", "MAX", "COUNT", "AVG"])
def test_device_window_cumulative_matches_reference(engines, fn):
    before = runtime.DEVICE_OP_STATS["window"]
    arg = "*" if fn == "COUNT" else "val"
    check(
        engines,
        f"SELECT fid, {fn}({arg}) OVER (PARTITION BY fdid ORDER BY fid) FROM fact ORDER BY fid LIMIT 5000",
        True,
    )
    assert runtime.DEVICE_OP_STATS["window"] > before


def test_device_window_row_number(engines):
    before = runtime.DEVICE_OP_STATS["window"]
    check(
        engines,
        "SELECT fid, ROW_NUMBER() OVER (PARTITION BY fdid ORDER BY val DESC, fid) FROM fact ORDER BY fid LIMIT 5000",
        True,
    )
    assert runtime.DEVICE_OP_STATS["window"] > before


def test_window_rank_stays_host_and_correct(engines):
    before = runtime.DEVICE_OP_STATS["window"]
    check(engines, "SELECT fid, RANK() OVER (PARTITION BY fdid ORDER BY val) FROM fact ORDER BY fid LIMIT 5000", True)
    assert runtime.DEVICE_OP_STATS["window"] == before


def test_device_window_sum_int32_does_not_wrap(monkeypatch):
    """int32 values widen to int64 in the running sum: no wrap past 2^31."""
    monkeypatch.setattr(runtime, "DEVICE_SORT_MIN", 4)
    n = 64
    out = runtime._device_window_cum("sum", np.zeros(n, dtype=np.int64), np.full(n, 2**30, dtype=np.int32), n, "cpu")
    assert out is not None and out[-1] == n * 2**30


@pytest.mark.parametrize("fname", ["sum", "min", "max", "count", "avg", "row_number"])
def test_segmented_scan_matches_the_host_cumulatives(fname):
    """The device scan's log-step passes against per-partition numpy
    cumulatives: exact for int64 sums, MIN, MAX and counts."""
    rng = np.random.default_rng(31)
    n = 5000
    gk = np.sort(rng.integers(0, 40, n))
    v = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    out = runtime._device_window_cum(fname, gk, None if fname in ("count", "row_number") else v, n, "cpu")
    want = np.empty(n)
    for g in np.unique(gk):
        m = gk == g
        seg = v[m]
        want[m] = {
            "sum": np.cumsum(seg),
            "min": np.minimum.accumulate(seg),
            "max": np.maximum.accumulate(seg),
            "count": np.arange(1, m.sum() + 1),
            "row_number": np.arange(1, m.sum() + 1),
            "avg": np.cumsum(seg.astype(np.float64)) / np.arange(1, m.sum() + 1),
        }[fname]
    if fname == "avg":
        np.testing.assert_allclose(out, want, rtol=1e-12)
    else:
        np.testing.assert_array_equal(out, want.astype(np.int64) if fname != "avg" else want)


def test_economic_gate_declines_on_tunnel_link(monkeypatch):
    """With a tunnel-like link (70 ms RTT, 15 MB/s) the sort and window
    device paths decline, as the reference's do; a local link accepts."""
    n = 100_000
    keys = [np.arange(n, dtype=np.int64)]
    gk = np.zeros(n, dtype=np.int64)
    v = np.ones(n, dtype=np.int64)
    monkeypatch.setitem(devlink._profiles, "cpu", TUNNEL_LINK)
    monkeypatch.setattr(jdevlink, "_profile", TUNNEL_LINK)
    assert runtime._device_sort_perm(keys, [False], "cpu") is None is jruntime._device_sort_perm(keys, [False])
    assert runtime._device_window_cum("sum", gk, v, n, "cpu") is None is jruntime._device_window_cum("sum", gk, v, n)
    monkeypatch.setitem(devlink._profiles, "cpu", LOCAL_LINK)
    assert runtime._device_sort_perm(keys, [False], "cpu") is not None
    assert runtime._device_window_cum("sum", gk, v, n, "cpu") is not None


def test_device_sort_permutation_is_the_stable_lexsort():
    """DESC flips (bitwise NOT for ints, negation for floats) and ties keep
    their order, as np.lexsort's; a NaN or text key declines."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 5, 1000).astype(np.int32)
    b = rng.standard_normal(1000).round(1)
    got = runtime._device_sort_perm([a, b], [True, False], "cpu")
    np.testing.assert_array_equal(got, np.lexsort((b, ~a)))
    assert runtime._device_sort_perm([np.array([1.0, np.nan])], [False], "cpu") is None
    assert runtime._device_sort_perm([np.array(["a", "b"], dtype=object)], [False], "cpu") is None


def test_link_profile_is_measured_once_per_device(monkeypatch):
    """The probe's round trips run once a device; transfer_cost_s is the
    reference's model over the profile."""
    monkeypatch.delitem(devlink._profiles, "cpu", raising=False)
    rtt, bw = devlink.link_profile("cpu")
    assert rtt >= 0 and bw > 0 and devlink.link_profile("cpu") == (rtt, bw)
    monkeypatch.setitem(devlink._profiles, "cpu", (0.5, 100.0))
    assert devlink.transfer_cost_s(200, round_trips=2, device="cpu") == 2 * 0.5 + 2.0
