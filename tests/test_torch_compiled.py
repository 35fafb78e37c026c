"""The port's compile layer (query/kernels.py `get_kernel`, `get_packed_kernel`,
`run_plan`, `run_plan_packed`, `_fused_cost`; query/graphs.py's table) against
the JAX package's: the same seeded segments planned by both packages, run
through both compiled programs (the reference's jitted ones on the CPU, the
port's eager ones on the CPU), their outputs leaf for leaf; the compile
caches' meters over one SQL sequence; the `query.fused_packed` records of an
engine query; `/debug/roofline`; the multistage leaf's mask. On a card the
same entry points replay CUDA graphs (chip_smoke.py's `compiled_program`);
here the parts of that path the CPU can hold are tested alone: the replay
bookkeeping, the capture's routing of launches, the operand slab and the
graph table."""

import gc
import inspect
import json
import threading
import urllib.request

import numpy as np
import pytest
import torch

import pinot_tpu.query.kernels as JK
from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common import kernel_obs as jkernel_obs
from pinot_tpu.common.kernel_obs import KERNELS as JKERNELS
from pinot_tpu.common.metrics import reset_registries as j_reset_registries
from pinot_tpu.common.metrics import server_metrics as j_server_metrics
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.query.plan import plan_filter_mask as j_plan_filter_mask
from pinot_tpu.query.plan import plan_segment as j_plan_segment
from pinot_tpu.query.sql import parse_sql as jparse
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, Schema
from pinot_tpu_torch.common import kernel_obs
from pinot_tpu_torch.common.kernel_obs import KERNELS, CapturedLaunches, KernelRegistry, capturing, count_launch
from pinot_tpu_torch.common.metrics import reset_registries, server_metrics
from pinot_tpu_torch.ops import extreme, groupby
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import graphs
from pinot_tpu_torch.query import kernels as K
from pinot_tpu_torch.query.plan import plan_filter_mask, plan_segment
from pinot_tpu_torch.query.sql import parse_sql
from pinot_tpu_torch.segment import SegmentBuilder
from test_torch_engine import TABLES


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setattr(jkernel_obs, "_link_rtt_ms", lambda: 0.0)
    for r in (KERNELS, JKERNELS):
        r.configure(enabled=True)
        r.reset_stats()
    yield
    for r in (KERNELS, JKERNELS):
        r.configure(enabled=True)
        r.reset_stats()


@pytest.fixture(scope="module")
def tables():
    """{table: [(reference segment, port segment)]} from the engine tests'
    seeded tables (tests/test_queries.py's generator, bench.py's SSB
    generator, a DOUBLE column with NaN and infinities)."""
    out = {}
    for table, (cols, datas) in TABLES.items():
        if table == "graft":
            continue
        out[table] = [
            (
                JBuilder(JSchema.build("lineorder", **cols(JDT))).build({k: v.copy() for k, v in d.items()}, f"{table}_{i}"),
                SegmentBuilder(Schema.build("lineorder", **cols(DataType))).build({k: v.copy() for k, v in d.items()}, f"{table}_{i}"),
            )
            for i, d in enumerate(datas)
        ]
    return out


#: (table, SQL): tests/test_queries.py's shapes, tests/test_kernel_obs.py's
#: engine query, and the SSB configs
CORPUS = [
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE region = 'ASIA'"),
    ("lineorder", "SELECT COUNT(*) FROM lineorder"),
    ("lineorder", "SELECT SUM(revenue), MIN(quantity), MAX(discount), AVG(revenue) FROM lineorder "
                  "WHERE year BETWEEN 1993 AND 1996 AND region = 'ASIA'"),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE NOT (region = 'ASIA' OR year != 1995)"),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE region IN ('ASIA','EUROPE') AND year NOT IN (1992, 1998)"),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE quantity > 25 AND discount <= 0.05"),
    ("lineorder", "SELECT COUNT(*) FROM lineorder WHERE quantity * 2 + 1 > 60"),
    ("lineorder", "SELECT DISTINCTCOUNT(nation) FROM lineorder WHERE year = 1995"),
    ("lineorder", "SELECT MINMAXRANGE(revenue) FROM lineorder"),
    ("lineorder", "SELECT region, COUNT(*) FROM lineorder GROUP BY region LIMIT 100"),
    ("lineorder", "SELECT year, region, SUM(revenue) FROM lineorder GROUP BY year, region ORDER BY year LIMIT 50"),
    ("lineorder", "SELECT nation, AVG(quantity) FROM lineorder GROUP BY nation HAVING COUNT(*) > 300 LIMIT 100"),
    ("lineorder", "SELECT region, year, quantity FROM lineorder WHERE year = 1996 LIMIT 7"),
    ("lineorder", "SELECT revenue, region FROM lineorder WHERE region='ASIA' ORDER BY revenue DESC LIMIT 5"),
    ("lineorder", "SELECT quantity FROM lineorder ORDER BY quantity LIMIT 4"),
    ("ssb", "SELECT d_year, SUM(lo_revenue) FROM lineorder WHERE lo_quantity < 25 GROUP BY d_year"),
    ("ssb", "SELECT d_year, c_nation, p_category, SUM(lo_revenue - lo_supplycost) FROM lineorder "
            "WHERE lo_quantity > 5 AND d_year BETWEEN 1993 AND 1997 GROUP BY d_year, c_nation, p_category LIMIT 10"),
    ("ssb", "SELECT d_year, c_nation, COUNT(*), MIN(lo_quantity), MAX(lo_revenue), MINMAXRANGE(lo_supplycost) "
            "FROM lineorder GROUP BY d_year, c_nation LIMIT 200"),
    ("ssb", "SELECT d_year, p_category, COUNT(*), DISTINCTCOUNT(c_nation) FROM lineorder "
            "WHERE lo_quantity = 1 GROUP BY d_year, p_category LIMIT 200"),
    ("doubles", "SELECT g, SUM(x), MIN(x), MAX(x), COUNT(*) FROM lineorder GROUP BY g"),
    ("doubles", "SELECT SUM(x), AVG(y) FROM lineorder WHERE y > 0"),
]


def _same_leaf(got, want, what) -> None:
    """Counts, integer sums, MIN/MAX, keys and flags bit-equal; float64 to
    rtol 1e-12 (NaN where NaN)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, got.shape, want.dtype, want.shape)
    if got.dtype.kind == "f":
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0, equal_nan=True, err_msg=what)
    else:
        np.testing.assert_array_equal(got, want, err_msg=what)


def _plans(pair, sql):
    jseg, seg = pair
    jplan = j_plan_segment(jseg, JEngine([jseg]).make_context(sql))
    plan = plan_segment(seg, QueryEngine([seg], device="cpu").make_context(sql))
    assert plan.spec == jplan.spec, sql
    return jplan, plan


@pytest.mark.parametrize("table,sql", CORPUS, ids=[f"{t}-{i}" for i, (t, _) in enumerate(CORPUS)])
def test_run_plan_packed_and_run_plan_equal_reference(tables, table, sql):
    """Every segment's packed outputs (one device->host copy) and device
    outputs equal the reference's compiled programs' on the same rows."""
    for pair in tables[table]:
        jplan, plan = _plans(pair, sql)
        jseg, seg = pair
        want, _ = K._flatten(JK.run_plan_packed(jplan, jseg.to_device_cached()))
        got, _ = K._flatten(K.run_plan_packed(plan, seg.to_device_cached("cpu")))
        assert len(got) == len(want), sql
        for i, (g, w) in enumerate(zip(got, want)):
            _same_leaf(g, w, f"{sql} packed leaf {i}")
        want, _ = K._flatten(JK.run_plan(jplan, jseg.to_device_cached()))
        got, _ = K._flatten(K.run_plan(plan, seg.to_device_cached("cpu")))
        for i, (g, w) in enumerate(zip(got, want)):
            _same_leaf(g.numpy(), np.asarray(w), f"{sql} leaf {i}")


def test_compiled_program_called_as_the_references():
    """get_kernel(spec)(cols, ops, n_docs, n_padded) is the eager program's
    tree; get_packed_kernel's the same leaves in one float64 vector."""
    seg = SegmentBuilder(Schema.build("t", dimensions=[("b", DataType.INT)], metrics=[("a", DataType.LONG)])).build(
        {"b": np.arange(300, dtype=np.int32) % 4, "a": np.arange(300, dtype=np.int64)}, "t_0")
    plan = plan_segment(seg, QueryEngine([seg], device="cpu").make_context("SELECT b, SUM(a) FROM t GROUP BY b"))
    cols, ops = K.plan_inputs(plan, seg.to_device_cached("cpu"))
    tree = K.get_kernel(plan.spec)(cols, ops, seg.n_docs, seg.to_device_cached("cpu").padded)
    leaves, _ = K._flatten(tree)
    vec = K.get_packed_kernel(plan.spec)(cols, ops, seg.n_docs, seg.to_device_cached("cpu").padded)
    assert torch.equal(vec, K.pack(leaves))
    assert leaves[0].item() == 300


def test_signatures_and_cache_sizes_are_the_references():
    from pinot_tpu.parallel import mesh as jmesh
    from pinot_tpu.parallel import shuffle as jshuffle
    from pinot_tpu_torch.parallel import mesh, shuffle

    for name in ("get_kernel", "get_packed_kernel", "run_plan", "run_plan_packed", "_fused_cost"):
        mine, ref = getattr(K, name), getattr(JK, name)
        assert list(inspect.signature(mine).parameters) == list(inspect.signature(ref).parameters), name
    for name in ("build_fn", "build_masked_fn", "get_kernel", "get_packed_kernel"):
        assert getattr(K, name).cache_info().maxsize == getattr(JK, name).cache_info().maxsize == 1024, name
    assert mesh._sharded_kernel.cache_info().maxsize == jmesh._sharded_kernel.cache_info().maxsize == 256
    assert shuffle._join_kernel.cache_info().maxsize == jshuffle._join_kernel.cache_info().maxsize == 64


@pytest.mark.parametrize("rows", [0, 1, 1000, 4_194_304, 2**20 + 3, -5, None])
@pytest.mark.parametrize("cols", [0, 1, 3, 17, None])
def test_fused_cost_equals_reference(rows, cols):
    shape = {k: v for k, v in (("rows", rows), ("cols", cols)) if v is not None}
    assert K._fused_cost(shape) == JK._fused_cost(shape)


def _fresh_cache(fn, obs) -> None:
    fn.cache_clear()
    obs._hits = obs._misses = obs._evictions = 0


def test_kernel_cache_meters_equal_reference(tables):
    """One SQL sequence through both engines (the packed program a segment)
    and one sequence of leaf masks (run_plan): equal
    engine.kernelCache.{hits,misses,size}{cache=kernel|packed}."""
    reset_registries()
    j_reset_registries()
    for fn, obs in ((K.get_kernel, K._kernel_cache_obs), (K.get_packed_kernel, K._packed_cache_obs),
                    (JK.get_kernel, JK._kernel_cache_obs), (JK.get_packed_kernel, JK._packed_cache_obs)):
        _fresh_cache(fn, obs)
    pairs = tables["lineorder"]
    jeng, peng = JEngine([p[0] for p in pairs]), QueryEngine([p[1] for p in pairs], device="cpu")
    sequence = [sql for t, sql in CORPUS if t == "lineorder"][:8]
    for sql in sequence + sequence[:3]:
        assert peng.execute(sql).rows == jeng.execute(sql).rows, sql
    for where in ("year = 1995", "region = 'ASIA' AND quantity > 10", "year = 1995"):
        sql = f"SELECT * FROM lineorder WHERE {where}"
        for jseg, seg in pairs:
            JK.run_plan(j_plan_filter_mask(jseg, jparse(sql).where), jseg.to_device_cached())
            K.run_plan(plan_filter_mask(seg, parse_sql(sql).where), seg.to_device_cached("cpu"))

    def meters(reg):
        return {
            (cache, what): reg.meter(f"engine.kernelCache.{what}", cache=cache).count
            for cache in ("kernel", "packed") for what in ("hits", "misses")
        } | {(cache, "size"): reg.gauge("engine.kernelCache.size", cache=cache).value for cache in ("kernel", "packed")}

    got, want = meters(server_metrics()), meters(j_server_metrics())
    assert got == want
    assert got[("packed", "hits")] > 0 and got[("kernel", "hits")] > 0 and got[("kernel", "misses")] > 0


def test_engine_query_records_fused_packed_as_the_reference(tables):
    """An engine query records `query.fused_packed` once a segment, under the
    reference's shape buckets and bytes (rows = the padded docs, cols = the
    plan's columns)."""
    pairs = tables["ssb"]
    sql = "SELECT d_year, SUM(lo_revenue), MAX(lo_quantity) FROM lineorder WHERE c_nation = 'NATION_03' GROUP BY d_year"
    JEngine([p[0] for p in pairs]).execute(sql)
    QueryEngine([p[1] for p in pairs], device="cpu").execute(sql)

    def fused(snap):
        return {k: (v["calls"], v["bytesMoved"]) for k, v in snap.items() if k[0] == "query.fused_packed"}

    got, want = fused(KERNELS.stats_snapshot()), fused(JKERNELS.stats_snapshot())
    assert got == want and sum(c for c, _ in got.values()) == len(pairs)
    assert all(b > 0 for _, b in got.values())
    roof = KERNELS.roofline()
    assert all(r["pctOfPeak"] <= 100 for r in roof["kernels"])
    assert {"query.fused", "query.fused_packed"} <= set(roof["registered"])


def test_debug_roofline_lists_both_programs():
    """The reference's /debug/roofline case on a port server: both program
    names registered, both rows served."""
    from pinot_tpu_torch.cluster.http import ServerHTTPService
    from pinot_tpu_torch.cluster.server import Server

    KERNELS.record("query.fused", 2.0, rows=1024, cols=4)
    KERNELS.record("query.fused_packed", 1.0, rows=2048, cols=3)
    svc = ServerHTTPService(Server("compiled-http", device="cpu"), port=0)
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{svc.port}/debug/roofline", timeout=10) as rsp:
            doc = json.loads(rsp.read())
    finally:
        svc.stop()
    assert {k["kernel"] for k in doc["kernels"]} == {"query.fused", "query.fused_packed"}
    assert {"query.fused", "query.fused_packed"} <= set(doc["registered"])
    assert doc["inProgram"] == [] and len(doc["offenders"]) == 2


def test_multistage_leaf_mask_equals_reference():
    """The leaf Scan's filter through run_plan (the compiled `mask` program)
    equals the reference's leaf mask, and runs on the device path."""
    from pinot_tpu.multistage.runtime import _leaf_filter_mask as j_leaf_mask
    from pinot_tpu_torch.common.metrics import ServerMeter
    from pinot_tpu_torch.multistage.runtime import _leaf_filter_mask

    cols, datas = TABLES["lineorder"]
    for i, d in enumerate(datas):
        jseg = JBuilder(JSchema.build("lineorder", **cols(JDT))).build({k: v.copy() for k, v in d.items()}, f"m{i}")
        seg = SegmentBuilder(Schema.build("lineorder", **cols(DataType))).build({k: v.copy() for k, v in d.items()}, f"m{i}")
        for where in ("year = 1995", "region IN ('ASIA', 'EUROPE') AND quantity > 20", "NOT (discount > 0.05)"):
            sql = f"SELECT * FROM lineorder WHERE {where}"
            meter = server_metrics().meter(ServerMeter.MULTISTAGE_LEAF_DEVICE_SCANS)
            before = meter.count
            got = _leaf_filter_mask(seg, parse_sql(sql).where, device="cpu")
            assert meter.count == before + 1
            np.testing.assert_array_equal(got, j_leaf_mask(jseg, jparse(sql).where), err_msg=where)


# -- the card path's parts, held alone on the CPU ---------------------------------


class _Wrapper:
    """A stand-in kernel wrapper: a `.launches` counter."""

    def __init__(self):
        self.launches = 0


def test_replay_bookkeeping_counts_each_captured_launch_once_a_replay():
    """replayed(): each captured counter bump made once a replay, each
    captured launch one in-program record (calls and bytes, no time, no
    timed row), with the replay's mask counts."""
    r = KernelRegistry()
    r.register("unit.k", cost_model=kernel_obs.streaming_cost)
    w1, w2 = _Wrapper(), _Wrapper()
    shape = {"rows": 1024, "per_doc": 8, "out_bytes": 16}
    cap = CapturedLaunches(launches=[("unit.k", shape, torch.tensor(5)), ("unit.k", shape, torch.tensor(2))],
                           counters=[w1, w2, w1])
    with r.collect() as sink:
        for _ in range(3):
            r.replayed(cap, "query.fused_packed", masked=[torch.tensor(5), torch.tensor(2)])
    assert (w1.launches, w2.launches) == (6, 3)
    assert len(sink) == 6 and all(p.start is None and p.program == "query.fused_packed" for p in sink)
    r.resolve(sink)
    assert r.stats_snapshot() == {}
    (row,) = r.roofline()["inProgram"]
    assert row == {"kernel": "unit.k", "shape": "2^10", "program": "query.fused_packed", "calls": 6,
                   "bytesMoved": 3 * ((1024 + 5 * 8 + 16) + (1024 + 2 * 8 + 16)), "flops": 3 * 7}
    assert r.roofline()["kernels"] == []
    # masked filled in after the replay (the packed copy), as ints
    with r.collect():
        (p,) = r.replayed(CapturedLaunches(launches=[("unit.k", shape, None)]), "query.fused_packed")
    p.masked = 4
    r.resolve([p])
    assert r.in_program_snapshot()[("unit.k", "2^10", "query.fused_packed")]["calls"] == 7
    # a disabled registry still counts the launches, and records nothing
    r.configure(enabled=False)
    assert r.replayed(cap, "query.fused_packed") == []
    assert (w1.launches, w2.launches) == (8, 4)


def test_capture_routes_launches_and_counts_to_the_capture():
    """Under capturing(): a launch runs and appends (name, shape, mask
    count), records nothing and bumps no counter; count_launch appends its
    wrapper. Outside it, launches record again."""
    r = KernelRegistry()
    r.register("unit.k", cost_model=kernel_obs.streaming_cost)
    w = _Wrapper()
    mask = torch.tensor([True, False, True])
    cap = CapturedLaunches()
    with capturing(cap):
        assert kernel_obs.current_capture() is cap
        assert r.launch("unit.k", lambda: 7, mask, rows=3) == 7
        count_launch(w)
    assert kernel_obs.current_capture() is None
    assert w.launches == 0 and cap.counters == [w]
    ((name, shape, masked),) = cap.launches
    assert (name, shape, int(masked)) == ("unit.k", {"rows": 3}, 2)
    assert r.stats_snapshot() == {}
    r.launch("unit.k", lambda: 7, mask, rows=3)
    assert r.stats_snapshot()[("unit.k", "2^1")]["calls"] == 1


def test_capture_counts_are_the_programs_last_output():
    """capture_counts(): the mask counts of the launches captured so far, in
    order, one int64 vector; empty outside a capture."""
    assert K.capture_counts("cpu").shape == (0,)
    g = torch.tensor([0, 1, 1, 2], dtype=torch.int32)
    m = torch.tensor([True, True, False, True])
    v = torch.tensor([5, 6, 7, 8], dtype=torch.int32)
    cap = CapturedLaunches()
    with capturing(cap):
        groupby.grouped_multi_sum([v], g, m, 3)
        extreme.grouped_extremes([v.to(torch.float64)], [(0, True)], g, ~m, 3)
        counts = K.capture_counts("cpu")
    assert counts.tolist() == [3, 1] and [n for n, _, _ in cap.launches] == ["ops.grouped_planes", "ops.grouped_extreme"]


def test_record_program_on_the_cpu_attributes_nothing_twice():
    """A CPU program's record lands on the ledger but not on the query's
    device ms (its plain kernels recorded theirs)."""
    from pinot_tpu_torch.common.accounting import default_accountant

    default_accountant.reset_rollups()
    with default_accountant.scope("cq-1", table="t", tenant="t"):
        KERNELS.record_program("query.fused_packed", 5.0, rows=1024, cols=2)
        KERNELS.record("ops.grouped_planes", 1.5, rows=1024)
    assert default_accountant.recent_query_stats("cq-1")["deviceMs"] == pytest.approx(1.5)
    assert KERNELS.stats_snapshot()[("query.fused_packed", "2^10")]["calls"] == 1


def test_registry_reset_is_the_references():
    r = KernelRegistry(hbm_peak_gbps=10.0)
    r.register("unit.k")
    r.configure(enabled=False)
    r.record("unit.k", 1.0, rows=4)
    r.reset()
    assert r.kernel_names() == [] and r.enabled and r.hbm_peak_gbps == kernel_obs.DEFAULT_HBM_PEAK_GBPS
    assert r.stats_snapshot() == {} and r.in_program_snapshot() == {}


def test_operand_binding_shares_and_lays_out_as_stage_operands():
    """The slab binding: equal scalars share one buffer and repeated arrays
    one, as stage_operands shares one tensor; a stable array binds its own
    device copy; every buffer 16-byte aligned; filled, the operands equal
    stage_operands' values; the signature tells the sharing apart."""
    lut = np.array([True, False, True])
    stable = K.mark_stable_operand(np.arange(5, dtype=np.uint32))
    operands = [np.int32(1997), lut, np.int32(1997), np.float64(2.5), stable, lut, np.int64(-3)]
    b = K.OperandBinding(operands, "cpu")
    assert b.index == [0, 1, 0, 2, 3, 1, 4]
    assert all(off % 16 == 0 for off in b.offsets if off is not None) and b.offsets[3] is None
    slab, ops = b.bind("cpu")
    b.fill(slab.numpy())
    want = K.stage_operands(operands, "cpu")
    for got, w in zip(ops, want):
        assert got.dtype == w.dtype and got.shape == w.shape and torch.equal(got, w)
    assert ops[0] is ops[2] and ops[1] is ops[5] and ops[4] is want[4]
    other = K.OperandBinding([np.int32(1997), lut, np.int32(1998), np.float64(2.5), stable, lut, np.int64(-3)], "cpu")
    assert other.signature != b.signature
    lut2 = np.array([False, False, True])
    same = K.OperandBinding([np.int32(7), lut2, np.int32(7), np.float64(0.5), stable, lut2, np.int64(1)], "cpu")
    assert same.signature == b.signature
    assert ops[0].shape == () and ops[1].shape == (3,)


class _FakeGraph:
    def __init__(self, nbytes):
        self.nbytes = nbytes


class _Owner:
    pass


def test_graph_table_evicts_by_bytes_and_follows_its_owners():
    t = graphs.GraphTable(budget=100)
    a, b = _Owner(), _Owner()
    t.put(("k", 1), a, _FakeGraph(40))
    t.put(("k", 2), a, _FakeGraph(40))
    assert t.get(("k", 1)) is not None  # now the most recent
    t.put(("k", 3), b, _FakeGraph(40))
    assert t.get(("k", 2)) is None and t.get(("k", 1)) is not None and t.get(("k", 3)) is not None
    st = t.stats()
    assert (st["graphs"], st["bytes"], st["peakBytes"], st["evictions"], st["captures"]) == (2, 80, 120, 1, 3)
    # one graph past the budget stays: the newest is never evicted
    t.put(("big",), b, _FakeGraph(500))
    assert t.stats()["graphs"] == 1 and t.get(("big",)) is not None
    del b
    gc.collect()
    assert t.stats()["graphs"] == 0 and t.stats()["bytes"] == 0
    t.put(("k", 4), a, _FakeGraph(1))
    t.clear()
    assert t.stats()["graphs"] == 0 and t.stats()["bytes"] == 0


def test_graph_budget_is_a_share_of_the_cards_free_memory(monkeypatch):
    """A table's budget is unset until its first pool, then
    GRAPH_MEMORY_SHARE of the card's free memory at that moment; a fixed
    budget stays; one pool a card."""
    free = {"now": 64 << 30}
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (free["now"], 80 << 30))
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(graphs, "Pool", lambda device: ("pool", str(device)))
    assert graphs.GRAPH_MEMORY_SHARE == 1 / 16
    assert graphs.graph_budget("cuda:0") == 4 << 30
    t = graphs.GraphTable()
    assert t.budget is None and t.stats()["budget"] is None
    p0 = t.pool("cuda:0")
    free["now"] = 16 << 30
    assert t.pool("cuda:0") is p0 and t.pool("cuda") is p0 and t.pool("cuda:1") is not p0
    assert t.budget == 4 << 30
    fixed = graphs.GraphTable(budget=123)
    fixed.pool("cuda:0")
    assert fixed.budget == 123
    assert graphs.GRAPHS.budget is None or graphs.GRAPHS.budget > 0
    assert graphs.CAPTURE_LOCK is __import__("pinot_tpu_torch.segment.segment", fromlist=["x"])._STAGE_LOCK


def test_a_retired_pool_takes_no_more_captures(monkeypatch):
    """After a failed capture the table retires its card's pool: the next
    capture there gets a new pool, the other cards keep theirs."""
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(graphs, "Pool", lambda device: object())
    t = graphs.GraphTable(budget=1)
    p0, p1 = t.pool("cuda:0"), t.pool("cuda:1")
    t.retire(p0)
    assert t.pool("cuda:0") is not p0 and t.pool("cuda:1") is p1
    t.retire(object())
    assert t.pool("cuda:1") is p1


def test_held_bytes_count_each_storage_once():
    a = torch.zeros(100, dtype=torch.int64)
    b = torch.zeros(10, dtype=torch.float32)
    assert graphs.held_bytes([a, a[10:20], a.view(10, 10), b]) == 800 + 40
    assert graphs.held_bytes([]) == 0


class _OrderPool:
    """A pool that logs each step of a use, and whether its lock was held."""

    def __init__(self, log):
        self.lock = threading.Lock()
        self.device = "cpu"
        self.log = log

    def begin(self):
        self.log.append(("begin", self.lock.locked()))

    def end(self):
        self.log.append(("end", self.lock.locked()))


def test_replay_orders_a_use_of_the_pool():
    """kernels.replay, the one helper every replay goes through (run_plan,
    dispatch_plan_packed, the sharded slot): under the pool's lock, the
    pool's last use awaited, the operands loaded, the replay, the outputs
    read, the captured counter bumps and records made, the use's end
    marked; the read's mask counts reach the records."""
    log = []
    w = _Wrapper()
    pool = _OrderPool(log)

    class _G:
        pass

    class _CG:
        def replay(self):
            log.append(("replay", pool.lock.locked()))

    class _Binding:
        def load(self, slab):
            log.append(("load", pool.lock.locked()))

    g = _G()
    g.pool, g.device, g.graph, g.slab = pool, "cpu", _CG(), None
    g.outputs = (torch.tensor([1.0, 2.0]), torch.tensor([7, 9]))
    g.captured = CapturedLaunches(launches=[("ops.grouped_planes", {"rows": 8}, None)] * 2, counters=[w])

    def read(outputs):
        log.append(("read", pool.lock.locked()))
        return K.read_cloned(outputs)

    real = KERNELS.replayed

    def replayed(*a, **k):
        log.append(("replayed", pool.lock.locked()))
        return real(*a, **k)

    KERNELS.replayed = replayed
    try:
        with KERNELS.collect() as sink:
            got, rec, launches = K.replay(g, _Binding(), "query.fused", read)
    finally:
        del KERNELS.replayed
    assert [step for step, _ in log] == ["begin", "load", "replay", "read", "replayed", "end"]
    assert all(held for _, held in log)
    assert rec is None and w.launches == 1 and len(launches) == 2 and launches == sink
    assert [int(p.masked) for p in launches] == [7, 9] and all(p.program == "query.fused" for p in launches)
    assert len(got) == 1 and torch.equal(got[0], g.outputs[0]) and got[0] is not g.outputs[0]


def test_replays_and_table_under_threads():
    """Query threads replay concurrently (the schedulers' runners, the
    broker's scatter): with a short switch interval, 16 threads each
    replaying 200 times lose no counter bump and no in-program record, and
    the table's bytes stay the sum of what it holds."""
    import sys
    import threading

    r = KernelRegistry()
    r.register("unit.k", cost_model=kernel_obs.streaming_cost)
    w = _Wrapper()
    cap = CapturedLaunches(launches=[("unit.k", {"rows": 8}, None)], counters=[w, w])
    table = graphs.GraphTable(budget=1000)
    owners = [_Owner() for _ in range(4)]
    errors = []

    def work(i):
        try:
            with r.collect() as sink:
                for j in range(200):
                    r.replayed(cap, "query.fused_packed")
                    key = ("k", i % 4, j % 8)
                    if table.get(key) is None:
                        table.put(key, owners[i % 4], _FakeGraph(10))
            for p in sink:
                p.masked = 1
            r.resolve(sink)
        except Exception as e:  # noqa: BLE001  # surfaced by the assertion below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors
    assert w.launches == 16 * 200 * 2
    assert r.in_program_snapshot()[("unit.k", "2^3", "query.fused_packed")]["calls"] == 16 * 200
    st = table.stats()
    assert st["bytes"] == 10 * st["graphs"] and st["graphs"] == 32
