"""Upsert validity (`seg.extras["valid_docs"]`) through the port and the JAX
package: the single-segment cases of tests/test_upsert.py:332-399 and
tests/test_minion.py:264. The validity rides into the device program as a
docmask operand, into the host executor as an extra mask, and turns the
star-tree swap off. Its array may be mutated in place between queries (a
concurrent upsert): every query must read the current flags. Rows and
numDocsScanned must equal the reference's, exactly."""

import numpy as np
import pytest

from pinot_tpu.common import DataType as JDT
from pinot_tpu.common import Schema as JSchema
from pinot_tpu.common.config import IndexingConfig as JIndexingConfig
from pinot_tpu.common.config import StarTreeIndexConfig as JStarTreeIndexConfig
from pinot_tpu.common.config import TableConfig as JTableConfig
from pinot_tpu.query import QueryEngine as JEngine
from pinot_tpu.segment import SegmentBuilder as JBuilder
from pinot_tpu_torch.common import DataType, IndexingConfig, Schema, StarTreeIndexConfig, TableConfig
from pinot_tpu_torch.query import QueryEngine
from pinot_tpu_torch.query import kernels as kernels_mod
from pinot_tpu_torch.query.plan import plan_segment
from pinot_tpu_torch.segment import SegmentBuilder, segment_from_numpy
from test_torch_pruner import assert_same_result
from test_torch_segment import describe


def pid_columns(DT):
    return dict(dimensions=[("pid", DT.INT), ("team", DT.STRING)], metrics=[("v", DT.LONG)])


def _pid_data(n: int = 100) -> dict:
    return {
        "pid": (np.arange(n) % 10).astype(np.int32),
        "team": np.asarray(["red", "blue", "green"], dtype=object)[np.arange(n) % 3],
        "v": np.arange(n, dtype=np.int64),
    }


def _pair(live: np.ndarray, star=None):
    """(reference segment, [port segments: built, carried]) over _pid_data,
    each with a validity reading `live` (a view: mutations show)."""
    jcfg = JTableConfig("t", indexing=JIndexingConfig(star_tree_configs=[JStarTreeIndexConfig(*star)] if star else []))
    cfg = TableConfig("t", IndexingConfig(star_tree_configs=[StarTreeIndexConfig(*star)] if star else []))
    data = _pid_data(len(live))
    jseg = JBuilder(JSchema.build("t", **pid_columns(JDT)), jcfg).build(data, "s0")
    segs = [SegmentBuilder(Schema.build("t", **pid_columns(DataType)), cfg).build(data, "s0"),
            segment_from_numpy(describe(jseg))]
    for s in [jseg, *segs]:
        s.extras["valid_docs"] = lambda nd: live[:nd]
    return jseg, segs


def _no_host(monkeypatch):
    def no_host(*a, **k):
        raise AssertionError("an upsert segment took the host path")

    monkeypatch.setattr("pinot_tpu_torch.query.engine.host_exec.execute_segment", no_host)


QUERIES = [
    "SELECT SUM(v) FROM t",
    "SELECT COUNT(*), MIN(v), MAX(v), AVG(v) FROM t WHERE team <> 'green'",
    "SELECT pid, COUNT(*), SUM(v) FROM t GROUP BY pid ORDER BY pid LIMIT 20",
    "SELECT team, DISTINCTCOUNT(pid) FROM t GROUP BY team ORDER BY team",
    "SELECT DISTINCTCOUNT(pid), DISTINCTCOUNTHLL(pid) FROM t",
    "SELECT DISTINCT team FROM t ORDER BY team",
    "SELECT pid, v FROM t ORDER BY v DESC LIMIT 5",
    "SELECT pid, v FROM t WHERE v > 50 LIMIT 50",
    "SET enableNullHandling = true; SELECT SUM(v), COUNT(*) FROM t WHERE v > 95",
]


@pytest.mark.parametrize("sql", QUERIES)
def test_upsert_queries_run_on_the_device_and_track_mutation(sql, monkeypatch):
    """tests/test_upsert.py:370's case: the latest row of each pid valid,
    then the validity flipped in place to an older set; every query through
    the device program, each answer the reference's."""
    live = np.zeros(100, dtype=bool)
    live[90:] = True
    jseg, segs = _pair(live)
    ref = JEngine([jseg])
    ports = [QueryEngine([s], device="cpu") for s in segs]
    _no_host(monkeypatch)
    for flip in range(2):
        want = ref.execute(sql)
        for port in ports:
            port.segment_modes.clear()
            assert_same_result(port.execute(sql), want, sql)
            assert dict(port.segment_modes) == {"device": 1}
        live[:] = False
        live[80:90] = True


def test_upsert_mask_is_an_operand_not_a_constant():
    """The same spec before and after the flip (a runtime operand), and the
    validity never becomes a stable operand: no array of the validity is
    held by the operand cache."""
    live = np.zeros(100, dtype=bool)
    live[90:] = True
    _, segs = _pair(live)
    eng = QueryEngine([segs[0]], device="cpu")
    ctx = eng.make_context("SELECT SUM(v) FROM t")
    plan0 = plan_segment(segs[0], ctx)
    assert eng.execute("SELECT SUM(v) FROM t").rows[0][0] == sum(range(90, 100))
    live[:] = False
    live[80:90] = True
    assert eng.execute("SELECT SUM(v) FROM t").rows[0][0] == sum(range(80, 90))
    plan1 = plan_segment(segs[0], ctx)
    assert plan1.spec == plan0.spec
    assert plan1.spec[1][0] == "and" and plan1.spec[1][1][0][0] == "docmask"
    with kernels_mod._OP_CACHE_LOCK:
        held = [ref() for ref in kernels_mod._STABLE_OPS.values()]
    assert not any(o is not None and o.shape[0] >= 100 and o.dtype == bool and o[:100].tolist() == live.tolist()
                   and np.shares_memory(o, live) for o in held)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT MODE(v), PERCENTILE(v, 50) FROM t",
        "SELECT pid, PERCENTILE(v, 50), STDDEV_POP(v) FROM t GROUP BY pid ORDER BY pid",
        "SELECT v, COUNT(*) FROM t GROUP BY v ORDER BY v LIMIT 30",
        "SELECT PERCENTILETDIGEST(v, 90), STDDEV_SAMP(v) FROM t WHERE team = 'red'",
    ],
)
def test_upsert_host_path_keeps_the_mask(sql):
    """Queries the reference answers on its host: the validity is ANDed into
    the host executor's mask."""
    live = np.zeros(100, dtype=bool)
    live[::7] = True
    jseg, segs = _pair(live)
    want = JEngine([jseg]).execute(sql)
    for s in segs:
        port = QueryEngine([s], device="cpu")
        assert_same_result(port.execute(sql), want, sql)
        assert "host" in port.segment_modes


@pytest.mark.parametrize(
    "sql",
    ["SELECT team, SUM(v) FROM t GROUP BY team ORDER BY team", "SELECT team, COUNT(*) FROM t GROUP BY team ORDER BY team"],
)
def test_upsert_skips_the_star_tree(sql):
    """A star tree pre-aggregates every doc: under a validity the per-doc
    program runs, and the rows count the valid docs alone."""
    live = np.zeros(99, dtype=bool)
    live[::4] = True
    jseg, segs = _pair(live, star=(["team"], ["SUM__v", "COUNT__*"]))
    want = JEngine([jseg]).execute(sql)
    for s in segs:
        port = QueryEngine([s], device="cpu")
        got = port.execute(sql)
        assert_same_result(got, want, sql)
        assert dict(port.segment_modes) == {"device": 1}
    # without the validity the same query takes the star tree
    for s in segs:
        s.extras.pop("valid_docs")
        port = QueryEngine([s], device="cpu")
        port.execute(sql)
        assert dict(port.segment_modes) == {"startree": 1}


def test_compacted_validity_selects_latest():
    """tests/test_minion.py:264's validity: the latest doc of each key valid
    (2 of 4)."""
    cols = lambda DT: dict(dimensions=[("pk", DT.STRING)], metrics=[("value", DT.LONG), ("ts", DT.LONG)])  # noqa: E731
    data = {
        "pk": np.asarray(["a", "a", "a", "b"], dtype=object),
        "value": np.asarray([1, 2, 3, 9], dtype=np.int64),
        "ts": np.asarray([1, 2, 3, 1], dtype=np.int64),
    }
    jseg = JBuilder(JSchema.build("ups", **cols(JDT))).build(data, "u0")
    seg = SegmentBuilder(Schema.build("ups", **cols(DataType))).build(data, "u0")
    for s in (jseg, seg):
        s.extras["valid_docs"] = lambda n: np.asarray([False, False, True, True])
    sql = "SELECT pk, value FROM ups ORDER BY pk LIMIT 10"
    got = QueryEngine([seg], device="cpu").execute(sql)
    assert_same_result(got, JEngine([jseg]).execute(sql), sql)
    assert [list(r) for r in got.rows] == [["a", 3], ["b", 9]]
