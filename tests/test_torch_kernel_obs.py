"""The port's kernel registry (common/kernel_obs.py) against the JAX
package's: the cases of tests/test_kernel_obs.py that have no JAX-only part
(the link-RTT probe, the jit caches and the HTTP surfaces wait for their
layers), and the engine's attribution: on the CPU every call of a kernel's
plain version through its wrapper records once, under the reference's
kernel name, with the bytes of chip_smoke.py's data-dependent bound. On the
card the same records come from CUDA events, read at resolve; here the
collector and resolve are driven with stand-in events."""

import time

import numpy as np
import pytest
import torch

from pinot_tpu.common import kernel_obs as jkernel_obs
from pinot_tpu.common.kernel_obs import KERNELS as JKERNELS
from pinot_tpu.common.kernel_obs import shape_bucket as jshape_bucket
from pinot_tpu_torch.common import kernel_obs
from pinot_tpu_torch.common.accounting import default_accountant
from pinot_tpu_torch.common.kernel_obs import KERNELS, HostHbmEstimator, KernelRegistry, shape_bucket
from pinot_tpu_torch.common.metrics import reset_registries, server_metrics
from pinot_tpu_torch.common.trace import start_trace
from pinot_tpu_torch.ops import extreme, groupby, grouped_sum_f32
from test_torch_pruner import pair, time_columns, time_partitioned


@pytest.fixture(autouse=True)
def _clean():
    KERNELS.configure(enabled=True)
    KERNELS.reset_stats()
    yield
    KERNELS.configure(enabled=True)
    KERNELS.reset_stats()


def _registry(**kw):
    r = KernelRegistry(**kw)
    r.register("unit.k", cost_model=lambda s: (s.get("rows", 0) * 8.0, s.get("rows", 0) * 2.0))
    return r


def test_shape_bucket_matches_reference():
    for n in [1, 2, 3, 1023, 1024, 1025, 2047, 2048, 0, -5, "x", None, 10**9, 2**40 + 1]:
        assert shape_bucket(n) == jshape_bucket(n)
    assert len({shape_bucket(n) for n in range(1, 1_000_000, 997)}) <= 21


def test_register_and_double_register():
    r = _registry()
    assert r.is_registered("unit.k") and r.kernel_names() == ["unit.k"]
    with pytest.raises(ValueError, match="already registered"):
        r.register("unit.k")


def test_record_unregistered_is_silent_noop():
    r = _registry()
    r.record("never.registered", 5.0, rows=10)
    assert r.stats_snapshot() == {}


def test_kernel_names_are_the_references():
    """The port's four kernels, the sharded program and the join exchange
    carry the JAX package's names, so a roofline row can be found across
    both packages."""
    import pinot_tpu.ops.groupby_pallas  # noqa: F401  (registers the reference's kernels)
    import pinot_tpu.parallel.mesh  # noqa: F401  (and its sharded program)
    import pinot_tpu.parallel.shuffle  # noqa: F401  (and its join exchange)
    import pinot_tpu_torch.parallel.mesh  # noqa: F401
    import pinot_tpu_torch.parallel.shuffle  # noqa: F401

    assert KERNELS.kernel_names() == [
        "exchange.join",
        "exchange.sharded",
        "ops.grouped_extreme",
        "ops.grouped_planes",
        "ops.grouped_planes2",
        "ops.grouped_sum",
    ]
    assert set(KERNELS.kernel_names()) <= set(JKERNELS.kernel_names())
    assert kernel_obs.DEFAULT_HBM_PEAK_GBPS == 3350.0


def test_record_matches_reference_ledger(monkeypatch):
    """The same records give the same stats and roofline rows as the
    reference's registry (its link RTT pinned to 0, as its tests do)."""
    monkeypatch.setattr(jkernel_obs, "_link_rtt_ms", lambda: 0.0)
    mine, ref = KernelRegistry(hbm_peak_gbps=10.0), jkernel_obs.KernelRegistry(hbm_peak_gbps=10.0)
    for r in (mine, ref):
        r.register("m.k", cost_model=lambda s: (1e9 * s["rows"] / 16, 2e9))
        r.register("tiny", cost_model=lambda s: (1e4, 0.0))
        r.record("m.k", 1000.0, rows=16)
        r.record("m.k", 500.0, rows=20)
        r.record("tiny", 1.0, rows=1)
        r.record("tiny", 0.0, rows=4096)
    assert mine.stats_snapshot() == ref.stats_snapshot()
    a, b = mine.roofline(), ref.roofline()
    assert a["kernels"] == b["kernels"] and a["offenders"] == b["offenders"] and a["hbmPeakGBps"] == b["hbmPeakGBps"]
    assert a["hbm"] == b["hbm"]


def test_launch_records_host_wall_on_the_cpu():
    r = _registry()
    mask = torch.tensor([True, False, True, True])
    out = r.launch("unit.k", lambda: (time.sleep(0.005), 42)[1], mask, rows=1024)
    assert out == 42
    s = r.stats_snapshot()[("unit.k", "2^10")]
    assert s["calls"] == 1 and s["deviceMs"] >= 4.0
    assert s["bytesMoved"] == 1024 * 8.0 and s["flops"] == 1024 * 2.0
    assert r.total_device_ms() == pytest.approx(s["deviceMs"])


def test_disabled_registry_records_nothing():
    r = _registry()
    r.configure(enabled=False)
    assert not r.enabled
    assert r.launch("unit.k", lambda: 7, torch.ones(8, dtype=torch.bool), rows=8) == 7
    assert r.stats_snapshot() == {}


def test_hbm_estimator_math():
    h = HostHbmEstimator()
    h.alloc(100)
    h.alloc(50)
    assert (h.live, h.peak) == (150, 150)
    h.free(50)
    assert (h.live, h.peak) == (100, 150)
    assert h.transient(200) == 300
    assert (h.live, h.peak) == (100, 300)
    h.free(10_000)
    assert h.live == 0
    h.reset()
    assert (h.live, h.peak) == (0, 0)


def test_hbm_snapshot_is_the_estimator_without_a_card():
    r = _registry()
    r.record("unit.k", 1.0, rows=100)
    assert r.hbm_snapshot() == {"liveBytes": 0, "peakBytes": 800, "source": "estimator"}


def test_record_emits_labelled_metric_families():
    reset_registries()
    r = _registry()
    r.record("unit.k", 3.0, rows=1024)
    r.record("unit.k", 2.0, rows=1024)
    reg = server_metrics()
    assert reg.timer("engine.kernel.deviceMs", kernel="unit.k", shape="2^10").count == 2
    assert reg.meter("engine.kernel.invocations", kernel="unit.k", shape="2^10").count == 2
    assert reg.meter("engine.kernel.bytesMoved", kernel="unit.k", shape="2^10").count == 2 * 1024 * 8
    assert reg.gauge("engine.hbm.peakBytes").value == 1024 * 8


def test_device_ms_attributed_to_query_scope():
    default_accountant.reset_rollups()
    r = _registry()
    with default_accountant.scope("kq-1", table="t", tenant="gold"):
        r.record("unit.k", 5.0, rows=100)
        r.record("unit.k", 2.5, rows=100)
    st = default_accountant.recent_query_stats("kq-1")
    assert st["deviceMs"] == pytest.approx(7.5) and st["peakHbmBytes"] == 800
    default_accountant.merge_recent("kq-1", {"deviceMs": 2.5, "peakHbmBytes": 500})
    assert default_accountant.recent_query_stats("kq-1") == {"deviceMs": 10.0, "peakHbmBytes": 800}
    with default_accountant.scope("kq-2", table="t", tenant="gold"):
        r.record("unit.k", 6.0, rows=1000)
    (roll,) = [w for w in default_accountant.workload_rollups() if w["table"] == "t" and w["tenant"] == "gold"]
    assert roll["deviceMs"] == pytest.approx(13.5) and roll["peakHbmBytes"] == 8000


def test_record_lands_on_active_trace():
    r = _registry()
    with start_trace("req-7") as tr:
        r.record("unit.k", 2.5, rows=64)
    d = tr.to_dict()
    (ev,) = [e for e in d.get("events", []) if e["name"] == "kernel.execute"]
    assert ev["attrs"] == {"kernel": "unit.k", "shape": "2^6", "deviceMs": 2.5, "bytesMoved": 512}
    assert d["phaseTimesMs"]["deviceExecution"] == pytest.approx(2.5)


class _Event:
    """A stand-in for a completed torch.cuda.Event pair."""

    def __init__(self, t_ms: float):
        self.t_ms = t_ms
        self.waited = False

    def elapsed_time(self, end) -> float:
        return end.t_ms - self.t_ms

    def synchronize(self) -> None:
        self.waited = True


def test_collector_and_resolve():
    """The card's path with stand-in events: launches made inside collect()
    queue on its list, resolve() records each with its event time and its
    mask count; a launch outside any collector waits for its end event when
    a snapshot is read."""
    r = KernelRegistry()
    r.register("unit.k", cost_model=kernel_obs.streaming_cost)
    with r.collect() as sink:
        sink.append(kernel_obs._Pending("unit.k", _Event(1.0), _Event(3.5), torch.tensor(7), {"rows": 100, "per_doc": 8, "out_bytes": 16}))
        sink.append(kernel_obs._Pending("unit.k", _Event(0.0), _Event(0.5), torch.tensor(3), {"rows": 100, "per_doc": 8, "out_bytes": 16}))
    assert kernel_obs._COLLECTOR.get() is None
    assert r.stats_snapshot() == {}
    r.resolve(sink)
    s = r.stats_snapshot()[("unit.k", "2^6")]
    assert s == {"calls": 2, "deviceMs": 3.0, "bytesMoved": (100 + 7 * 8 + 16) + (100 + 3 * 8 + 16), "flops": 10.0}
    end = _Event(2.0)
    r._orphans.append(kernel_obs._Pending("unit.k", _Event(1.0), end, torch.tensor(1), {"rows": 100}))
    assert r.stats_snapshot()[("unit.k", "2^6")]["calls"] == 3 and end.waited
    assert r._orphans == []


@pytest.fixture(scope="module")
def tp():
    return pair("t", time_columns, time_partitioned())


def _spy(monkeypatch, module, name, shape_of):
    """Count the calls of a plain version reached through its wrapper and
    reckon each call's bytes from its own inputs."""
    calls = []
    real = getattr(module, name)

    def spy(*a, **k):
        calls.append(shape_of(*a, **k))
        return real(*a, **k)

    monkeypatch.setattr(module, name, spy)
    return calls


def _planes_bytes(values, gid, mask, ng):
    k, masked = len(values), int(mask.sum())
    return gid.numel() + masked * (4 + 4 * k) + (k + 1) * ng * 8


def _extreme_bytes(columns, outputs, gid, mask, ng, counts=None):
    used = dict.fromkeys(c for c, _ in outputs)
    out = sum(ng * (4 if columns[c].dtype == torch.float32 else 8) for c, _ in outputs) + (ng * 8 if counts is not None else 0)
    return gid.numel() + int(mask.sum()) * (4 + sum(columns[c].element_size() for c in used)) + out


def _presence_bytes(columns, pads, mask, gid=None, ng=1):
    per_doc = 4 * len(columns) + (4 if gid is not None else 0)
    return mask.numel() + int(mask.sum()) * per_doc + ng * sum(pads)


@pytest.mark.parametrize(
    "sql",
    [
        "SELECT region, city, SUM(revenue), COUNT(*), MIN(qty), MAX(qty) FROM t WHERE year = 1997 GROUP BY region, city "
        "ORDER BY SUM(revenue) DESC LIMIT 1000",
        "SELECT region, DISTINCTCOUNT(city), MAX(qty) FROM t WHERE year >= 1996 GROUP BY region",
        "SELECT DISTINCTCOUNT(city), DISTINCTCOUNT(custkey) FROM t WHERE year <> 1995",
        "SELECT custkey, SUM(qty) FROM t WHERE year BETWEEN 1997 AND 1998 GROUP BY custkey ORDER BY SUM(qty) DESC LIMIT 5",
    ],
)
def test_engine_records_every_kernel_call(tp, sql, monkeypatch):
    """Over a query, each kernel's registry calls equal the calls of its
    plain version through the wrapper (on the card: its launch counter), and
    its bytes the byte model reckoned from those calls' own inputs."""
    _, ports = tp
    spies = {
        "ops.grouped_planes": _spy(monkeypatch, groupby, "grouped_multi_sum_plain", _planes_bytes),
        "ops.grouped_extreme": _spy(monkeypatch, extreme, "grouped_extremes_plain", _extreme_bytes),
        "ops.grouped_sum": _spy(monkeypatch, grouped_sum_f32, "presences_plain", _presence_bytes),
    }
    ports["built"].execute(sql)
    snap = KERNELS.stats_snapshot()
    assert sum(spies.values(), []), "the query reached no kernel"
    for name, calls in spies.items():
        rows = [v for (k, _), v in snap.items() if k == name]
        assert sum(v["calls"] for v in rows) == len(calls), name
        assert sum(v["bytesMoved"] for v in rows) == sum(calls), name
    assert all(r["pctOfPeak"] <= 100 for r in KERNELS.roofline()["kernels"])


def test_disabled_registry_changes_no_result(tp):
    _, ports = tp
    sql = "SELECT region, SUM(revenue), MIN(qty) FROM t WHERE year = 1996 GROUP BY region ORDER BY region"
    on = ports["built"].execute(sql).rows
    assert KERNELS.stats_snapshot()
    KERNELS.reset_stats()
    KERNELS.configure(enabled=False)
    assert ports["built"].execute(sql).rows == on
    assert KERNELS.stats_snapshot() == {}


def test_two_level_wrapper_records_as_planes2():
    g = torch.tensor([0, 5, 5, 9], dtype=torch.int32)
    m = torch.tensor([True, True, False, True])
    v = torch.tensor([1, 2, 3, 4], dtype=torch.int32)
    groupby.grouped_multi_sum_2l([v], g, m, 16)
    snap = KERNELS.stats_snapshot()
    assert snap[("ops.grouped_planes2", "2^2")]["calls"] == 1
    assert snap[("ops.grouped_planes2", "2^2")]["bytesMoved"] == 4 + 3 * 8 + 2 * 16 * 8
