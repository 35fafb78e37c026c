"""Upsert validity (`seg.extras["valid_docs"]`) through the port and the JAX
package: the single-segment cases of tests/test_upsert.py:332-399 and
tests/test_minion.py:264. The validity rides into the device program as a
docmask operand, into the host executor as an extra mask, and turns the
star-tree swap off. Its array may be mutated in place between queries (a
concurrent upsert): every query must read the current flags. Rows and
numDocsScanned must equal the reference's, exactly.

Then every case of tests/test_upsert.py through both packages: the upsert
and dedup metadata managers, the partial-merge strategies, and realtime
upsert / dedup tables consumed from a seeded stream, where each segment's
valid-doc mask, the upsert snapshot files (byte for byte, and each restored
by the other package) and the rows through each package's Broker must equal
the reference's."""

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


# -- the metadata managers and realtime upsert / dedup tables ---------------

import json  # noqa: E402
import threading  # noqa: E402
import time  # noqa: E402
from types import SimpleNamespace  # noqa: E402

import pinot_tpu.cluster as r_cluster  # noqa: E402
import pinot_tpu.common as r_common  # noqa: E402
import pinot_tpu.realtime as r_realtime  # noqa: E402
import pinot_tpu.upsert as r_upsert  # noqa: E402
import pinot_tpu_torch.cluster as p_cluster  # noqa: E402
import pinot_tpu_torch.common as p_common  # noqa: E402
import pinot_tpu_torch.realtime as p_realtime  # noqa: E402
import pinot_tpu_torch.upsert as p_upsert  # noqa: E402

REF = SimpleNamespace(name="ref", cluster=r_cluster, common=r_common, realtime=r_realtime, upsert=r_upsert,
                      server=lambda sid: r_cluster.Server(sid))
PORT = SimpleNamespace(name="port", cluster=p_cluster, common=p_common, realtime=p_realtime, upsert=p_upsert,
                       server=lambda sid: p_cluster.Server(sid, device="cpu"))
PKGS = (REF, PORT)


def _players(pkg):
    dt = pkg.common.DataType
    return pkg.common.Schema.build(
        "players",
        dimensions=[("pid", dt.INT), ("name", dt.STRING)],
        metrics=[("score", dt.LONG), ("deleted", dt.INT)],
        date_times=[("ts", dt.LONG)],
        primary_key_columns=["pid"],
    )


def _rt_config(pkg, **kw):
    c = pkg.common
    if "upsert" in kw:
        kw["upsert"] = c.UpsertConfig(**kw["upsert"])
    if "dedup" in kw:
        kw["dedup"] = c.DedupConfig(**kw["dedup"])
    return c.TableConfig("players", table_type=c.TableType.REALTIME, time_column="ts", **kw)


def _rt_cluster(pkg, root, config, partitions=1, max_rows=1000):
    controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / "deep")
    server = pkg.server("s0")
    controller.register_server("s0", server)
    schema = _players(pkg)
    controller.add_schema(schema)
    controller.add_table(config)
    stream = pkg.realtime.InMemoryStream(partitions=partitions)
    mgr = pkg.realtime.RealtimeTableManager(controller, server, schema, config, stream, max_rows_per_segment=max_rows)
    return controller, server, pkg.cluster.Broker(controller), stream, mgr


def _row(pid, name, score, ts, deleted=0):
    return {"pid": pid, "name": name, "score": score, "ts": ts, "deleted": deleted}


def _masks(mgr):
    """Partition -> segment -> valid-doc mask."""
    return {
        p: {s: vd.mask(vd.n).tolist() for s, vd in sorted(u._valid.items())}
        for p, u in sorted(mgr.upsert_managers.items())
    }


def _wait(pred, timeout=10.0):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return pred()


def _both(fn):
    out = {pkg.name: fn(pkg) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


def test_upsert_manager_latest_wins():
    def run(pkg):
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts")
        m.add_row("seg0", 0, {"pid": 1, "ts": 10})
        m.add_row("seg0", 1, {"pid": 1, "ts": 20})  # newer: wins
        m.add_row("seg0", 2, {"pid": 1, "ts": 15})  # out of order: loses
        m.add_row("seg0", 3, {"pid": 2, "ts": 5})
        m.add_row("seg0", 4, {"pid": 2, "ts": 5})  # a tie: the later arrival wins
        return m.valid_provider("seg0")(5).tolist(), m.num_primary_keys

    assert _both(run) == ([False, True, False, False, True], 2)


def test_upsert_manager_cross_segment_invalidation():
    def run(pkg):
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts")
        m.add_row("seg0", 0, {"pid": 1, "ts": 10})
        m.add_row("seg1", 0, {"pid": 1, "ts": 30})  # newer doc in a later segment
        return m.valid_provider("seg0")(1).tolist(), m.valid_provider("seg1")(1).tolist()

    assert _both(run) == ([False], [True])


def test_upsert_manager_delete_record():
    def run(pkg):
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts", delete_column="deleted")
        m.add_row("seg0", 0, {"pid": 1, "ts": 10})
        m.add_row("seg0", 1, {"pid": 1, "ts": 20, "deleted": 1})
        return m.valid_provider("seg0")(2).tolist(), m.num_primary_keys

    assert _both(run) == ([False, False], 0)


def test_upsert_snapshot_restore(tmp_path):
    def run(pkg):
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts")
        m.add_row("seg0", 0, {"pid": 1, "ts": 10})
        m.add_row("seg0", 1, {"pid": 2, "ts": 20})
        m.add_row("seg0", 2, {"pid": 1, "ts": 30})
        path = tmp_path / pkg.name / "snap.json"
        m.snapshot(path)
        m2 = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts")
        m2.restore(path)
        out = [m2.valid_provider("seg0")(3).tolist(), m2.num_primary_keys]
        # restored state keeps resolving conflicts correctly
        m2.add_row("seg1", 0, {"pid": 2, "ts": 25})
        return out + [m2.valid_provider("seg0")(3).tolist(), path.read_bytes()]

    got = _both(run)
    assert got[:3] == [[False, True, True], 2, [False, False, True]]


def _random_ops(seed, n=400):
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, 40, n).tolist()
    ts = rng.integers(0, 200, n).tolist()
    dels = (rng.random(n) < 0.05).astype(int).tolist()
    segs = [f"t__0__{i * 3 // n}" for i in range(n)]
    docs = [i - (i * 3 // n) * ((n + 2) // 3) for i in range(n)]
    return list(zip(segs, docs, pids, ts, dels))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_files_cross_restore(seed, tmp_path):
    """A seeded run of inserts, out-of-order rows, ties and deletes over 3
    segments: the snapshot files are the same bytes, a reference-written
    snapshot restores in the port and the reverse, and the restored masks
    and key counts equal the writer's."""
    ops = _random_ops(seed)
    mgrs, files = {}, {}
    for pkg in PKGS:
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts", delete_column="deleted")
        for seg, doc, pid, ts, dl in ops:
            m.add_row(seg, doc, {"pid": pid, "ts": ts, "deleted": dl})
        files[pkg.name] = tmp_path / f"{pkg.name}.json"
        m.snapshot(files[pkg.name])
        mgrs[pkg.name] = m
    assert files["port"].read_bytes() == files["ref"].read_bytes()
    for reader, writer in (("port", "ref"), ("ref", "port")):
        pkg = PORT if reader == "port" else REF
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts", delete_column="deleted")
        m.restore(files[writer])
        w = mgrs[writer]
        assert m.num_primary_keys == w.num_primary_keys
        for seg in w._valid:
            n = w._valid[seg].n
            assert m.valid_provider(seg)(n).tolist() == w.valid_provider(seg)(n).tolist()
        # and it goes on resolving as the writer does
        m.add_row("t__0__3", 0, {"pid": ops[-1][2], "ts": 10_000})
        w2 = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts", delete_column="deleted")
        w2.restore(files[reader])
        w2.add_row("t__0__3", 0, {"pid": ops[-1][2], "ts": 10_000})
        assert {s: m.valid_provider(s)(v.n).tolist() for s, v in m._valid.items()} == {
            s: w2.valid_provider(s)(v.n).tolist() for s, v in w2._valid.items()
        }


STRATEGIES = ["OVERWRITE", "IGNORE", "INCREMENT", "MAX", "MIN", "APPEND", "UNION"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_partial_merge_strategy(strategy):
    """Each strategy over present, absent and list values."""

    def run(pkg):
        out = []
        for prev, new in (({"pid": 1, "x": 10, "ts": 5}, {"pid": 1, "x": 7, "ts": 9}),
                          ({"pid": 1, "x": None, "ts": 5}, {"pid": 1, "x": 7, "ts": 9}),
                          ({"pid": 1, "x": 3, "ts": 5}, {"pid": 1, "x": None, "ts": 9}),
                          ({"pid": 1, "x": [1, 2], "ts": 5}, {"pid": 1, "x": [2, 3], "ts": 9})):
            if strategy in ("INCREMENT", "MAX", "MIN") and isinstance(prev["x"], list):
                continue
            out.append(sorted(pkg.upsert.merge_partial(prev, new, ["pid"], "ts", {"x": strategy}).items()))
        return out

    _both(run)


def test_partial_merge_strategies():
    def run(pkg):
        prev = {"pid": 1, "name": "a", "score": 10, "tags": [1], "ts": 5}
        new = {"pid": 1, "name": None, "score": 7, "tags": [2], "ts": 9}
        return pkg.upsert.merge_partial(prev, new, ["pid"], "ts", {"score": "INCREMENT", "tags": "UNION", "name": "IGNORE"})

    merged = _both(run)
    assert (merged["score"], merged["tags"], merged["name"], merged["ts"]) == (17, [1, 2], "a", 9)


def test_dedup_manager_ttl():
    def run(pkg):
        d = pkg.upsert.PartitionDedupMetadataManager(["pid"], metadata_ttl=10.0, time_column="ts")
        return [
            d.check_and_add({"pid": 1, "ts": 100}),
            d.check_and_add({"pid": 1, "ts": 101}),
            d.check_and_add({"pid": 2, "ts": 120}),  # past the TTL: pid 1 expires
            d.check_and_add({"pid": 1, "ts": 121}),
            d.check_and_add({"pid": 3, "ts": 50}),  # outside retention: rejected
        ]

    assert _both(run) == [True, False, True, True, False]


def test_dedup_ttl_amortized_eviction():
    def run(pkg):
        d = pkg.upsert.PartitionDedupMetadataManager(["pid"], metadata_ttl=100.0, time_column="ts")
        assert all(d.check_and_add({"pid": i, "ts": float(i)}) for i in range(1000))
        return d.num_primary_keys

    assert 100 <= _both(run) < 1000


def test_tombstone_blocks_late_older_record():
    def run(pkg):
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts", delete_column="deleted")
        m.add_row("seg0", 0, {"pid": 1, "ts": 10})
        m.add_row("seg0", 1, {"pid": 1, "ts": 20, "deleted": 1})  # tombstone @20
        m.add_row("seg0", 2, {"pid": 1, "ts": 15})  # older than the tombstone: loses
        out = [m.valid_provider("seg0")(3).tolist(), m.num_primary_keys]
        m.add_row("seg0", 3, {"pid": 1, "ts": 25})  # a newer record revives the key
        return out + [m.valid_provider("seg0")(4).tolist(), m.num_primary_keys]

    assert _both(run) == [[False, False, False], 0, [False, False, False, True], 1]


def test_valid_provider_survives_restore(tmp_path):
    def run(pkg):
        m = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts")
        m.add_row("seg0", 0, {"pid": 1, "ts": 10})
        provider = m.valid_provider("seg0")  # attached before restore
        m.snapshot(tmp_path / f"{pkg.name}.json")
        m.add_row("seg0", 1, {"pid": 1, "ts": 20})
        m.restore(tmp_path / f"{pkg.name}.json")  # back to only doc0 valid
        out = [provider(2).tolist()]
        m.add_row("seg1", 0, {"pid": 1, "ts": 30})  # post-restore update visible
        return out + [provider(2).tolist()]

    assert _both(run) == [[True, False], [False, False]]


def test_table_config_json_carries_upsert_and_dedup():
    """TableConfig.from_json takes upsertConfig and dedupConfig (it raised
    before the realtime slice) and both packages write the same JSON."""
    for kw in ({"upsert": {"mode": "PARTIAL", "comparison_column": "ts", "partial_strategies": {"score": "MAX"},
                           "delete_record_column": "deleted"}},
               {"dedup": {"metadata_ttl": 30.0, "dedup_time_column": "ts"}}):
        texts = {pkg.name: _rt_config(pkg, **kw).to_json() for pkg in PKGS}
        assert json.loads(texts["port"]) == json.loads(texts["ref"])
        back = p_common.TableConfig.from_json(texts["ref"])
        assert back.upsert == _rt_config(PORT, **kw).upsert and back.dedup == _rt_config(PORT, **kw).dedup
        assert json.loads(back.to_json()) == json.loads(texts["ref"])


def _consume(pkg, root, config_kw, rows, *, max_rows=1000, partitions=1, queries=(), after=None):
    """Produce `rows` (partition, row) into a fresh cluster, consume to the
    end, run `queries`; returns rows, valid masks and committed metadata."""
    config = _rt_config(pkg, **config_kw)
    controller, server, broker, stream, mgr = _rt_cluster(pkg, root, config, partitions, max_rows)
    for p, r in rows:
        stream.produce(p, r)
    mgr.start()
    try:
        assert mgr.wait_until_caught_up([stream.latest_offset(p) for p in range(partitions)])
        n_commits = sum(stream.latest_offset(p) // max_rows for p in range(partitions))
        assert _wait(lambda: sum("endOffset" in m for m in controller.all_segment_metadata("players").values())
                     >= n_commits)
        got = [broker.execute(q).rows for q in queries]
        extra = after(pkg, controller, server, mgr) if after else None
    finally:
        mgr.stop()
        broker.shutdown()
    committed = {n: (m["startOffset"], m["endOffset"], m["numDocs"])
                 for n, m in sorted(controller.all_segment_metadata("players").items()) if "endOffset" in m}
    return {"rows": got, "masks": _masks(mgr), "committed": committed, "extra": extra}


def test_full_upsert_end_to_end(tmp_path):
    rows = [(0, _row(i % 10, f"p{i % 10}", 100 + i, ts=i)) for i in range(50)]
    qs = ["SELECT COUNT(*) FROM players", "SELECT SUM(score) FROM players", "SELECT score FROM players WHERE pid = 3",
          "SELECT pid, name, score FROM players ORDER BY pid LIMIT 20"]
    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, {"upsert": {"mode": "FULL"}}, rows, queries=qs))
    assert int(got["rows"][0][0][0]) == 10  # one live row a key
    assert int(got["rows"][1][0][0]) == sum(range(140, 150))
    assert got["rows"][2] == [[143]]


def test_upsert_across_rollover(tmp_path):
    """Rows in committed segments are invalidated by newer consuming rows;
    the committed segments carry the same masks and snapshot bytes."""
    rows = [(0, _row(i % 10, f"p{i % 10}", 1000 + i, ts=i)) for i in range(60)]
    qs = ["SELECT COUNT(*) FROM players", "SELECT MAX(score) FROM players", "SELECT MIN(score) FROM players"]

    def snap(pkg, controller, server, mgr):
        path = tmp_path / f"{pkg.name}.snap.json"
        mgr.upsert_managers[0].snapshot(path)
        return path.read_bytes()

    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, {"upsert": {"mode": "FULL"}}, rows, max_rows=20,
                                     queries=qs, after=snap))
    assert [int(r[0][0]) for r in got["rows"]] == [10, 1059, 1050]
    assert len(got["committed"]) == 3


def test_partial_upsert_end_to_end(tmp_path):
    rows = [(0, _row(1, "alice", 10, ts=1)), (0, _row(1, "overwritten?", 5, ts=2)), (0, _row(1, "zzz", 3, ts=3))]
    cfg = {"upsert": {"mode": "PARTIAL", "partial_strategies": {"score": "INCREMENT", "name": "IGNORE"}}}
    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, cfg, rows,
                                     queries=["SELECT name, score FROM players WHERE pid = 1"]))
    assert got["rows"][0] == [["alice", 18]]  # IGNORE keeps the first name, INCREMENT sums


def test_partial_upsert_across_rollover_reads_committed_rows(tmp_path):
    """A PARTIAL merge whose previous row lies in a committed segment reads
    it through the reader attached on load."""
    rows = [(0, _row(i % 4, f"n{i}", 1, ts=i)) for i in range(30)]
    cfg = {"upsert": {"mode": "PARTIAL", "partial_strategies": {"score": "INCREMENT", "name": "IGNORE"}}}
    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, cfg, rows, max_rows=8,
                                     queries=["SELECT pid, name, score FROM players ORDER BY pid"]))
    assert got["rows"][0] == [[0, "n0", 8], [1, "n1", 8], [2, "n2", 7], [3, "n3", 7]]


def test_delete_record_end_to_end(tmp_path):
    rows = [(0, _row(1, "a", 10, ts=1)), (0, _row(2, "b", 20, ts=2)), (0, _row(1, "a", 0, ts=3, deleted=1))]
    cfg = {"upsert": {"mode": "FULL", "delete_record_column": "deleted"}}
    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, cfg, rows,
                                     queries=["SELECT COUNT(*) FROM players", "SELECT pid FROM players"]))
    assert int(got["rows"][0][0][0]) == 1 and got["rows"][1] == [[2]]


def test_dedup_end_to_end(tmp_path):
    rows = [(0, _row(i % 10, f"p{i}", 100 + i, ts=i)) for i in range(30)]
    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, {"dedup": {"enabled": True}}, rows,
                                     queries=["SELECT COUNT(*) FROM players", "SELECT score FROM players WHERE pid = 3"]))
    assert int(got["rows"][0][0][0]) == 10  # duplicates dropped at ingestion
    assert got["rows"][1] == [[103]]  # dedup keeps the FIRST row a key


def test_upsert_via_multistage_scan(tmp_path):
    """The multistage leaf scans honour the validity too."""
    rows = [(0, _row(i % 8, f"p{i % 8}", i, ts=i)) for i in range(40)]

    def ms(pkg, controller, server, mgr):
        snaps = mgr.consuming_snapshots()
        if pkg is REF:
            from pinot_tpu.multistage import MultistageEngine as ME

            eng = ME({"players": snaps}, n_workers=2)
        else:
            from pinot_tpu_torch.multistage import MultistageEngine as ME

            eng = ME({"players": snaps}, n_workers=2, device="cpu")
        return eng.execute("SELECT COUNT(*) FROM players p").rows

    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, {"upsert": {"mode": "FULL"}}, rows, after=ms))
    assert int(got["extra"][0][0]) == 8


def test_upsert_plus_dedup_rejected(tmp_path):
    for pkg in PKGS:
        config = _rt_config(pkg, upsert={"mode": "FULL"}, dedup={"enabled": True})
        with pytest.raises(ValueError, match="both upsert and dedup"):
            _rt_cluster(pkg, tmp_path / pkg.name, config)


def test_upsert_query_runs_on_device_path(tmp_path, monkeypatch):
    """Consuming and committed upsert segments run the device program with
    the validity as its docmask operand, never the host executor."""
    _no_host(monkeypatch)
    rows = [(0, _row(i % 10, f"p{i % 10}", 100 + i, ts=i)) for i in range(50)]
    qs = ["SELECT SUM(score) FROM players", "SELECT pid, COUNT(*) FROM players GROUP BY pid ORDER BY pid LIMIT 20"]
    got = _both(lambda pkg: _consume(pkg, tmp_path / pkg.name, {"upsert": {"mode": "FULL"}}, rows, max_rows=30,
                                     queries=qs))
    assert int(got["rows"][0][0][0]) == sum(range(140, 150))
    assert len(got["rows"][1]) == 10 and all(r[1] == 1 for r in got["rows"][1])


def test_device_upsert_mask_tracks_concurrent_invalidation():
    """The validity is a runtime operand: flipping it between queries
    changes the answer under the same plan spec (no respecialisation), as
    a query racing concurrent upsert ingestion sees."""
    schema = Schema.build("t", dimensions=[("pid", DataType.INT)], metrics=[("v", DataType.LONG)],
                          primary_key_columns=["pid"])
    n = 100
    data = {"pid": (np.arange(n) % 10).astype(np.int32), "v": np.arange(n, dtype=np.int64)}
    seg = SegmentBuilder(schema).build(data, "s0")
    live = np.zeros(n, dtype=bool)
    live[90:] = True  # the latest row a key
    seg.extras["valid_docs"] = lambda nd: live[:nd]
    eng = QueryEngine([seg], device="cpu")
    ctx = eng.make_context("SELECT SUM(v) FROM t")
    spec0 = plan_segment(seg, ctx).spec
    assert eng.execute("SELECT SUM(v) FROM t").rows[0][0] == sum(range(90, 100))
    live[:] = False
    live[80:90] = True
    assert eng.execute("SELECT SUM(v) FROM t").rows[0][0] == sum(range(80, 90))
    assert plan_segment(seg, ctx).spec == spec0


def test_validity_attaches_before_a_commit_is_queryable(tmp_path):
    """Queries racing rollovers of an upsert table never count a superseded
    row: each committed copy gets its validity before it becomes queryable,
    and the sealed copy keeps its own meanwhile."""
    config = _rt_config(PORT, upsert={"mode": "FULL"})
    controller, server, broker, stream, mgr = _rt_cluster(PORT, tmp_path, config, max_rows=40)
    seen, stop = [], threading.Event()

    def query():
        while not stop.is_set():
            seen.append(int(broker.execute("SELECT COUNT(*) FROM players").rows[0][0]))

    mgr.start()
    t = threading.Thread(target=query)
    t.start()
    try:
        for i in range(400):
            stream.produce(0, _row(i % 25, "x", i, ts=i))
            if i % 50 == 0:
                time.sleep(0.01)
        assert mgr.wait_until_caught_up([400])
        assert _wait(lambda: len(server.segments_of("players")) == 10)
    finally:
        stop.set()
        t.join()
        mgr.stop()
        broker.shutdown()
    assert seen and max(seen) <= 25
    assert all("valid_docs" in server.get_segment_object("players", n).extras for n in server.segments_of("players"))
    assert int(p_cluster.Broker(controller).execute("SELECT COUNT(*) FROM players").rows[0][0]) == 25


def test_upsert_restart_restores_validity(tmp_path):
    """A new manager over the same controller and server resumes at the
    committed end offsets and replays the committed segments' keys: the
    same masks and rows as before the restart, and as the reference's. The
    snapshot the first manager wrote restores to the same masks."""
    rows = [(i % 2, _row(i % 14, f"p{i}", i, ts=i if i % 9 else i - 30)) for i in range(200)]
    qs = ["SELECT COUNT(*), SUM(score) FROM players", "SELECT pid, score FROM players ORDER BY pid LIMIT 20"]

    def run(pkg):
        config = _rt_config(pkg, upsert={"mode": "FULL"})
        controller, server, broker, stream, mgr = _rt_cluster(pkg, tmp_path / pkg.name, config, 2, 30)
        for p, r in rows:
            stream.produce(p, r)
        mgr.start()
        assert mgr.wait_until_caught_up([100, 100])
        assert _wait(lambda: len(controller.all_segment_metadata("players")) == 6)
        before = [broker.execute(q).rows for q in qs]
        masks = _masks(mgr)
        snaps = {}
        for p, u in mgr.upsert_managers.items():
            snaps[p] = tmp_path / f"{pkg.name}.{p}.json"
            u.snapshot(snaps[p])
        mgr.stop()
        mgr2 = pkg.realtime.RealtimeTableManager(controller, server, _players(pkg), config, stream,
                                                 max_rows_per_segment=30)
        resumed = [(c.offset, c.sequence) for c in mgr2.consumers]
        mgr2.start()
        try:
            assert mgr2.wait_until_caught_up([100, 100])
            after = [broker.execute(q).rows for q in qs]
        finally:
            mgr2.stop()
            broker.shutdown()
        assert after == before and _masks(mgr2) == masks
        for p, path in snaps.items():
            restored = pkg.upsert.PartitionUpsertMetadataManager(["pid"], comparison_column="ts")
            restored.restore(path)
            assert {s: restored.valid_provider(s)(v.n).tolist() for s, v in restored._valid.items()} == masks[p]
        return {"rows": after, "masks": masks, "resumed": resumed, "snaps": {p: f.read_bytes() for p, f in snaps.items()}}

    got = _both(run)
    assert got["resumed"] == [(90, 3), (90, 3)]
