"""The port's distributed multistage stages against the JAX package's.

Mirrors tests/test_multistage_distributed.py: two servers, each behind its
own ServerHTTPService on a localhost socket and registered with the
controller as a RemoteServerClient, so the broker dispatches the stages to
the servers and every stage-to-stage block crosses a socket through
/mailbox. The same seeded data goes through the reference's cluster of the
same shape; rows must be equal (exact: the sums are of int64 columns).
Plans, placements and mailbox envelopes must be equal too, byte for byte.
"""

import json
import urllib.error
import urllib.request

import numpy as np
import pandas as pd
import pytest

import pinot_tpu.cluster as rc
import pinot_tpu.cluster.http as rhttp
import pinot_tpu_torch.cluster as pc
import pinot_tpu_torch.cluster.http as phttp
from pinot_tpu.common import DataType as RDataType, Schema as RSchema, TableConfig as RTableConfig
from pinot_tpu.segment import SegmentBuilder as RSegmentBuilder
from pinot_tpu_torch.common import DataType, Schema, TableConfig
from pinot_tpu_torch.segment import SegmentBuilder

N_ORDERS, N_CUST = 4000, 50

QUERIES = [
    # the headline: a JOIN whose hash exchange crosses server boundaries
    "SELECT c.cnation, SUM(o.amount) FROM orders o JOIN customers c ON o.ocid = c.cid "
    "GROUP BY c.cnation ORDER BY c.cnation LIMIT 20",
    "SET useMultistageEngine=true; SELECT status, COUNT(*) FROM orders GROUP BY status ORDER BY status LIMIT 10",
    "SELECT COUNT(*) FROM orders o JOIN customers c ON o.ocid = c.cid WHERE o.status = 'OPEN' AND c.credit > 50000",
    # bench.py config 6's shape: the leaf aggregates each orders segment
    "SELECT c.cnation, SUM(o.amount) FROM orders o JOIN customers c ON o.ocid = c.cid "
    "GROUP BY c.cnation ORDER BY SUM(o.amount) DESC",
    # a lookup join with ORDER BY over the joined rows
    "SELECT o.ocid, c.cnation, o.amount FROM orders o JOIN customers c ON o.ocid = c.cid "
    "ORDER BY o.amount DESC, o.ocid LIMIT 15",
]


def _data():
    rng = np.random.default_rng(7)
    odata = {
        "ocid": rng.integers(0, N_CUST, N_ORDERS).astype(np.int32),
        "status": np.array(["OPEN", "SHIPPED", "CLOSED"], dtype=object)[rng.integers(0, 3, N_ORDERS)],
        "amount": rng.integers(1, 10_000, N_ORDERS).astype(np.int64),
    }
    cdata = {
        "cid": np.arange(N_CUST, dtype=np.int32),
        "cnation": np.array([f"N{i % 7}" for i in range(N_CUST)], dtype=object),
        "credit": rng.integers(0, 100_000, N_CUST).astype(np.int64),
    }
    return odata, cdata


def _cluster(pkg, root):
    """Two HTTP servers of package `pkg` behind a broker of the same package:
    (broker, controller, in-process servers, services)."""
    cl, http, dt, sch, tc, sb = pkg
    controller = cl.Controller(cl.PropertyStore(), root / "deepstore")
    kw = {"device": "cpu"} if cl is pc else {}
    inner = {f"server_{i}": cl.Server(f"server_{i}", **kw) for i in range(2)}
    services = {sid: http.ServerHTTPService(s, port=0) for sid, s in inner.items()}
    for sid, svc in services.items():
        controller.register_server(sid, http.RemoteServerClient(f"http://127.0.0.1:{svc.port}"))
    orders = sch.build("orders", dimensions=[("ocid", dt.INT), ("status", dt.STRING)], metrics=[("amount", dt.LONG)])
    customers = sch.build("customers", dimensions=[("cid", dt.INT), ("cnation", dt.STRING)], metrics=[("credit", dt.LONG)])
    controller.add_schema(orders)
    controller.add_schema(customers)
    controller.add_table(tc("orders", replication=1))
    controller.add_table(tc("customers", replication=1))
    odata, cdata = _data()
    for i in range(4):  # spread across both servers
        part = {k: v[i * 1000 : (i + 1) * 1000] for k, v in odata.items()}
        controller.upload_segment("orders", sb(orders).build(part, f"orders_{i}"))
    controller.upload_segment("customers", sb(customers).build(cdata, "customers_0"))
    return cl.Broker(controller, **kw), controller, inner, services


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    port = _cluster((pc, phttp, DataType, Schema, TableConfig, SegmentBuilder), tmp_path_factory.mktemp("msd_port"))
    ref = _cluster(
        (rc, rhttp, RDataType, RSchema, RTableConfig, RSegmentBuilder), tmp_path_factory.mktemp("msd_ref")
    )
    yield {"port": port, "ref": ref}
    for broker, _, _, services in (port, ref):
        for svc in services.values():
            svc.stop()
        if getattr(broker, "_dispatcher", None) is not None:
            broker._dispatcher.stop()
    port[0].shutdown()


def test_segments_span_both_servers(clusters):
    for _, _, inner, _ in clusters.values():
        hosted = {sid: s.segments_of("orders") for sid, s in inner.items()}
        assert all(hosted.values()), f"orders segments must span both servers: {hosted}"


@pytest.mark.parametrize("sql", QUERIES)
def test_distributed_rows_equal_reference(clusters, sql):
    got = clusters["port"][0].execute(sql)
    want = clusters["ref"][0].execute(sql)
    assert got.columns == want.columns
    assert got.rows == want.rows
    assert got.total_docs == want.total_docs
    # the DISTRIBUTED path ran (not the in-process fallback)
    assert clusters["port"][0]._dispatcher is not None


def test_join_matches_pandas_truth(clusters):
    odata, cdata = _data()
    ot, ct = pd.DataFrame(odata), pd.DataFrame(cdata)
    truth = ot.merge(ct, left_on="ocid", right_on="cid").groupby("cnation").amount.sum().sort_index()
    rows = clusters["port"][0].execute(QUERIES[0]).rows
    assert rows == [[k, float(v)] for k, v in truth.items()]


def test_leaf_runs_the_single_stage_engine_in_the_servers(clusters):
    """Config 6's shape: the orders leaf is one exact group-by a segment,
    run by the servers' QueryEngine (the plain version of B1 on the CPU,
    counted by the kernel registry)."""
    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.common.kernel_obs import KERNELS

    def calls():
        return sum(v["calls"] for (k, _), v in KERNELS.stats_snapshot().items() if k == "ops.grouped_planes")

    broker = pc.Broker(clusters["port"][1], cache_config=CacheConfig(enabled=False), device="cpu")
    try:
        before = calls()
        rows = broker.execute(QUERIES[3]).rows
        assert calls() - before == 4
        assert broker._dispatcher is not None
    finally:
        broker.shutdown()
    assert rows == clusters["ref"][0].execute(QUERIES[3]).rows


def test_plan_determinism_with_row_counts():
    """The broker ships its row-count snapshot so every process rebuilds the
    same plan; the port's build_plan and plan_placement give the
    reference's stages, exchanges, parallelism and placement."""
    from pinot_tpu.multistage.distributed import build_plan as r_build, plan_placement as r_place
    from pinot_tpu.query.sql import parse_sql as r_parse
    from pinot_tpu_torch.multistage.distributed import build_plan, plan_placement
    from pinot_tpu_torch.query.sql import parse_sql

    schemas = {"fact": ["fid", "fdid", "val"], "dim": ["did", "dname"]}
    rcounts = {"fact": 1_000_000, "dim": 500}
    sql = "SELECT d.dname, SUM(f.val) FROM fact f JOIN dim d ON f.fdid = d.did GROUP BY d.dname"
    for counts in (rcounts, None):
        plan = build_plan(parse_sql(sql), schemas, 4, counts)
        ref = r_build(r_parse(sql), schemas, 4, counts)
        assert {i: s.dist for i, s in plan.stages.items()} == {i: s.dist for i, s in ref.stages.items()}
        assert {i: list(s.inputs) for i, s in plan.stages.items()} == {i: list(s.inputs) for i, s in ref.stages.items()}
        table_servers = {"fact": ["s0", "s1", "s2"], "dim": ["s1"]}
        got = plan_placement(plan, table_servers, ["s0", "s1", "s2"], 4)
        want = r_place(ref, table_servers, ["s0", "s1", "s2"], 4)
        assert got == want
    assert "broadcast" in {s.dist for s in build_plan(parse_sql(sql), schemas, 4, rcounts).stages.values()}
    assert "broadcast" not in {s.dist for s in build_plan(parse_sql(sql), schemas, 4, None).stages.values()}


def _stage_shapes(plan):
    return {i: (s.dist, list(s.inputs), s.parallelism) for i, s in plan.stages.items()}


def test_distributed_plan_with_the_brokers_ndv(clusters, monkeypatch):
    """The submit body carries the broker's row counts and NDV bounds: they
    are Catalog.from_segments's over the same segments, so a server that
    rebuilds the plan from the body gets the in-process engine's plan and
    the broker's parallelism and placement. The reference's servers ignore
    `ndv` and would plan config 6's shape without the aggregate below the
    join, which is why the broker and its servers are of one package."""
    from pinot_tpu_torch.multistage import logical as L
    from pinot_tpu_torch.multistage.distributed import BROKER_ID, apply_parallelism, build_plan, plan_placement
    from pinot_tpu_torch.query.sql import parse_sql

    docs = []
    real = phttp.RemoteServerClient.multistage_submit
    monkeypatch.setattr(
        phttp.RemoteServerClient, "multistage_submit", lambda self, doc: (docs.append(doc), real(self, doc))[1]
    )
    from pinot_tpu_torch.common.config import CacheConfig

    sql = QUERIES[3]
    broker = pc.Broker(clusters["port"][1], cache_config=CacheConfig(enabled=False), device="cpu")
    try:
        rows = broker.execute(sql).rows
    finally:
        broker.shutdown()
    assert rows == clusters["ref"][0].execute(sql).rows
    assert len(docs) == 2 and all(d["ndv"] == docs[0]["ndv"] for d in docs)
    doc = docs[0]
    segs = {
        t: [s.get_segment_object(t, n) for s in clusters["port"][2].values() for n in s.segments_of(t)]
        for t in ("orders", "customers")
    }
    cat = L.Catalog.from_segments(segs)
    assert doc["ndv"] == cat.ndv and doc["ndv"]["orders"] and doc["ndv"]["customers"]
    assert doc["row_counts"] == cat.row_counts

    plan = build_plan(parse_sql(sql), doc["schemas"], doc["n_workers"], doc["row_counts"], doc["ndv"])
    in_process = L.build_stage_plan(parse_sql(sql), cat, doc["n_workers"])
    assert {i: (s.dist, list(s.inputs)) for i, s in plan.stages.items()} == {
        i: (s.dist, list(s.inputs)) for i, s in in_process.stages.items()
    }
    table_servers = {t: sorted(d["target"] for d in docs if d["segments"].get(t)) for t in ("orders", "customers")}
    all_servers = sorted(a for a in doc["addresses"] if a != BROKER_ID)
    parallelism, placement = plan_placement(plan, table_servers, all_servers, doc["n_workers"])
    assert {str(k): v for k, v in parallelism.items()} == doc["parallelism"]
    assert sorted([sid, w, o] for (sid, w), o in placement.items()) == sorted(doc["placement"])
    apply_parallelism(plan, parallelism)
    without_ndv = build_plan(parse_sql(sql), doc["schemas"], doc["n_workers"], doc["row_counts"], None)
    assert _stage_shapes(without_ndv) != _stage_shapes(plan)


def test_root_stage_runs_on_the_brokers_device(clusters, monkeypatch):
    """The broker's root stage runs its device operators on the broker's
    device, through the gates every stage has: with the sort gate lowered,
    the root's ORDER BY sorts on `device` in the broker's own thread."""
    import threading

    from pinot_tpu_torch.common.config import CacheConfig
    from pinot_tpu_torch.multistage import runtime as R

    seen = []
    real = R._device_sort_perm

    def spy(keys, descs, device="cuda"):
        seen.append((str(device), threading.current_thread().name))
        return real(keys, descs, device)

    monkeypatch.setattr(R, "DEVICE_SORT_MIN", 1)
    monkeypatch.setattr(R, "_device_sort_perm", spy)
    sql = "SELECT o.ocid, c.cnation, o.amount FROM orders o JOIN customers c ON o.ocid = c.cid ORDER BY o.amount DESC, o.ocid"
    broker = pc.Broker(clusters["port"][1], cache_config=CacheConfig(enabled=False), device="cpu")
    try:
        assert broker.execute(sql).rows == clusters["ref"][0].execute(sql).rows
        assert broker._dispatcher.device == "cpu"
    finally:
        broker.shutdown()
    root = [d for d, thread in seen if not thread.startswith("ms-")]
    assert root == ["cpu"], seen


def test_distributed_route_without_a_card_raises(clusters):
    """A broker's default device is the card: with none, its distributed
    route raises instead of running the root stage on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    broker = pc.Broker(clusters["port"][1])
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            broker.execute(QUERIES[0])
    finally:
        broker.shutdown()


def _block_and_frame():
    from pinot_tpu_torch.multistage.runtime import Block

    cols = [
        np.arange(5, dtype=np.int64),
        np.array(["a", "b", "a", "d", "e"], dtype=object),
        np.array([1.5, np.nan, 2.0, 0.0, -1.0]),
        np.array([True, False, True, True, False]),
    ]
    return Block(cols), pd.DataFrame({i: c for i, c in enumerate(cols)})


@pytest.mark.parametrize(
    "kind",
    ["block", "eos", "eos_stats", "err", "err_code"],
)
def test_envelopes_equal_reference_bytes(kind):
    """Byte-equal envelopes for the same block, a bare EOS, an EOS carrying
    stats, and an error marker with and without its code; each decodes back
    to what was sent."""
    from pinot_tpu.multistage import runtime as RR
    from pinot_tpu.multistage.transport import encode_envelope as r_encode
    from pinot_tpu_torch.multistage import runtime as R
    from pinot_tpu_torch.multistage.transport import decode_envelope, encode_envelope

    blk, df = _block_and_frame()
    stats = [{"stage": 1, "worker": 0, "rows": 12}]
    port, ref = {
        "block": (blk, df),
        "eos": (R._EOS, RR._EOS),
        "eos_stats": (("__eos__", stats), ("__eos__", stats)),
        "err": (("__err__", "boom"), ("__err__", "boom")),
        "err_code": (("__err__", "late", 250), ("__err__", "late", 250)),
    }[kind]
    data = encode_envelope("q1", 2, 1, 3, port)
    assert data == r_encode("q1", 2, 1, 3, ref)
    header, out = decode_envelope(data)
    assert (header["qid"], header["rs"], header["rw"], header["ss"]) == ("q1", 2, 1, 3)
    if kind == "block":
        assert out.width == blk.width
        for a, b in zip(out.cols, blk.cols):
            assert a.dtype == b.dtype
            assert pd.Series(a).equals(pd.Series(b))
    elif kind == "eos":
        assert out is R._EOS
    else:
        assert out == port


@pytest.mark.parametrize(
    "body",
    [b"", b"\x01\x00", b"\xff\xff\x00\x00{}", b"\x02\x00\x00\x00{]", b'\x0b\x00\x00\x00{"qid": "q"}',
     b'\x2c\x00\x00\x00{"qid": "q", "rs": 0, "rw": 0, "ss": 1, "kind": "block"}PTDT\x02\x00\x63'],
    ids=["empty", "short", "long_header", "bad_json", "missing_keys", "bad_block"],
)
def test_corrupt_envelope_is_a_400(clusters, body):
    """A garbled /mailbox POST is the sender's fault: decode_envelope raises
    ValueError and the server answers 400, as the reference does."""
    from pinot_tpu_torch.multistage.transport import decode_envelope

    with pytest.raises(ValueError, match="corrupt mailbox envelope"):
        decode_envelope(body)
    port = next(iter(clusters["port"][3].values())).port
    req = urllib.request.Request(f"http://127.0.0.1:{port}/mailbox", data=body, method="POST")
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=10)
    assert ei.value.code == 400
    assert "corrupt mailbox envelope" in json.loads(ei.value.read())["error"]


def test_straggler_envelope_of_a_closed_query_is_dropped():
    from pinot_tpu_torch.multistage import runtime as R
    from pinot_tpu_torch.multistage.transport import MailboxRegistry, encode_envelope

    reg = MailboxRegistry()
    reg.get("q9")
    reg.close("q9")
    reg.deliver(encode_envelope("q9", 0, 0, 1, R._EOS))
    assert reg.straggler_drops == 1 and reg.live_queries() == []


def test_mailbox_receive_timeout():
    from pinot_tpu_torch.multistage.transport import DistributedMailbox

    box = DistributedMailbox()
    box.receive_timeout = 0.2
    with pytest.raises(RuntimeError, match="timed out"):
        box.receive_all(1, 0, 2, n_senders=1)
