"""The port's stream plugins against the JAX package's: Kafka's wire protocol
over sockets, Pulsar's admin REST API, Kinesis' HTTP/JSON API with SigV4,
and the file stream.

The stub servers are the reference tests' (`tests/test_kafka.py`,
`tests/test_pulsar.py`, `tests/test_kinesis.py`, and the FileStream cases
of `tests/test_plugins_connectors.py`). Each case drives both packages'
clients against the same stub: the messages, offsets and partition counts
must be equal, the Kafka requests the same bytes, the SigV4 headers the
same bytes for the same clock, and a realtime table fed by each plugin must
answer with the same rows through each package's Broker.
"""

import base64
import datetime
import json
import socket
import struct
import threading
import time
from http.server import BaseHTTPRequestHandler, HTTPServer
from types import SimpleNamespace
from urllib.parse import parse_qs, urlparse

import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.realtime as r_realtime
import pinot_tpu.realtime.kafka as r_kafka
import pinot_tpu.realtime.kinesis as r_kinesis
import pinot_tpu.realtime.plugins as r_plugins
import pinot_tpu.realtime.pulsar as r_pulsar
import pinot_tpu.realtime.stream as r_stream
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.realtime as p_realtime
import pinot_tpu_torch.realtime.kafka as p_kafka
import pinot_tpu_torch.realtime.kinesis as p_kinesis
import pinot_tpu_torch.realtime.plugins as p_plugins
import pinot_tpu_torch.realtime.pulsar as p_pulsar
import pinot_tpu_torch.realtime.stream as p_stream

REF = SimpleNamespace(name="ref", cluster=r_cluster, common=r_common, realtime=r_realtime, stream=r_stream,
                      kafka=r_kafka, pulsar=r_pulsar, kinesis=r_kinesis, plugins=r_plugins,
                      server=lambda sid: r_cluster.Server(sid))
PORT = SimpleNamespace(name="port", cluster=p_cluster, common=p_common, realtime=p_realtime, stream=p_stream,
                       kafka=p_kafka, pulsar=p_pulsar, kinesis=p_kinesis, plugins=p_plugins,
                       server=lambda sid: p_cluster.Server(sid, device="cpu"))
PKGS = (REF, PORT)


def _msgs(msgs):
    return [(m.offset, m.key, m.value) for m in msgs]


def _ingest(pkg, root, table, factory, n_rows, targets, max_rows=20):
    """A realtime table fed by `factory`: rows of COUNT/SUM and GROUP BY
    through the package's Broker once caught up, and the committed
    segments' offsets."""
    dt = pkg.common.DataType
    schema = pkg.common.Schema.build(table, dimensions=[("kind", dt.STRING)], metrics=[("value", dt.LONG)])
    ctrl = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / "deep")
    ctrl.add_schema(schema)
    cfg = pkg.common.TableConfig(table, table_type=pkg.common.TableType.REALTIME)
    ctrl.add_table(cfg)
    srv = pkg.server("server_0")
    ctrl.register_server("server_0", handle=srv)
    mgr = pkg.realtime.RealtimeTableManager(ctrl, srv, schema, cfg, factory, max_rows_per_segment=max_rows)
    mgr.start()
    broker = pkg.cluster.Broker(ctrl)
    try:
        assert mgr.wait_until_caught_up(targets, timeout=20.0)
        want_commits = sum(t // max_rows for t in targets)
        deadline = time.time() + 10
        while time.time() < deadline and sum(
            "endOffset" in m for m in ctrl.all_segment_metadata(table).values()
        ) < want_commits:
            time.sleep(0.02)
        rows = [
            broker.execute(f"SELECT COUNT(*), SUM(value) FROM {table}").rows,
            broker.execute(f"SELECT kind, COUNT(*), SUM(value) FROM {table} GROUP BY kind ORDER BY kind").rows,
        ]
    finally:
        mgr.stop()
        broker.shutdown()
    committed = {n: (m["startOffset"], m["endOffset"], m["numDocs"])
                 for n, m in sorted(ctrl.all_segment_metadata(table).items()) if "endOffset" in m}
    assert rows[0] == [[n_rows, float(sum(range(n_rows)))]]
    return {"rows": rows, "committed": committed}


# -- Kafka ------------------------------------------------------------------


def _str_enc(s):
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


def _bytes_enc(b):
    if b is None:
        return struct.pack(">i", -1)
    return struct.pack(">i", len(b)) + b


class _KafkaStub:
    """Single-topic, multi-partition in-memory Kafka broker; records every
    request body it receives."""

    def __init__(self, topic: str, partitions: int):
        self.topic = topic
        self.logs = [[] for _ in range(partitions)]  # partition -> [value bytes]
        self.requests: list[bytes] = []
        self.srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.srv.bind(("127.0.0.1", 0))
        self.port = self.srv.getsockname()[1]
        self.srv.listen(4)
        self._stop = False
        threading.Thread(target=self._accept_loop, daemon=True).start()

    def produce(self, partition: int, doc: dict) -> None:
        self.logs[partition].append(json.dumps(doc).encode())

    def stop(self):
        self._stop = True
        self.srv.close()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self.srv.accept()
            except OSError:
                return
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn):
        try:
            while True:
                hdr = self._recv(conn, 4)
                if hdr is None:
                    return
                (n,) = struct.unpack(">i", hdr)
                body = self._recv(conn, n)
                self.requests.append(body)
                resp = self._handle(body)
                conn.sendall(struct.pack(">i", len(resp)) + resp)
        except OSError:
            pass
        finally:
            conn.close()

    @staticmethod
    def _recv(conn, n):
        out = b""
        while len(out) < n:
            chunk = conn.recv(n - len(out))
            if not chunk:
                return None
            out += chunk
        return out

    def _handle(self, body: bytes) -> bytes:
        api_key, api_version, corr = struct.unpack(">hhi", body[:8])
        pos = 8
        (cid_len,) = struct.unpack(">h", body[pos : pos + 2])
        pos += 2 + max(cid_len, 0)
        payload = body[pos:]
        out = struct.pack(">i", corr)
        if api_key == 3:  # Metadata v1
            out += struct.pack(">i", 1)  # one broker
            out += struct.pack(">i", 0) + _str_enc("127.0.0.1") + struct.pack(">i", self.port) + _str_enc(None)
            out += struct.pack(">i", 0)  # controller id
            out += struct.pack(">i", 1)  # one topic
            out += struct.pack(">h", 0) + _str_enc(self.topic) + struct.pack(">b", 0)
            out += struct.pack(">i", len(self.logs))
            for p in range(len(self.logs)):
                out += struct.pack(">hiii", 0, p, 0, 1) + struct.pack(">i", 0)  # err,id,leader,replicas[0]
                out += struct.pack(">i", 1) + struct.pack(">i", 0)  # isr[0]
            return out
        if api_key == 2:  # ListOffsets v1
            p_off = 4 + 4  # replica + topic count
            (tlen,) = struct.unpack(">h", payload[p_off : p_off + 2])
            p_off += 2 + tlen + 4  # topic + partition count
            partition, ts = struct.unpack(">iq", payload[p_off : p_off + 12])
            offset = 0 if ts == -2 else len(self.logs[partition])
            out += struct.pack(">i", 1) + _str_enc(self.topic) + struct.pack(">i", 1)
            out += struct.pack(">ihqq", partition, 0, -1, offset)
            return out
        if api_key == 1:  # Fetch v2
            p_off = 12 + 4  # replica+maxwait+minbytes + topic count
            (tlen,) = struct.unpack(">h", payload[p_off : p_off + 2])
            p_off += 2 + tlen + 4
            partition, fetch_offset, max_bytes = struct.unpack(">iqi", payload[p_off : p_off + 16])
            log = self.logs[partition]
            msgset = b""
            for off in range(fetch_offset, len(log)):
                value = log[off]
                # MessageSet v1 entry: crc(i32) magic attrs timestamp key value
                msg = struct.pack(">ibbq", 0, 1, 0, 0) + _bytes_enc(None) + _bytes_enc(value)
                entry = struct.pack(">qi", off, len(msg)) + msg
                if len(msgset) + len(entry) > max_bytes and msgset:
                    # truncated partial message, as real brokers send
                    msgset += entry[: max_bytes - len(msgset)]
                    break
                msgset += entry
            out += struct.pack(">i", 0)  # throttle
            out += struct.pack(">i", 1) + _str_enc(self.topic) + struct.pack(">i", 1)
            out += struct.pack(">ihq", partition, 0, len(log))
            out += struct.pack(">i", len(msgset)) + msgset
            return out
        raise AssertionError(f"unexpected api {api_key}")


@pytest.fixture()
def kafka():
    stub = _KafkaStub("events", partitions=2)
    yield stub
    stub.stop()


def _kafka_props(stub):
    return {"stream.kafka.broker.list": f"127.0.0.1:{stub.port}", "stream.kafka.topic.name": "events"}


def test_kafka_metadata_and_offsets(kafka):
    for i in range(5):
        kafka.produce(0, {"i": i})
    out, requests = {}, {}
    for pkg in PKGS:
        kafka.requests.clear()
        f = pkg.kafka.KafkaStreamFactory(_kafka_props(kafka))
        try:
            out[pkg.name] = (f.partition_count(), f.earliest_offset(0), f.latest_offset(0), f.latest_offset(1))
        finally:
            f.close()
        requests[pkg.name] = list(kafka.requests)
    assert out["port"] == out["ref"] == (2, 0, 5, 0)
    assert requests["port"] == requests["ref"]  # the same request bytes


def test_kafka_fetch_messages(kafka):
    for i in range(10):
        kafka.produce(1, {"n": i, "s": f"v{i}"})
    out, requests = {}, {}
    for pkg in PKGS:
        kafka.requests.clear()
        f = pkg.kafka.KafkaStreamFactory(_kafka_props(kafka))
        try:
            consumer = f.create_consumer(1)
            got = []
            for start, count in ((0, 100), (4, 3), (10, 10)):
                msgs, nxt = consumer.fetch_messages(start, count)
                got.append((_msgs(msgs), nxt))
            out[pkg.name] = got
        finally:
            f.close()
        requests[pkg.name] = list(kafka.requests)
    assert out["port"] == out["ref"]
    assert [m[2]["n"] for m in out["port"][0][0]] == list(range(10)) and out["port"][0][1] == 10
    assert [m[2]["n"] for m in out["port"][1][0]] == [4, 5, 6] and out["port"][1][1] == 7
    assert out["port"][2] == ([], 10)
    assert requests["port"] == requests["ref"]


def test_kafka_truncated_message_set_parses_alike():
    """A MessageSet cut inside its last message (max_bytes) parses to the
    same complete messages, and a compressed message fails alike."""
    entries = b""
    for off in range(3):
        msg = struct.pack(">ibbq", 0, 1, 0, 0) + _bytes_enc(None) + _bytes_enc(json.dumps({"o": off}).encode())
        entries += struct.pack(">qi", off, len(msg)) + msg
    cut = entries[:-5]
    assert (p_kafka.KafkaWireClient._parse_message_set(cut, 1)
            == r_kafka.KafkaWireClient._parse_message_set(cut, 1) == [(1, b'{"o": 1}')])
    gz = struct.pack(">ibbq", 0, 1, 1, 0) + _bytes_enc(None) + _bytes_enc(b"x")
    for mod in (r_kafka, p_kafka):
        with pytest.raises(RuntimeError, match="compressed"):
            mod.KafkaWireClient._parse_message_set(struct.pack(">qi", 0, len(gz)) + gz, 0)


def test_kafka_factory_registry_resolves_kafka(kafka):
    for pkg in PKGS:
        f = pkg.stream.get_stream_factory("kafka", _kafka_props(kafka))
        try:
            assert isinstance(f, pkg.kafka.KafkaStreamFactory) and f.partition_count() == 2
        finally:
            f.close()


def test_kafka_factory_gated():
    """The kafka factory is gated on its connection config and on the
    broker's reachability (tests/test_plugins_connectors.py)."""
    for pkg in PKGS:
        with pytest.raises(ValueError, match="kafka stream requires"):
            pkg.stream.get_stream_factory("kafka", {})
        with pytest.raises(OSError):
            pkg.stream.get_stream_factory(
                "kafka", {"stream.kafka.broker.list": "127.0.0.1:1", "stream.kafka.topic.name": "t"}
            )


def test_kafka_ingestion_end_to_end(kafka, tmp_path):
    """The stub Kafka -> the consume loop -> queryable rows, in each package."""
    for i in range(200):
        kafka.produce(i % 2, {"kind": f"k{i % 4}", "value": i})
    out = {}
    for pkg in PKGS:
        f = pkg.kafka.KafkaStreamFactory(_kafka_props(kafka))
        try:
            out[pkg.name] = _ingest(pkg, tmp_path / pkg.name, "events", f, 200, [100, 100], max_rows=64)
        finally:
            f.close()
    assert out["port"] == out["ref"]


# -- Pulsar -----------------------------------------------------------------


class _PulsarStub:
    """Pulsar admin-API stub: partitioned-topic metadata + examinemessage."""

    def __init__(self, partitions: int = 2):
        self.partitions = partitions
        self.logs: dict[int, list[dict]] = {p: [] for p in range(max(1, partitions))}

    def put(self, partition: int, value: dict) -> None:
        self.logs[partition].append(value)


@pytest.fixture()
def pulsar():
    stub = _PulsarStub(partitions=2)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            u = urlparse(self.path)
            parts = u.path.strip("/").split("/")
            # /admin/v2/persistent/{tenant}/{ns}/{topic}[-partition-N]/(partitions|examinemessage)
            if parts[-1] == "partitions":
                body = json.dumps({"partitions": stub.partitions}).encode()
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            if parts[-1] == "examinemessage":
                topic = parts[-2]
                part = 0
                if "-partition-" in topic:
                    topic, _, pn = topic.rpartition("-partition-")
                    part = int(pn)
                pos = int(parse_qs(u.query)["messagePosition"][0])
                log = stub.logs[part]
                if pos < 1 or pos > len(log):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = json.dumps(log[pos - 1]).encode()
                self.send_response(200)
                self.send_header("X-Pulsar-Message-ID", f"{part}:{pos - 1}:0")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            self.send_response(400)
            self.end_headers()

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield stub, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def _pulsar_props(url):
    return {"stream.pulsar.topic.name": "events", "stream.pulsar.serviceHttpUrl": url}


def test_pulsar_factory_registration_and_partitions(pulsar):
    stub, url = pulsar
    for pkg in PKGS:
        factory = pkg.stream.get_stream_factory("pulsar", _pulsar_props(url))
        assert isinstance(factory, pkg.pulsar.PulsarStreamFactory)
        assert factory.partition_count() == 2


def test_pulsar_factory_requires_endpoint():
    for pkg in PKGS:
        with pytest.raises(ValueError, match="serviceHttpUrl"):
            pkg.pulsar.PulsarStreamFactory({"stream.pulsar.topic.name": "events"})
        with pytest.raises(ValueError, match="topic.name"):
            pkg.pulsar.PulsarStreamFactory({"stream.pulsar.serviceHttpUrl": "http://x"})


def test_pulsar_consumer_fetch_roundtrip(pulsar):
    stub, url = pulsar
    for i in range(25):
        stub.put(i % 2, {"k": f"v{i}", "n": i})
    out = {}
    for pkg in PKGS:
        stub.logs[0] = stub.logs[0][:13]
        factory = pkg.pulsar.PulsarStreamFactory(_pulsar_props(url))
        c0 = factory.create_consumer(0)
        msgs, next_off = c0.fetch_messages(0, 100)
        assert len(msgs) == 13 and msgs[0].value == {"k": "v0", "n": 0}
        assert msgs[0].key == "0:0:0"  # the ledger:entry message id rides along
        stub.put(0, {"k": "late", "n": 99})  # a checkpointed resume takes only it
        more, next2 = c0.fetch_messages(next_off, 100)
        some, off = factory.create_consumer(1).fetch_messages(0, 5)  # a bounded batch
        out[pkg.name] = (_msgs(msgs), next_off, _msgs(more), next2, _msgs(some), off)
    assert out["port"] == out["ref"]
    assert [m[2]["k"] for m in out["port"][2]] == ["late"] and out["port"][3] == 14
    assert len(out["port"][4]) == 5 and out["port"][5] == 5


def test_pulsar_end_to_end_realtime_ingestion(pulsar, tmp_path):
    stub, url = pulsar
    stub.logs = {0: [], 1: []}
    for i in range(60):
        stub.put(i % 2, {"kind": f"k{i % 3}", "value": i})
    out = {pkg.name: _ingest(pkg, tmp_path / pkg.name, "pev", pkg.pulsar.PulsarStreamFactory(_pulsar_props(url)),
                             60, [30, 30]) for pkg in PKGS}
    assert out["port"] == out["ref"]


# -- Kinesis ----------------------------------------------------------------


class _KinesisStub:
    """In-memory Kinesis stream: shards of (sequence, payload) records."""

    def __init__(self, n_shards=2):
        self.shards = {f"shardId-{i:012d}": [] for i in range(n_shards)}
        self.auth_failures = 0
        self.auth: list[str] = []

    def put(self, shard_idx: int, value: dict) -> int:
        shard = sorted(self.shards)[shard_idx]
        seq = len(self.shards[shard])
        self.shards[shard].append((seq, json.dumps(value).encode()))
        return seq

    def handle(self, target: str, body: dict, headers) -> dict:
        auth = headers.get("Authorization", "")
        self.auth.append(auth)
        if "AWS4-HMAC-SHA256" not in auth or "/kinesis/aws4_request" not in auth:
            self.auth_failures += 1
            raise PermissionError("missing/invalid SigV4 authorization")
        action = target.split(".")[-1]
        if action == "ListShards":
            return {"Shards": [{"ShardId": s} for s in self.shards]}
        if action == "GetShardIterator":
            itype = body.get("ShardIteratorType")
            if itype == "TRIM_HORIZON":
                pos = 0
            elif itype == "AFTER_SEQUENCE_NUMBER":
                pos = int(body["StartingSequenceNumber"]) + 1
            else:
                raise ValueError(f"unsupported iterator type {itype}")
            return {"ShardIterator": json.dumps({"shard": body["ShardId"], "pos": pos})}
        if action == "GetRecords":
            it = json.loads(body["ShardIterator"])
            recs = self.shards[it["shard"]]
            chunk = recs[it["pos"] : it["pos"] + int(body.get("Limit", 1000))]
            return {
                "Records": [
                    {"SequenceNumber": str(seq), "Data": base64.b64encode(data).decode()} for seq, data in chunk
                ],
                "NextShardIterator": json.dumps({"shard": it["shard"], "pos": it["pos"] + len(chunk)}),
            }
        raise ValueError(f"unknown action {action}")


@pytest.fixture()
def kinesis():
    stub = _KinesisStub(n_shards=2)

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            body = json.loads(self.rfile.read(int(self.headers.get("Content-Length", 0)) or 0) or b"{}")
            try:
                out = stub.handle(self.headers.get("X-Amz-Target", ""), body, self.headers)
                payload = json.dumps(out).encode()
                self.send_response(200)
            except PermissionError as e:
                payload = json.dumps({"__type": "AccessDeniedException", "message": str(e)}).encode()
                self.send_response(403)
            self.send_header("Content-Length", str(len(payload)))
            self.end_headers()
            self.wfile.write(payload)

        def log_message(self, *a):
            pass

    srv = HTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield stub, f"http://127.0.0.1:{srv.server_port}"
    srv.shutdown()


def _kinesis_props(endpoint):
    return {"stream.kinesis.topic.name": "events", "stream.kinesis.endpoint": endpoint}


def test_kinesis_factory_registration_and_shards(kinesis):
    stub, endpoint = kinesis
    for pkg in PKGS:
        factory = pkg.stream.get_stream_factory("kinesis", _kinesis_props(endpoint))
        assert isinstance(factory, pkg.kinesis.KinesisStreamFactory)
        assert factory.partition_count() == 2
    assert stub.auth_failures == 0  # every request carried a valid SigV4 shape


def test_kinesis_consumer_fetch_roundtrip(kinesis):
    stub, endpoint = kinesis
    for i in range(25):
        stub.put(i % 2, {"k": f"v{i}", "n": i})
    shard0 = sorted(stub.shards)[0]
    out = {}
    for pkg in PKGS:
        stub.shards[shard0] = stub.shards[shard0][:13]
        factory = pkg.kinesis.KinesisStreamFactory(_kinesis_props(endpoint))
        c0 = factory.create_consumer(0)
        msgs, next_off = c0.fetch_messages(0, 100)
        assert len(msgs) == 13 and msgs[0].value == {"k": "v0", "n": 0} and next_off == 13
        stub.put(0, {"k": "late", "n": 99})  # an incremental fetch from a checkpoint
        more, next2 = c0.fetch_messages(next_off, 100)
        some, off = factory.create_consumer(1).fetch_messages(0, 5)  # a bounded batch
        out[pkg.name] = (_msgs(msgs), next_off, _msgs(more), next2, _msgs(some), off)
    assert out["port"] == out["ref"]
    assert [m[2]["k"] for m in out["port"][2]] == ["late"] and out["port"][3] == 14


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 17, 12, 34, 56, tzinfo=tz)


@pytest.mark.parametrize("target", ["ListShards", "GetShardIterator", "GetRecords"])
def test_kinesis_sigv4_headers_are_the_same_bytes(target, monkeypatch):
    """SigV4 signing is the reference's, byte for byte: at the same clock
    the same payload signs to the same headers."""
    payload = json.dumps({"StreamName": "events", "Limit": 7}).encode()
    headers = {}
    for pkg in PKGS:
        monkeypatch.setattr(pkg.kinesis.datetime, "datetime", _FixedClock)
        client = pkg.kinesis.KinesisClient("http://127.0.0.1:9/", region="eu-west-1", access_key="AK", secret_key="SK")
        headers[pkg.name] = client._sign(payload, target)
    assert headers["port"] == headers["ref"]
    assert headers["port"]["X-Amz-Date"] == "20240517T123456Z"


def test_kinesis_end_to_end_realtime_ingestion(kinesis, tmp_path):
    stub, endpoint = kinesis
    for i in range(60):
        stub.put(i % 2, {"kind": f"k{i % 3}", "value": i})
    out = {pkg.name: _ingest(pkg, tmp_path / pkg.name, "kev", pkg.kinesis.KinesisStreamFactory(_kinesis_props(endpoint)),
                             60, [30, 30]) for pkg in PKGS}
    assert out["port"] == out["ref"]
    assert stub.auth_failures == 0


# -- the file stream -----------------------------------------------------------


def test_file_stream_produce_consume(tmp_path):
    out = {}
    for pkg in PKGS:
        fs = pkg.stream.get_stream_factory(
            "file", {"stream.file.root": str(tmp_path / pkg.name / "s"), "stream.file.partitions": 2}
        )
        fs.produce(0, {"kind": "a", "value": 1})
        fs.produce(0, {"kind": "b", "value": 2})
        fs.produce(1, {"kind": "c", "value": 3})
        assert fs.partition_count() == 2 and fs.latest_offset(0) == 2
        c = fs.create_consumer(0)
        msgs, nxt = c.fetch_messages(0, 10)
        fs.produce(0, {"kind": "d", "value": 4})  # the tail goes on after an append
        more, nxt2 = c.fetch_messages(nxt, 10)
        out[pkg.name] = (_msgs(msgs), nxt, _msgs(more), nxt2,
                         (tmp_path / pkg.name / "s" / "partition-0.jsonl").read_bytes())
    assert out["port"] == out["ref"]
    assert [m[2]["kind"] for m in out["port"][0]] == ["a", "b"] and out["port"][1] == 2
    assert [m[2]["kind"] for m in out["port"][2]] == ["d"] and out["port"][3] == 3


def test_file_stream_feeds_realtime_table(tmp_path):
    out = {}
    for pkg in PKGS:
        fs = pkg.stream.get_stream_factory("file", {"stream.file.root": str(tmp_path / pkg.name / "stream")})
        for i in range(25):
            fs.produce(0, {"kind": f"k{i % 3}", "value": i})
        out[pkg.name] = _ingest(pkg, tmp_path / pkg.name, "events", fs, 25, [25], max_rows=10)
    assert out["port"] == out["ref"]
