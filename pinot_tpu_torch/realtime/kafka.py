"""Minimal native Kafka consumer: the wire protocol over stdlib sockets.

Reference parity: KafkaPartitionLevelConsumer / KafkaConsumerFactory
(pinot-plugins/pinot-stream-ingestion/pinot-kafka-2.0/.../
KafkaPartitionLevelConsumer.java) implementing StreamConsumerFactory /
PartitionGroupConsumer (pinot-spi/.../stream/). No kafka client library
ships in this image, so this speaks the protocol directly — pinned to
versions every 2.x/3.x broker serves (brokers down-convert record batches
for old fetch versions):

    Metadata    v1  (partition discovery)
    ListOffsets v1  (earliest/latest offsets)
    Fetch       v2  (MessageSet v0/v1 payloads)

Values are JSON documents (the quickstart decoder); keys are ignored.
Conformance target: the in-process stub broker in tests/test_kafka.py
(no egress in this image).
"""

from __future__ import annotations

import json
import socket
import struct
import threading

from pinot_tpu_torch.realtime.stream import StreamMessage

EARLIEST = -2
LATEST = -1


def _str(s: str | None) -> bytes:
    if s is None:
        return struct.pack(">h", -1)
    b = s.encode()
    return struct.pack(">h", len(b)) + b


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        self.pos += n
        return b

    def i8(self) -> int:
        return struct.unpack(">b", self.take(1))[0]

    def i16(self) -> int:
        return struct.unpack(">h", self.take(2))[0]

    def i32(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def i64(self) -> int:
        return struct.unpack(">q", self.take(8))[0]

    def string(self) -> str | None:
        n = self.i16()
        return None if n < 0 else self.take(n).decode()

    def bytes_(self) -> bytes | None:
        n = self.i32()
        return None if n < 0 else self.take(n)


class KafkaWireClient:
    """One broker connection; thread-safe request/response."""

    API_METADATA = 3
    API_LIST_OFFSETS = 2
    API_FETCH = 1

    def __init__(self, host: str, port: int, client_id: str = "pinot-tpu", timeout: float = 10.0):
        self.client_id = client_id
        self._sock = socket.create_connection((host, port), timeout=timeout)
        self._corr = 0
        self._lock = threading.Lock()

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass

    def _roundtrip(self, api_key: int, api_version: int, payload: bytes) -> _Reader:
        with self._lock:
            self._corr += 1
            corr = self._corr
            header = struct.pack(">hhi", api_key, api_version, corr) + _str(self.client_id)
            msg = header + payload
            self._sock.sendall(struct.pack(">i", len(msg)) + msg)
            raw = self._recv_exact(4)  # pinotlint: disable=blocking-under-lock — per-connection wire lock: it exists to serialize request/response pairs on this socket, so blocking reads under it are the design, and no other lock nests inside
            (n,) = struct.unpack(">i", raw)
            body = self._recv_exact(n)  # pinotlint: disable=blocking-under-lock — same wire-serialization shape as above
        r = _Reader(body)
        got_corr = r.i32()
        if got_corr != corr:
            raise RuntimeError(f"kafka correlation mismatch: {got_corr} != {corr}")
        return r

    def _recv_exact(self, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = self._sock.recv(n - len(out))
            if not chunk:
                raise ConnectionError("kafka broker closed connection")
            out += chunk
        return out

    # -- Metadata v1 ----------------------------------------------------------

    def partition_count(self, topic: str) -> int:
        payload = struct.pack(">i", 1) + _str(topic)
        r = self._roundtrip(self.API_METADATA, 1, payload)
        n_brokers = r.i32()
        for _ in range(n_brokers):
            r.i32()  # node id
            r.string()  # host
            r.i32()  # port
            r.string()  # rack
        r.i32()  # controller id
        n_topics = r.i32()
        for _ in range(n_topics):
            err = r.i16()
            name = r.string()
            r.i8()  # is_internal
            n_parts = r.i32()
            part_ids = []
            for _ in range(n_parts):
                r.i16()  # partition error
                part_ids.append(r.i32())
                r.i32()  # leader
                for _ in range(r.i32()):  # replicas
                    r.i32()
                for _ in range(r.i32()):  # isr
                    r.i32()
            if name == topic:
                if err != 0:
                    raise RuntimeError(f"kafka metadata error {err} for topic {topic!r}")
                return len(part_ids)
        raise RuntimeError(f"topic {topic!r} not in metadata response")

    # -- ListOffsets v1 -------------------------------------------------------

    def list_offset(self, topic: str, partition: int, timestamp: int) -> int:
        payload = (
            struct.pack(">i", -1)  # replica_id
            + struct.pack(">i", 1)  # one topic
            + _str(topic)
            + struct.pack(">i", 1)  # one partition
            + struct.pack(">iq", partition, timestamp)
        )
        r = self._roundtrip(self.API_LIST_OFFSETS, 1, payload)
        r.i32()  # topic count
        r.string()
        r.i32()  # partition count
        r.i32()  # partition id
        err = r.i16()
        if err != 0:
            raise RuntimeError(f"kafka ListOffsets error {err}")
        r.i64()  # timestamp
        return r.i64()

    # -- Fetch v2 -------------------------------------------------------------

    def fetch(
        self, topic: str, partition: int, offset: int, max_bytes: int = 1 << 20, max_wait_ms: int = 100
    ) -> list[tuple[int, bytes]]:
        """Returns [(offset, value_bytes)] at or after `offset`."""
        payload = (
            struct.pack(">iii", -1, max_wait_ms, 1)  # replica, max_wait, min_bytes
            + struct.pack(">i", 1)
            + _str(topic)
            + struct.pack(">i", 1)
            + struct.pack(">iqi", partition, offset, max_bytes)
        )
        r = self._roundtrip(self.API_FETCH, 2, payload)
        r.i32()  # throttle_time_ms
        r.i32()  # topic count
        r.string()
        r.i32()  # partition count
        r.i32()  # partition id
        err = r.i16()
        if err != 0:
            raise RuntimeError(f"kafka Fetch error {err}")
        r.i64()  # high watermark
        set_size = r.i32()
        data = r.take(set_size)
        return self._parse_message_set(data, offset)

    @staticmethod
    def _parse_message_set(data: bytes, min_offset: int) -> list[tuple[int, bytes]]:
        """MessageSet v0/v1: [offset i64][size i32][crc i32][magic i8]
        [attrs i8][timestamp i64 if magic>=1][key bytes][value bytes].
        A trailing partial message (truncated by max_bytes) is skipped."""
        out: list[tuple[int, bytes]] = []
        r = _Reader(data)
        while r.pos + 12 <= len(data):
            off = r.i64()
            size = r.i32()
            if r.pos + size > len(data):
                break  # partial trailing message
            body = _Reader(r.take(size))
            body.i32()  # crc (stub-trusted; a full client would verify)
            magic = body.i8()
            attrs = body.i8()
            if attrs & 0x07:
                # fail fast with an actionable message instead of a
                # JSONDecodeError deep inside ingestion
                raise RuntimeError(
                    "compressed Kafka messages are not supported by the native "
                    "consumer; set compression.type=none on the topic/producer"
                )
            if magic >= 1:
                body.i64()  # timestamp
            body.bytes_()  # key
            value = body.bytes_()
            if off >= min_offset and value is not None:
                out.append((off, value))
        return out


class KafkaConsumer:
    """PartitionGroupConsumer over one topic partition."""

    def __init__(self, client: KafkaWireClient, topic: str, partition: int):
        self.client = client
        self.topic = topic
        self.partition = partition

    def fetch_messages(self, start_offset: int, max_count: int) -> tuple[list[StreamMessage], int]:
        raw = self.client.fetch(self.topic, self.partition, start_offset)
        msgs = []
        next_offset = start_offset
        for off, value in raw[:max_count]:
            msgs.append(StreamMessage(offset=off, value=json.loads(value)))
            next_offset = off + 1
        return msgs, next_offset


class KafkaStreamFactory:
    """StreamFactory over a reachable Kafka broker.

    Props (stream config parity with the reference's stream.kafka.* keys):
        stream.kafka.broker.list  "host:port"
        stream.kafka.topic.name   topic
    """

    def __init__(self, props: dict):
        broker = props.get("stream.kafka.broker.list", "")
        self.topic = props.get("stream.kafka.topic.name", "")
        if not broker or not self.topic:
            raise ValueError(
                "kafka stream requires stream.kafka.broker.list and stream.kafka.topic.name"
            )
        # standard comma-separated bootstrap list: try each in order
        last: Exception | None = None
        self.client = None
        for entry in broker.split(","):
            host, _, port = entry.strip().partition(":")
            try:
                self.client = KafkaWireClient(host, int(port or 9092))
                break
            except OSError as e:
                last = e
        if self.client is None:
            raise OSError(f"no reachable kafka broker in {broker!r}") from last

    def partition_count(self) -> int:
        return self.client.partition_count(self.topic)

    def earliest_offset(self, partition: int) -> int:
        return self.client.list_offset(self.topic, partition, EARLIEST)

    def latest_offset(self, partition: int) -> int:
        return self.client.list_offset(self.topic, partition, LATEST)

    def create_consumer(self, partition: int) -> KafkaConsumer:
        return KafkaConsumer(self.client, self.topic, partition)

    def close(self) -> None:
        self.client.close()
