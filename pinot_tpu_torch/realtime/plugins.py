"""Stream plugins: file-tail (JSONL) and Kafka (gated).

Reference parity: pinot-plugins/pinot-stream-ingestion/ — Kafka 2/3,
Kinesis, Pulsar factories implementing the StreamConsumerFactory SPI. This
image has no Kafka broker or client library, so the Kafka factory registers
but raises with guidance at construction (plugin-gating pattern); the
FileStream is a real, durable stream useful for tailing log files into
realtime tables (CLP-log ingestion flavor) and doubles as the template for
writing external connectors.
"""

from __future__ import annotations

import json
from pathlib import Path

from pinot_tpu_torch.realtime.stream import StreamMessage, register_stream_factory


class FileStream:
    """Directory of JSONL files, one per partition: partition-<N>.jsonl.
    Offsets are line numbers; producers append lines (optionally via
    `produce`), consumers tail."""

    def __init__(self, root: str | Path, partitions: int = 1):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._n = partitions
        for p in range(partitions):
            self._file(p).touch()

    def _file(self, partition: int) -> Path:
        return self.root / f"partition-{partition}.jsonl"

    def partition_count(self) -> int:
        return self._n

    def produce(self, partition: int, value: dict) -> int:
        with open(self._file(partition), "a") as f:
            f.write(json.dumps(value) + "\n")
        return self.latest_offset(partition) - 1

    def latest_offset(self, partition: int) -> int:
        with open(self._file(partition)) as f:
            return sum(1 for _ in f)

    def create_consumer(self, partition: int) -> "FileConsumer":
        return FileConsumer(self._file(partition))


class FileConsumer:
    def __init__(self, path: Path):
        self._path = path

    def fetch_messages(self, start_offset: int, max_count: int) -> tuple[list[StreamMessage], int]:
        out = []
        with open(self._path) as f:
            for i, line in enumerate(f):
                if i < start_offset:
                    continue
                if len(out) >= max_count:
                    break
                line = line.strip()
                if line:
                    out.append(StreamMessage(offset=i, value=json.loads(line)))
        return out, start_offset + len(out)


def _file_factory(props: dict) -> FileStream:
    return FileStream(props["stream.file.root"], int(props.get("stream.file.partitions", 1)))


def _kafka_factory(props: dict):
    """Kafka consumer factory (KafkaConsumerFactory parity): native
    wire-protocol client (realtime/kafka.py), no client library needed.
    Gated only on broker reachability — construction connects."""
    from pinot_tpu_torch.realtime.kafka import KafkaStreamFactory

    return KafkaStreamFactory(props)


register_stream_factory("file", _file_factory)
register_stream_factory("kafka", _kafka_factory)
