"""Stream ingestion SPI + in-memory stream implementation.

Reference parity: pinot-spi stream contracts (StreamConsumerFactory,
PartitionGroupConsumer.fetchMessages, StreamMessage, offsets) that the
Kafka 2/3 / Kinesis / Pulsar plugins implement
(pinot-plugins/pinot-stream-ingestion/). The InMemoryStream is the embedded-
Kafka test analog; real connectors implement the same three methods.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Protocol


@dataclass
class StreamMessage:
    offset: int
    value: Mapping[str, Any]  # decoded row
    key: str | None = None
    #: producer-side wall-clock stamp (Kafka record timestamp parity); the
    #: consume loop measures event-to-queryable freshness against it. 0 =
    #: unknown (freshness not tracked for this message)
    timestamp_ms: int = 0


class PartitionGroupConsumer(Protocol):
    """One consumer attached to one stream partition (PartitionGroupConsumer
    parity)."""

    def fetch_messages(self, start_offset: int, max_count: int) -> tuple[list[StreamMessage], int]:
        """Returns (messages, next_start_offset)."""
        ...


class StreamFactory(Protocol):
    def partition_count(self) -> int: ...

    def create_consumer(self, partition: int) -> PartitionGroupConsumer: ...


_REGISTRY: dict[str, Callable[[dict], StreamFactory]] = {}


def register_stream_factory(stream_type: str, ctor: Callable[[dict], StreamFactory]) -> None:
    """Plugin registration (StreamConsumerFactoryProvider parity)."""
    _REGISTRY[stream_type] = ctor


#: plugin modules auto-imported on first use, so a table config naming a
#: stream type works without the caller importing the plugin module
#: (PluginManager classloading parity)
_PLUGIN_MODULES = {
    "kafka": "pinot_tpu_torch.realtime.plugins",
    "file": "pinot_tpu_torch.realtime.plugins",
    "kinesis": "pinot_tpu_torch.realtime.kinesis",
    "pulsar": "pinot_tpu_torch.realtime.pulsar",
}


def get_stream_factory(stream_type: str, props: dict) -> StreamFactory:
    if stream_type not in _REGISTRY and stream_type in _PLUGIN_MODULES:
        import importlib

        importlib.import_module(_PLUGIN_MODULES[stream_type])
    if stream_type not in _REGISTRY:
        raise KeyError(f"unknown stream type {stream_type!r}; registered: {sorted(_REGISTRY)}")
    return _REGISTRY[stream_type](props)


class InMemoryStream:
    """Thread-safe in-process stream with N partitions (embedded-Kafka test
    analog; also the default 'inmemory' factory)."""

    def __init__(self, partitions: int = 1):
        self._partitions: list[list[StreamMessage]] = [[] for _ in range(partitions)]
        self._lock = threading.RLock()

    def produce(self, partition: int, value: Mapping[str, Any], key: str | None = None) -> int:
        with self._lock:
            log = self._partitions[partition]
            offset = len(log)
            log.append(
                StreamMessage(
                    offset=offset,
                    value=dict(value),
                    key=key,
                    timestamp_ms=int(time.time() * 1e3),
                )
            )
            return offset

    def partition_count(self) -> int:
        return len(self._partitions)

    def latest_offset(self, partition: int) -> int:
        with self._lock:
            return len(self._partitions[partition])

    def create_consumer(self, partition: int) -> "InMemoryConsumer":
        return InMemoryConsumer(self, partition)


class InMemoryConsumer:
    def __init__(self, stream: InMemoryStream, partition: int):
        self.stream = stream
        self.partition = partition

    def fetch_messages(self, start_offset: int, max_count: int) -> tuple[list[StreamMessage], int]:
        with self.stream._lock:
            log = self.stream._partitions[self.partition]
            batch = log[start_offset : start_offset + max_count]
            return list(batch), start_offset + len(batch)


register_stream_factory("inmemory", lambda props: props["stream_object"])
