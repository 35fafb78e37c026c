"""Apache Pulsar consumer plugin — third wire-protocol stream plugin.

Reference parity: pinot-plugins/pinot-stream-ingestion/pinot-pulsar/
(PulsarConsumerFactory / PulsarPartitionLevelConsumer /
PulsarStreamMetadataProvider / MessageIdStreamOffset). The reference rides
the Pulsar binary client; this image has no Pulsar client library, so this
plugin speaks Pulsar's REST admin API over stdlib urllib — partitioned-topic
metadata (`GET /admin/v2/persistent/{tenant}/{ns}/{topic}/partitions`) and
per-position reads (`GET .../examinemessage?initialPosition=earliest&
messagePosition=N`, payload in the body, message id in the
`X-Pulsar-Message-ID` header) — which works against a real broker's admin
port, a Pulsar standalone, or the in-process stub in tests.

Offset mapping (MessageIdStreamOffset analog): the SPI's integer offsets are
1-based positions from the earliest retained message; offset N fetches
position N+1. Ledger/entry message ids ride along in StreamMessage.key for
observability. Per-message GETs make this a conformance/functional tier —
a production deployment should front it with the binary client; the
interface contract (StreamFactory/consumer SPI) is identical either way.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request

from pinot_tpu_torch.realtime.stream import StreamMessage, register_stream_factory


class PulsarAdminClient:
    """Minimal Pulsar REST admin client (stdlib-only)."""

    def __init__(self, service_http_url: str, timeout: float = 10.0):
        self.base = service_http_url.rstrip("/")
        self.timeout = timeout

    def _topic_path(self, topic: str, tenant: str, namespace: str) -> str:
        # accept both bare names and full persistent://tenant/ns/topic URLs
        if topic.startswith("persistent://"):
            return topic[len("persistent://") :]
        return f"{tenant}/{namespace}/{topic}"

    def partitioned_metadata(self, topic: str, tenant: str, namespace: str) -> int:
        """Partition count; 0 means non-partitioned (treated as 1 partition,
        PulsarStreamMetadataProvider.fetchPartitionCount parity)."""
        path = self._topic_path(topic, tenant, namespace)
        url = f"{self.base}/admin/v2/persistent/{path}/partitions"
        with urllib.request.urlopen(url, timeout=self.timeout) as r:
            meta = json.loads(r.read().decode())
        return int(meta.get("partitions", 0))

    def examine_message(
        self, topic: str, tenant: str, namespace: str, position: int, partition: int | None
    ) -> "tuple[str, bytes] | None":
        """(message_id, payload) of the 1-based `position` from earliest, or
        None past the end of the topic."""
        path = self._topic_path(topic, tenant, namespace)
        if partition is not None:
            path = f"{path}-partition-{partition}"
        q = urllib.parse.urlencode({"initialPosition": "earliest", "messagePosition": position})
        url = f"{self.base}/admin/v2/persistent/{path}/examinemessage?{q}"
        try:
            with urllib.request.urlopen(url, timeout=self.timeout) as r:
                mid = r.headers.get("X-Pulsar-Message-ID", "")
                return mid, r.read()
        except urllib.error.HTTPError as e:
            if e.code in (404, 412):  # past end / empty topic
                return None
            raise


class PulsarConsumer:
    """PartitionGroupConsumer over one partition
    (PulsarPartitionLevelConsumer parity)."""

    def __init__(
        self,
        client: PulsarAdminClient,
        topic: str,
        tenant: str,
        namespace: str,
        partition: int | None,
        batch: int = 100,
    ):
        self.client = client
        self.topic = topic
        self.tenant = tenant
        self.namespace = namespace
        self.partition = partition
        self.batch = batch

    def fetch_messages(self, start_offset: int, max_count: int) -> tuple[list[StreamMessage], int]:
        msgs: list[StreamMessage] = []
        off = start_offset
        for _ in range(min(max_count, self.batch)):
            got = self.client.examine_message(
                self.topic, self.tenant, self.namespace, off + 1, self.partition
            )
            if got is None:
                break
            mid, payload = got
            msgs.append(StreamMessage(offset=off, key=mid or None, value=json.loads(payload.decode())))
            off += 1
        return msgs, off


class PulsarStreamFactory:
    """StreamFactory over a Pulsar topic. Props (stream config map,
    PulsarConfig key parity): stream.pulsar.serviceHttpUrl (admin REST
    endpoint), stream.pulsar.topic.name, stream.pulsar.tenant (default
    'public'), stream.pulsar.namespace (default 'default')."""

    def __init__(self, props: dict):
        self.topic = props.get("stream.pulsar.topic.name") or props.get("topic", "")
        if not self.topic:
            raise ValueError("pulsar stream config requires stream.pulsar.topic.name")
        url = props.get("stream.pulsar.serviceHttpUrl") or props.get("serviceHttpUrl", "")
        if not url:
            raise ValueError(
                "pulsar stream config requires stream.pulsar.serviceHttpUrl "
                "(the broker's admin REST endpoint, e.g. http://broker:8080)"
            )
        self.tenant = props.get("stream.pulsar.tenant", "public")
        self.namespace = props.get("stream.pulsar.namespace", "default")
        self.client = PulsarAdminClient(url, timeout=float(props.get("stream.pulsar.timeout", 10)))
        # construct-time connectivity gate (plugin pattern: fail fast with a
        # clear error instead of a dead consume loop)
        self._partitions = self.client.partitioned_metadata(self.topic, self.tenant, self.namespace)

    def partition_count(self) -> int:
        return max(1, self._partitions)

    def create_consumer(self, partition: int) -> PulsarConsumer:
        # non-partitioned topics (metadata 0) address the topic directly
        part = partition if self._partitions > 0 else None
        return PulsarConsumer(self.client, self.topic, self.tenant, self.namespace, part)


register_stream_factory("pulsar", PulsarStreamFactory)
