"""Python client: connections, broker selection, result sets, DB-API cursor.

Reference parity: pinot-clients/pinot-java-client (ConnectionFactory,
SimpleBrokerSelector round-robin over a static list, DynamicBrokerSelector
refreshing the broker list from cluster metadata, JSON-over-HTTP transport
JsonAsyncHttpPinotClientTransport) and pinot-jdbc-client (cursor surface,
here PEP-249-shaped: cursor().execute/fetchall/description).

This is the JAX package's `client.py`. It speaks HTTP only and needs no
device; `ResultSet.to_pandas` imports pandas when it is called, so the
package itself runs without it.
"""

from __future__ import annotations

import http.client
import itertools
import threading
import time
from typing import Any

from pinot_tpu_torch.cluster.http import query_broker_http
from pinot_tpu_torch.cluster.quota import QuotaExceededError
from pinot_tpu_torch.query.scheduler import SchedulerRejectedError


class PinotClientError(RuntimeError):
    pass


class ResultSet:
    """Broker response wrapper (org.apache.pinot.client.ResultSet parity)."""

    def __init__(self, response: dict):
        self._resp = response
        # a degraded-but-answered query (allowPartialResults) carries BOTH
        # rows and exceptions: surface the rows, expose the exceptions;
        # exceptions WITHOUT a result table are a hard failure
        self.partial_result: bool = bool(response.get("partialResult"))
        self.exceptions: list[dict] = list(response.get("exceptions") or [])
        #: distributed-trace exemplar id ("" when the query wasn't sampled);
        #: feeds GET /debug/traces/{traceId} on the broker
        self.trace_id: str = response.get("traceId", "")
        if self.exceptions and not (self.partial_result and response.get("resultTable")):
            raise PinotClientError(
                "; ".join(e.get("message", "") for e in self.exceptions)
            )
        rt = response.get("resultTable") or {}
        schema = rt.get("dataSchema") or {}
        self.columns: list[str] = schema.get("columnNames", [])
        self.column_types: list[str] = schema.get("columnDataTypes", [])
        self.rows: list[list[Any]] = rt.get("rows", [])

    def __len__(self) -> int:
        return len(self.rows)

    def __iter__(self):
        return iter(self.rows)

    @property
    def execution_stats(self) -> dict:
        return {
            k: self._resp.get(k)
            for k in (
                "numDocsScanned",
                "totalDocs",
                "numSegmentsQueried",
                "timeUsedMs",
                "numServersQueried",
                "numServersResponded",
            )
        }

    def to_pandas(self):
        import pandas as pd

        return pd.DataFrame(self.rows, columns=self.columns or None)


class _BrokerSelector:
    """Round-robin with failover skip (SimpleBrokerSelector parity)."""

    def __init__(self, broker_urls: list[str]):
        if not broker_urls:
            raise PinotClientError("no brokers available")
        self._urls = list(broker_urls)
        self._rr = itertools.cycle(range(len(self._urls)))
        self._lock = threading.Lock()

    def urls_in_order(self) -> list[str]:
        with self._lock:
            start = next(self._rr)
        return [self._urls[(start + i) % len(self._urls)] for i in range(len(self._urls))]


class Connection:
    def __init__(
        self,
        broker_urls: list[str] | None = None,
        controller_url: str | list[str] | None = None,
    ):
        """Static broker list (SimpleBrokerSelector) or controller discovery
        (DynamicBrokerSelector). With a controller, the broker list refreshes
        on failure. `controller_url` accepts one URL, a comma-separated
        string, or a list — an HA deployment's standbys are candidates, and
        discovery follows `leaderUrl` hints / fails over when the lead dies.
        When every controller candidate is down, discovery raises the typed
        `ControllerUnavailableError` (a ConnectionError subclass)."""
        self._controller_url = controller_url
        self._controller = None  # lazy RemoteControllerClient, kept so failover state persists
        if broker_urls is None:
            if controller_url is None:
                raise PinotClientError("need broker_urls or controller_url")
            broker_urls = self._discover()
        self._selector = _BrokerSelector(broker_urls)

    def _discover(self) -> list[str]:
        from pinot_tpu_torch.cluster.http import RemoteControllerClient

        if self._controller is None:
            self._controller = RemoteControllerClient(self._controller_url)
        brokers = self._controller.brokers()
        return sorted(brokers.values())

    def execute(
        self,
        sql: str,
        retries_per_broker: int = 1,
        timeout_ms: float | None = None,
        allow_partial_results: bool | None = None,
    ) -> ResultSet:
        """timeout_ms / allow_partial_results become per-query SET options
        (`timeoutMs`, `allowPartialResults`) prepended to the statement —
        the java client's query-options map.

        Admission rejections raise typed: `QuotaExceededError` (HTTP 429)
        and `SchedulerRejectedError` (HTTP 503 shed), each carrying
        `retry_after_s` from the broker's Retry-After header. Neither is
        retried on another broker — the quota/overload verdict applies to
        the serving plane, not one broker instance."""
        opts = []
        if timeout_ms is not None:
            opts.append(f"SET timeoutMs = {float(timeout_ms):g};")
        if allow_partial_results is not None:
            opts.append(f"SET allowPartialResults = {str(bool(allow_partial_results)).lower()};")
        if opts:
            sql = " ".join(opts) + " " + sql
        last_err: Exception | None = None
        for attempt in range(retries_per_broker + 1):
            for url in self._selector.urls_in_order():
                try:
                    return ResultSet(query_broker_http(url, sql))
                except (QuotaExceededError, SchedulerRejectedError):
                    raise  # typed admission rejection: honor retry_after_s
                except PinotClientError:
                    raise  # server-side SQL error: do not retry elsewhere
                except (OSError, http.client.HTTPException) as e:
                    # connection-level: refused/reset (OSError) or a torn
                    # response from a broker killed mid-body (IncompleteRead,
                    # an HTTPException, not an OSError) — queries are
                    # idempotent reads, so retry on the next broker
                    last_err = e
            if self._controller_url is not None:
                try:
                    self._selector = _BrokerSelector(self._discover())
                except Exception:  # pinotlint: disable=deadline-swallow — broker rediscovery is best-effort; no deadline errors cross this discovery call
                    pass
            if attempt < retries_per_broker:
                time.sleep(0.05 * (attempt + 1))
        raise PinotClientError(f"all brokers unreachable: {last_err}")

    def cancel(self, query_id: str) -> bool:
        """DELETE /query/{id} against each broker until one knows the id
        (the cancel REST surface; ids come from GET /queries)."""
        import json as _json
        import urllib.error
        import urllib.request

        for url in self._selector.urls_in_order():
            req = urllib.request.Request(
                f"{url.rstrip('/')}/query/{query_id}", method="DELETE"
            )
            try:
                with urllib.request.urlopen(req, timeout=5.0) as resp:
                    if _json.loads(resp.read()).get("cancelled"):
                        return True
            except (urllib.error.URLError, OSError):
                continue
        return False

    # -- PEP-249 shim (pinot-jdbc-client parity) -----------------------------

    def cursor(self) -> "Cursor":
        return Cursor(self)

    def close(self) -> None:
        pass


class Cursor:
    def __init__(self, conn: Connection):
        self._conn = conn
        self._rs: ResultSet | None = None
        self._idx = 0

    @property
    def description(self):
        if self._rs is None:
            return None
        return [(c, t, None, None, None, None, None) for c, t in zip(self._rs.columns, self._rs.column_types)]

    @property
    def rowcount(self) -> int:
        return -1 if self._rs is None else len(self._rs)

    def execute(self, sql: str, params: tuple | None = None) -> "Cursor":
        if params:
            sql = sql % tuple(_quote(p) for p in params)
        self._rs = self._conn.execute(sql)
        self._idx = 0
        return self

    def fetchone(self):
        if self._rs is None or self._idx >= len(self._rs.rows):
            return None
        row = self._rs.rows[self._idx]
        self._idx += 1
        return tuple(row)

    def fetchmany(self, size: int = 1):
        out = []
        for _ in range(size):
            r = self.fetchone()
            if r is None:
                break
            out.append(r)
        return out

    def fetchall(self):
        out = [tuple(r) for r in (self._rs.rows[self._idx :] if self._rs else [])]
        self._idx = len(self._rs.rows) if self._rs else 0
        return out

    def close(self) -> None:
        self._rs = None


def _quote(p) -> str:
    if isinstance(p, str):
        return "'" + p.replace("'", "''") + "'"
    return str(p)


def connect(
    broker_urls: list[str] | str | None = None,
    controller_url: str | list[str] | None = None,
) -> Connection:
    """ConnectionFactory.fromHostList / fromController parity.
    `controller_url` may name several HA controllers (list or
    comma-separated string); the client fails over between them."""
    if isinstance(broker_urls, str):
        broker_urls = [broker_urls]
    return Connection(broker_urls, controller_url)
