"""Broker-side query quotas and rate-limited query logging.

Reference parity: HelixExternalViewBasedQueryQuotaManager
(pinot-broker/.../queryquota/) — per-table QPS quotas from TableConfig
(extra["queryQuotaQps"], the quota.maxQueriesPerSecond analog) enforced with
a sliding-window rate check; and QueryLogger (broker/querylog/QueryLogger)
— per-query log lines rate-limited to maxRatePerSecond with a dropped-count
carried on the next emitted line.
"""

from __future__ import annotations

import collections
import logging
import threading
import time

from pinot_tpu_torch.common.errors import QueryErrorCode


class QuotaExceededError(RuntimeError):
    """Surfaced to clients as the HTTP 429 quota-exceeded broker error.
    Carries the registered error code so `code_of()` maps it at response
    boundaries, plus a `Retry-After` hint (the quota window length)."""

    error_code = QueryErrorCode.QUOTA_EXCEEDED

    def __init__(self, message: str, retry_after_s: float = 1.0):
        super().__init__(message)
        self.retry_after_s = retry_after_s


class QueryQuotaManager:
    """Sliding-1s-window QPS admission, per table (from TableConfig
    extra["queryQuotaQps"]) and per tenant (from `tenant_qps`, aggregated
    across every table the tenant serves — the HelixExternalViewBased
    database/application rate-limiter analog)."""

    def __init__(self, controller, tenant_qps: dict[str, float] | None = None):
        self._controller = controller
        self._hits: dict[str, collections.deque] = {}
        self._tenant_hits: dict[str, collections.deque] = {}
        self._tenant_qps = dict(tenant_qps or {})
        self._lock = threading.Lock()
        self.rejected = 0  # lifetime rejections (debug/admission snapshot)

    def _qps_limit(self, table: str) -> float | None:
        config = self._controller.get_table(table)
        if config is None:
            return None
        q = (config.extra or {}).get("queryQuotaQps")
        return float(q) if q else None

    @staticmethod
    def _over(dq: collections.deque, now: float, limit: float) -> bool:
        while dq and now - dq[0] > 1.0:
            dq.popleft()
        return len(dq) >= limit

    def _reject(self, message: str, table: str, tenant: str) -> None:
        from pinot_tpu_torch.common.metrics import broker_metrics

        self.rejected += 1
        broker_metrics().meter(
            "broker.admission.quotaRejected", table=table, tenant=tenant or "unknown"
        ).mark()
        raise QuotaExceededError(message, retry_after_s=1.0)

    def _tenant_of(self, table: str) -> str:
        from pinot_tpu_torch.cluster.tenancy import table_tenants

        config = self._controller.get_table(table) or self._controller.get_table(
            f"{table}_REALTIME"
        )
        return table_tenants(config)[1] if config is not None else ""

    def acquire(self, table: str, tenant: str | None = None) -> None:
        """Admit or reject one query against the table's QPS quota and (when
        configured) the owning tenant's aggregate QPS quota. The tenant is
        resolved from the table config when not supplied — and only when
        tenant quotas exist, so the common no-quota path stays one lookup."""
        limit = self._qps_limit(table)
        tenant_limit = None
        if self._tenant_qps:
            if tenant is None:
                tenant = self._tenant_of(table)
            tenant_limit = self._tenant_qps.get(tenant)
        tenant = tenant or ""
        if limit is None and tenant_limit is None:
            return
        now = time.monotonic()
        with self._lock:
            if limit is not None:
                dq = self._hits.setdefault(table, collections.deque())
                if self._over(dq, now, limit):
                    self._reject(
                        f"table {table!r} exceeded query quota of {limit} QPS",
                        table,
                        tenant,
                    )
            if tenant_limit is not None:
                tq = self._tenant_hits.setdefault(tenant, collections.deque())
                if self._over(tq, now, tenant_limit):
                    self._reject(
                        f"tenant {tenant!r} exceeded query quota of {tenant_limit} QPS",
                        table,
                        tenant,
                    )
                tq.append(now)
            if limit is not None:
                self._hits[table].append(now)


class QueryLogger:
    """Rate-limited query logging (QueryLogger parity)."""

    def __init__(self, max_rate_per_sec: float = 10_000.0, logger: logging.Logger | None = None):
        self.max_rate = max_rate_per_sec
        self._logger = logger or logging.getLogger("pinot_tpu_torch.querylog")
        self._window = collections.deque()
        self._dropped = 0
        self._lock = threading.Lock()
        self.emitted = 0  # test/observability counters
        self.dropped_total = 0

    def log(self, sql: str, table: str, time_ms: float, num_docs_scanned: int, exception: str | None = None) -> bool:
        """Returns True when the line was emitted (False = rate-dropped)."""
        now = time.monotonic()
        with self._lock:
            while self._window and now - self._window[0] > 1.0:
                self._window.popleft()
            if len(self._window) >= self.max_rate:
                self._dropped += 1
                self.dropped_total += 1
                return False
            self._window.append(now)
            dropped, self._dropped = self._dropped, 0
            self.emitted += 1
        suffix = f" droppedSince={dropped}" if dropped else ""
        status = f" exception={exception}" if exception else ""
        self._logger.info(
            "table=%s timeMs=%.1f docsScanned=%d%s%s query=%s",
            table,
            time_ms,
            num_docs_scanned,
            status,
            suffix,
            sql,
        )
        return True
