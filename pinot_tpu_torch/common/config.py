"""Table configuration: the subset the port's segment builder reads.

Reference parity: TableConfig / IndexingConfig (pinot-spi/.../config/table/).
Field names match the JAX package's `common/config.py`, so a configuration
written for either package reads the same. The builder encodes columns from
`no_dictionary_columns` / `dictionary_columns`, builds the star-tree tables
of `star_tree_configs`, the null vectors of `null_handling`, and the
auxiliary indexes of every `*_index_columns` / `bloom_filter_columns` field
(segment/indexes.py); `extra["customIndexes"]` names plugin index types
(segment/index_spi.py).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from enum import Enum

from pinot_tpu_torch.common.kernel_obs import DEFAULT_HBM_PEAK_GBPS


class TableType(Enum):
    OFFLINE = "OFFLINE"
    REALTIME = "REALTIME"


@dataclass
class ObservabilityConfig:
    """Broker observability knobs (pinot.broker.* instance-config parity):
    the slow-query log threshold, its bounded in-memory buffer size, and
    distributed-trace sampling / retention."""

    #: queries at or above this wall time get a structured slow-query log
    #: entry on the broker
    slow_query_threshold_ms: float = 1000.0
    #: ring-buffer capacity of Broker.slow_queries (inspection/debug surface)
    slow_query_log_max_entries: int = 128
    #: probability [0, 1] of tracing a query that did NOT set `trace=true`
    #: (trace=true always samples; 0.0 = opt-in only, the default)
    trace_sample_rate: float = 0.0
    #: ring-buffer capacity of Broker.traces (GET /debug/traces)
    trace_buffer_max_entries: int = 64
    #: start the continuous sampling profiler (common/profiler.py) with the
    #: service; /debug/pprof?seconds=N on-demand capture works either way
    profiler_enabled: bool = False
    #: sampling rate of the profiler daemon (prime default decorrelates from
    #: round-millisecond workload periods — see profiler.py bias caveats)
    profiler_hz: float = 31.0
    #: continuous-ring capacity in distinct collapsed stacks; rarest half is
    #: evicted (and counted) when full
    profiler_ring_max_stacks: int = 2048
    #: declarative SLO objectives evaluated by common/slo.py on the
    #: controller's aggregated cluster series. Keys (all optional; see
    #: slo.DEFAULT_OBJECTIVES): "availability" (fraction, e.g. 0.999),
    #: "p99LatencyMs", "burnRateThreshold", "shortWindowS", "longWindowS",
    #: and "tables": {table: {same keys}} per-table overrides. Empty dict =
    #: defaults (availability 99.9%, latency objective off).
    slo_objectives: dict = field(default_factory=dict)
    #: per-kernel device-time attribution + HBM accounting (common/
    #: kernel_obs.py). On by default: the disabled guard only matters when a
    #: deployment wants the last fraction of a percent back.
    kernel_obs_enabled: bool = True
    #: device-memory peak bandwidth (GB/s) the roofline report compares
    #: achieved bandwidth against: kernel_obs's default, a config number
    #: rather than a probed one so CPU roofline output stays deterministic
    hbm_peak_gbps: float = DEFAULT_HBM_PEAK_GBPS
    #: instrument the HTTP plane with per-request wire-phase timelines and
    #: connection gauges (common/frontend_obs.py, GET /debug/frontend). On
    #: by default — the bookkeeping is a few dict writes per request.
    frontend_obs_enabled: bool = True
    #: heartbeat interval of the scheduling-lag probe (runtime.schedLagMs);
    #: <= 0 disables the probe thread
    sched_lag_interval_ms: float = 50.0
    #: per-predicate scan-path attribution + segment heat accounting
    #: (query/scan_stats.py, common/segment_heat.py). On by default — the
    #: per-segment cost is a handful of dict writes after execution.
    scan_obs_enabled: bool = True

    def to_dict(self) -> dict:
        return {
            "slowQueryThresholdMs": self.slow_query_threshold_ms,
            "slowQueryLogMaxEntries": self.slow_query_log_max_entries,
            "traceSampleRate": self.trace_sample_rate,
            "traceBufferMaxEntries": self.trace_buffer_max_entries,
            "profilerEnabled": self.profiler_enabled,
            "profilerHz": self.profiler_hz,
            "profilerRingMaxStacks": self.profiler_ring_max_stacks,
            "sloObjectives": dict(self.slo_objectives),
            "kernelObsEnabled": self.kernel_obs_enabled,
            "hbmPeakGBps": self.hbm_peak_gbps,
            "frontendObsEnabled": self.frontend_obs_enabled,
            "schedLagIntervalMs": self.sched_lag_interval_ms,
            "scanObsEnabled": self.scan_obs_enabled,
        }

    @staticmethod
    def from_dict(d: dict) -> "ObservabilityConfig":
        return ObservabilityConfig(
            d.get("slowQueryThresholdMs", 1000.0),
            d.get("slowQueryLogMaxEntries", 128),
            d.get("traceSampleRate", 0.0),
            d.get("traceBufferMaxEntries", 64),
            d.get("profilerEnabled", False),
            d.get("profilerHz", 31.0),
            d.get("profilerRingMaxStacks", 2048),
            dict(d.get("sloObjectives", {})),
            d.get("kernelObsEnabled", True),
            d.get("hbmPeakGBps", DEFAULT_HBM_PEAK_GBPS),
            d.get("frontendObsEnabled", True),
            d.get("schedLagIntervalMs", 50.0),
            d.get("scanObsEnabled", True),
        )


@dataclass
class ResilienceConfig:
    """Query-resilience knobs (pinot.broker.timeoutMs / grpc retry parity):
    the default per-query deadline, the allowPartialResults default, mailbox
    send retry/backoff bounds, and the fault-injection rule set chaos tests
    wire through common.faults.FAULTS."""

    #: default per-query deadline when no `SET timeoutMs` is given
    default_timeout_ms: float = 30000.0
    #: default for the allowPartialResults query option
    allow_partial_results: bool = False
    #: DistributedMailbox.send connection-failure retries (beyond the first try)
    mailbox_send_retries: int = 3
    #: first retry backoff; doubles per attempt up to the max
    mailbox_retry_initial_s: float = 0.05
    mailbox_retry_max_s: float = 1.0
    #: how long a closed query id tombstone drops straggler envelopes
    mailbox_tombstone_ttl_s: float = 60.0
    #: fault-injection rules (point -> FaultRule dict) + deterministic seed
    faults: dict = field(default_factory=dict)
    fault_seed: int = 0
    #: hedged scatter (tail-at-scale): after hedge_delay_factor × the
    #: per-(server,table) latency EWMA — clamped to [hedge_delay_min_ms,
    #: hedge_delay_max_ms] — re-issue an unfinished segment-group to a
    #: surviving replica and take whichever answers first
    hedge_enabled: bool = False
    hedge_delay_factor: float = 3.0
    hedge_delay_min_ms: float = 5.0
    hedge_delay_max_ms: float = 500.0
    #: fan-out budget: hedges are suppressed once issued-hedges exceed this
    #: fraction of primary scatter calls (tail-at-scale's "≤5% extra load")
    hedge_budget_fraction: float = 0.05

    def to_dict(self) -> dict:
        return {
            "defaultTimeoutMs": self.default_timeout_ms,
            "allowPartialResults": self.allow_partial_results,
            "mailboxSendRetries": self.mailbox_send_retries,
            "mailboxRetryInitialS": self.mailbox_retry_initial_s,
            "mailboxRetryMaxS": self.mailbox_retry_max_s,
            "mailboxTombstoneTtlS": self.mailbox_tombstone_ttl_s,
            "faults": self.faults,
            "faultSeed": self.fault_seed,
            "hedgeEnabled": self.hedge_enabled,
            "hedgeDelayFactor": self.hedge_delay_factor,
            "hedgeDelayMinMs": self.hedge_delay_min_ms,
            "hedgeDelayMaxMs": self.hedge_delay_max_ms,
            "hedgeBudgetFraction": self.hedge_budget_fraction,
        }

    @staticmethod
    def from_dict(d: dict) -> "ResilienceConfig":
        return ResilienceConfig(
            default_timeout_ms=d.get("defaultTimeoutMs", 30000.0),
            allow_partial_results=d.get("allowPartialResults", False),
            mailbox_send_retries=d.get("mailboxSendRetries", 3),
            mailbox_retry_initial_s=d.get("mailboxRetryInitialS", 0.05),
            mailbox_retry_max_s=d.get("mailboxRetryMaxS", 1.0),
            mailbox_tombstone_ttl_s=d.get("mailboxTombstoneTtlS", 60.0),
            faults=d.get("faults", {}),
            fault_seed=d.get("faultSeed", 0),
            hedge_enabled=d.get("hedgeEnabled", False),
            hedge_delay_factor=d.get("hedgeDelayFactor", 3.0),
            hedge_delay_min_ms=d.get("hedgeDelayMinMs", 5.0),
            hedge_delay_max_ms=d.get("hedgeDelayMaxMs", 500.0),
            hedge_budget_fraction=d.get("hedgeBudgetFraction", 0.05),
        )


@dataclass
class SchedulerConfig:
    """Admission / scheduling knobs for the serving path
    (pinot.query.scheduler.name + accounting-factory parity).

    Selects the QueryScheduler implementation the broker request path and
    the server scatter/stage path run queries through, bounds its per-group
    queues, and tunes the admission controller built on top (wait-estimate
    shedding, quota enforcement, degrade-under-partial)."""

    #: scheduler implementation: "fcfs" | "priority" | "binary_workload";
    #: priority = per-table groups with token-bucket fairness (the default)
    kind: str = "priority"
    #: concurrent query slots (runner threads). The default is deliberately
    #: generous: numpy kernels release the GIL, so steady-state throughput
    #: needs wide concurrency — overload protection comes from the shed
    #: projection and the bounded per-group queues, not a small pool
    num_runners: int = 64
    #: bounded per-group queue length; overflow -> SchedulerRejectedError
    max_pending_per_group: int = 256
    #: token-bucket accrual rate / burst for the priority scheduler
    tokens_per_sec: float = 1.0
    token_burst_sec: float = 4.0
    #: binary-workload lane caps (kind="binary_workload" only)
    secondary_runners: int = 1
    max_secondary_pending: int = 16
    #: master switch: False = run queries inline on the caller thread with
    #: no admission control (the pre-scheduler behavior)
    enabled: bool = True
    #: shed queries whose projected completion exceeds remaining deadline
    #: budget (never enqueue work that is already doomed)
    shed_enabled: bool = True
    #: shed when projected_completion_ms > remaining_ms * this headroom
    #: factor (<1.0 sheds earlier, leaving slack for reduce/transport)
    shed_headroom: float = 0.9
    #: floor for the per-table service-time EWMA so a cold estimator never
    #: projects zero wait
    min_service_ms: float = 1.0
    #: EWMA smoothing for observed service times (weight of the new sample)
    service_ewma_alpha: float = 0.2
    #: under degrade (allowPartialResults + projected overload), keep this
    #: fraction of the planned scatter servers (floor 1)
    degrade_keep_fraction: float = 0.5
    #: estimator-liveness probe: when a shed would rest entirely on the
    #: service-time EWMA (free runners, no queue pressure), admit one query
    #: per this interval per table so the estimate can recover — the EWMA
    #: only updates when a query completes, so shedding everything would
    #: freeze a poisoned estimate forever (FailureDetector probe parity)
    probe_interval_ms: float = 500.0
    #: per-tenant aggregate QPS quotas (tenant -> QPS), enforced by
    #: QueryQuotaManager alongside per-table TableConfig quotas
    tenant_qps: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        return {
            "kind": self.kind,
            "numRunners": self.num_runners,
            "maxPendingPerGroup": self.max_pending_per_group,
            "tokensPerSec": self.tokens_per_sec,
            "tokenBurstSec": self.token_burst_sec,
            "secondaryRunners": self.secondary_runners,
            "maxSecondaryPending": self.max_secondary_pending,
            "enabled": self.enabled,
            "shedEnabled": self.shed_enabled,
            "shedHeadroom": self.shed_headroom,
            "minServiceMs": self.min_service_ms,
            "serviceEwmaAlpha": self.service_ewma_alpha,
            "degradeKeepFraction": self.degrade_keep_fraction,
            "probeIntervalMs": self.probe_interval_ms,
            "tenantQps": dict(self.tenant_qps),
        }

    @staticmethod
    def from_dict(d: dict) -> "SchedulerConfig":
        return SchedulerConfig(
            kind=d.get("kind", "priority"),
            num_runners=d.get("numRunners", 64),
            max_pending_per_group=d.get("maxPendingPerGroup", 256),
            tokens_per_sec=d.get("tokensPerSec", 1.0),
            token_burst_sec=d.get("tokenBurstSec", 4.0),
            secondary_runners=d.get("secondaryRunners", 1),
            max_secondary_pending=d.get("maxSecondaryPending", 16),
            enabled=d.get("enabled", True),
            shed_enabled=d.get("shedEnabled", True),
            shed_headroom=d.get("shedHeadroom", 0.9),
            min_service_ms=d.get("minServiceMs", 1.0),
            service_ewma_alpha=d.get("serviceEwmaAlpha", 0.2),
            degrade_keep_fraction=d.get("degradeKeepFraction", 0.5),
            probe_interval_ms=d.get("probeIntervalMs", 500.0),
            tenant_qps=d.get("tenantQps", {}),
        )

    def make(self):
        """Build the configured QueryScheduler (not started); None when
        scheduling is disabled."""
        if not self.enabled:
            return None
        from pinot_tpu_torch.query.scheduler import make_scheduler

        kind = self.kind.lower()
        if kind == "fcfs":
            return make_scheduler("fcfs", num_runners=self.num_runners)
        if kind in ("binary_workload", "binaryworkload"):
            return make_scheduler(
                "binary_workload",
                num_runners=self.num_runners,
                secondary_runners=self.secondary_runners,
                max_secondary_pending=self.max_secondary_pending,
            )
        if kind != "priority":
            raise ValueError(f"unknown scheduler kind: {self.kind}")
        return make_scheduler(
            "priority",
            num_runners=self.num_runners,
            tokens_per_sec=self.tokens_per_sec,
            token_burst_sec=self.token_burst_sec,
            max_pending_per_group=self.max_pending_per_group,
        )


@dataclass
class CacheConfig:
    """Broker query-cache knobs (the response/plan-cache tier the reference
    keeps beside the QueryQuotaManager; SURVEY §L5).

    Three cooperating tiers, all behind one switch: the result cache (reduced
    responses keyed on normalized SQL + option fingerprint + per-table routing
    version vector), the parse cache (raw SQL -> immutable AST), and the plan
    cache (normalized SQL + schema/routing epoch -> star-expanded statement).
    Invalidation is implicit: any segment-set mutation bumps the owning
    table's routing version, which changes every affected result/plan key."""

    #: master switch: False = every query takes the full
    #: parse -> plan -> scatter -> reduce path (pre-cache behavior)
    enabled: bool = True
    #: cache implementation; "lru" is the only kind today (`make()` rejects
    #: anything else, SchedulerConfig.make parity)
    kind: str = "lru"
    #: result-cache byte budget; least-recently-used entries evict past it
    max_bytes: int = 64 * 1024 * 1024
    #: result-cache entry-count bound (backstop against many tiny entries)
    max_entries: int = 4096
    #: optional wall-clock TTL for every result entry (0 = version-vector
    #: invalidation only, the default: offline data only changes via bumps)
    ttl_ms: float = 0.0
    #: TTL cap for results touching a table with an active consuming
    #: segment — consuming rows change without any metadata mutation, so
    #: freshness is bounded by time, not versions
    realtime_ttl_ms: float = 250.0
    #: parse-cache entry bound (raw SQL text -> parsed statement)
    parse_max_entries: int = 2048
    #: plan-cache entry bound (normalized SQL + epoch -> expanded statement)
    plan_max_entries: int = 2048
    #: single-flight de-dup: N identical concurrent queries compile once and
    #: share one scatter result instead of racing N misses
    single_flight: bool = True

    def to_dict(self) -> dict:
        return {
            "enabled": self.enabled,
            "kind": self.kind,
            "maxBytes": self.max_bytes,
            "maxEntries": self.max_entries,
            "ttlMs": self.ttl_ms,
            "realtimeTtlMs": self.realtime_ttl_ms,
            "parseMaxEntries": self.parse_max_entries,
            "planMaxEntries": self.plan_max_entries,
            "singleFlight": self.single_flight,
        }

    _WIRE_KEYS = frozenset(
        {
            "enabled", "kind", "maxBytes", "maxEntries", "ttlMs",
            "realtimeTtlMs", "parseMaxEntries", "planMaxEntries", "singleFlight",
        }
    )

    @staticmethod
    def from_dict(d: dict) -> "CacheConfig":
        # strict: a typo'd knob silently falling back to its default would
        # read as "cache misbehaving", so unknown keys fail loudly here
        unknown = sorted(set(d) - CacheConfig._WIRE_KEYS)
        if unknown:
            raise ValueError(
                f"unknown CacheConfig key(s): {unknown}; known: {sorted(CacheConfig._WIRE_KEYS)}"
            )
        return CacheConfig(
            enabled=d.get("enabled", True),
            kind=d.get("kind", "lru"),
            max_bytes=int(d.get("maxBytes", 64 * 1024 * 1024)),
            max_entries=int(d.get("maxEntries", 4096)),
            ttl_ms=float(d.get("ttlMs", 0.0)),
            realtime_ttl_ms=float(d.get("realtimeTtlMs", 250.0)),
            parse_max_entries=int(d.get("parseMaxEntries", 2048)),
            plan_max_entries=int(d.get("planMaxEntries", 2048)),
            single_flight=d.get("singleFlight", True),
        )

    def make(self):
        """Build the broker's QueryCaches (None when disabled); rejects
        unknown kinds like SchedulerConfig.make rejects unknown schedulers."""
        if not self.enabled:
            return None
        if self.kind.lower() != "lru":
            raise ValueError(f"unknown cache kind: {self.kind}")
        from pinot_tpu_torch.cluster.result_cache import QueryCaches

        return QueryCaches(self)


@dataclass
class StarTreeIndexConfig:
    """Parity with StarTreeIndexConfig (dimensionsSplitOrder,
    functionColumnPairs, maxLeafRecords)."""

    dimensions_split_order: list[str] = field(default_factory=list)
    function_column_pairs: list[str] = field(default_factory=list)  # e.g. "SUM__revenue"
    max_leaf_records: int = 10000

    def to_dict(self) -> dict:
        return {
            "dimensionsSplitOrder": self.dimensions_split_order,
            "functionColumnPairs": self.function_column_pairs,
            "maxLeafRecords": self.max_leaf_records,
        }

    @staticmethod
    def from_dict(d: dict) -> "StarTreeIndexConfig":
        return StarTreeIndexConfig(
            d.get("dimensionsSplitOrder", []),
            d.get("functionColumnPairs", []),
            d.get("maxLeafRecords", 10000),
        )


@dataclass
class IndexingConfig:
    no_dictionary_columns: list[str] = field(default_factory=list)
    dictionary_columns: list[str] = field(default_factory=list)
    inverted_index_columns: list[str] = field(default_factory=list)
    range_index_columns: list[str] = field(default_factory=list)
    bloom_filter_columns: list[str] = field(default_factory=list)
    star_tree_configs: list[StarTreeIndexConfig] = field(default_factory=list)
    text_index_columns: list[str] = field(default_factory=list)
    json_index_columns: list[str] = field(default_factory=list)
    geo_index_columns: list[list[str]] = field(default_factory=list)
    vector_index_columns: list[str] = field(default_factory=list)
    #: vector index flavor: EXACT (brute-force top-k, the default) or HNSW
    vector_index_type: str = "EXACT"
    fst_index_columns: list[str] = field(default_factory=list)
    map_index_columns: list[str] = field(default_factory=list)
    #: null vector index per column (enableNullHandling parity)
    null_handling: bool = False
    sorted_column: str | None = None

    def to_dict(self) -> dict:
        return {
            "noDictionaryColumns": self.no_dictionary_columns,
            "dictionaryColumns": self.dictionary_columns,
            "invertedIndexColumns": self.inverted_index_columns,
            "rangeIndexColumns": self.range_index_columns,
            "bloomFilterColumns": self.bloom_filter_columns,
            "sortedColumn": self.sorted_column,
            "starTreeConfigs": [c.to_dict() for c in self.star_tree_configs],
            "textIndexColumns": self.text_index_columns,
            "jsonIndexColumns": self.json_index_columns,
            "geoIndexColumns": self.geo_index_columns,
            "vectorIndexColumns": self.vector_index_columns,
            "vectorIndexType": self.vector_index_type,
            "fstIndexColumns": self.fst_index_columns,
            "mapIndexColumns": self.map_index_columns,
            "nullHandlingEnabled": self.null_handling,
        }

    @staticmethod
    def from_dict(d: dict) -> "IndexingConfig":
        return IndexingConfig(
            no_dictionary_columns=d.get("noDictionaryColumns", []),
            dictionary_columns=d.get("dictionaryColumns", []),
            inverted_index_columns=d.get("invertedIndexColumns", []),
            range_index_columns=d.get("rangeIndexColumns", []),
            bloom_filter_columns=d.get("bloomFilterColumns", []),
            sorted_column=d.get("sortedColumn"),
            star_tree_configs=[StarTreeIndexConfig.from_dict(c) for c in d.get("starTreeConfigs", [])],
            text_index_columns=d.get("textIndexColumns", []),
            json_index_columns=d.get("jsonIndexColumns", []),
            geo_index_columns=d.get("geoIndexColumns", []),
            vector_index_columns=d.get("vectorIndexColumns", []),
            vector_index_type=d.get("vectorIndexType", "EXACT"),
            fst_index_columns=d.get("fstIndexColumns", []),
            map_index_columns=d.get("mapIndexColumns", []),
            null_handling=d.get("nullHandlingEnabled", False),
        )


@dataclass
class TableConfig:
    """The reference's TableConfig. `indexing` stays the second positional
    argument, as the port's builder callers pass it; upsert and dedup
    configurations come with the realtime tables (ROADMAP A10)."""

    table_name: str
    indexing: IndexingConfig = field(default_factory=IndexingConfig)
    #: free-form settings; "customIndexes": {index type: [columns]}
    extra: dict = field(default_factory=dict)
    table_type: TableType = TableType.OFFLINE
    replication: int = 1
    time_column: str | None = None
    upsert: None = None
    dedup: None = None

    @property
    def table_name_with_type(self) -> str:
        return f"{self.table_name}_{self.table_type.value}"

    def to_json(self) -> str:
        return json.dumps(
            {
                "tableName": self.table_name,
                "tableType": self.table_type.value,
                "indexing": self.indexing.to_dict(),
                "replication": self.replication,
                "timeColumn": self.time_column,
                "upsertConfig": None,
                "dedupConfig": None,
                "extra": self.extra,
            }
        )

    @staticmethod
    def from_json(s: str) -> "TableConfig":
        d = json.loads(s)
        for key in ("upsertConfig", "dedupConfig"):
            if d.get(key):
                raise NotImplementedError(f"TableConfig {key}: upsert and dedup tables are ROADMAP A10")
        return TableConfig(
            table_name=d["tableName"],
            table_type=TableType(d.get("tableType", "OFFLINE")),
            indexing=IndexingConfig.from_dict(d.get("indexing", {})),
            replication=d.get("replication", 1),
            time_column=d.get("timeColumn"),
            extra=d.get("extra", {}),
        )
