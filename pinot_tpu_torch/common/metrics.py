"""Metrics registry: typed meters / gauges / timers / histograms per node role.

Reference parity: PinotMetricsRegistry SPI (pinot-spi/.../metrics/) with the
yammer/dropwizard plugins collapsed into one thread-safe in-process registry,
and the typed metric names of pinot-common/.../metrics/. This is the JAX
package's `common/metrics.py` cut to what the engine, `kernel_obs` and the
cluster's server, broker and controller use: the metric kinds, the labelled
registry and its JSON snapshot, the Prometheus text form, ServerMeter /
ScanMeter / ServerTimer, the broker, controller and minion enums and the
per-role registries, and the federated histogram merge the controller's
metrics aggregator and SLO evaluator read.
"""

from __future__ import annotations

import bisect
import math
import re
import threading
import time
from enum import Enum


class Meter:
    """Monotone event counter (yammer Meter parity, without rate decay —
    rates are derived by scrapers from (count, first_ts, last_ts))."""

    __slots__ = ("count", "first_ts", "last_ts", "_lock")

    def __init__(self):
        self.count = 0
        self.first_ts = None
        self.last_ts = None
        self._lock = threading.Lock()

    def mark(self, n: int = 1) -> None:
        now = time.time()
        with self._lock:
            self.count += n
            if self.first_ts is None:
                self.first_ts = now
            self.last_ts = now

    def one_minute_rate(self) -> float:
        with self._lock:
            if not self.count or self.first_ts is None or self.last_ts == self.first_ts:
                return 0.0
            return self.count / max(self.last_ts - self.first_ts, 1e-9)


class Gauge:
    """Settable point-in-time value (ServerGauge.LLC_PARTITION_CONSUMING style)."""

    __slots__ = ("value", "_lock")

    def __init__(self):
        self.value = 0
        self._lock = threading.Lock()

    def set(self, v) -> None:
        with self._lock:
            self.value = v

    def add(self, delta) -> None:
        with self._lock:
            self.value += delta


# HDR-style log-linear bucket bounds shared by every Histogram: geometric
# upper bounds from 10µs to ~22min with ratio 2^(1/4) (~19% max relative
# error — two significant figures, the HdrHistogram default precision class).
# A fixed shared tuple keeps each instance to one small counts list.
_HIST_RATIO = 2.0 ** 0.25
_HIST_BOUNDS: tuple = tuple(0.01 * _HIST_RATIO**i for i in range(int(math.log(1.4e8, _HIST_RATIO)) + 1))


class Histogram:
    """Bucketed duration histogram with p50/p95/p99 (HdrHistogram parity:
    fixed log-linear buckets, constant memory, O(buckets) quantile reads).
    Values are milliseconds; quantiles return the bucket upper bound clamped
    to the observed [min, max] so exact extremes survive bucketing."""

    __slots__ = ("counts", "count", "total_ms", "min_ms", "max_ms", "_lock")

    def __init__(self):
        self.counts = [0] * (len(_HIST_BOUNDS) + 1)  # +1 = overflow bucket
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0
        self._lock = threading.Lock()

    @staticmethod
    def _bucket(ms: float) -> int:
        if ms <= _HIST_BOUNDS[0]:
            return 0
        i = int(math.log(ms / 0.01, _HIST_RATIO)) + 1
        # float-log edge wobble: settle on the first bound >= ms
        while i < len(_HIST_BOUNDS) and _HIST_BOUNDS[i] < ms:
            i += 1
        while i > 0 and _HIST_BOUNDS[i - 1] >= ms:
            i -= 1
        return i

    def update_ms(self, ms: float) -> None:
        ms = max(float(ms), 0.0)
        with self._lock:
            self.counts[self._bucket(ms)] += 1
            self.count += 1
            self.total_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)

    def quantile_ms(self, q: float) -> float:
        with self._lock:
            if not self.count:
                return 0.0
            target = max(1, math.ceil(q * self.count))
            seen = 0
            for i, c in enumerate(self.counts):
                seen += c
                if seen >= target:
                    bound = _HIST_BOUNDS[i] if i < len(_HIST_BOUNDS) else self.max_ms
                    return min(max(bound, self.min_ms), self.max_ms)
            return self.max_ms

    def mean_ms(self) -> float:
        with self._lock:
            return self.total_ms / self.count if self.count else 0.0

    def bucket_counts(self) -> "list[tuple[float, int]]":
        """Cumulative (upper_bound_ms, count) pairs, Prometheus `le` style;
        the final pair's bound is +inf."""
        out = []
        cum = 0
        with self._lock:
            for i, c in enumerate(self.counts):
                cum += c
                if c or i == len(self.counts) - 1:
                    out.append((_HIST_BOUNDS[i] if i < len(_HIST_BOUNDS) else float("inf"), cum))
        return out

    def load_cumulative(self, pairs, total_ms: float = 0.0, max_ms=None) -> None:
        """Replace this histogram's contents with externally merged cumulative
        `(le, cum)` pairs (a scraped/federated series), re-bucketed onto the
        shared `_HIST_BOUNDS` via `rebucket_counts` — conservative, so the
        total count is preserved exactly and quantiles only round up."""
        per = rebucket_counts(pairs, _HIST_BOUNDS)
        n = sum(per)
        hi = 0.0
        for i in range(len(per) - 1, -1, -1):
            if per[i]:
                hi = _HIST_BOUNDS[i] if i < len(_HIST_BOUNDS) else _HIST_BOUNDS[-1] * _HIST_RATIO
                break
        with self._lock:
            self.counts = per
            self.count = n
            self.total_ms = float(total_ms)
            self.min_ms = 0.0 if n else float("inf")
            self.max_ms = float(max_ms) if max_ms is not None else hi

    class _Ctx:
        __slots__ = ("_hist", "_t0")

        def __init__(self, hist):
            self._hist = hist

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._hist.update_ms((time.perf_counter() - self._t0) * 1e3)
            return False

    def time(self) -> "_Ctx":
        return Histogram._Ctx(self)


class Timer:
    """Duration recorder with count/total/min/max (yammer Timer parity) plus
    an embedded Histogram so every existing ServerTimer/BrokerTimer call site
    gets p50/p95/p99 for free."""

    __slots__ = ("count", "total_ms", "min_ms", "max_ms", "hist", "_lock")

    def __init__(self):
        self.count = 0
        self.total_ms = 0.0
        self.min_ms = float("inf")
        self.max_ms = 0.0
        self.hist = Histogram()
        self._lock = threading.Lock()

    def update_ms(self, ms: float) -> None:
        with self._lock:
            self.count += 1
            self.total_ms += ms
            self.min_ms = min(self.min_ms, ms)
            self.max_ms = max(self.max_ms, ms)
        self.hist.update_ms(ms)

    def quantile_ms(self, q: float) -> float:
        return self.hist.quantile_ms(q)

    def mean_ms(self) -> float:
        with self._lock:
            return self.total_ms / self.count if self.count else 0.0

    class _Ctx:
        __slots__ = ("_timer", "_t0")

        def __init__(self, timer):
            self._timer = timer

        def __enter__(self):
            self._t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self._timer.update_ms((time.perf_counter() - self._t0) * 1e3)
            return False

    def time(self) -> "_Ctx":
        return Timer._Ctx(self)


# -- histogram merge (federated scrape) ---------------------------------------
#
# Nodes may expose histograms with *different* bucket boundaries (different
# build revisions, sparse `bucket_counts()` output, foreign exporters). A
# correct merge must never drop counts: every source bucket's population is
# re-assigned to the smallest target bound >= its own upper bound — latency is
# only ever over-estimated, and the merged `+Inf` count equals the sum of the
# per-source `_count`s (the exposition invariant, preserved end-to-end).


def _bucket_deltas(pairs) -> "list[tuple[float, int]]":
    """Cumulative `(le, cum)` pairs -> per-bucket `(le, delta)` counts.
    Non-monotone cumulative values (a decreasing scrape artifact) clamp to
    zero deltas rather than going negative."""
    out = []
    prev = 0
    for le, cum in sorted(pairs, key=lambda p: p[0]):
        d = int(cum) - prev
        if d > 0:
            out.append((float(le), d))
            prev = int(cum)
    return out


def merge_cumulative_buckets(series) -> "list[tuple[float, int]]":
    """Merge cumulative `(le, cum)` bucket lists from many nodes into one
    cumulative list over the union of all finite bounds, ending in `(+inf,
    total)`. Because the union contains every source bound, each finite
    bucket maps exactly; source `+Inf` populations stay in `+Inf`. The
    result satisfies `merged +Inf == Σ source _count` by construction."""
    inf = float("inf")
    bounds = sorted({float(le) for s in series for le, _ in s if float(le) != inf})
    at = {b: 0 for b in bounds}
    overflow = 0
    for s in series:
        for le, d in _bucket_deltas(s):
            if le == inf:
                overflow += d
            else:
                at[le] += d
    out = []
    cum = 0
    for b in bounds:
        cum += at[b]
        out.append((b, cum))
    out.append((inf, cum + overflow))
    return out


def rebucket_counts(pairs, bounds) -> "list[int]":
    """Re-bucket cumulative `(le, cum)` pairs onto a fixed ascending bound
    list, returning per-bucket counts with one trailing overflow slot.
    Conservative: each source bucket lands at the smallest target bound >=
    its own (never a smaller one), and anything past the last bound —
    including the source `+Inf` bucket — lands in the overflow slot, so the
    total count is preserved exactly."""
    counts = [0] * (len(bounds) + 1)
    for le, d in _bucket_deltas(pairs):
        i = bisect.bisect_left(bounds, le) if le != float("inf") else len(bounds)
        counts[min(i, len(bounds))] += d
    return counts


def buckets_to_json(pairs) -> list:
    """`(le, cum)` pairs -> JSON-safe `[[le, cum], ...]` with the infinite
    bound spelled `"+Inf"` (strict JSON has no float Infinity)."""
    return [["+Inf" if float(le) == float("inf") else float(le), int(cum)] for le, cum in pairs]


def buckets_from_json(raw) -> "list[tuple[float, int]]":
    """Inverse of `buckets_to_json`; `float("+Inf")` parses to inf."""
    return [(float(le), int(cum)) for le, cum in raw]


def quantile_from_buckets(pairs, q: float) -> float:
    """Quantile read off cumulative `(le, cum)` pairs (bucket upper bound —
    the same over-estimate a Histogram reports). Empty -> 0.0; populations
    in `+Inf` report the largest finite bound (best available estimate)."""
    pairs = sorted(pairs, key=lambda p: p[0])
    total = pairs[-1][1] if pairs else 0
    if not total:
        return 0.0
    target = max(1, math.ceil(q * total))
    finite = [le for le, _ in pairs if le != float("inf")]
    for le, cum in pairs:
        if cum >= target:
            return le if le != float("inf") else (finite[-1] if finite else 0.0)
    return finite[-1] if finite else 0.0


def _escape_label_value(v: str) -> str:
    # per the exposition format spec: backslash, double-quote and line feed
    # are the only escapes inside a label value
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _label_key(k: str) -> str:
    # label names share the metric-name charset minus the colon
    return re.sub(r"[^a-zA-Z0-9_]", "_", str(k))


def series_key(base: str, labels: dict | None) -> str:
    """Canonical registry key for one (metric, labels) series: the base name
    with a sorted, escaped `{k="v",...}` suffix. Two call sites passing the
    same labels in any order resolve to the same underlying metric."""
    if not labels:
        return base
    body = ",".join(
        f'{_label_key(k)}="{_escape_label_value(str(v))}"' for k, v in sorted(labels.items())
    )
    return f"{base}{{{body}}}"


class MetricsRegistry:
    """Thread-safe name -> metric registry (PinotMetricsRegistry parity).

    Metrics accept optional labels (`registry.meter("queries", table="t",
    tenant="gold")`), the ServerMeter-with-table-suffix pattern of the
    reference generalized to real Prometheus label pairs: each distinct
    label set is its own series keyed by `series_key()`, rendered as
    `{label="value"}` in the exposition."""

    def __init__(self, role: str = ""):
        self.role = role
        self._metrics: dict[str, object] = {}
        #: series key -> (base name, labels) for labelled series only
        self._labels: dict[str, tuple[str, dict]] = {}
        self._lock = threading.Lock()

    def _get(self, name, cls, labels: dict | None = None):
        base = name.value if isinstance(name, Enum) else str(name)
        key = series_key(base, labels)
        with self._lock:
            m = self._metrics.get(key)
            if m is None:
                m = cls()
                self._metrics[key] = m
                if labels:
                    self._labels[key] = (base, dict(labels))
            elif not isinstance(m, cls):
                raise TypeError(f"metric {key} already registered as {type(m).__name__}")
            return m

    def series_labels(self, key: str) -> "tuple[str, dict]":
        """(base name, labels) for a registry key; unlabelled -> (key, {})."""
        with self._lock:
            return self._labels.get(key, (key, {}))

    def meter(self, name, **labels) -> Meter:
        return self._get(name, Meter, labels)

    def gauge(self, name, **labels) -> Gauge:
        return self._get(name, Gauge, labels)

    def timer(self, name, **labels) -> Timer:
        return self._get(name, Timer, labels)

    def histogram(self, name, **labels) -> Histogram:
        return self._get(name, Histogram, labels)

    def snapshot(self) -> dict:
        """Flat JSON-able dump (the JMX/exposition analog)."""
        out = {}
        with self._lock:
            items = list(self._metrics.items())
            labelled = dict(self._labels)
        for k, m in items:
            if isinstance(m, Meter):
                out[k] = {"type": "meter", "count": m.count}
            elif isinstance(m, Gauge):
                out[k] = {"type": "gauge", "value": m.value}
            elif isinstance(m, Timer):
                out[k] = {
                    "type": "timer",
                    "count": m.count,
                    "totalMs": m.total_ms,
                    "meanMs": m.mean_ms(),
                    "maxMs": m.max_ms if m.count else 0.0,
                    "p50Ms": m.quantile_ms(0.5),
                    "p95Ms": m.quantile_ms(0.95),
                    "p99Ms": m.quantile_ms(0.99),
                    "buckets": buckets_to_json(m.hist.bucket_counts()),
                }
            elif isinstance(m, Histogram):
                out[k] = {
                    "type": "histogram",
                    "count": m.count,
                    "totalMs": m.total_ms,
                    "meanMs": m.mean_ms(),
                    "maxMs": m.max_ms if m.count else 0.0,
                    "p50Ms": m.quantile_ms(0.5),
                    "p95Ms": m.quantile_ms(0.95),
                    "p99Ms": m.quantile_ms(0.99),
                    "buckets": buckets_to_json(m.bucket_counts()),
                }
            if k in labelled and k in out:
                out[k]["labels"] = dict(labelled[k][1])
        return out


# -- Prometheus exposition ----------------------------------------------------


def _prom_name(key: str) -> str:
    # exposition names must match [a-zA-Z_:][a-zA-Z0-9_:]*
    return "pinot_" + re.sub(r"[^a-zA-Z0-9_:]", "_", key)


def _prom_num(v) -> str:
    if v == float("inf"):
        return "+Inf"
    return repr(float(v)) if isinstance(v, float) else str(v)


def _prom_labels(labels: dict, **extra) -> str:
    """`{k="v",...}` suffix with spec escaping; "" when no labels. `extra`
    pairs (the histogram `le`) render after the sorted user labels."""
    pairs = [
        (_label_key(k), _escape_label_value(str(v))) for k, v in sorted(labels.items())
    ] + [(k, _escape_label_value(str(v))) for k, v in extra.items()]
    if not pairs:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"


def prometheus_text(registry: "MetricsRegistry") -> str:
    """Render one registry in the Prometheus text exposition format 0.0.4
    (the PinotMetricsRegistry -> JMX -> jmx_exporter chain collapsed to one
    renderer). Meters become `_total` counters, gauges map directly; timers
    and histograms are full histogram families — cumulative
    `_bucket{le="..."}` series always terminated by a `+Inf` bucket equal to
    `_count`, plus `_sum` and `_p50`/`_p95`/`_p99` quantile gauges. Labelled
    series render `{label="value"}` pairs (escaped per the spec) and share
    one `# TYPE` line per family. Durations stay in milliseconds — the
    metric names already carry the Ms suffix."""
    with registry._lock:
        items = sorted(registry._metrics.items())
        labelled = dict(registry._labels)
    lines: list[str] = []
    typed: set[str] = set()

    def _type(name: str, kind: str) -> None:
        if name not in typed:
            typed.add(name)
            lines.append(f"# TYPE {name} {kind}")

    def _hist_family(name: str, lbl: str, labels: dict, m, hist: Histogram) -> None:
        _type(name, "histogram")
        for bound, cum in hist.bucket_counts():
            lines.append(f"{name}_bucket{_prom_labels(labels, le=_prom_num(bound))} {cum}")
        lines.append(f"{name}_sum{lbl} {_prom_num(m.total_ms)}")
        lines.append(f"{name}_count{lbl} {m.count}")
        for q, suffix in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
            _type(f"{name}_{suffix}", "gauge")
            lines.append(f"{name}_{suffix}{lbl} {_prom_num(m.quantile_ms(q))}")

    for key, m in items:
        base, labels = labelled.get(key, (key, {}))
        name = _prom_name(base)
        lbl = _prom_labels(labels)
        if isinstance(m, Meter):
            _type(f"{name}_total", "counter")
            lines.append(f"{name}_total{lbl} {m.count}")
        elif isinstance(m, Gauge):
            _type(name, "gauge")
            lines.append(f"{name}{lbl} {_prom_num(m.value)}")
        elif isinstance(m, Timer):
            _hist_family(name, lbl, labels, m, m.hist)
        elif isinstance(m, Histogram):
            _hist_family(name, lbl, labels, m, m)
    return "\n".join(lines) + "\n"


PROMETHEUS_CONTENT_TYPE = "text/plain; version=0.0.4"


# -- typed metric names (subset of pinot-common/.../metrics enums) -----------


class ServerMeter(Enum):
    QUERIES = "server.queries"
    NUM_DOCS_SCANNED = "server.numDocsScanned"
    NUM_SEGMENTS_QUERIED = "server.numSegmentsQueried"
    NUM_SEGMENTS_PRUNED = "server.numSegmentsPruned"
    DEVICE_FALLBACKS = "server.deviceFallbacks"
    MULTISTAGE_LEAF_DEVICE_SCANS = "server.multistageLeafDeviceScans"
    REALTIME_ROWS_CONSUMED = "server.realtimeRowsConsumed"
    QUERIES_KILLED = "server.queriesKilled"
    SCHEDULING_TIMEOUTS = "server.schedulingTimeouts"
    MAILBOX_STRAGGLER_DROPS = "server.mailboxStragglerDrops"


class ScanMeter(Enum):
    #: scan-path plane (one series per table label; PREDICATES also carries
    #: an index= label naming the access path that served the predicate)
    PREDICATES = "server.scan.predicates"
    ENTRIES_IN_FILTER = "server.scan.entriesInFilter"
    ENTRIES_POST_FILTER = "server.scan.entriesPostFilter"
    #: predicate full-scanned a column whose segment declares a usable index
    #: (the offender signal: follow /debug/segments -> /debug/traces/{id})
    FULL_SCAN_FALLBACK = "server.scan.fullScanFallback"


class ServerHistogram(Enum):
    #: event-to-queryable latency: stream-producer stamp -> row visible in
    #: the consuming segment (freshness SLO input, one series per table)
    FRESHNESS = "server.freshnessMs"


class IngestGauge(Enum):
    #: per-(table, partition) consumer lag in events: upstream head minus
    #: the committed read offset (the "how far behind" the freshness SLO
    #: can't distinguish from slow commits on its own)
    LAG_EVENTS = "server.ingest.lagEvents"


class IngestTimer(Enum):
    #: seal -> durable commit latency per rollover (one series per table)
    COMMIT_LATENCY = "server.ingest.commitLatencyMs"


class ServerTimer(Enum):
    QUERY_EXECUTION = "server.queryExecutionMs"
    SEGMENT_LOAD = "server.segmentLoadMs"
    DEVICE_EXECUTION = "server.deviceExecutionMs"


class BrokerMeter(Enum):
    QUERIES = "broker.queries"
    NO_SERVING_HOST = "broker.noServingHostForSegment"
    REQUEST_FAILURES = "broker.requestFailures"
    QUERIES_TIMED_OUT = "broker.queriesTimedOut"
    QUERIES_CANCELLED = "broker.queriesCancelled"
    PARTIAL_RESPONSES = "broker.partialResponses"
    DOCS_SCANNED = "broker.docsScanned"
    # admission tier (one series per table label)
    ADMISSION_ADMITTED = "broker.admission.admitted"
    ADMISSION_SHED = "broker.admission.shed"
    ADMISSION_QUOTA_REJECTED = "broker.admission.quotaRejected"
    ADMISSION_DEGRADED = "broker.admission.degraded"
    ADMISSION_PROBED = "broker.admission.probed"
    # hedged scatter (tail-at-scale): extra replica requests issued after the
    # EWMA hedge delay, split by which leg answered first
    HEDGE_ISSUED = "broker.hedge.issued"
    HEDGE_WON = "broker.hedge.won"
    HEDGE_WASTED = "broker.hedge.wasted"


class BrokerGauge(Enum):
    ONLINE_SERVERS = "broker.onlineServers"
    ADMISSION_QUEUE_DEPTH = "broker.admission.queueDepth"
    ADMISSION_IN_FLIGHT = "broker.admission.inFlight"


class BrokerTimer(Enum):
    QUERY_TOTAL = "broker.queryTotalMs"
    REDUCE = "broker.reduceMs"
    SCATTER_GATHER = "broker.scatterGatherMs"


class ControllerMeter(Enum):
    SEGMENT_UPLOADS = "controller.segmentUploads"
    TABLE_ADDS = "controller.tableAdds"


class MinionMeter(Enum):
    TASKS_EXECUTED = "minion.tasksExecuted"
    TASKS_FAILED = "minion.tasksFailed"


# global per-role registries (the reference holds one registry per started
# service; in-process multi-role tests share by role name)
_registries: dict[str, MetricsRegistry] = {}
_reg_lock = threading.Lock()


def get_registry(role: str) -> MetricsRegistry:
    with _reg_lock:
        r = _registries.get(role)
        if r is None:
            r = MetricsRegistry(role)
            _registries[role] = r
        return r


def reset_registries() -> None:
    """Test hook."""
    with _reg_lock:
        _registries.clear()


server_metrics = lambda: get_registry("server")  # noqa: E731
broker_metrics = lambda: get_registry("broker")  # noqa: E731
controller_metrics = lambda: get_registry("controller")  # noqa: E731
minion_metrics = lambda: get_registry("minion")  # noqa: E731
