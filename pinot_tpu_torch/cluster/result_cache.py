"""Broker query caches: result cache + parse/plan caches + single-flight.

Reference parity: the broker-side response cache and Calcite plan cache the
reference keeps beside the QueryQuotaManager (SURVEY §L5,
pinot-core/.../query/scheduler/ neighborhood). Three tiers share one
CacheConfig and one labelled meter family
`broker.cache.{hits,misses,evictions,invalidations,bytes}{cache=result|parse|plan}`:

- **Result cache** — bounded LRU of reduced responses, keyed on
  (normalized SQL, option fingerprint, per-table routing version vector).
  Invalidation is implicit: every segment-set mutation (upload, refresh,
  delete, rebalance move, realtime commit) bumps the owning table's routing
  version (Controller.bump_routing_version), which changes the key; the
  superseded entry is detected on the next lookup, counted as an
  invalidation, and dropped. Entries are byte-bounded (`maxBytes`) and a
  result touching a table with an active consuming segment carries a TTL cap
  (`realtimeTtlMs`) because consuming rows change with no metadata mutation.
- **Parse cache** — raw SQL text -> (immutable parsed statement, normalized
  text). Statements handed out are shared; callers must not mutate them
  (the plan tier deep-copies before star expansion).
- **Plan cache** — (normalized SQL, table, routing epoch) -> the
  star-expanded statement + a QueryContext prototype. Per query the broker
  clones the prototype (fresh hints/options dicts, fresh deadline slot) so
  per-request state never leaks between queries sharing a plan.
- **Single-flight** — N identical concurrent misses collapse to one compile
  / one scatter; the other N−1 wait on the winner and read the cache.

Thread-safe throughout; every structure is guarded by one plain lock and
does no blocking work while holding it.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import OrderedDict

from pinot_tpu_torch.query.sql import SqlParseError, parse_sql, tokenize


def normalize_sql(sql: str) -> str:
    """Whitespace-insensitive canonical text: the token stream re-joined
    with single spaces. String literals keep their exact content (they are
    single tokens), so `SELECT 'a  b'` and `SELECT  'a  b'` normalize equal
    while `'a b'` stays distinct. Falls back to the stripped raw text when
    the SQL does not lex (the parser will raise the real error later)."""
    try:
        return " ".join(t.text for t in tokenize(sql) if t.kind != "eof")
    except SqlParseError:
        return sql.strip()


def options_fingerprint(options: dict) -> tuple:
    """Deterministic hashable form of the statement's SET options."""
    return tuple(sorted((str(k), str(v)) for k, v in (options or {}).items()))


def estimate_result_bytes(result) -> int:
    """Cheap size estimate of a cached ResultTable: sampled sizeof over the
    row payload plus a fixed per-entry overhead. Runs on the miss path only,
    so a bounded sample (not an exact deep walk) is the right trade."""
    rows = getattr(result, "rows", None) or []
    overhead = 512
    if not rows:
        return overhead
    sample = rows[:64]
    per_cell = 0
    cells = 0
    for row in sample:
        for cell in row if isinstance(row, (list, tuple)) else (row,):
            per_cell += sys.getsizeof(cell)
            cells += 1
    row_bytes = (per_cell / max(1, cells)) * sum(
        len(r) if isinstance(r, (list, tuple)) else 1 for r in rows[: len(sample)]
    ) / len(sample)
    return int(overhead + row_bytes * len(rows) + 64 * len(rows))


class CacheStats:
    """Lifetime counters for one tier, mirrored into the broker registry as
    labelled meters by QueryCaches (the registry is process-global; these
    plain ints feed /debug/cache without a registry scan)."""

    __slots__ = ("hits", "misses", "evictions", "invalidations")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def to_dict(self) -> dict:
        total = self.hits + self.misses
        return {
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "invalidations": self.invalidations,
            "hitRate": round(self.hits / total, 4) if total else 0.0,
        }


class _SingleFlight:
    """In-flight de-dup: the first caller of `begin(key)` becomes the leader
    (does the work, then `done(key)`); the rest wait on the leader's event
    and re-read whatever cache the leader filled."""

    def __init__(self):
        self._lock = threading.Lock()
        self._flights: dict = {}

    def begin(self, key) -> tuple[bool, threading.Event]:
        """(is_leader, event). Leaders MUST call done(key) in a finally."""
        with self._lock:
            ev = self._flights.get(key)
            if ev is not None:
                return False, ev
            ev = threading.Event()
            self._flights[key] = ev
            return True, ev

    def done(self, key) -> None:
        with self._lock:
            ev = self._flights.pop(key, None)
        if ev is not None:
            ev.set()

    def wait(self, ev: threading.Event, timeout: float | None) -> bool:
        return ev.wait(timeout)


class LruEntryCache:
    """Entry-bounded LRU (parse/plan tiers)."""

    def __init__(self, max_entries: int, stats: CacheStats):
        self.max_entries = max(1, int(max_entries))
        self.stats = stats
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                self.stats.hits += 1
                return self._d[key]
            self.stats.misses += 1
            return None

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.max_entries:
                self._d.popitem(last=False)
                self.stats.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class ResultCache:
    """Byte-bounded LRU of reduced query responses.

    One entry per (normalized SQL, option fingerprint); the entry records the
    routing version vector it was computed against plus an optional absolute
    expiry. A lookup whose current version vector differs from the stored one
    (or that arrives past expiry) drops the entry and counts an invalidation
    — the no-explicit-flush model: mutators only ever bump versions."""

    def __init__(self, max_bytes: int, max_entries: int, stats: CacheStats):
        self.max_bytes = max(0, int(max_bytes))
        self.max_entries = max(1, int(max_entries))
        self.stats = stats
        self._lock = threading.Lock()
        self._d: OrderedDict = OrderedDict()  # key -> entry dict
        self.bytes = 0

    def get(self, key, versions: tuple, now: float | None = None):
        """The cached result for `key` computed against exactly `versions`
        and not yet expired, else None."""
        now = time.monotonic() if now is None else now
        with self._lock:
            ent = self._d.get(key)
            if ent is None:
                self.stats.misses += 1
                return None
            if ent["versions"] != versions or (
                ent["expires"] is not None and now >= ent["expires"]
            ):
                # superseded by a version bump (or aged out of its realtime
                # freshness window): same outcome, the entry is dead
                del self._d[key]
                self.bytes -= ent["size"]
                self.stats.invalidations += 1
                self.stats.misses += 1
                return None
            self._d.move_to_end(key)
            self.stats.hits += 1
            return ent["value"]

    def put(self, key, value, versions: tuple, size: int, ttl_s: float | None) -> None:
        if self.max_bytes and size > self.max_bytes:
            return  # larger than the whole budget: never admit
        now = time.monotonic()
        with self._lock:
            old = self._d.pop(key, None)
            if old is not None:
                self.bytes -= old["size"]
            self._d[key] = {
                "value": value,
                "versions": versions,
                "size": size,
                "expires": now + ttl_s if ttl_s is not None else None,
            }
            self.bytes += size
            while self._d and (
                len(self._d) > self.max_entries
                or (self.max_bytes and self.bytes > self.max_bytes)
            ):
                _, ev = self._d.popitem(last=False)
                self.bytes -= ev["size"]
                self.stats.evictions += 1

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class QueryCaches:
    """The broker's cache plane: one instance per Broker, built by
    CacheConfig.make(). Owns the three tiers, the two single-flight maps
    (compile + scatter), and the meter mirroring."""

    def __init__(self, config):
        self.config = config
        self.result_stats = CacheStats()
        self.parse_stats = CacheStats()
        self.plan_stats = CacheStats()
        self.result = ResultCache(config.max_bytes, config.max_entries, self.result_stats)
        self.parse = LruEntryCache(config.parse_max_entries, self.parse_stats)
        self.plan = LruEntryCache(config.plan_max_entries, self.plan_stats)
        self.compile_flight = _SingleFlight()
        self.result_flight = _SingleFlight()

    # -- metrics ---------------------------------------------------------------

    def _meter(self, event: str, cache: str):
        from pinot_tpu_torch.common.metrics import broker_metrics

        return broker_metrics().meter(f"broker.cache.{event}", cache=cache)

    def mark(self, event: str, cache: str) -> None:
        self._meter(event, cache).mark()

    def publish_gauges(self) -> None:
        from pinot_tpu_torch.common.metrics import broker_metrics

        broker_metrics().gauge("broker.cache.bytes", cache="result").set(self.result.bytes)

    # -- parse tier ------------------------------------------------------------

    def get_or_parse(self, sql: str, on_compile=None):
        """(statement, normalized_text). The returned statement is SHARED
        and must be treated as immutable by callers. `on_compile` wraps the
        actual parse work (the broker passes the requestCompilation phase
        timer) so cache hits never tick the compile phase counter. Identical
        concurrent misses parse once (single-flight)."""
        ent = self.parse.get(sql)
        if ent is not None:
            self.mark("hits", "parse")
            return ent
        if self.config.single_flight:
            leader, ev = self.compile_flight.begin(("parse", sql))
            if not leader:
                self.compile_flight.wait(ev, timeout=30.0)
                ent = self.parse.get(sql)
                if ent is not None:
                    self.mark("hits", "parse")
                    return ent
                # leader failed (parse error most likely): parse ourselves so
                # the caller sees the real exception
                return self._parse_fill(sql, on_compile, record=False)
            try:
                return self._parse_fill(sql, on_compile)
            finally:
                self.compile_flight.done(("parse", sql))
        return self._parse_fill(sql, on_compile)

    def _parse_fill(self, sql: str, on_compile, record: bool = True):
        if record:
            self.mark("misses", "parse")
        if on_compile is not None:
            with on_compile():
                stmt = parse_sql(sql)
        else:
            stmt = parse_sql(sql)
        ent = (stmt, normalize_sql(sql))
        self.parse.put(sql, ent)
        return ent

    # -- plan tier -------------------------------------------------------------

    def get_plan(self, key):
        ent = self.plan.get(key)
        self.mark("hits" if ent is not None else "misses", "plan")
        return ent

    def put_plan(self, key, value) -> None:
        self.plan.put(key, value)

    # -- result tier -----------------------------------------------------------

    def result_get(self, key, versions: tuple):
        inv_before = self.result_stats.invalidations
        value = self.result.get(key, versions)
        self.mark("hits" if value is not None else "misses", "result")
        if self.result_stats.invalidations > inv_before:
            # runbook: stale suspicion -> watch this series move with bumps
            self.mark("invalidations", "result")
        self.publish_gauges()
        return value

    def result_put(self, key, value, versions: tuple, realtime: bool) -> None:
        ttl_ms = self.config.ttl_ms or 0.0
        if realtime:
            ttl_ms = (
                min(ttl_ms, self.config.realtime_ttl_ms)
                if ttl_ms
                else self.config.realtime_ttl_ms
            )
        ev_before = self.result_stats.evictions
        self.result.put(
            key,
            value,
            versions,
            size=estimate_result_bytes(value),
            ttl_s=(ttl_ms / 1000.0) if ttl_ms else None,
        )
        evicted = self.result_stats.evictions - ev_before
        for _ in range(evicted):
            self.mark("evictions", "result")
        self.publish_gauges()

    # -- observability ---------------------------------------------------------

    def snapshot(self) -> dict:
        """The GET /debug/cache document."""
        return {
            "enabled": True,
            "config": self.config.to_dict(),
            "result": {
                **self.result_stats.to_dict(),
                "entries": len(self.result),
                "bytes": self.result.bytes,
                "maxBytes": self.result.max_bytes,
            },
            "parse": {**self.parse_stats.to_dict(), "entries": len(self.parse)},
            "plan": {**self.plan_stats.to_dict(), "entries": len(self.plan)},
        }
