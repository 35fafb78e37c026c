"""SLO plane: declarative objectives, error budgets, multi-window burn-rate
alerts over the federated cluster series.

Reference parity: the reference cluster leaves SLO evaluation to external
Prometheus/Alertmanager stacks fed by ValidationMetrics; here the controller
is the hub, so the evaluator lives in-process and consumes the
`ClusterMetricsAggregator`'s accumulated series directly. The alerting model
is the SRE-workbook multi-window burn rate: an availability objective of
99.9% leaves an error budget of 0.1%; the burn rate is the windowed error
rate divided by that budget, and an alert fires only when BOTH a short
(5m-analog) and a long (1h-analog) window burn faster than the threshold —
the short window gates on recency (no alerting on long-resolved incidents),
the long window on significance (no alerting on one bad scrape). Latency
objectives fire the same way on windowed p99 read off merged cumulative
buckets. Alerts are a deduped `ok -> firing -> resolved` state machine keyed
by (objective, table), kept in a bounded ring served at `GET /debug/alerts`,
each carrying a trace/slow-query exemplar so an operator can jump straight
from the alert to `/debug/traces/{traceId}`.

All time comes from an injected `now_fn` — tests drive windows without
sleeping.

This is the JAX package's `common/slo.py`, unchanged but for its imports.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque

from pinot_tpu_torch.common.metrics import quantile_from_buckets

#: objective-dict defaults; every knob can be overridden per call via
#: ObservabilityConfig.slo_objectives (camelCase keys, matching its wire form)
DEFAULT_OBJECTIVES = {
    "availability": 0.999,
    "p99LatencyMs": None,  # disabled unless configured
    "freshnessP99Ms": None,  # event-to-queryable p99 target; disabled unless set
    # unrepairable-corruption budget per short window (integrity scrubber
    # feed); any count above this fires — data loss is never acceptable
    "scrubUnrepairable": 0,
    "burnRateThreshold": 1.0,
    "shortWindowS": 300.0,
    "longWindowS": 3600.0,
    "tables": {},
}


def _merged_objectives(raw: dict | None) -> dict:
    obj = dict(DEFAULT_OBJECTIVES)
    obj["tables"] = {}
    for k, v in (raw or {}).items():
        obj[k] = v
    obj["tables"] = {t: dict(o) for t, o in (obj.get("tables") or {}).items()}
    return obj


class SloEvaluator:
    """Consumes one aggregated sample per scrape cycle (`observe()`), keeps a
    bounded history spanning the long window, and evaluates every configured
    objective against short/long windowed deltas. Samples carry *accumulated
    monotone* counters (the aggregator's counter-reset handling has already
    run), so windowed deltas are plain subtractions.

    Thread-safety: `observe()` runs on the periodic-task thread; `alerts()` /
    `status()` are read from HTTP handler threads — all state is guarded by
    one lock and the work under it is pure arithmetic (no I/O)."""

    def __init__(self, objectives: dict | None = None, now_fn=None,
                 registry=None, max_alerts: int = 256):
        self.objectives = _merged_objectives(objectives)
        self.now_fn = now_fn or time.time
        self.registry = registry
        self._history: deque = deque()
        self._alerts: deque = deque(maxlen=max_alerts)
        #: (slo, table) -> live alert dict while in the firing state
        self._firing: dict = {}
        self._ids = itertools.count(1)
        self._last_exemplar: dict = {}  # table|None -> slow-query entry
        self._lock = threading.Lock()

    # -- sample intake --------------------------------------------------------

    def observe(self, sample: dict) -> list[dict]:
        """Record one aggregated sample and evaluate all objectives.

        sample = {"queries": int, "errors": int,
                  "latencyBuckets": [(le, cum), ...],          # accumulated
                  "freshnessBuckets": [(le, cum), ...],        # accumulated
                  "tables": {table: {"queries", "errors", "latencyBuckets",
                                     "freshnessBuckets"}},
                  "exemplars": [slow-query entries, newest last]}

        Returns the list of alert *transitions* (newly fired / newly
        resolved alert dicts) so the caller can cross-link them onto traces
        and slow-query logs."""
        now = self.now_fn()
        with self._lock:
            for ex in sample.get("exemplars") or ():
                self._last_exemplar[None] = ex
                if ex.get("table"):
                    self._last_exemplar[ex["table"]] = ex
            self._history.append((now, sample))
            horizon = now - float(self.objectives["longWindowS"]) - 1.0
            while len(self._history) > 1 and self._history[1][0] <= horizon:
                self._history.popleft()
            transitions = self._evaluate_locked(now)
        self._publish_gauges()
        return transitions

    # -- windowed reads -------------------------------------------------------

    def _window(self, now: float, window_s: float, table: str | None) -> dict:
        """Delta of (queries, errors, latency buckets) over the trailing
        window. The baseline is the newest sample at or before the window
        start; with only one sample everything since process start counts."""
        cur = self._history[-1][1]
        base = None
        start = now - window_s
        for ts, s in self._history:
            if ts <= start:
                base = s
            else:
                break
        if base is None:
            base = {}

        def _pick(s):
            if table is None:
                return s
            return (s.get("tables") or {}).get(table) or {}

        c, b = _pick(cur), _pick(base)
        queries = max(0, int(c.get("queries") or 0) - int(b.get("queries") or 0))
        errors = max(0, int(c.get("errors") or 0) - int(b.get("errors") or 0))

        def _delta_buckets(key: str):
            cur_b = {le: cum for le, cum in (c.get(key) or ())}
            base_b = {le: cum for le, cum in (b.get(key) or ())}
            # per-bound cumulative deltas; a bound the baseline hadn't seen
            # yet contributes its full count, and a running max keeps the
            # result a valid (non-decreasing) cumulative series
            delta_b = []
            hi = 0
            for le, cum in sorted(cur_b.items()):
                hi = max(hi, max(0, cum - base_b.get(le, 0)))
                delta_b.append((le, hi))
            return delta_b

        return {
            "queries": queries,
            "errors": errors,
            "buckets": _delta_buckets("latencyBuckets"),
            "freshnessBuckets": _delta_buckets("freshnessBuckets"),
            "scrubUnrepairable": max(
                0, int(c.get("scrubUnrepairable") or 0) - int(b.get("scrubUnrepairable") or 0)
            ),
        }

    @staticmethod
    def _burn_rate(win: dict, availability: float) -> float:
        budget = max(1e-9, 1.0 - float(availability))
        if not win["queries"]:
            return 0.0
        return (win["errors"] / win["queries"]) / budget

    @staticmethod
    def _p99(win: dict) -> float:
        return quantile_from_buckets(win["buckets"], 0.99)

    # -- evaluation + alert state machine ------------------------------------

    def _evaluate_locked(self, now: float) -> list[dict]:
        transitions = []
        scopes = [(None, self.objectives)]
        for table, override in self.objectives["tables"].items():
            merged = {k: v for k, v in self.objectives.items() if k != "tables"}
            merged.update(override)
            scopes.append((table, merged))
        self._status = {"scopes": {}}
        for table, obj in scopes:
            short = self._window(now, float(obj["shortWindowS"]), table)
            long_ = self._window(now, float(obj["longWindowS"]), table)
            scope_key = table or "_cluster"
            scope_status = {}

            avail = obj.get("availability")
            if avail is not None:
                bs = self._burn_rate(short, avail)
                bl = self._burn_rate(long_, avail)
                thr = float(obj["burnRateThreshold"])
                scope_status["availability"] = {
                    "target": avail, "burnRateShort": bs, "burnRateLong": bl,
                    "errorBudgetRemaining": max(0.0, 1.0 - bl),
                }
                transitions += self._transition(
                    "availability", table, firing=(bs > thr and bl > thr),
                    clear=(bs <= thr), now=now,
                    measured={"burnRateShort": bs, "burnRateLong": bl,
                              "threshold": thr, "target": avail},
                )

            p99_target = obj.get("p99LatencyMs")
            if p99_target is not None:
                ps, pl = self._p99(short), self._p99(long_)
                scope_status["p99Latency"] = {
                    "targetMs": float(p99_target), "p99ShortMs": ps, "p99LongMs": pl,
                }
                transitions += self._transition(
                    "p99Latency", table,
                    firing=(ps > float(p99_target) and pl > float(p99_target)),
                    clear=(ps <= float(p99_target)), now=now,
                    measured={"p99ShortMs": ps, "p99LongMs": pl,
                              "targetMs": float(p99_target)},
                )

            scrub_budget = obj.get("scrubUnrepairable")
            if scrub_budget is not None and table is None:
                # a discrete data-loss event, not a rate: the short window
                # alone both fires and clears (clears once the window rolls
                # past the incident — resolution means "no NEW unrepairable
                # corruption", the lost copy itself needs the runbook)
                n = short["scrubUnrepairable"]
                scope_status["scrubUnrepairable"] = {
                    "budget": int(scrub_budget), "shortWindowCount": n,
                }
                transitions += self._transition(
                    "scrubUnrepairable", table,
                    firing=(n > int(scrub_budget)),
                    clear=(n <= int(scrub_budget)), now=now,
                    measured={"shortWindowCount": n, "budget": int(scrub_budget)},
                )

            fresh_target = obj.get("freshnessP99Ms")
            if fresh_target is not None:
                fs = quantile_from_buckets(short["freshnessBuckets"], 0.99)
                fl = quantile_from_buckets(long_["freshnessBuckets"], 0.99)
                scope_status["freshness"] = {
                    "targetMs": float(fresh_target), "p99ShortMs": fs, "p99LongMs": fl,
                }
                transitions += self._transition(
                    "freshness", table,
                    firing=(fs > float(fresh_target) and fl > float(fresh_target)),
                    clear=(fs <= float(fresh_target)), now=now,
                    measured={"p99ShortMs": fs, "p99LongMs": fl,
                              "targetMs": float(fresh_target)},
                )
            self._status["scopes"][scope_key] = scope_status
        return transitions

    def _transition(self, slo: str, table: str | None, firing: bool,
                    clear: bool, now: float, measured: dict) -> list[dict]:
        """ok -> firing on `firing`; firing -> resolved on `clear` (the short
        window alone clears, so recovery is fast even while the long window
        still remembers the incident). Already-firing alerts dedupe: their
        measured values refresh in place, no new ring entry."""
        key = (slo, table)
        live = self._firing.get(key)
        if live is not None:
            live["measured"] = measured
            if clear:
                live["state"] = "resolved"
                live["resolvedAtMs"] = now * 1000.0
                del self._firing[key]
                return [live]
            return []
        if not firing:
            return []
        exemplar = self._last_exemplar.get(table) or self._last_exemplar.get(None)
        alert = {
            "id": f"alert-{next(self._ids)}",
            "slo": slo,
            "table": table,
            "state": "firing",
            "firedAtMs": now * 1000.0,
            "resolvedAtMs": None,
            "measured": measured,
            "exemplar": dict(exemplar) if exemplar else None,
        }
        self._firing[key] = alert
        self._alerts.append(alert)
        return [alert]

    # -- reads ----------------------------------------------------------------

    def alerts(self) -> list[dict]:
        """Ring contents, newest last; firing entries mutate in place as the
        evaluator refreshes them, resolved ones are frozen."""
        with self._lock:
            return [dict(a) for a in self._alerts]

    def status(self) -> dict:
        """Latest per-scope burn rates / p99s plus the firing count — the
        `cluster.slo.*` gauge source and the /debug/cluster `slo` block."""
        with self._lock:
            st = dict(getattr(self, "_status", {"scopes": {}}))
            st["firing"] = len(self._firing)
            st["objectives"] = {k: v for k, v in self.objectives.items()}
            return st

    def _publish_gauges(self) -> None:
        if self.registry is None:
            return
        st = self.status()
        self.registry.gauge("cluster.slo.alertsFiring").set(st["firing"])
        for scope, per_slo in st["scopes"].items():
            a = per_slo.get("availability")
            if a:
                self.registry.gauge("cluster.slo.burnRate", scope=scope, window="short").set(a["burnRateShort"])
                self.registry.gauge("cluster.slo.burnRate", scope=scope, window="long").set(a["burnRateLong"])
                self.registry.gauge("cluster.slo.errorBudgetRemaining", scope=scope).set(a["errorBudgetRemaining"])
            p = per_slo.get("p99Latency")
            if p:
                self.registry.gauge("cluster.slo.p99Ms", scope=scope, window="short").set(p["p99ShortMs"])
                self.registry.gauge("cluster.slo.p99Ms", scope=scope, window="long").set(p["p99LongMs"])
            f = per_slo.get("freshness")
            if f:
                self.registry.gauge("cluster.slo.freshnessP99Ms", scope=scope, window="short").set(f["p99ShortMs"])
                self.registry.gauge("cluster.slo.freshnessP99Ms", scope=scope, window="long").set(f["p99LongMs"])
