"""Per-segment access-heat registry: the eviction signal for tiered storage.

The JAX package's `common/segment_heat.py`. Every segment execution folds
one record here — query count, docs scanned, bytes touched, device time,
last-access wall clock, and a half-life-decayed heat score. `snapshot()`
ranks them (hot->cold, or cold->hot); a segment nobody has touched for an
hour with near-zero heat is the candidate to demote, a top-N hot segment
the one to keep staged on the card. The `/debug/segments` endpoint that
serves it comes with the server process.

Heat is an exponentially-decayed access counter: on each fold,
``heat = heat * 2^(-dt / halflife) + n_queries``.  With the default 300 s
half-life a segment that stops being queried loses half its score every
five minutes, so the ranking reflects *current* pressure rather than
lifetime totals (which ``queries``/``docsScanned`` still carry).

The registry is bounded: when ``max_entries`` is exceeded the coldest record
(lowest decayed heat) is evicted, so a churn-heavy cluster cannot grow this
map without limit.  All methods are thread-safe; ``now_fn`` is injectable so
tests can drive decay deterministically.
"""

from __future__ import annotations

import threading
import time


class SegmentHeatRegistry:
    def __init__(
        self,
        max_entries: int = 4096,
        halflife_s: float = 300.0,
        now_fn=time.time,
    ) -> None:
        self.max_entries = int(max_entries)
        self.halflife_s = float(halflife_s)
        self._now = now_fn
        self._lock = threading.Lock()
        # (table, segment) -> mutable record dict
        self._records: dict[tuple[str, str], dict] = {}

    # -- fold -----------------------------------------------------------------

    def record(
        self,
        table: str,
        segment: str,
        *,
        queries: int = 1,
        docs_scanned: int = 0,
        bytes_touched: int = 0,
        device_ms: float = 0.0,
    ) -> None:
        now = float(self._now())
        key = (str(table), str(segment))
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                if len(self._records) >= self.max_entries:
                    self._evict_coldest_locked(now)
                rec = {
                    "table": key[0],
                    "segment": key[1],
                    "queries": 0,
                    "docsScanned": 0,
                    "bytesTouched": 0,
                    "deviceMs": 0.0,
                    "heat": 0.0,
                    "lastAccessS": now,
                }
                self._records[key] = rec
            rec["heat"] = self._decayed_locked(rec, now) + float(queries)
            rec["lastAccessS"] = now
            rec["queries"] += int(queries)
            rec["docsScanned"] += int(docs_scanned)
            rec["bytesTouched"] += int(bytes_touched)
            rec["deviceMs"] += float(device_ms)

    def _decayed_locked(self, rec: dict, now: float) -> float:
        dt = max(0.0, now - rec["lastAccessS"])
        if dt == 0.0 or rec["heat"] == 0.0:
            return rec["heat"]
        return rec["heat"] * (2.0 ** (-dt / self.halflife_s))

    def _evict_coldest_locked(self, now: float) -> None:
        coldest = min(
            self._records,
            key=lambda k: self._decayed_locked(self._records[k], now),
        )
        del self._records[coldest]

    # -- serve ----------------------------------------------------------------

    def snapshot(self, top: int | None = None, cold: bool = False) -> dict:
        """Ranked heat rows, hottest first (coldest first with ``cold=True``).

        Decay is applied at read time so a snapshot taken long after the last
        fold still ranks correctly; stored records are not mutated.
        """
        now = float(self._now())
        with self._lock:
            rows = [
                {
                    "table": rec["table"],
                    "segment": rec["segment"],
                    "queries": rec["queries"],
                    "docsScanned": rec["docsScanned"],
                    "bytesTouched": rec["bytesTouched"],
                    "deviceMs": round(rec["deviceMs"], 3),
                    "heat": round(self._decayed_locked(rec, now), 6),
                    "lastAccessMs": int(rec["lastAccessS"] * 1000.0),
                    "idleS": round(max(0.0, now - rec["lastAccessS"]), 3),
                }
                for rec in self._records.values()
            ]
        rows.sort(key=lambda r: (r["heat"], r["lastAccessMs"]), reverse=not cold)
        total = len(rows)
        if top is not None:
            rows = rows[: max(0, int(top))]
        return {"segments": rows, "count": total, "order": "cold" if cold else "hot"}

    def reset(self) -> None:
        with self._lock:
            self._records.clear()


# Process-wide registry: engines fold into it.
HEAT = SegmentHeatRegistry()
