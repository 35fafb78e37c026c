"""Segment completion protocol: multi-replica commit coordination with
pauseless completion, committer-failure re-election, and peer download.

Reference parity:
- SegmentCompletionManager + the completion FSM (pinot-controller/.../helix/
  core/realtime/SegmentCompletionManager.java, segment/CommittingSegment
  states HOLDING -> COMMITTER_DECIDED -> COMMITTING -> COMMITTED) driving
  the segmentConsumed / segmentCommitStart / segmentCommitEnd server calls.
- PauselessSegmentCompletionFSM (pinot-controller/.../realtime/
  PauselessSegmentCompletionFSM.java:46): commit METADATA first so the next
  consuming segment opens immediately; the segment build/upload finishes
  asynchronously.
- Peer download (peerSegmentDownloadScheme): when the deep store has no
  copy, non-committing replicas fetch the built segment from the committer
  server instead.

The FSM is controller-side state keyed by segment name; replicas poll it
from their consume loops. A committer that stops responding past
commit_timeout_s loses its claim and a HOLDING replica is promoted —
the chaos case (replica killed mid-commit) recovers without operator
action.
"""

from __future__ import annotations

import threading
import time

HOLD = "HOLD"
COMMIT = "COMMIT"
CATCHUP = "CATCHUP"
DISCARD_AND_DOWNLOAD = "DISCARD_AND_DOWNLOAD"
KEEP = "KEEP"


class SegmentCompletionManager:
    """Controller-side completion FSM. One instance per controller; state is
    per committing segment."""

    def __init__(self, commit_timeout_s: float = 5.0, max_commit_factor: float = 3.0):
        self.commit_timeout_s = commit_timeout_s
        #: absolute cap on one committer's total commit time — heartbeats
        #: renew the claim, but never past commit_start + timeout*factor
        #: (SegmentCompletionManager MAX_COMMIT_TIME parity)
        self.max_commit_s = commit_timeout_s * max_commit_factor
        self._lock = threading.RLock()
        # in-flight segment -> state dict (evicted on COMMITTED)
        self._fsm: dict[str, dict] = {}
        # compact permanent ledger: segment -> (committed_end, download_from)
        self._committed: dict[str, tuple] = {}

    def _state(self, segment: str) -> dict:
        st = self._fsm.get(segment)
        if st is None:
            st = self._fsm[segment] = {
                "phase": "HOLDING",
                "offsets": {},  # server_id -> reached offset
                "committer": None,
                "commit_deadline": None,
                "winning_offset": None,
                "committed_end": None,
                "download_from": None,
            }
        return st

    # -- server calls --------------------------------------------------------

    def segment_consumed(self, segment: str, server_id: str, offset: int) -> tuple[str, int | None]:
        """A replica reached its end criteria at `offset`. Returns
        (directive, target_offset). Directives: COMMIT (you are the
        committer — build and commit), HOLD (wait; another replica is
        committing or more replicas may arrive), CATCHUP (consume to
        target_offset then call again), DISCARD_AND_DOWNLOAD (segment
        already committed at target_offset — drop local rows, download)."""
        with self._lock:
            done = self._committed.get(segment)
            if done is not None:
                # KEEP: a replica whose local rows cover EXACTLY the
                # committed range builds/serves its own copy — no download
                # (reference CONTROLLER_RESPONSE_KEEP)
                if offset == done[0]:
                    return KEEP, done[0]
                return DISCARD_AND_DOWNLOAD, done[0]
            st = self._state(segment)
            st["offsets"][server_id] = max(st["offsets"].get(server_id, 0), offset)
            if st["phase"] == "COMMITTING":
                if st["committer"] == server_id:
                    # this replica holds the claim (it may have been promoted
                    # by a re-election triggered from ANOTHER replica's poll
                    # or a failed commit_end) — (re)grant COMMIT
                    return COMMIT, st["winning_offset"]
                if self._commit_timed_out(st):
                    self._reelect(segment, st, exclude=st["committer"])
                    if st["committer"] == server_id:
                        return COMMIT, st["winning_offset"]
                return HOLD, st["winning_offset"]
            # HOLDING: largest offset seen so far wins (the reference picks
            # the largest offset among arrivals; stragglers catch up to it)
            winning = max(st["offsets"].values())
            if offset < winning:
                return CATCHUP, winning
            st["phase"] = "COMMITTING"
            st["committer"] = server_id
            st["winning_offset"] = winning
            st["commit_started"] = time.time()
            st["commit_deadline"] = time.time() + self.commit_timeout_s
            return COMMIT, winning

    def commit_heartbeat(self, segment: str, server_id: str) -> bool:
        """Committer extends its claim during a long build/upload (renewed
        up to the absolute max_commit_s cap — a hung committer cannot hold
        the claim forever). Returns False when the claim was lost."""
        with self._lock:
            if segment in self._committed:
                return False
            # .get, not _state: a stray/late heartbeat for an unknown name
            # must not mint a fresh FSM entry in this controller-lifetime map
            st = self._fsm.get(segment)
            if st is None:
                return False
            if st["phase"] != "COMMITTING" or st["committer"] != server_id:
                return False
            started = st.get("commit_started") or time.time()
            if time.time() > started + self.max_commit_s:
                return False
            st["commit_deadline"] = time.time() + self.commit_timeout_s
            return True

    def commit_end(
        self,
        segment: str,
        server_id: str,
        end_offset: int,
        success: bool,
        download_from: str | None = None,
    ) -> bool:
        """Commit finished (or failed). On success the segment is COMMITTED
        and held replicas are told to discard-and-download; `download_from`
        records the committer server for peer download when the deep store
        has no copy. Returns False if this server no longer held the claim."""
        with self._lock:
            if segment in self._committed:
                return False  # a late commit after eviction: rejected
            st = self._fsm.get(segment)
            if st is None or st["committer"] != server_id:
                return False
            if not success:
                self._reelect(segment, st, exclude=server_id)
                return True
            # evict the heavy in-flight state; keep only the compact ledger
            # entry (a controller-lifetime singleton must not grow per-
            # replica dicts forever — review r4)
            self._committed[segment] = (end_offset, download_from)
            del self._fsm[segment]
            return True

    # -- introspection -------------------------------------------------------

    def phase(self, segment: str) -> str:
        with self._lock:
            if segment in self._committed:
                return "COMMITTED"
            st = self._fsm.get(segment)
            return st["phase"] if st is not None else "HOLDING"

    def download_source(self, segment: str) -> str | None:
        with self._lock:
            done = self._committed.get(segment)
            return done[1] if done is not None else None

    # -- internals -----------------------------------------------------------

    def _commit_timed_out(self, st: dict) -> bool:
        return st["commit_deadline"] is not None and time.time() > st["commit_deadline"]

    def _reelect(self, segment: str, st: dict, exclude: str | None) -> None:
        """Committer failed (timeout or explicit failure): drop its claim
        and promote the holding replica with the largest offset — the
        replica-failure-during-commit path (SegmentCompletionManager re-
        election on ControllerLeaderLocator timeouts)."""
        st["offsets"].pop(exclude, None)
        if not st["offsets"]:
            # no live replicas holding: back to HOLDING; the next arrival
            # becomes the committer
            st["phase"] = "HOLDING"
            st["committer"] = None
            st["commit_deadline"] = None
            return
        new = max(st["offsets"], key=lambda s: st["offsets"][s])
        st["committer"] = new
        st["winning_offset"] = max(st["offsets"].values())
        st["commit_started"] = time.time()
        st["commit_deadline"] = time.time() + self.commit_timeout_s
