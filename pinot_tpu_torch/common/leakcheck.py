"""Leak-detection harness: the device-side analog of the reference's test-time
resource leak listeners.

Reference parity: NettyLeakListener (pinot-integration-test-base/.../
NettyLeakListener.java — fails a test run when Netty buffers leak) and the
DirectOOMHandler guard (core/transport/DirectOOMHandler.java). The resources
that can leak HERE are different: staged device-memory copies of segments,
in-flight accountant query registrations, undrained mailbox queues, and
unfinished scheduler work. The harness snapshots/asserts each:

  with leak_check():                      # pytest usage (also a fixture)
      ... run queries / multistage ...
  # exit asserts: no new accountant registrations left behind, registered
  # mailbox fabrics drained, schedulers idle

  tracker.assert_staging_collectable(keep={...})  # device-memory check:
      staged DeviceSegments whose host segment was dropped must be
      GC-collectable (nothing else may pin HBM staging alive)

Staging tracking is always on (a weakref list costs nothing); the harness is
opt-in per test.
"""

from __future__ import annotations

import gc
import threading
import weakref
from contextlib import contextmanager


class StagingTracker:
    """Weakref registry of every DeviceSegment ever staged. A DeviceSegment
    pins its host segment's column arrays in device memory; once the host
    segment is unhosted and queries finish, the staging must be collectable
    or HBM leaks (PinotDataBuffer close-tracking parity)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._staged: list[tuple[weakref.ref, str]] = []

    def track(self, device_segment) -> None:
        with self._lock:
            self._staged.append((weakref.ref(device_segment), device_segment.name))
            # compact dead refs as the list grows so a long-running server
            # doesn't accumulate one tuple per staging forever
            if len(self._staged) > 256 and len(self._staged) % 256 == 0:
                self._staged = [(r, n) for r, n in self._staged if r() is not None]

    def live(self) -> dict[str, int]:
        """Segment name -> count of live staged copies (after a GC pass)."""
        gc.collect()
        out: dict[str, int] = {}
        with self._lock:
            alive = []
            for ref, name in self._staged:
                if ref() is not None:
                    out[name] = out.get(name, 0) + 1
                    alive.append((ref, name))
            self._staged = alive
        return out

    def _assert_none_live(self, is_checked) -> None:
        leaked = {n: c for n, c in self.live().items() if is_checked(n)}
        if leaked:
            raise AssertionError(f"device staging leaked for segments: {leaked}")

    def assert_staging_collectable(self, keep: set[str] = frozenset()) -> None:
        """Assert every staged copy NOT named in `keep` has been collected."""
        self._assert_none_live(lambda n: n not in keep)

    def assert_collected(self, names: set[str]) -> None:
        """Assert the NAMED segments have no live staged copies. Unlike
        assert_staging_collectable this is scoped: unrelated segments other
        components legitimately keep staged (to_device_cached) don't trip
        it, so the check is stable under any test ordering."""
        self._assert_none_live(lambda n: n in names)


#: process-wide tracker (segment.to_device registers here)
staging_tracker = StagingTracker()


def _accountant_snapshot() -> set[str]:
    from pinot_tpu_torch.common.accounting import default_accountant

    with default_accountant._lock:
        return set(default_accountant._queries)


def _mailbox_leaks(service) -> list[tuple]:
    """Non-empty queues in an in-process MailboxService."""
    leaks = []
    for key, q in getattr(service, "_queues", {}).items():
        if not q.empty():
            leaks.append((key, q.qsize()))
    return leaks


@contextmanager
def leak_check(mailbox_services=(), schedulers=()):
    """Assert no resource leaks across the body:
    - accountant registrations present at exit but not at entry
    - undrained queues in the given mailbox services
    - pending work in the given schedulers
    """
    before = _accountant_snapshot()
    yield
    after = _accountant_snapshot()
    stuck = after - before
    if stuck:
        raise AssertionError(f"accountant registrations leaked: {sorted(stuck)}")
    for svc in mailbox_services:
        leaks = _mailbox_leaks(svc)
        if leaks:
            raise AssertionError(f"mailbox queues not drained: {leaks}")
    for sched in schedulers:
        pending = getattr(sched, "pending", None)
        if callable(pending):
            pending = pending()
        if pending:
            raise AssertionError(f"scheduler has pending work at exit: {pending}")
