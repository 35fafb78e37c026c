"""Deterministic fault injection for chaos testing the distributed query path.

Reference parity: Pinot's failure-injection knobs used by integration tests
(e.g. the failure detector / mailbox tests that kill servers mid-query). Here
a process-global `FaultInjector` holds named injection points the transport
and execution layers call through (`FAULTS.maybe_fail("mailbox.send")`); a
rule per point either raises an `InjectedFault` or sleeps a fixed delay.
Draws come from a seeded `random.Random`, so a chaos test that configures
{point, probability, seed} replays identically.

The JAX package's `common/faults.py`, with its whole set of points. In the
port only `segment.execute` has a caller yet (the engine's dispatch loop);
the others are declared for the layers that will call them.

Well-known points (where the JAX package calls them):
    mailbox.send     — DistributedMailbox.send, before the HTTP POST
    mailbox.deliver  — MailboxRegistry.deliver, before routing an envelope
    segment.execute  — QueryEngine partial resolution, per segment
    server.scatter   — Server.execute_partials entry (v1 scatter target)
    stream.consume   — Server.execute_partials_stream, per yielded frame
    wire.connect     — ConnectionPool._connect, before the TCP connect
    scheduler.admit  — AdmissionController.decide, before any admission math
    server.crash     — Server.execute_partials, hard-down simulation (the
                       whole server looks dead, not one scatter call)
    rebalance.move   — rebalance_table, per segment move before the ADD step
    stream.lag       — PartitionConsumer batch fetch, consumer-lag simulation
    storage.write    — common/durability.py atomic_write_bytes, before the
                       tmp-file write; supports the disk fault modes below
    storage.read     — SegmentFileReader open, after the file bytes are read

Disk fault modes (storage points only): beyond "error"/"delay", a rule may
declare mode "bitflip" (XOR one bit into the payload at `offset`),
"truncate" (drop everything from `offset` on), "torn" (write the prefix
up to `offset` then raise TornWriteFault — a SIGKILL mid-write), or
"enospc" (raise OSError(ENOSPC)). Callers at storage points pass the
payload through `maybe_fail(point, data=...)` and use the returned bytes.
"""

from __future__ import annotations

import errno
import random
import threading
import time
from dataclasses import dataclass


#: Declared injection points (the JAX package's set, which its linter holds
#: against the call sites). Runtime behavior is unaffected: tests may still
#: configure ad-hoc points (e.g. unit tests of the injector itself).
FAULT_POINTS = frozenset(
    {
        "mailbox.send",  # DistributedMailbox.send, before the HTTP POST
        "mailbox.deliver",  # MailboxRegistry.deliver, before routing an envelope
        "segment.execute",  # per-segment execution (v1 engine + v2 leaf scan)
        "server.scatter",  # Server.execute_partials entry (v1 scatter target)
        "stream.consume",  # Server.execute_partials_stream, per yielded frame
        "wire.connect",  # ConnectionPool._connect, before the TCP connect
        "scheduler.admit",  # AdmissionController.decide, before admission math
        "server.crash",  # Server.execute_partials, whole-server hard-down
        "rebalance.move",  # rebalance_table, per segment move (before ADD)
        "stream.lag",  # PartitionConsumer batch fetch, consumer-lag delay
        "storage.write",  # atomic_write_bytes, before the tmp-file write
        "storage.read",  # SegmentFileReader open, after the bytes are read
        "store.cas",  # PropertyStore update/cas, before taking the exclusive
        # section — contended-CAS retry exhaustion on the metadata store
        "lease.renew",  # LeaderElection._tick, before the lease claim —
        # deterministically freezes renewal so a standby takes over while
        # the (stale) ex-leader still believes it leads (split-brain test)
    }
)


class InjectedFault(ConnectionError):
    """Raised by error-mode rules. Subclasses ConnectionError so transport
    layers classify it as a connection-class failure (retry/failover paths
    see exactly what a dead TCP peer produces)."""


class TornWriteFault(InjectedFault):
    """Raised by torn-mode rules at storage points: the writer already put
    `offset` bytes of the payload on disk when the (simulated) SIGKILL hit.
    `common/durability.py` persists exactly that prefix to the tmp file
    before re-raising, so crash-consistency tests can kill a write at every
    byte offset."""

    def __init__(self, message: str, offset: int):
        super().__init__(message)
        self.offset = offset


#: modes that need the payload bytes to act on (disk-corruption shapes)
_DATA_MODES = frozenset({"bitflip", "truncate", "torn"})


@dataclass
class FaultRule:
    mode: str = "error"  # "error" | "delay" | "bitflip" | "truncate" | "torn" | "enospc"
    prob: float = 1.0  # probability each call through the point fires
    delay_s: float = 0.0  # sleep length for mode="delay"
    max_count: int | None = None  # stop firing after N triggers (None = forever)
    message: str = ""  # extra context for the raised error
    offset: int | None = None  # byte offset for bitflip/truncate/torn (None = seeded draw)

    @staticmethod
    def from_dict(d: dict) -> "FaultRule":
        return FaultRule(
            mode=d.get("mode", "error"),
            prob=float(d.get("prob", 1.0)),
            delay_s=float(d.get("delayS", d.get("delay_s", 0.0))),
            max_count=d.get("maxCount", d.get("max_count")),
            message=d.get("message", ""),
            offset=d.get("offset"),
        )


class FaultInjector:
    """Thread-safe registry of injection rules keyed by point name. Disabled
    (no rules) is the production state: `maybe_fail` is one dict check."""

    def __init__(self):
        self._rules: dict[str, FaultRule] = {}
        self._rng = random.Random(0)
        self._counts: dict[str, int] = {}
        self._lock = threading.Lock()

    def configure(self, rules: dict[str, FaultRule | dict], seed: int = 0) -> None:
        """Replace the rule set. `rules`: point -> FaultRule (or its dict
        form, e.g. from ResilienceConfig.faults). Resets trigger counts."""
        with self._lock:
            self._rules = {
                point: r if isinstance(r, FaultRule) else FaultRule.from_dict(r)
                for point, r in rules.items()
            }
            self._rng = random.Random(seed)
            self._counts = {}

    def reset(self) -> None:
        self.configure({})

    @property
    def enabled(self) -> bool:
        return bool(self._rules)

    def counts(self) -> dict[str, int]:
        """point -> number of times its rule fired (test assertions)."""
        with self._lock:
            return dict(self._counts)

    def maybe_fail(self, point: str, data: bytes | None = None) -> bytes | None:
        """Fire the rule for `point`, if any. Storage call sites pass the
        payload via `data` and use the return value: corruption modes
        (bitflip/truncate) hand back a mutated copy; every other outcome
        returns `data` unchanged (or None when no payload was given)."""
        if not self._rules:  # production fast path
            return data
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return data
            fired = self._counts.get(point, 0)
            if rule.max_count is not None and fired >= rule.max_count:
                return data
            if rule.mode in _DATA_MODES and data is None:
                return data  # corruption modes only act where bytes flow
            if rule.prob < 1.0 and self._rng.random() >= rule.prob:
                return data
            self._counts[point] = fired + 1
            if rule.offset is not None:
                off = int(rule.offset)
            else:
                off = self._rng.randrange(len(data)) if data else 0
        if rule.mode == "delay":
            time.sleep(rule.delay_s)
            return data
        detail = f": {rule.message}" if rule.message else ""
        if rule.mode == "bitflip":
            if not data:
                return data
            off = min(off, len(data) - 1)
            mutated = bytearray(data)
            mutated[off] ^= 1 << (off % 8)
            return bytes(mutated)
        if rule.mode == "truncate":
            return data[: min(off, len(data))]
        if rule.mode == "torn":
            raise TornWriteFault(
                f"injected torn write at {point} offset {off}{detail}", offset=off
            )
        if rule.mode == "enospc":
            raise OSError(
                errno.ENOSPC, f"injected ENOSPC at {point}{detail}"
            )
        raise InjectedFault(f"injected fault at {point}{detail}")


#: process-global injector; production code calls FAULTS.maybe_fail(point)
FAULTS = FaultInjector()
