"""Cluster metadata store: the ZooKeeper/Helix property-store analog.

Reference parity: Pinot keeps TableConfig/Schema/segment ZK metadata and
Helix IdealState/ExternalView in ZooKeeper (orchestrated by
PinotHelixResourceManager, pinot-controller/.../helix/core/
PinotHelixResourceManager.java:192). Here the same shapes live in a
path-keyed JSON store — in-memory for in-process clusters, file-backed for
multi-process ones.

Multi-process contract (the ZK-versioned-write analog):
  * Every mutation runs under an advisory `fcntl.flock` on a per-store
    lockfile (`<root>/.store.lock`), so read-modify-write via `update()` is
    atomic ACROSS PROCESSES, not just across threads — two controllers
    sharing one file-backed store contend correctly on the lead lease.
  * Every write stamps a monotonic per-document version (on disk the doc is
    wrapped as `{"__v": n, "doc": {...}}`); `get_versioned`/`cas` make lost
    updates detectable and preventable, exactly like ZK's setData(version).
    Like a ZK znode, the version restarts when a document is deleted and
    recreated at the same path.
  * Fencing: a mutation may carry `fence=<lease epoch>`. If the lead lease
    document records a NEWER epoch, the write raises `FencedWriteError` —
    a paused/partitioned ex-leader cannot corrupt ideal state after a
    standby takes over (the classic stale-leader split-brain hole).

Layout:
  /schemas/{name}                      -> Schema json
  /tables/{name}/config                -> TableConfig json
  /tables/{name}/idealstate            -> {segment: {server: "ONLINE"|"CONSUMING"}}
  /tables/{name}/segments/{segment}    -> segment zk metadata (docs, stats, location)
  /instances/{server}                  -> instance config (host, port, alive)
  /controllers/{cid}                   -> controller endpoint (host, port)
  /controllers/lease                   -> {owner, expires, epoch} lead lease
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
from pathlib import Path

try:
    import fcntl
except ImportError:  # pragma: no cover — non-POSIX platform: in-process locking only
    fcntl = None

from pinot_tpu_torch.common.durability import atomic_write_json
from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
from pinot_tpu_torch.common.trace import trace_event

#: the lead-controller lease document every fenced write is checked against
LEASE_PATH = "/controllers/lease"


class FencedWriteError(RuntimeError):
    """A store mutation carried a lease epoch older than the current lease:
    the writer is a stale ex-leader (paused, partitioned, or frozen) whose
    lease was taken over. The write was REJECTED; the caller must stop
    acting as leader."""

    def __init__(self, message: str, fence: int, current_epoch: int):
        super().__init__(message)
        self.fence = fence
        self.current_epoch = current_epoch


class PropertyStore:
    """Path -> JSON document store; file-backed when rooted, else in-memory."""

    def __init__(self, root: str | Path | None = None):
        self.root = Path(root) if root else None
        self._mem: dict[str, dict] = {}
        self._mem_ver: dict[str, int] = {}
        self._lock = threading.RLock()
        self._lock_fd: int | None = None

    _SUFFIX = ".doc.json"
    _LOCKFILE = ".store.lock"

    def _file(self, path: str) -> Path:
        # real nested directories: no separator encoding, so names containing
        # any character sequence round-trip exactly
        assert self.root is not None
        parts = [p for p in path.split("/") if p]
        return self.root.joinpath(*parts[:-1]) / (parts[-1] + self._SUFFIX)

    # -- cross-process exclusion ----------------------------------------------

    def _flock_fd(self) -> int:
        # one cached fd per store instance; in-process threads are already
        # serialized by self._lock, so sharing the fd is safe (flock excludes
        # per open-file-description, i.e. per process here)
        if self._lock_fd is None:
            assert self.root is not None
            self.root.mkdir(parents=True, exist_ok=True)
            self._lock_fd = os.open(str(self.root / self._LOCKFILE), os.O_RDWR | os.O_CREAT, 0o644)
        return self._lock_fd

    @contextlib.contextmanager
    def _exclusive(self):
        """Mutation critical section: the store thread lock, plus (file-backed)
        an advisory flock on the per-store lockfile so read-modify-write is
        atomic across PROCESSES — two controllers sharing one store contend
        correctly on the lease instead of silently losing updates."""
        with self._lock:
            if self.root is None or fcntl is None:
                yield
                return
            fd = self._flock_fd()
            fcntl.flock(fd, fcntl.LOCK_EX)
            try:
                yield
            finally:
                fcntl.flock(fd, fcntl.LOCK_UN)

    # -- versioned read/write internals ----------------------------------------

    @staticmethod
    def _unwrap(raw) -> tuple[dict | None, int]:
        """On-disk JSON -> (doc, version). Pre-versioning stores wrote the
        bare doc; those read as version 0 and upgrade on their next write."""
        if isinstance(raw, dict) and set(raw) == {"__v", "doc"}:
            return raw["doc"], int(raw["__v"])
        return raw, 0

    def _read_versioned(self, path: str) -> tuple[dict | None, int]:
        if self.root is None:
            doc = self._mem.get(path)
            if doc is None:
                return None, 0
            return json.loads(json.dumps(doc)), self._mem_ver.get(path, 0)
        f = self._file(path)
        if not f.exists():
            return None, 0
        return self._unwrap(json.loads(f.read_text()))

    def _write(self, path: str, doc: dict, version: int) -> None:
        if self.root is None:
            self._mem[path] = json.loads(json.dumps(doc))
            self._mem_ver[path] = version
            return
        f = self._file(path)
        f.parent.mkdir(parents=True, exist_ok=True)
        # tmp+rename+fsync: a crash mid-set leaves the previous doc
        # intact, never a torn JSON that bricks controller restart
        atomic_write_json(f, {"__v": version, "doc": doc})

    def _check_fence(self, path: str, fence: int | None) -> None:
        """Reject a mutation whose lease epoch is older than the current
        lease document's (caller holds the exclusive section, so the check
        and the write are one atomic step). Lease writes themselves are
        unfenced — the election's `update` closure is the arbiter there."""
        if fence is None or path == LEASE_PATH:
            return
        lease, _ = self._read_versioned(LEASE_PATH)
        current = int((lease or {}).get("epoch", 0))
        if current > fence:
            from pinot_tpu_torch.common.metrics import controller_metrics

            controller_metrics().meter("controller.ha.fencedWrites").mark()
            trace_event("store.fenced_write", path=path, fence=fence, epoch=current)
            raise FencedWriteError(
                f"fenced write to {path!r}: lease epoch {current} > writer epoch {fence} "
                "(stale ex-leader; a standby has taken over)",
                fence=fence,
                current_epoch=current,
            )

    # -- public surface ---------------------------------------------------------

    def set(self, path: str, doc: dict, fence: int | None = None) -> int:
        """Write `doc`, stamping version = current + 1. Returns the version
        written. `fence` (a lease epoch) rejects stale ex-leader writes."""
        with self._exclusive():
            self._check_fence(path, fence)
            _, ver = self._read_versioned(path)
            self._write(path, doc, ver + 1)
            return ver + 1

    def get(self, path: str) -> dict | None:
        with self._lock:
            doc, _ = self._read_versioned(path)
            return doc

    def get_versioned(self, path: str) -> tuple[dict | None, int]:
        """(doc, version); (None, 0) when absent. The version feeds `cas`."""
        with self._lock:
            return self._read_versioned(path)

    def update(self, path: str, fn, fence: int | None = None) -> dict | None:
        """Atomic read-modify-write under the store's exclusive section
        (thread lock + cross-process flock): fn(current_doc) -> new doc to
        write, or None to leave unchanged. Returns what was written (or
        None). This is the CAS primitive leader leases and external-view
        updates build on (ZK versioned-write analog)."""
        try:
            FAULTS.maybe_fail("store.cas")
        except InjectedFault:
            trace_event("fault.injected", point="store.cas", path=path)
            raise
        with self._exclusive():
            cur, ver = self._read_versioned(path)
            new = fn(cur)
            if new is not None:
                self._check_fence(path, fence)
                self._write(path, new, ver + 1)
            return new

    def cas(self, path: str, expected_version: int, doc: dict, fence: int | None = None) -> bool:
        """Write `doc` only if the document's version still equals
        `expected_version` (from `get_versioned`). Returns False on a lost
        race — the caller's read is stale and must not clobber the winner
        (ZK setData(path, data, version) parity)."""
        try:
            FAULTS.maybe_fail("store.cas")
        except InjectedFault:
            trace_event("fault.injected", point="store.cas", path=path)
            raise
        with self._exclusive():
            cur, ver = self._read_versioned(path)
            if ver != expected_version or (cur is None and expected_version != 0):
                return False
            self._check_fence(path, fence)
            self._write(path, doc, ver + 1)
            return True

    def delete(self, path: str, fence: int | None = None) -> None:
        with self._exclusive():
            self._check_fence(path, fence)
            if self.root is None:
                self._mem.pop(path, None)
                self._mem_ver.pop(path, None)
            else:
                f = self._file(path)
                if f.exists():
                    f.unlink()

    def list(self, prefix: str) -> list[str]:
        with self._lock:
            if self.root is None:
                return sorted(p for p in self._mem if p.startswith(prefix))
            # walk only the subtree the prefix names: hot polls (e.g. the HA
            # transition queue) must not rglob every document in the store
            parts = [p for p in prefix.split("/") if p]
            if prefix.endswith("/"):
                base = self.root.joinpath(*parts)
            else:
                base = self.root.joinpath(*parts[:-1]) if parts else self.root
            if not base.exists():
                return []
            out = []
            for f in base.rglob("*" + self._SUFFIX):
                rel = f.relative_to(self.root)
                key = "/" + "/".join(rel.parts)[: -len(self._SUFFIX)]
                if key.startswith(prefix):
                    out.append(key)
            return sorted(out)
