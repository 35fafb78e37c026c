"""Server role: hosts segments, executes the per-segment half of queries.

Reference parity: BaseServerStarter/ServerInstance (pinot-server/.../starter/
ServerInstance.java:66) + InstanceDataManager segment hosting with
acquire/release refcounting (pinot-core/.../data/manager/BaseTableDataManager)
+ ServerQueryExecutorV1Impl execution. The server returns host-format
partials (the DataTable analog) that the broker reduces.

The server is the one role that touches the device: each table's segments
are answered by a `QueryEngine` on `device` ("cuda" unless the caller asks
for the CPU), so a group-by launches its kernels once a hosted segment.
Group, DISTINCT and selection partials leave as `Frame`s, the DataTable's
frame type. A distributed multistage submission (`multistage_submit`) runs
this server's stage workers on the same device, its leaf stages through the
single-stage engine, its blocks crossing to other processes through the
mailbox registry. A realtime table's consuming segments are served from its
`RealtimeTableManager`'s snapshots through the same engine, each committed
segment's upsert validity attached before it becomes queryable.
"""

from __future__ import annotations

import itertools
import threading
import time
from pathlib import Path

from pinot_tpu_torch.common.datatable import Frame
from pinot_tpu_torch.query.engine import QueryEngine
from pinot_tpu_torch.query.reduce import frame_len
from pinot_tpu_torch.segment.loader import load_segment
from pinot_tpu_torch.segment.segment import ImmutableSegment


# process-wide query sequence for accounting ids (requestId generator parity)
_query_seq = itertools.count()


class Server:
    def __init__(self, server_id: str, device="cuda", fast32: bool = False, scheduler=None, data_dir=None):
        """`device`: where this server's engines stage and run its segments;
        with no card the first query's engine raises (nothing falls back to
        the CPU). `scheduler`: optional QueryScheduler instance, a
        common.config.SchedulerConfig, or a kind string
        ("fcfs" | "priority" | "binary_workload"). When set, execute_partials
        and multistage_submit route through it (QueryScheduler.submit
        parity) so server-side concurrency is bounded and queue overflow
        surfaces as SchedulerRejectedError (-> HTTP 503 + Retry-After);
        None executes inline (the in-process test default).

        `data_dir`: optional local segment directory (the server dataDir of
        the reference). When set, add_segment DOWNLOADS each assigned
        segment's file from the deep store into
        `<data_dir>/<table>/<segment>/`, CRC-verifies the copy, and serves
        from it — giving the integrity plane a real local artifact to
        scrub, quarantine (`*.quarantined`), and self-heal (re-download
        from deep store, then peer replicas via `peer_fetch`). When None,
        segments load straight from the deep-store dir (the in-process
        default; behavior unchanged)."""
        if scheduler is not None and not hasattr(scheduler, "submit"):
            from pinot_tpu_torch.common.config import SchedulerConfig

            cfg = (
                scheduler
                if isinstance(scheduler, SchedulerConfig)
                else SchedulerConfig(kind=str(scheduler))
            )
            scheduler = cfg.make()
        self.server_id = server_id
        self.device = device
        self._tables: dict[str, dict[str, ImmutableSegment]] = {}
        self._engines: dict[str, QueryEngine] = {}
        self._realtime: dict[str, object] = {}  # table -> RealtimeTableManager
        self._lock = threading.RLock()
        # query id -> Deadline of an in-flight query (cancellation fan-out
        # target; QueryThreadContext registry parity)
        self._running: dict[str, object] = {}
        # in-flight Helix-style segment state transitions; non-zero means a
        # segment is mid-load and /health/ready must answer 503
        self._pending_transitions = 0

        self._fast32 = fast32
        self._scheduler = scheduler
        self.data_dir = Path(data_dir) if data_dir else None
        #: (table, segment) -> {"local": dir, "source": deep-store dir} for
        #: every data-dir'd copy — the scrubber's work list
        self._local_segs: dict[tuple[str, str], dict] = {}
        self._scrub_cursor = 0
        #: optional callable(table, segment) -> segment-file bytes | None,
        #: the peer-replica fallback when local copy AND deep store are bad
        self.peer_fetch = None
        if scheduler is not None:
            scheduler.start()

    def shutdown(self) -> None:
        if self._scheduler is not None:
            self._scheduler.stop()

    def admission_snapshot(self) -> dict:
        """Live scheduler state for GET /debug/admission (server role)."""
        sched = self._scheduler
        return {
            "role": "server",
            "serverId": self.server_id,
            "enabled": sched is not None,
            "scheduler": sched.stats() if sched is not None else None,
        }

    # -- cancellation ---------------------------------------------------------

    def _register_query(self, qid: str | None, deadline) -> None:
        if qid is not None and deadline is not None:
            with self._lock:
                self._running[qid] = deadline

    def _unregister_query(self, qid: str | None) -> None:
        if qid is not None:
            with self._lock:
                self._running.pop(qid, None)

    def running_queries(self) -> list[str]:
        with self._lock:
            return sorted(self._running)

    def cancel_query(self, qid: str) -> bool:
        """Set the cancel flag on an in-flight query (v1 partials or
        multistage workers) and tombstone-close its mailboxes. Returns
        whether the query was found here."""
        with self._lock:
            deadline = self._running.get(qid)
            reg = getattr(self, "_mailbox_registry", None)
        if deadline is not None:
            deadline.cancel()
        if reg is not None and qid in reg.live_queries():
            reg.close(qid)
        return deadline is not None

    # -- realtime ------------------------------------------------------------

    def attach_realtime(self, table: str, manager) -> None:
        """Attach a RealtimeTableManager whose consuming segments this server
        serves (RealtimeTableDataManager role)."""
        with self._lock:
            self._realtime[table] = manager

    def pause_consumption(self, table: str) -> bool:
        rt = self._realtime.get(table)
        if rt is None:
            return False
        rt.pause()
        return True

    def resume_consumption(self, table: str) -> bool:
        rt = self._realtime.get(table)
        if rt is None:
            return False
        rt.resume()
        return True

    def consumption_status(self, table: str) -> list[dict]:
        rt = self._realtime.get(table)
        return rt.consumption_status() if rt is not None else []

    # -- state transitions (Helix OFFLINE->ONLINE analog) --------------------

    def add_segment(self, table: str, segment_name: str, seg_dir: str | Path) -> None:
        with self._lock:
            self._pending_transitions += 1
        try:
            self._add_segment_inner(table, segment_name, seg_dir)
        finally:
            with self._lock:
                self._pending_transitions -= 1

    def _add_segment_inner(self, table: str, segment_name: str, seg_dir: str | Path) -> None:
        from pinot_tpu_torch.segment.store import SEGMENT_FILE

        seg_dir = Path(seg_dir)
        if self.data_dir is not None and (seg_dir / SEGMENT_FILE).exists():
            seg = self._load_with_healing(table, segment_name, seg_dir)
        else:
            seg = load_segment(seg_dir)
        with self._lock:
            rt = self._realtime.get(table)
            if rt is not None and hasattr(rt, "on_segment_loaded"):
                # upsert tables: validity mask must be attached BEFORE the
                # segment becomes queryable, or a concurrent query would see
                # superseded rows (validDocIds attach-then-online ordering)
                rt.on_segment_loaded(seg)
            self._tables.setdefault(table, {})[segment_name] = seg
            # engines are rebuilt lazily; drop the cached one
            self._engines.pop(table, None)

    # -- storage integrity: local copies, quarantine, self-healing -----------

    def _quarantine(self, path: Path) -> Path:
        """Move a corrupt file aside as `<name>.quarantined` (never deleted:
        the operator runbook inspects these) and meter the event."""
        import logging
        import os

        from pinot_tpu_torch.common.metrics import server_metrics

        q = path.with_name(path.name + ".quarantined")
        os.replace(path, q)
        server_metrics().meter("storage.quarantined").mark()
        logging.getLogger("pinot_tpu_torch.storage").warning(
            "server %s quarantined corrupt segment file %s -> %s",
            self.server_id, path, q.name,
        )
        return q

    def _fetch_verified(self, src: Path, local_dir: Path) -> None:
        """Download (copy) a deep-store segment file into the local dir and
        verify the landed copy; raises SegmentCorruptedError when the SOURCE
        is bad (the landed bytes are quarantined, not left live)."""
        from pinot_tpu_torch.common.durability import atomic_write_bytes
        from pinot_tpu_torch.common.errors import SegmentCorruptedError
        from pinot_tpu_torch.segment.store import SEGMENT_FILE, verify_segment_file

        local_dir.mkdir(parents=True, exist_ok=True)
        data = (src / SEGMENT_FILE).read_bytes()
        atomic_write_bytes(local_dir / SEGMENT_FILE, data)
        try:
            verify_segment_file(local_dir / SEGMENT_FILE)
        except SegmentCorruptedError:
            self._quarantine(local_dir / SEGMENT_FILE)
            raise

    def _register_local(self, table: str, name: str, local_dir: Path, source_dir: Path):
        seg = load_segment(local_dir)
        with self._lock:
            self._local_segs[(table, name)] = {
                "local": str(local_dir),
                "source": str(source_dir),
            }
        return seg

    def _load_with_healing(self, table: str, name: str, source_dir: Path):
        """Load a segment via a verified local copy, self-healing corruption:
        bad local copy -> quarantine + re-download from the deep store; bad
        deep-store copy too -> peer-replica fallback (`peer_fetch`); only
        when EVERY source is bad does the typed SegmentCorruptedError
        surface to the caller."""
        from pinot_tpu_torch.common.durability import atomic_write_bytes
        from pinot_tpu_torch.common.errors import SegmentCorruptedError
        from pinot_tpu_torch.common.metrics import server_metrics
        from pinot_tpu_torch.segment.store import (
            SEGMENT_FILE,
            verify_segment_bytes,
            verify_segment_file,
        )

        m = server_metrics()
        local_dir = self.data_dir / table / name
        local_file = local_dir / SEGMENT_FILE
        # 1. existing verified local copy
        if local_file.exists():
            try:
                verify_segment_file(local_file)
                return self._register_local(table, name, local_dir, source_dir)
            except SegmentCorruptedError:
                m.meter("storage.corruption.detected").mark()
                self._quarantine(local_file)
        # 2. (re-)download from the deep store, verified on landing
        try:
            self._fetch_verified(source_dir, local_dir)
            return self._register_local(table, name, local_dir, source_dir)
        except SegmentCorruptedError:
            m.meter("storage.corruption.detected").mark()
        # 3. peer-replica fallback
        if self.peer_fetch is not None:
            data = self.peer_fetch(table, name)
            if data:
                verify_segment_bytes(data, f"peer copy of {table}/{name}")
                local_dir.mkdir(parents=True, exist_ok=True)
                atomic_write_bytes(local_file, data)
                m.meter("storage.repaired").mark()
                return self._register_local(table, name, local_dir, source_dir)
        raise SegmentCorruptedError(
            f"segment {table}/{name}: local copy, deep store, and peer "
            "replicas all failed integrity verification",
            path=str(local_file),
        )

    def scrub(self, io_budget_bytes: int | None = None) -> dict:
        """Incrementally CRC-verify this server's local segment copies,
        healing what it can (quarantine + re-download + hot-swap the
        in-memory segment). `io_budget_bytes` caps bytes read per call; the
        cursor resumes where the last call stopped, so repeated small-budget
        calls cover the full set (the scrubber's IO throttle)."""
        from pinot_tpu_torch.common.errors import SegmentCorruptedError
        from pinot_tpu_torch.common.metrics import server_metrics
        from pinot_tpu_torch.segment.store import SEGMENT_FILE, verify_segment_file

        m = server_metrics()
        out = {"verified": 0, "corrupted": 0, "repaired": 0, "unrepairable": 0, "bytesScanned": 0}
        with self._lock:
            items = sorted(self._local_segs.items())
        if not items:
            return out
        start = self._scrub_cursor % len(items)
        for (table, name), entry in items[start:] + items[:start]:
            if io_budget_bytes is not None and out["bytesScanned"] >= io_budget_bytes:
                break
            self._scrub_cursor += 1
            local_dir = Path(entry["local"])
            f = local_dir / SEGMENT_FILE
            try:
                out["bytesScanned"] += f.stat().st_size
            except OSError:
                pass
            try:
                verify_segment_file(f)
                out["verified"] += 1
                m.meter("storage.scrub.verified").mark()
                continue
            except SegmentCorruptedError:
                out["corrupted"] += 1
                m.meter("storage.scrub.corrupted").mark()
            try:
                if f.exists():
                    self._quarantine(f)
                self._fetch_verified(Path(entry["source"]), local_dir)
                seg = load_segment(local_dir)
                with self._lock:
                    self._tables.setdefault(table, {})[name] = seg
                    self._engines.pop(table, None)
                out["repaired"] += 1
                m.meter("storage.scrub.repaired").mark()
            except Exception:  # noqa: BLE001  # pinotlint: disable=deadline-swallow — scrub repair is best-effort; the unrepairable meter is the alert signal and queries keep serving the in-memory copy
                out["unrepairable"] += 1
                m.meter("storage.scrub.unrepairable").mark()
        return out

    def fetch_segment_file(self, table: str, segment_name: str) -> bytes | None:
        """Serve this server's copy of a segment's file bytes (the
        controller's peer-repair source for a corrupt deep-store copy),
        verified before shipping so corruption never propagates. Falls back
        to re-serializing the in-memory segment when there is no local file
        (in-process servers without a data dir)."""
        from pinot_tpu_torch.common.errors import SegmentCorruptedError
        from pinot_tpu_torch.segment.store import SEGMENT_FILE, verify_segment_bytes

        with self._lock:
            entry = self._local_segs.get((table, segment_name))
            seg = self._tables.get(table, {}).get(segment_name)
        if entry is not None:
            f = Path(entry["local"]) / SEGMENT_FILE
            if f.exists():
                data = f.read_bytes()
                try:
                    verify_segment_bytes(data, str(f))
                    return data
                except SegmentCorruptedError:
                    pass  # fall through to re-serialization of the live copy
        if seg is None:
            return None
        import tempfile

        from pinot_tpu_torch.segment.store import write_segment_file

        with tempfile.TemporaryDirectory(prefix="pinot_tpu_fetch_") as td:
            d = write_segment_file(seg, Path(td) / segment_name)
            data = (d / SEGMENT_FILE).read_bytes()
        verify_segment_bytes(data, f"re-serialized {table}/{segment_name}")
        return data

    def local_segment_report(self) -> dict:
        """Local-copy + quarantine inventory for debug surfaces."""
        with self._lock:
            entries = {f"{t}/{n}": dict(e) for (t, n), e in sorted(self._local_segs.items())}
        quarantined = []
        if self.data_dir is not None and self.data_dir.exists():
            quarantined = sorted(str(p) for p in self.data_dir.rglob("*.quarantined"))
        return {"dataDir": str(self.data_dir) if self.data_dir else None,
                "localSegments": entries, "quarantined": quarantined}

    def add_segment_object(self, table: str, seg: ImmutableSegment) -> None:
        with self._lock:
            self._tables.setdefault(table, {})[seg.name] = seg
            self._engines.pop(table, None)

    def remove_segment(self, table: str, segment_name: str) -> None:
        with self._lock:
            self._tables.get(table, {}).pop(segment_name, None)
            self._engines.pop(table, None)
            self._local_segs.pop((table, segment_name), None)

    def segments_of(self, table: str) -> list[str]:
        with self._lock:
            return sorted(self._tables.get(table, {}))

    def readiness(self) -> tuple[bool, dict]:
        """(ready, per-component detail) for GET /health/ready — distinct
        from liveness: a live server mid-way through segment loads or with a
        stopped scheduler must not take traffic yet (the reference's
        ServiceStatus readiness-check pattern: Helix state converged before
        ONLINE). Components: segmentsLoaded (no in-flight state
        transitions), mailboxRegistry (v2 shuffle registry serving),
        scheduler (running, or inline when none is configured)."""
        with self._lock:
            pending = self._pending_transitions
            sched = self._scheduler
        components = {
            "segmentsLoaded": {"ok": pending == 0, "pendingTransitions": pending},
            "mailboxRegistry": {"ok": self.mailbox_registry is not None},
            "scheduler": {
                "ok": sched is None or bool(getattr(sched, "_running", True)),
                "configured": sched is not None,
            },
        }
        return all(c["ok"] for c in components.values()), components

    def get_segment_object(self, table: str, segment_name: str) -> ImmutableSegment | None:
        """Hand out a hosted segment for multistage leaf scans
        (LeafStageTransferableBlockOperator acquires segments the same way)."""
        with self._lock:
            return self._tables.get(table, {}).get(segment_name)

    # -- distributed multistage ----------------------------------------------

    @property
    def mailbox_registry(self):
        """Per-server mailbox registry for cross-process stage shuffle
        (ReceivingMailbox registry parity)."""
        with self._lock:
            reg = getattr(self, "_mailbox_registry", None)
            if reg is None:
                from pinot_tpu_torch.multistage.transport import MailboxRegistry

                reg = self._mailbox_registry = MailboxRegistry()
            return reg

    def multistage_submit(self, body: dict) -> None:
        """Accept a distributed stage-plan submission (QueryServer.submit
        parity, worker.proto:24-32): rebuild the plan and run this server's
        assigned (stage, worker) OpChains on background threads. With a
        scheduler configured, the plan rebuild + worker launch is admitted
        through it, so a flood of stage submissions is bounded by the same
        queue that bounds the v1 scatter path (overflow rejects with
        SchedulerRejectedError instead of spawning unbounded workers)."""
        if self._scheduler is not None:
            tables = sorted(body.get("segments") or {})
            group = tables[0] if tables else "_stages"
            self._scheduler.submit(self._multistage_submit_inner, body, table=group).result()
            return
        self._multistage_submit_inner(body)

    def _multistage_submit_inner(self, body: dict) -> None:
        from pinot_tpu_torch.multistage.distributed import run_assigned_stages

        placement = {(int(s), int(w)): owner for s, w, owner in body["placement"]}
        segments: dict[str, list] = {}
        for table, entries in (body.get("segments") or {}).items():
            objs = []
            for entry in entries:
                name, location = entry if isinstance(entry, (list, tuple)) else (entry, None)
                got = self.get_segment_object(table, name)
                if got is None and location:
                    # stale local state (concurrent remove/reload): scan the
                    # deep-store copy rather than silently shrinking results
                    from pinot_tpu_torch.segment.loader import load_segment

                    got = load_segment(location)
                if got is None:
                    raise RuntimeError(
                        f"assigned segment {table}/{name} not hosted here and no "
                        "deep-store copy available"
                    )
                objs.append(got)
            segments[table] = objs
        from pinot_tpu_torch.query.context import Deadline

        qid = body["query_id"]
        deadline_ts = body.get("deadline_ts")
        deadline = Deadline(float(deadline_ts) if deadline_ts is not None else None)
        # register BEFORE starting workers: a cancel racing the submit must
        # find the entry (on_done unregisters once the last worker finishes)
        self._register_query(qid, deadline)
        run_assigned_stages(
            qid=qid,
            my_id=body.get("target", self.server_id),
            sql=body["sql"],
            schemas=body["schemas"],
            n_workers=int(body.get("n_workers", 4)),
            parallelism={int(k): int(v) for k, v in body["parallelism"].items()},
            placement=placement,
            addresses=body["addresses"],
            segments=segments,
            registry=self.mailbox_registry,
            receive_timeout=float(body.get("receive_timeout", 60.0)),
            row_counts={k: int(v) for k, v in (body.get("row_counts") or {}).items()},
            ndv={t: {c: int(v) for c, v in cols.items()} for t, cols in (body.get("ndv") or {}).items()},
            deadline=deadline,
            on_done=lambda: self._unregister_query(qid),
            trace_ctx=body.get("trace_ctx"),
            device=self.device,
        )

    def _engine(self, table: str) -> QueryEngine:
        with self._lock:
            eng = self._engines.get(table)
            if eng is None:
                eng = QueryEngine(
                    list(self._tables.get(table, {}).values()), device=self.device, fast32=self._fast32
                )
                self._engines[table] = eng
            return eng

    # -- query execution -----------------------------------------------------

    #: rows per streamed selection frame (GrpcConfig maxBlockRowSize analog)
    STREAM_FRAME_ROWS = 65_536

    def execute_partials_stream(
        self,
        table: str,
        sql: str,
        segment_names: list[str],
        hints: dict | None = None,
        max_rows: int | None = None,
    ):
        """Streaming selection execution: yields (frame, matched, seg_docs)
        per ≤STREAM_FRAME_ROWS chunk as segments finish, stopping once
        max_rows selection rows have been emitted. The server never holds
        more than one segment's result; the broker can close the stream
        early (server.proto:24-26 streaming Submit parity)."""
        segs = self._resolve_segments(table, segment_names)
        if len(segs) != len(segment_names):
            # a silently-dropped unhosted segment would mean missing rows
            # reported as success (the partial-response guard _scatter_leg
            # applies client-side); the stream fails loudly instead.
            # Exception: names of the ACTIVE consuming generation — during
            # segment rollover the routed CONSUMING name can be transiently
            # unresolvable (the committed replacement serves the data). A
            # missing COMMITTED segment of a realtime table still errors.
            hosted = {s.name for s in segs}
            missing = set(segment_names) - hosted
            with self._lock:
                rt = self._realtime.get(table)
                active = set()
                if rt is not None:
                    for c in rt.consumers:
                        # previous/current/next sequence of each partition are
                        # the rollover window (seal -> commit -> reopen)
                        for seq in (c.sequence - 1, c.sequence, c.sequence + 1):
                            active.add(f"{c.table}__{c.partition}__{seq}")
            truly_missing = missing - active
            if truly_missing:
                raise RuntimeError(
                    f"server {self.server_id} does not host segments "
                    f"{sorted(truly_missing)} of table {table!r}"
                )
        from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
        from pinot_tpu_torch.common.metrics import ServerMeter, server_metrics
        from pinot_tpu_torch.common.trace import trace_event

        try:
            FAULTS.maybe_fail("server.crash")
        except InjectedFault as e:
            trace_event("fault.injected", point="server.crash", server=self.server_id)
            raise RuntimeError(f"server {self.server_id} unreachable: {e}") from None
        hints, deadline, broker_qid, _tctx = self._pop_resilience_hints(hints)
        eng = self._engine(table)
        ctx = eng.make_context(sql)
        if hints:
            ctx.hints.update(hints)
        ctx.deadline = deadline
        server_metrics().meter(ServerMeter.QUERIES).mark()
        self._register_query(broker_qid, deadline)
        try:
            emitted = 0
            for seg, partial, matched, seg_scan in eng.partials_iter(ctx, segs):
                try:
                    FAULTS.maybe_fail("stream.consume")
                except InjectedFault:
                    trace_event("fault.injected", point="stream.consume", segment=seg.name)
                    raise
                if deadline is not None:
                    deadline.check(f"stream {seg.name}")
                if isinstance(partial, dict):  # selection frame: chunk it
                    start = 0
                    n = frame_len(partial)
                    while start < n:
                        chunk = Frame(
                            (c, v[start : start + self.STREAM_FRAME_ROWS]) for c, v in partial.items()
                        )
                        # scan stats ride only the segment's FIRST frame (like
                        # matched/seg_docs) so the broker fold never
                        # double-counts a chunked segment
                        yield (
                            chunk,
                            (matched if start == 0 else 0),
                            (seg.n_docs if start == 0 else 0),
                            (seg_scan if start == 0 else None),
                        )
                        emitted += frame_len(chunk)
                        start += self.STREAM_FRAME_ROWS
                        if max_rows is not None and emitted >= max_rows:
                            return
                    if n == 0:
                        yield Frame(partial), matched, seg.n_docs, seg_scan
                else:
                    yield partial, matched, seg.n_docs, seg_scan
                if max_rows is not None and emitted >= max_rows:
                    return
        finally:
            self._unregister_query(broker_qid)

    def _resolve_segments(self, table: str, segment_names: list[str]):
        with self._lock:
            hosted = self._tables.get(table, {})
            rt = self._realtime.get(table)
            segs = []
            for name in segment_names:
                if name in hosted:
                    segs.append(hosted[name])
                elif rt is not None:
                    for c in rt.consumers:
                        # the name check and the snapshot under the consumer's
                        # lock: a rollover between them would hand out the
                        # next segment's rows under this name
                        with c._lock:
                            if c._seg_name() == name:
                                segs.append(c._mutable.snapshot())
                                break
                        pend = getattr(c, "pending_sealed", lambda _n: None)(name)
                        if pend is not None:
                            # sealed, commit in flight (pauseless): the local
                            # build serves until the committed copy lands
                            segs.append(pend)
                            break
            return segs

    def execute_partials(
        self, table: str, sql: str, segment_names: list[str], hints: dict | None = None, workload: str = "PRIMARY"
    ):
        """Run the per-segment half for the requested segments; returns
        (partials, matched_docs, total_docs, trace_subtree | None,
        scan_summary). The broker passes hints (e.g.
        global percentile bounds) so partials merge across servers. With a
        scheduler configured, execution queues behind its policy; the caller
        blocks on the future (QueryScheduler.submit parity)."""
        if self._scheduler is not None:
            # the scheduler snapshots the submitting contextvars per job, so
            # the active trace crosses into the worker thread by itself; it
            # records the job's wait (trace phase, wire sub-phase, timer)
            fut = self._scheduler.submit(
                self._execute_partials, table, sql, segment_names, hints, table=table, workload=workload
            )
            return fut.result()
        return self._execute_partials(table, sql, segment_names, hints)

    @staticmethod
    def _pop_resilience_hints(hints: dict | None):
        """Split the broker's deadline/query-id markers out of the hints dict
        (they ride the existing hints channel so every server-handle shape —
        in-process, HTTP, test stubs — carries them without signature churn).
        Returns (clean hints, Deadline | None, broker query id | None,
        trace-context dict | None)."""
        from pinot_tpu_torch.query.context import Deadline

        hints = dict(hints or {})
        deadline_ts = hints.pop("__deadlineTs__", None)
        broker_qid = hints.pop("__queryId__", None)
        trace_ctx = hints.pop("__traceCtx__", None)
        deadline = None
        if deadline_ts is not None or broker_qid is not None:
            deadline = Deadline(float(deadline_ts) if deadline_ts is not None else None)
        return hints, deadline, broker_qid, trace_ctx

    def _execute_partials(self, table: str, sql: str, segment_names: list[str], hints: dict | None = None):
        from pinot_tpu_torch.common.accounting import default_accountant
        from pinot_tpu_torch.common.faults import FAULTS, InjectedFault
        from pinot_tpu_torch.common.metrics import ServerMeter, ServerTimer, server_metrics
        from pinot_tpu_torch.common.trace import (
            RequestTrace,
            ServerQueryPhase,
            TraceContext,
            active_trace,
            phase_timer,
            run_traced,
            trace_event,
        )

        try:
            FAULTS.maybe_fail("server.scatter")
        except InjectedFault as e:
            trace_event("fault.injected", point="server.scatter", server=self.server_id)
            # present exactly what a dead TCP peer produces so the broker's
            # failover path (which matches on "unreachable") engages
            raise RuntimeError(f"server {self.server_id} unreachable: {e}") from None
        try:
            # whole-server hard-down simulation: same surface as a dead TCP
            # peer, but (unlike server.scatter) also armed on the streaming
            # path so the server is dead from every angle
            FAULTS.maybe_fail("server.crash")
        except InjectedFault as e:
            trace_event("fault.injected", point="server.crash", server=self.server_id)
            raise RuntimeError(f"server {self.server_id} unreachable: {e}") from None
        hints, deadline, broker_qid, tctx = self._pop_resilience_hints(hints)
        # workload-attribution marker (rides hints like the resilience
        # markers): the broker stamps the table's tenant so the accountant's
        # per-(tenant, table) rollups attribute this query server-side
        tenant = str(hints.pop("__tenant__", "") or "")
        local_tr = None
        if tctx is not None and active_trace() is None:
            # remote hop: the broker's trace context arrived over the wire;
            # record this process's span subtree locally and ship it back as
            # a 4th result element (in-process handles share the broker's
            # trace directly and keep the bare triple)
            local_tr = RequestTrace(
                broker_qid or "",
                context=TraceContext.from_dict(tctx),
                service=f"server:{self.server_id}",
            )
        segs = self._resolve_segments(table, segment_names)
        m = server_metrics()
        m.meter(ServerMeter.QUERIES).mark()
        # labelled workload meter: per-table/tenant query counts on /metrics
        # (`{table="...",tenant="..."}` series, reference table-suffix parity)
        m.meter("server.tableQueries", table=table, tenant=tenant or "DefaultTenant").mark()
        qid = f"{self.server_id}-{next(_query_seq)}"
        self._register_query(broker_qid, deadline)

        def body():
            with m.timer(ServerTimer.QUERY_EXECUTION).time(), default_accountant.scope(
                qid, table=table, tenant=tenant
            ):
                eng = self._engine(table)
                with phase_timer(ServerQueryPhase.BUILD_QUERY_PLAN, role="server"):
                    ctx = eng.make_context(sql)
                if hints:
                    ctx.hints.update(hints)
                ctx.deadline = deadline
                with phase_timer(ServerQueryPhase.QUERY_PLAN_EXECUTION, role="server"):
                    partials, matched, scan = eng.partials(ctx, segs)
                # frame partials travel under the DataTable's frame tag
                return [Frame(p) if isinstance(p, dict) else p for p in partials], matched, scan

        try:
            partials, matched, scan = run_traced(local_tr, body) if local_tr is not None else body()
        finally:
            self._unregister_query(broker_qid)
            if broker_qid and broker_qid != qid:
                # re-publish this request's device split under the broker's
                # query id so the broker-side slow-query log can stamp it
                # (scatter fan-out merges: ms sum, HBM max)
                st = default_accountant.recent_query_stats(qid)
                if st is not None:
                    default_accountant.merge_recent(broker_qid, st)
        m.meter(ServerMeter.NUM_DOCS_SCANNED).mark(matched)
        total = sum(s.n_docs for s in segs)
        if local_tr is not None:
            local_tr.root.duration_ms = local_tr.now_ms()
            return partials, matched, total, local_tr.subtree(), scan
        # uniform 5-tuple: element 3 (trace subtree) is None on the
        # in-process path, element 4 carries the scan-path summary
        return partials, matched, total, None, scan
