"""Controller: table/schema management, segment assignment, ideal state.

Reference parity: PinotHelixResourceManager (pinot-controller/.../helix/core/
PinotHelixResourceManager.java:192 — tables, schemas, instances, ideal
states), segment assignment strategies (controller/helix/core/assignment/
segment/OfflineSegmentAssignment.java: balanced instance pick by segment
count; replica groups), and the segment upload path (addNewSegment -> ideal
state update -> server state transition). Our state transitions are
synchronous calls onto the server objects/endpoints (the Helix
OFFLINE->ONLINE message analog); the external view equals the ideal state
once those calls return.
"""

from __future__ import annotations

from pathlib import Path

from pinot_tpu_torch.common.config import TableConfig
from pinot_tpu_torch.common.types import Schema
from pinot_tpu_torch.cluster.metadata import PropertyStore
from pinot_tpu_torch.segment.builder import write_segment
from pinot_tpu_torch.segment.segment import ImmutableSegment


class Controller:
    #: optional AccessControl SPI enforced by the HTTP endpoints
    access_control = None
    #: bound by PeriodicTaskScheduler(controller=...) — the /health/ready
    #: "periodicScheduler" component reports on it when present
    periodic_scheduler = None
    #: bound by ClusterMetricsAggregator(controller) — serves /debug/cluster
    #: and /debug/alerts on the controller HTTP surface
    cluster_aggregator = None

    def __init__(self, store: PropertyStore, deep_store: str | Path, controller_id: str = "controller_0"):
        """deep_store: directory holding uploaded segment dirs (the PinotFS
        deep-store analog: segments are durable here; servers load from it)."""
        self.store = store
        self.deep_store = Path(deep_store)
        self.deep_store.mkdir(parents=True, exist_ok=True)
        self.controller_id = controller_id
        self._servers: dict[str, object] = {}  # server_id -> Server handle
        self._election = None
        self._transitions = None

    def readiness(self) -> "tuple[bool, dict]":
        """(ready, per-component detail) for GET /health/ready — the broker/
        server readiness contract extended to the controller: the property
        store must answer, a configured periodic scheduler must actually be
        running, and with HA enabled the lease state must be known (election
        thread alive — leader or standby both count as known)."""
        components: dict[str, dict] = {}
        try:
            self.store.list("/instances/")
            components["propertyStore"] = {"ok": True}
        except Exception as e:  # noqa: BLE001  # pinotlint: disable=deadline-swallow — readiness probe, off the query path; the failure is the signal
            components["propertyStore"] = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        sched = self.periodic_scheduler
        if sched is None:
            components["periodicScheduler"] = {"ok": True, "configured": False}
        else:
            running = bool(getattr(sched, "_running", False))
            components["periodicScheduler"] = {
                "ok": running,
                "configured": True,
                "tasks": [t.name for t in sched.tasks],
            }
        if self._election is None:
            components["ha"] = {"ok": True, "enabled": False}
        else:
            thread = getattr(self._election, "_thread", None)
            known = thread is not None and thread.is_alive()
            components["ha"] = {"ok": known, "enabled": True, "leader": self.is_leader}
        return all(c["ok"] for c in components.values()), components

    # -- high availability (cluster/ha.py) -----------------------------------

    def enable_ha(self, lease_ttl: float = 2.0, renew_every: float = 0.4) -> None:
        """Join lead-controller election and start the async transition
        worker (lead-controller partitioning + Helix message queue analog;
        PinotHelixResourceManager.java:192). Safe on multiple controllers
        sharing one store: only the lease holder acts."""
        from pinot_tpu_torch.cluster.ha import LeaderElection, TransitionManager

        if self._election is not None:
            self.stop_ha()  # re-enable replaces, never leaks threads
        self._election = LeaderElection(self.store, self.controller_id, lease_ttl, renew_every)
        self._transitions = TransitionManager(self, self._election)
        self._election.start()
        self._transitions.start()

    def stop_ha(self, release_lease: bool = True) -> None:
        """Stop participating (simulates controller death when
        release_lease=False: standbys must wait out the lease TTL). Clears
        the transition manager too: with no worker to drain it, routing
        upload failures into the queue would silently lose replicas."""
        if self._transitions is not None:
            self._transitions.stop()
            self._transitions = None
        if self._election is not None:
            self._election.stop(release=release_lease)
            self._election = None

    @property
    def is_leader(self) -> bool:
        return self._election is None or self._election.is_leader

    def lease_fence(self) -> int | None:
        """Fencing token (lease epoch) lead-path store mutations carry so
        the store rejects them once a newer lease exists. None when HA is
        off — single-controller deployments stay unfenced."""
        return self._election.epoch if self._election is not None else None

    def register_controller_endpoint(self, host: str, port: int) -> None:
        """Publish this controller's HTTP endpoint so standbys' `leaderUrl`
        hints and client failover can locate whoever holds the lease."""
        self.store.set(f"/controllers/{self.controller_id}", {"host": host, "port": port})  # pinotlint: disable=fence-discipline — deliberately unfenced: STANDBYS must publish their endpoint too (leaderUrl redirects + client failover depend on it), and a standby holds no lease epoch to fence with

    def leader_url(self) -> str | None:
        """Base URL of the current lease holder, or None when unknown (no
        lease, or the holder never registered an HTTP endpoint)."""
        from pinot_tpu_torch.cluster.metadata import LEASE_PATH

        lease = self.store.get(LEASE_PATH) or {}
        owner = lease.get("owner") or ""
        if not owner:
            return None
        doc = self.store.get(f"/controllers/{owner}") or {}
        if not doc.get("port"):
            return None
        return f"http://{doc['host']}:{doc['port']}"

    def ha_status(self) -> dict:
        """controller.ha.* observability block for /debug/cluster and
        GET /leader: lease role, fencing epoch, takeover/fenced-write
        counters."""
        from pinot_tpu_torch.common.metrics import controller_metrics

        return {
            "enabled": self._election is not None,
            "controllerId": self.controller_id,
            "isLeader": self.is_leader,
            "leaseEpoch": self._election.epoch if self._election is not None else 0,
            "takeovers": self._election.takeovers if self._election is not None else 0,
            "fencedWrites": int(controller_metrics().meter("controller.ha.fencedWrites").count),
            "leaderUrl": self.leader_url(),
        }

    # -- instances -----------------------------------------------------------

    def register_server(
        self, server_id: str, handle=None, host: str = "local", port: int = 0, tags: list[str] | None = None
    ) -> None:
        """handle=None with a port registers a remote (HTTP) server — the
        cross-process Helix-participant analog; a RemoteServerClient is built
        lazily from the instance doc. `tags` carry tenant/tier membership
        ("<tenant>_OFFLINE", "hot_tier", ...); untagged servers belong to
        the DefaultTenant."""
        if handle is not None:
            self._servers[server_id] = handle
        else:
            # HTTP re-registration (server restart): the endpoint may have
            # moved ports — drop any cached remote handle built from the old
            # instance doc so deliveries go to the live process
            self._servers.pop(server_id, None)
        prev = self.store.get(f"/instances/{server_id}") or {}
        # a re-registration without tags (server restart) must not wipe
        # operator-assigned tenant/tier tags
        eff_tags = list(tags) if tags is not None else prev.get("tags", [])
        # fenced: instance registration is a leader-only mutation (HTTP gates
        # standbys already); a deposed lead must not resurrect stale liveness
        self.store.set(
            f"/instances/{server_id}",
            {"host": host, "port": port, "alive": True, "tags": eff_tags},
            fence=self.lease_fence(),
        )

    def update_server_tags(self, server_id: str, tags: list[str]) -> None:
        """Re-tag a server (updateInstanceTags REST parity)."""
        doc = self.store.get(f"/instances/{server_id}") or {}
        doc["tags"] = list(tags)
        self.store.set(f"/instances/{server_id}", doc, fence=self.lease_fence())

    def servers(self) -> dict[str, object]:
        out = dict(self._servers)
        for path in self.store.list("/instances/"):
            sid = path.split("/")[-1]
            if sid in out:
                continue
            doc = self.store.get(path) or {}
            if doc.get("port"):
                from pinot_tpu_torch.cluster.http import RemoteServerClient

                out[sid] = self._servers[sid] = RemoteServerClient(f"http://{doc['host']}:{doc['port']}")
        return out

    # -- brokers (DynamicBrokerSelector's ZK external-view analog) -----------

    def register_broker(self, broker_id: str, host: str, port: int) -> None:
        self.store.set(f"/brokers/{broker_id}", {"host": host, "port": port}, fence=self.lease_fence())

    def brokers(self) -> dict[str, str]:
        """broker_id -> base URL."""
        out = {}
        for path in self.store.list("/brokers/"):
            doc = self.store.get(path) or {}
            out[path.split("/")[-1]] = f"http://{doc['host']}:{doc['port']}"
        return out

    # -- schemas / tables ----------------------------------------------------

    def add_schema(self, schema: Schema) -> None:
        # fenced: config mutations from a stale ex-leader (lease lost while
        # it was paused/partitioned) must bounce like any other lead write
        self.store.set(f"/schemas/{schema.name}", {"json": schema.to_json()}, fence=self.lease_fence())

    def get_schema(self, name: str) -> Schema | None:
        doc = self.store.get(f"/schemas/{name}")
        return Schema.from_json(doc["json"]) if doc else None

    def add_table(self, config: TableConfig) -> None:
        fence = self.lease_fence()
        self.store.set(f"/tables/{config.table_name}/config", {"json": config.to_json()}, fence=fence)
        if self.store.get(f"/tables/{config.table_name}/idealstate") is None:
            self.store.set(f"/tables/{config.table_name}/idealstate", {}, fence=fence)
        # config (re)writes can change plans/pruning: treat as a routing change
        self.bump_routing_version(config.table_name)

    # -- routing version vector ----------------------------------------------
    # One monotonic counter per table, bumped by EVERY code path that mutates
    # the table's segment set or its routing-relevant metadata (upload,
    # delete, refresh, rebalance move, realtime state change, deep-store
    # repair). The broker's result/plan caches key on these versions, so a
    # bump implicitly invalidates every cached result computed against the
    # old segment set — no explicit flush protocol exists or is needed. The
    # pinotlint `cache-invalidation` checker enforces that mutation sites
    # keep calling this.

    def bump_routing_version(self, table: str) -> int:
        """Increment and return the table's routing version."""
        doc = self.store.update(
            f"/tables/{table}/routingversion",
            lambda cur: {"v": int((cur or {}).get("v", 0)) + 1},
            fence=self.lease_fence(),
        )
        return int(doc["v"])

    def routing_version(self, table: str) -> int:
        """The table's current routing version (0 = never mutated/unknown)."""
        doc = self.store.get(f"/tables/{table}/routingversion")
        return int((doc or {}).get("v", 0))

    def routing_versions(self, tables: list[str]) -> dict[str, int]:
        """Batched `routing_version` (one round trip for HTTP deployments)."""
        return {t: self.routing_version(t) for t in tables}

    def get_table(self, name: str) -> TableConfig | None:
        doc = self.store.get(f"/tables/{name}/config")
        return TableConfig.from_json(doc["json"]) if doc else None

    def tables(self) -> list[str]:
        return [p.split("/")[2] for p in self.store.list("/tables/") if p.endswith("/config")]

    def delete_table(self, name: str) -> int:
        """Drop a table: every segment (server unload + deep-store cleanup),
        the dimension-table registration, and then the ENTIRE
        /tables/{name}/ subtree — pauseStatus, watermarks, and any other
        table-scoped key would otherwise poison a recreated table
        (DeleteTableCommand / PinotHelixResourceManager.deleteOfflineTable
        parity). Returns the number of segments removed."""
        cfg = self.get_table(name)
        segs = [
            p.split("/")[-1]
            for p in self.store.list(f"/tables/{name}/segments/")
        ]
        for s in segs:
            self.delete_segment(name, s)
        if cfg is not None and (cfg.extra or {}).get("isDimTable"):
            from pinot_tpu_torch.cluster.dimension import unregister_dim_table

            unregister_dim_table(name)
            for handle in self.servers().values():
                unload = getattr(handle, "unload_dim_table", None)
                if unload is not None:
                    unload(name)
        for p in list(self.store.list(f"/tables/{name}/")):
            self.store.delete(p, fence=self.lease_fence())
        return len(segs)

    def delete_schema(self, name: str) -> None:
        """Drop a schema (DeleteSchemaCommand parity). Refuses while a table
        still uses it — the reference's referential guard."""
        if name in self.tables():
            raise ValueError(f"schema {name!r} is still used by table {name!r}; delete the table first")
        self.store.delete(f"/schemas/{name}", fence=self.lease_fence())

    # -- segment upload & assignment ----------------------------------------

    def upload_segment(self, table: str, segment: ImmutableSegment) -> list[str]:
        """Write segment to the deep store, VERIFY the written bytes, then
        assign replicas and push state transitions to the chosen servers.
        Returns the assigned server ids.

        Ordering contract (write → verify → assign): no cluster metadata —
        segment doc, ideal state, server transition — may reference the
        deep-store dir until the on-disk image passes whole-file CRC
        verification. A failed or short write (ENOSPC, crash, disk fault)
        surfaces as a typed SegmentUploadError and removes the partial dir,
        so later downloads can never reference half a segment."""
        config = self.get_table(table)
        if config is None:
            raise KeyError(f"no such table: {table}")
        from pinot_tpu_torch.common.errors import SegmentCorruptedError, SegmentUploadError
        from pinot_tpu_torch.segment.store import SEGMENT_FILE, verify_segment_file

        table_dir = self.deep_store / table
        seg_dir = table_dir / segment.name
        existed = seg_dir.exists()
        table_dir_existed = table_dir.exists()
        try:
            seg_dir = write_segment(segment, table_dir)
            file_crc = (
                verify_segment_file(seg_dir) if (seg_dir / SEGMENT_FILE).exists() else None
            )
        except (OSError, SegmentCorruptedError) as e:
            if not existed:
                import shutil

                shutil.rmtree(seg_dir, ignore_errors=True)
                if not table_dir_existed:
                    # first segment of the table: drop the dir the failed
                    # write created so the deep store is exactly as before
                    import contextlib

                    with contextlib.suppress(OSError):
                        table_dir.rmdir()
            raise SegmentUploadError(
                getattr(e, "errno", None) or 0,
                f"segment upload {table}/{segment.name} failed, no partial dir left: {e}",
            ) from e
        stats = {
            col: {
                "min": ci.stats.to_dict()["min"],
                "max": ci.stats.to_dict()["max"],
                "cardinality": ci.cardinality,
            }
            for col, ci in segment.columns.items()
        }
        assigned = self._assign(table, segment.name, config.replication)
        import time as _time

        seg_meta = {
            "numDocs": segment.n_docs,
            "location": str(seg_dir),
            "stats": stats,
            "servers": assigned,
            "uploadedAt": _time.time(),
        }
        if file_crc is not None:
            # cluster truth for downloaders/scrubbers: a copy whose bytes
            # don't hash to this is corrupt no matter what its footer says
            seg_meta["fileCrc"] = file_crc
        partitions = self._compute_partitions(segment, config)
        if partitions:
            seg_meta["partitions"] = partitions
        self.store.set(f"/tables/{table}/segments/{segment.name}", seg_meta, fence=self.lease_fence())  # pinotlint: disable=cache-invalidation — _update_ideal on the next line bumps the routing version after the ideal-state write
        self._update_ideal(table, lambda ideal: ideal.update({segment.name: {s: "ONLINE" for s in assigned}}))
        # state transition: servers load the segment from the deep store.
        # With HA enabled, a failing server falls back to the durable retry
        # queue instead of failing the upload (Helix async transition analog).
        handles = self.servers()
        for sid in assigned:
            if self._transitions is not None:
                try:
                    handles[sid].add_segment(table, segment.name, str(seg_dir))
                    self._transitions.record_external_view(table, segment.name, sid, "ONLINE")
                except Exception:  # pinotlint: disable=deadline-swallow — segment-add control plane; failure enqueues a retryable helix transition
                    self._transitions.enqueue(table, segment.name, sid, "add", str(seg_dir))
            else:
                handles[sid].add_segment(table, segment.name, str(seg_dir))
        self._refresh_dim_table(table, config)
        return assigned

    def _refresh_dim_table(self, table: str, config: TableConfig | None = None) -> None:
        """Dimension tables reload their in-memory PK map on any segment
        change (DimensionTableDataManager refresh semantics)."""
        config = config or self.get_table(table)
        if config is None or not (config.extra or {}).get("isDimTable"):
            return
        from pinot_tpu_torch.cluster.dimension import load_dim_table

        schema = self.get_schema(table)
        locations = [m["location"] for _, m in sorted(self.all_segment_metadata(table).items()) if m.get("location")]
        load_dim_table(table, schema, locations)
        # servers in processes of their own keep their own registry: hand
        # each the same locations (in-process servers share this one)
        for handle in self.servers().values():
            load = getattr(handle, "load_dim_table", None)
            if load is not None:
                load(table, schema, locations)

    @staticmethod
    def _compute_partitions(segment: ImmutableSegment, config: TableConfig) -> dict:
        """Per-segment partition metadata (SegmentPartitionConfig parity):
        for each declared partition column, the set of partition ids present —
        the broker's MultiPartitionColumnsSegmentPruner consumes this."""
        ppc = (config.extra or {}).get("segmentPartitionConfig") or {}
        out = {}
        for col, n_parts in ppc.items():
            ci = segment.columns.get(col)
            if ci is None:
                continue
            from pinot_tpu_torch.cluster.routing import partition_of

            if ci.dictionary is not None:
                distinct = ci.dictionary.values
            else:
                import numpy as np

                distinct = np.unique(ci.forward)
                if len(distinct) > 100_000:  # unpartitioned high-cardinality raw column
                    continue
            ids = sorted({partition_of(v, int(n_parts)) for v in distinct.tolist()})
            out[col] = {"numPartitions": int(n_parts), "partitionIds": ids}
        return out

    def _assign(self, table: str, segment_name: str, replication: int) -> list[str]:
        """Balanced assignment restricted to the table's server-tenant pool:
        pick the `replication` eligible servers hosting the fewest segments
        of this table (OfflineSegmentAssignment + tenant tags)."""
        from pinot_tpu_torch.cluster.tenancy import candidate_servers

        handles = self.servers()
        if not handles:
            raise RuntimeError("no servers registered")
        config = self.get_table(table)
        eligible = set(candidate_servers(self, config)) if config is not None else set(handles)
        handles = {sid: h for sid, h in handles.items() if sid in eligible}
        if not handles:
            raise RuntimeError(f"no servers in table {table!r}'s tenant")
        ideal = self.store.get(f"/tables/{table}/idealstate") or {}
        load: dict[str, int] = {sid: 0 for sid in handles}
        for seg, replicas in ideal.items():
            for sid in replicas:
                if sid in load:
                    load[sid] += 1
        ranked = sorted(load, key=lambda s: (load[s], s))
        return ranked[: max(1, min(replication, len(ranked)))]

    def delete_segment(self, table: str, segment_name: str, remove_from_deep_store: bool = True) -> None:
        """Drop a segment: server unload transitions, ideal-state removal,
        metadata + deep-store cleanup (SegmentDeletionManager parity). Any
        queued ADD transitions for the segment are cancelled and its
        external-view entry cleared — a surviving add would otherwise retry
        forever against a deleted deep-store dir, or resurrect the segment."""
        # order matters: drop the ideal-state intent FIRST so the reconciler
        # and the delivery worker's obsolete-message guard both stop wanting
        # the segment, THEN cancel queued messages, then unload
        removed: dict[str, dict] = {}
        self._update_ideal(table, lambda ideal: removed.update(replicas=ideal.pop(segment_name, {})))
        replicas = removed["replicas"]
        if self._transitions is not None:
            self._transitions.cancel(table, segment_name)
        handles = self.servers()
        for sid in replicas:
            srv = handles.get(sid)
            if srv is not None:
                srv.remove_segment(table, segment_name)
        meta = self.store.get(f"/tables/{table}/segments/{segment_name}")
        self.store.delete(f"/tables/{table}/segments/{segment_name}", fence=self.lease_fence())
        if remove_from_deep_store and meta and meta.get("location"):
            import shutil

            shutil.rmtree(meta["location"], ignore_errors=True)
        self._refresh_dim_table(table)

    def reload_segments(self, table: str, segment_name: str | None = None) -> list[str]:
        """Rebuild segments from deep-store data under the CURRENT table
        config/schema (segment reload REST + SegmentPreProcessor parity:
        index config changes take effect on reload). Preserves realtime
        offset metadata across the rebuild."""
        from pinot_tpu_torch.segment.builder import SegmentBuilder
        from pinot_tpu_torch.segment.loader import load_segment

        schema = self.get_schema(table)
        config = self.get_table(table)
        if schema is None or config is None:
            raise KeyError(f"no such table: {table}")
        builder = SegmentBuilder(schema, config)
        reloaded = []
        for name, meta in sorted(self.all_segment_metadata(table).items()):
            if segment_name is not None and name != segment_name:
                continue
            loc = meta.get("location")
            if not loc:
                continue
            seg = load_segment(loc)
            cols = {c: ci.materialize() for c, ci in seg.columns.items()}
            rebuilt = builder.build(cols, name)
            keep = {k: v for k, v in meta.items() if k in ("startOffset", "endOffset", "partition", "refreshEpoch")}
            self.delete_segment(table, name)
            self.upload_segment(table, rebuilt)
            if keep:
                new_meta = self.segment_metadata(table, name) or {}
                new_meta.update(keep)
                self.store.set(f"/tables/{table}/segments/{name}", new_meta, fence=self.lease_fence())
                self.bump_routing_version(table)
            reloaded.append(name)
        return reloaded

    def replace_segments(self, table: str, old_names: list[str], new_segments: list[ImmutableSegment]) -> None:
        """Atomic-enough swap (segment-lineage startReplaceSegments/
        endReplaceSegments parity): upload replacements first, then drop the
        originals, so readers always see a complete data set. Under HA, a
        replacement whose ADD was only queued (server transiently down) must
        come ONLINE before the originals are dropped — deleting early would
        leave readers seeing neither old nor new rows."""
        for seg in new_segments:
            self.upload_segment(table, seg)
        if self._transitions is not None:
            if not self._transitions.await_online(
                table, [s.name for s in new_segments], timeout=30.0
            ):
                raise RuntimeError(
                    f"replacement segments for {table!r} did not come ONLINE; "
                    "originals kept (swap aborted, retry when servers recover)"
                )
        for name in old_names:
            self.delete_segment(table, name)

    # -- realtime segment state (LLC CONSUMING entries) ----------------------

    def set_segment_state(self, table: str, segment: str, server_id: str, state: str | None) -> None:
        """Set/remove one (segment, server) ideal-state entry; state=None
        removes the segment entry entirely when its replica map empties."""

        def apply(ideal: dict) -> None:
            entry = ideal.get(segment, {})
            if state is None:
                entry.pop(server_id, None)
            else:
                entry[server_id] = state
            if entry:
                ideal[segment] = entry
            else:
                ideal.pop(segment, None)

        self._update_ideal(table, apply)

    def _update_ideal(self, table: str, change) -> None:
        """change(ideal) edits the table's ideal state in place, under the
        store's atomic read-modify-write: the consumer threads of a
        realtime table's partitions commit segments and open the next ones
        at once, and a plain get-then-set would drop one thread's entry (a
        consuming segment no query routes to). Then bumps the table's
        routing version, so no broker cache answers from the old segment
        set: every write of the ideal state comes with its bump."""

        def edit(cur):  # the store hands out a copy
            ideal = cur or {}
            change(ideal)
            return ideal

        self.store.update(f"/tables/{table}/idealstate", edit, fence=self.lease_fence())
        self.bump_routing_version(table)

    # -- views ---------------------------------------------------------------

    def reset_external_views(self) -> int:
        """Disaster-recovery entry point for a full-cluster cold restart:
        external views record what servers held LAST session, and in the
        reference they are derived from session-ephemeral Helix current
        state — a restarted cluster must not trust them. Clearing them makes
        the reconciler re-enqueue every (segment, replica) the ideal state
        wants, and restarted servers re-download CRC-verified copies from
        the deep store. Returns how many view docs were cleared."""
        n = 0
        for t in self.tables():
            if self.store.get(f"/tables/{t}/externalview") is not None:
                self.store.delete(f"/tables/{t}/externalview", fence=self.lease_fence())
                n += 1
        return n

    def ideal_state(self, table: str) -> dict:
        return self.store.get(f"/tables/{table}/idealstate") or {}

    def segment_metadata(self, table: str, segment: str) -> dict | None:
        return self.store.get(f"/tables/{table}/segments/{segment}")

    def all_segment_metadata(self, table: str) -> dict[str, dict]:
        out = {}
        for p in self.store.list(f"/tables/{table}/segments/"):
            name = p.split("/")[-1]
            out[name] = self.store.get(p)
        return out
