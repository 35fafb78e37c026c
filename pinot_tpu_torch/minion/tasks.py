"""Built-in minion tasks: mergeRollup, purge, realtimeToOfflineSegments,
refreshSegment, upsertCompaction, segmentGenerationAndPush.

Reference parity: pinot-plugins/pinot-minion-tasks/pinot-minion-builtin-tasks/
.../tasks/{mergerollup,purge,realtimetoofflinesegments,refreshsegment,
upsertcompaction,segmentgenerationandpush}/ — each a (TaskGenerator,
TaskExecutor) pair. Tables opt in via TableConfig.extra["taskTypes"] plus a
per-task config block (the reference's taskTypeConfigsMap).

This is the JAX package's `minion/tasks.py`, over the port's Controller
(`replace_segments`, `upload_segment`, `delete_segment`,
`bump_routing_version`) and `Server.get_segment_object`.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

from pinot_tpu_torch.minion.framework import PinotTaskExecutor, TaskConfig, TaskGenerator
from pinot_tpu_torch.minion.processing import SegmentProcessorConfig, process_segments

# Record purgers register per table (MinionContext.recordPurgerFactory parity
# — purge logic is code, not config, in the reference too).
RECORD_PURGER_REGISTRY: dict[str, Callable[[dict[str, np.ndarray]], np.ndarray]] = {}


def _load_segments(controller, table: str, names: list[str]):
    from pinot_tpu_torch.segment.loader import load_segment

    segs = []
    for name in names:
        meta = controller.segment_metadata(table, name)
        if meta and meta.get("location"):
            segs.append(load_segment(meta["location"]))
    return segs


# -- mergeRollup -------------------------------------------------------------


class MergeRollupTaskGenerator(TaskGenerator):
    """Emit one merge task when a table has more than `maxNumSegments` small
    segments (simplified bucketing: one merge bucket per schedule; the
    reference buckets by time window and merge level)."""

    task_type = "MergeRollupTask"

    def generate_tasks(self, table_config, controller) -> list[TaskConfig]:
        cfg = (table_config.extra or {}).get("mergeRollup")
        if cfg is None:
            return []
        meta = controller.all_segment_metadata(table_config.table_name)
        min_merge = int(cfg.get("minNumSegments", 2))
        if len(meta) < min_merge:
            return []
        return [
            TaskConfig(
                self.task_type,
                table_config.table_name,
                {"segments": sorted(meta), **cfg},
            )
        ]


class MergeRollupTaskExecutor(PinotTaskExecutor):
    task_type = "MergeRollupTask"

    def execute(self, task: TaskConfig, controller) -> dict:
        table = task.table_name
        tc = controller.get_table(table)
        schema = controller.get_schema(table)
        names = task.configs["segments"]
        segs = _load_segments(controller, table, names)
        if not segs:
            return {"merged": 0}
        cfg = SegmentProcessorConfig(
            schema=schema,
            table_config=tc,
            time_column=tc.time_column,
            merge_type=task.configs.get("mergeType", "CONCAT"),
            rollup_aggregates=task.configs.get("aggregates", {}),
            max_rows_per_segment=int(task.configs.get("maxNumRecordsPerSegment", 5_000_000)),
            segment_name_prefix=f"{table}_merged_{task.task_id.rsplit('_', 1)[-1]}",
        )
        out = process_segments(segs, cfg)
        controller.replace_segments(table, names, out)
        return {"merged": len(names), "produced": [s.name for s in out]}


# -- purge -------------------------------------------------------------------


class PurgeTaskGenerator(TaskGenerator):
    task_type = "PurgeTask"

    def generate_tasks(self, table_config, controller) -> list[TaskConfig]:
        if table_config.table_name not in RECORD_PURGER_REGISTRY:
            return []
        meta = controller.all_segment_metadata(table_config.table_name)
        # one task per segment (the reference parallelizes per segment too)
        return [
            TaskConfig(self.task_type, table_config.table_name, {"segment": name})
            for name in sorted(meta)
        ]


class PurgeTaskExecutor(PinotTaskExecutor):
    task_type = "PurgeTask"

    def execute(self, task: TaskConfig, controller) -> dict:
        table = task.table_name
        purger = RECORD_PURGER_REGISTRY[table]
        name = task.configs["segment"]
        [seg] = _load_segments(controller, table, [name])
        schema = controller.get_schema(table)
        cfg = SegmentProcessorConfig(
            schema=schema,
            table_config=controller.get_table(table),
            # keep rows where the purger says False (purger marks rows to drop)
            filter_fn=lambda cols: ~np.asarray(purger(cols), dtype=bool),
            segment_name_prefix=f"{name}_purged",
        )
        out = process_segments([seg], cfg)
        controller.replace_segments(table, [name], out)
        return {"purged_segment": name, "produced": [s.name for s in out]}


# -- realtimeToOfflineSegments ----------------------------------------------


class RealtimeToOfflineTaskGenerator(TaskGenerator):
    """Move committed realtime segments older than the watermark window into
    the offline table (RealtimeToOfflineSegmentsTaskGenerator parity;
    watermark persists in the property store)."""

    task_type = "RealtimeToOfflineSegmentsTask"

    def generate_tasks(self, table_config, controller) -> list[TaskConfig]:
        cfg = (table_config.extra or {}).get("realtimeToOffline")
        if not cfg or table_config.table_type.value != "REALTIME":
            return []
        table = table_config.table_name
        bucket_ms = float(cfg.get("bucketTimeMs", 86_400_000))
        wm_doc = controller.store.get(f"/tables/{table}/r2o_watermark") or {}
        watermark = float(wm_doc.get("ts", cfg.get("startTimeMs", 0)))
        meta = controller.all_segment_metadata(table)
        tcol = table_config.time_column
        # window is complete when every committed segment starts past its end
        max_seen = None
        eligible = []
        for name, m in sorted(meta.items()):
            s = m.get("stats", {}).get(tcol)
            if not s or not isinstance(s.get("min"), (int, float)):
                continue
            max_seen = s["max"] if max_seen is None else max(max_seen, s["max"])
            if s["min"] < watermark + bucket_ms:
                eligible.append(name)
        if not eligible or max_seen is None or max_seen < watermark + bucket_ms:
            return []
        return [
            TaskConfig(
                self.task_type,
                table,
                {
                    "segments": eligible,
                    "windowStartMs": watermark,
                    "windowEndMs": watermark + bucket_ms,
                    "offlineTable": cfg.get("offlineTable", table.removesuffix("_REALTIME")),
                },
            )
        ]


class RealtimeToOfflineTaskExecutor(PinotTaskExecutor):
    task_type = "RealtimeToOfflineSegmentsTask"

    def execute(self, task: TaskConfig, controller) -> dict:
        table = task.table_name
        tc = controller.get_table(table)
        schema = controller.get_schema(table)
        offline_table = task.configs["offlineTable"]
        start, end = task.configs["windowStartMs"], task.configs["windowEndMs"]
        segs = _load_segments(controller, table, task.configs["segments"])
        cfg = SegmentProcessorConfig(
            schema=schema,
            table_config=controller.get_table(offline_table) or tc,
            time_column=tc.time_column,
            window_start=start,
            window_end=end,
            segment_name_prefix=f"{offline_table}_{int(start)}",
        )
        out = process_segments(segs, cfg)
        for seg in out:
            controller.upload_segment(offline_table, seg)
        controller.store.set(f"/tables/{table}/r2o_watermark", {"ts": end})
        return {"offlineSegments": [s.name for s in out], "watermarkMs": end}


# -- refreshSegment ----------------------------------------------------------


class RefreshSegmentTaskGenerator(TaskGenerator):
    """Refresh segments whose on-disk index set predates the current table
    config (simplified trigger: a `refreshEpoch` bump in table extra)."""

    task_type = "RefreshSegmentTask"

    def generate_tasks(self, table_config, controller) -> list[TaskConfig]:
        epoch = (table_config.extra or {}).get("refreshEpoch")
        if epoch is None:
            return []
        table = table_config.table_name
        out = []
        for name, m in sorted(controller.all_segment_metadata(table).items()):
            if m.get("refreshEpoch") != epoch:
                out.append(TaskConfig(self.task_type, table, {"segment": name, "epoch": epoch}))
        return out


class RefreshSegmentTaskExecutor(PinotTaskExecutor):
    task_type = "RefreshSegmentTask"

    def execute(self, task: TaskConfig, controller) -> dict:
        from pinot_tpu_torch.segment.builder import SegmentBuilder

        table = task.table_name
        name = task.configs["segment"]
        [seg] = _load_segments(controller, table, [name])
        cols = {c: ci.materialize() for c, ci in seg.columns.items()}
        rebuilt = SegmentBuilder(controller.get_schema(table), controller.get_table(table)).build(cols, name)
        controller.delete_segment(table, name)
        controller.upload_segment(table, rebuilt)
        meta = controller.segment_metadata(table, name)
        meta["refreshEpoch"] = task.configs["epoch"]
        controller.store.set(f"/tables/{table}/segments/{name}", meta)
        controller.bump_routing_version(table)
        return {"refreshed": name}


# -- upsertCompaction --------------------------------------------------------


class UpsertCompactionTaskGenerator(TaskGenerator):
    """Compact upsert segments whose invalid-doc ratio exceeds the threshold
    (UpsertCompactionTaskGenerator parity). Validity comes from the serving
    server's in-memory upsert metadata (validDocIds snapshot analog)."""

    task_type = "UpsertCompactionTask"

    def generate_tasks(self, table_config, controller) -> list[TaskConfig]:
        cfg = (table_config.extra or {}).get("upsertCompaction", {})
        if table_config.upsert is None:
            return []
        table = table_config.table_name
        threshold = float(cfg.get("invalidRecordsThresholdPercent", 30.0))
        out = []
        for name, replicas in sorted(controller.ideal_state(table).items()):
            mask = _valid_mask_from_servers(controller, table, name, replicas)
            if mask is None:
                continue
            invalid_pct = 100.0 * float((~mask).sum()) / max(len(mask), 1)
            if invalid_pct > threshold:
                out.append(TaskConfig(self.task_type, table, {"segment": name}))
        return out


def _valid_mask_from_servers(controller, table, segment_name, replicas):
    for sid in sorted(replicas):
        srv = controller.servers().get(sid)
        if srv is None:
            continue
        seg = srv.get_segment_object(table, segment_name)
        if seg is None:
            continue
        provider = seg.extras.get("valid_docs")
        if provider is not None:
            return np.asarray(provider(seg.n_docs), dtype=bool)
    return None


class UpsertCompactionTaskExecutor(PinotTaskExecutor):
    task_type = "UpsertCompactionTask"

    def execute(self, task: TaskConfig, controller) -> dict:
        from pinot_tpu_torch.segment.builder import SegmentBuilder

        table = task.table_name
        name = task.configs["segment"]
        replicas = controller.ideal_state(table).get(name, {})
        mask = _valid_mask_from_servers(controller, table, name, replicas)
        if mask is None:
            return {"skipped": name}
        # compact from the server's live object (deep-store copy lacks the
        # in-memory validity), keeping only latest-per-PK rows
        seg = None
        for sid in sorted(replicas):
            srv = controller.servers().get(sid)
            seg = srv.get_segment_object(table, name) if srv else None
            if seg is not None:
                break
        cols = {c: ci.materialize()[mask[: seg.n_docs]] for c, ci in seg.columns.items()}
        rebuilt = SegmentBuilder(controller.get_schema(table), controller.get_table(table)).build(cols, name)
        controller.delete_segment(table, name)
        controller.upload_segment(table, rebuilt)
        return {"compacted": name, "keptDocs": int(mask.sum()), "dropped": int((~mask).sum())}


# -- segmentGenerationAndPush ------------------------------------------------


class SegmentGenerationAndPushTaskExecutor(PinotTaskExecutor):
    """Run a batch ingestion job as a minion task (SegmentGenerationAndPush
    parity; ad-hoc via PinotTaskManager.submit)."""

    task_type = "SegmentGenerationAndPushTask"

    def execute(self, task: TaskConfig, controller) -> dict:
        from pinot_tpu_torch.io.batch import SegmentGenerationJobSpec, run_segment_generation_job

        c = task.configs
        spec = SegmentGenerationJobSpec(
            table_name=task.table_name,
            schema=controller.get_schema(task.table_name),
            input_dir_uri=c["inputDirURI"],
            job_type="SegmentCreationAndTarPush",
            include_file_name_pattern=c.get("includeFileNamePattern", "*"),
            input_format=c.get("inputFormat"),
            segment_name_prefix=c.get("segmentNamePrefix") or task.table_name,
            table_config=controller.get_table(task.table_name),
        )
        names = run_segment_generation_job(spec, controller=controller)
        return {"pushed": names}


BUILTIN_GENERATORS = [
    MergeRollupTaskGenerator,
    PurgeTaskGenerator,
    RealtimeToOfflineTaskGenerator,
    RefreshSegmentTaskGenerator,
    UpsertCompactionTaskGenerator,
]
BUILTIN_EXECUTORS = [
    MergeRollupTaskExecutor,
    PurgeTaskExecutor,
    RealtimeToOfflineTaskExecutor,
    RefreshSegmentTaskExecutor,
    UpsertCompactionTaskExecutor,
    SegmentGenerationAndPushTaskExecutor,
]


def make_minion_with_builtins(minion_id: str, task_manager, controller):
    """Convenience: a minion with every built-in executor registered, and
    every built-in generator registered on the task manager."""
    from pinot_tpu_torch.minion.framework import Minion

    for g in BUILTIN_GENERATORS:
        task_manager.register_generator(g())
    minion = Minion(minion_id, task_manager, controller)
    for e in BUILTIN_EXECUTORS:
        minion.register_executor(e())
    return minion
