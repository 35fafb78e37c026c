"""Batch ingestion: segment-generation job spec + standalone runner.

Reference parity: pinot-spi/.../ingestion/batch/spec/SegmentGenerationJobSpec
(inputDirURI, includeFileNamePattern, outputDirURI, jobType, recordReaderSpec,
segmentNameGeneratorSpec, pushJobSpec) executed by
pinot-plugins/pinot-batch-ingestion/ runners (standalone/Hadoop/Spark —
here one threaded standalone runner; a distributed runner is a map of this
same per-file function, which is exactly what the Spark/Hadoop runners do).
Job types: SegmentCreation, SegmentCreationAndTarPush (push = hand the built
segment to the controller, the tar-upload analog).

This is the JAX package's `io/batch.py`. Its distributed runner starts its
worker processes with forkserver, or spawn where `__main__` is not a file,
and never with fork: a process that has initialised CUDA cannot be forked.
A worker loads no torch (it reads, builds on the host and pushes over REST)
unless the caller's `__main__` imports it at its top level (forkserver and
spawn import `__main__` in the workers). Both runners append one dict a file
to `report` when given one: file, segment, rows, read_s, build_s, push_s or
write_s, and the pid and `torch` (torch loaded there?) of the process that
built it.
"""

from __future__ import annotations

import fnmatch
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path, PurePosixPath

import numpy as np

from pinot_tpu_torch.common.types import DataType, Schema
from pinot_tpu_torch.io.fs import LocalFS, get_fs
from pinot_tpu_torch.io.readers import open_record_reader


@dataclass
class SegmentGenerationJobSpec:
    table_name: str
    schema: Schema
    input_dir_uri: str
    job_type: str = "SegmentCreation"  # or SegmentCreationAndTarPush
    include_file_name_pattern: str = "*"
    input_format: str | None = None  # None = by extension
    output_dir_uri: str | None = None
    segment_name_prefix: str | None = None  # default: table name
    table_config: object | None = None
    parallelism: int = 1
    # optional row-level transform applied before building (the
    # RecordTransformer/ingestion-transform analog): cols dict -> cols dict
    transform: object | None = None
    extra: dict = field(default_factory=dict)


def _coerce(schema: Schema, cols: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Project to schema columns and cast to declared types
    (DataTypeTransformer parity)."""
    out = {}
    for name, spec in schema.fields.items():
        if name not in cols:
            raise KeyError(f"input missing schema column {name!r}")
        v = cols[name]
        dt = spec.data_type
        if dt == DataType.INT:
            out[name] = np.asarray(v, dtype=np.int32) if v.dtype != np.int32 else v
        elif dt == DataType.LONG:
            out[name] = np.asarray(v, dtype=np.int64) if v.dtype != np.int64 else v
        elif dt == DataType.FLOAT:
            out[name] = np.asarray(v, dtype=np.float32) if v.dtype != np.float32 else v
        elif dt == DataType.DOUBLE:
            out[name] = np.asarray(v, dtype=np.float64) if v.dtype != np.float64 else v
        elif dt == DataType.STRING:
            out[name] = v if v.dtype == object else np.asarray([str(x) for x in v], dtype=object)
        else:
            out[name] = v
    return out


def run_segment_generation_job(spec: SegmentGenerationJobSpec, controller=None, report: list | None = None) -> list[str]:
    """Execute the job; returns written segment directories (SegmentCreation)
    and pushes to `controller` when job_type ends with TarPush
    (LaunchDataIngestionJobCommand -> SegmentGenerationJobRunner parity)."""
    from pinot_tpu_torch.segment.builder import SegmentBuilder, write_segment

    fs = get_fs(spec.input_dir_uri)
    files = [
        f
        for f in fs.list_files(spec.input_dir_uri, recursive=True)
        if fnmatch.fnmatch(PurePosixPath(f).name, spec.include_file_name_pattern)
    ]
    if not files:
        raise FileNotFoundError(
            f"no input files matching {spec.include_file_name_pattern!r} under {spec.input_dir_uri}"
        )
    push = spec.job_type.endswith("TarPush")
    if push and controller is None:
        raise ValueError(f"job type {spec.job_type} requires a controller to push to")
    if not push and spec.output_dir_uri is None:
        raise ValueError("SegmentCreation requires output_dir_uri")
    builder = SegmentBuilder(spec.schema, spec.table_config)

    local = isinstance(fs, LocalFS)

    def one(idx_file):
        i, fpath = idx_file
        if local:
            # sequence id in the segment name (SimpleSegmentNameGenerator
            # parity); read->transform->coerce->build shared with the
            # distributed runner
            seg, stats = _build_one_local(spec, builder, i, fpath)
        else:
            # non-local FS (object store / mem): stage through a temp file,
            # the copyToLocal step every non-standalone runner performs
            import tempfile

            suffix = PurePosixPath(fpath).suffix or (f".{spec.input_format}" if spec.input_format else "")
            with tempfile.NamedTemporaryFile(suffix=suffix, delete=False) as tmp:
                tmp.write(fs.read_bytes(fpath))
                staged = tmp.name
            try:
                seg, stats = _build_one_local(spec, builder, i, staged)
            finally:
                Path(staged).unlink(missing_ok=True)
            stats["file"] = fpath
        t0 = time.perf_counter()
        if push:
            controller.upload_segment(spec.table_name, seg)
            return seg.name, {**stats, "push_s": time.perf_counter() - t0}
        out = write_segment(seg, Path(spec.output_dir_uri))
        return str(out), {**stats, "write_s": time.perf_counter() - t0}

    if spec.parallelism > 1:
        with ThreadPoolExecutor(max_workers=spec.parallelism) as pool:
            done = list(pool.map(one, enumerate(files)))
    else:
        done = [one(x) for x in enumerate(files)]
    if report is not None:
        report.extend(stats for _, stats in done)
    return [out for out, _ in done]


# ---------------------------------------------------------------------------
# distributed runner (Hadoop/Spark SegmentGenerationJobRunner analog)
# ---------------------------------------------------------------------------


def _build_one_local(spec: SegmentGenerationJobSpec, builder, i: int, fpath: str):
    """Shared per-file body of both runners: read -> transform -> coerce ->
    build. (The standalone runner adds object-store staging around it.)
    Returns the segment and its report entry so far."""
    t0 = time.perf_counter()
    reader = open_record_reader(fpath, spec.input_format)
    try:
        cols = reader.read_columns()
    finally:
        reader.close()
    t1 = time.perf_counter()
    if spec.transform is not None:
        cols = spec.transform(cols)
    cols = _coerce(spec.schema, cols)
    prefix = spec.segment_name_prefix or spec.table_name
    seg = builder.build(cols, f"{prefix}_{i}")
    stats = {
        "file": str(fpath),
        "segment": seg.name,
        "rows": seg.n_docs,
        "read_s": t1 - t0,
        "build_s": time.perf_counter() - t1,
        "pid": os.getpid(),
        "torch": "torch" in sys.modules,
    }
    return seg, stats


def _run_partition(spec: SegmentGenerationJobSpec, part: list, controller_url: str | None):
    """One worker task: build + (push|write) every file in its partition.
    Runs in a SEPARATE PROCESS; pushes travel the real tar.gz-over-HTTP
    segment upload path, so the worker<->controller boundary matches the
    reference's distributed runners (SparkSegmentGenerationJobRunner's
    executors tar-pushing to the controller REST endpoint)."""
    from pinot_tpu_torch.segment.builder import SegmentBuilder, write_segment

    builder = SegmentBuilder(spec.schema, spec.table_config)
    push = spec.job_type.endswith("TarPush")
    client = None
    if push:
        from pinot_tpu_torch.cluster.http import RemoteControllerClient

        client = RemoteControllerClient(controller_url)
    out = []
    for i, fpath in part:
        seg, stats = _build_one_local(spec, builder, i, fpath)
        t0 = time.perf_counter()
        if push:
            client.upload_segment(spec.table_name, seg)
            out.append((seg.name, {**stats, "push_s": time.perf_counter() - t0}))
        else:
            out.append((str(write_segment(seg, Path(spec.output_dir_uri))), {**stats, "write_s": time.perf_counter() - t0}))
    return out


def run_distributed_segment_generation_job(
    spec: SegmentGenerationJobSpec,
    n_workers: int = 2,
    controller_url: str | None = None,
    max_task_retries: int = 1,
    report: list | None = None,
) -> list[str]:
    """Distributed-runner analog of run_segment_generation_job: input files
    round-robin across `n_workers` worker PROCESSES, each building its
    partition's segments and tar-pushing them to the controller over HTTP
    (SegmentCreationAndTarPush) or writing to the shared output dir.

    Failed partitions retry up to `max_task_retries` times (the map-task
    reattempt semantics of the Hadoop/Spark runners). `spec.transform` must
    be picklable (a module-level function) or None for this runner.

    Reference: pinot-plugins/pinot-batch-ingestion/pinot-batch-ingestion-
    {hadoop,spark-2.4,spark-3}/…/SegmentGenerationJobRunner.java — mappers/
    executors each run the same stage-build-push loop over their file split.
    """
    import concurrent.futures as cf
    import multiprocessing as mp

    fs = get_fs(spec.input_dir_uri)
    if not isinstance(fs, LocalFS):
        raise ValueError(
            "the distributed runner currently requires a shared local/NFS input dir "
            "(object-store inputs ride the standalone runner's staging path)"
        )
    files = [
        f
        for f in fs.list_files(spec.input_dir_uri, recursive=True)
        if fnmatch.fnmatch(PurePosixPath(f).name, spec.include_file_name_pattern)
    ]
    if not files:
        raise FileNotFoundError(
            f"no input files matching {spec.include_file_name_pattern!r} under {spec.input_dir_uri}"
        )
    push = spec.job_type.endswith("TarPush")
    if push and not controller_url:
        raise ValueError(f"job type {spec.job_type} requires controller_url to push to")
    if not push and spec.output_dir_uri is None:
        raise ValueError("SegmentCreation requires output_dir_uri")

    n_workers = max(1, min(n_workers, len(files)))
    partitions: list[list] = [[] for _ in range(n_workers)]
    for i, f in enumerate(files):
        partitions[i % n_workers].append((i, f))

    # start method: forkserver (the workers fork from a fresh server process,
    # so none inherits this process's threads or its CUDA context) where
    # __main__ is a file the server can re-import, else spawn; never fork,
    # since this process may have initialised CUDA
    import __main__ as _m

    methods = mp.get_all_start_methods()
    script_main = getattr(_m, "__file__", None) is not None and Path(str(_m.__file__)).exists()
    ctx = mp.get_context("forkserver" if script_main and "forkserver" in methods else "spawn")
    results: list[tuple[str, dict]] = []
    pending = {pid: part for pid, part in enumerate(partitions) if part}
    attempts: dict[int, int] = {pid: 0 for pid in pending}
    pool_breaks = 0
    while pending:
        with cf.ProcessPoolExecutor(max_workers=n_workers, mp_context=ctx) as pool:
            futs = {
                pool.submit(_run_partition, spec, part, controller_url): pid
                for pid, part in pending.items()
            }
            failed: dict[int, list] = {}
            for fut in cf.as_completed(futs):
                pid = futs[fut]
                try:
                    results.extend(fut.result())
                except cf.process.BrokenProcessPool:
                    # collateral of ANOTHER task crashing the pool: requeue
                    # without charging this partition's retry budget; a
                    # separate cap stops a repeatedly-dying worker
                    pool_breaks += 1
                    if pool_breaks > (max_task_retries + 1) * max(1, len(partitions)):
                        raise
                    failed[pid] = pending[pid]
                except Exception:
                    attempts[pid] += 1
                    if attempts[pid] > max_task_retries:
                        raise
                    failed[pid] = pending[pid]
        pending = failed
    if report is not None:
        report.extend(stats for _, stats in results)
    return [out for out, _ in results]
