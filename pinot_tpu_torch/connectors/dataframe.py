"""Batch read/write connector: tables <-> column frames.

Reference parity: pinot-connectors/ (Spark/Flink read + write connectors).
The Spark read connector plans one input split per segment and reads segment
data directly (server gRPC scan); here read_table fans a thread pool over the
deep-store segment copies — the same segment-level parallelism — and
write_table is the write connector: chunk a frame into segments and push
them through the controller. Both work against an in-process Controller or a
RemoteControllerClient (controller REST), so external jobs can use them the
way Spark executors use the reference connector.

This is the JAX package's `connectors/dataframe.py` without pandas. A frame
is an ordered `dict[str, np.ndarray]`, one array a column, in the column
order the reference's DataFrame has; where the reference concatenates
DataFrames, the columns' arrays are concatenated. Each column equals the
reference frame's `df[c].to_numpy()`: numbers keep their dtype, strings come
as object arrays of str. `write_table` takes such a dict or any object with
`columns` and `__getitem__` giving something `np.asarray` accepts (a pandas
DataFrame a caller holds works as it is).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import numpy as np


def _as_column(v) -> np.ndarray:
    """A column as a DataFrame holds it: numpy strings become an object
    array of str."""
    v = np.asarray(v)
    return v.astype(object) if v.dtype.kind in "US" else v


def _empty_frame(names: list[str]) -> dict[str, np.ndarray]:
    """`pd.DataFrame(columns=names)`: empty object columns."""
    return {c: np.empty(0, dtype=object) for c in names}


def _concat(frames: list[dict[str, np.ndarray]]) -> dict[str, np.ndarray]:
    """`pd.concat(frames, ignore_index=True)` of frames with the same
    columns."""
    return {c: np.concatenate([f[c] for f in frames]) for c in frames[0]}


def read_table(
    controller,
    table: str,
    columns: list[str] | None = None,
    parallelism: int = 4,
    where: str | None = None,
) -> dict[str, np.ndarray]:
    """Table scan into a frame, one task per segment. `where` pushes a
    SQL predicate into each segment scan (the reference Spark connector's
    filter pushdown): bloom/min-max pruning skips whole segments, and only
    matching rows materialize."""
    from pinot_tpu_torch.query.sql import parse_sql
    from pinot_tpu_torch.segment.loader import load_segment

    pred = parse_sql(f"SELECT * FROM _t WHERE {where}").where if where else None

    meta = controller.all_segment_metadata(table)
    locations = [m["location"] for _, m in sorted(meta.items()) if m.get("location")]

    def one(loc: str) -> dict[str, np.ndarray]:
        from pinot_tpu_torch.query import host_exec, pruner

        seg = load_segment(loc)
        cols = columns or list(seg.columns)
        if pred is not None:
            if not pruner.filter_can_match(seg, pred):
                # empty frames keep real column dtypes: a default float64
                # empty column would widen int64 ids across the concat
                def _empty(ci):
                    if ci.is_mv or ci.data_type.value in ("STRING", "JSON", "BYTES"):
                        return np.empty(0, dtype=object)
                    return np.empty(0, dtype=ci.data_type.np_dtype)

                return {c: _empty(seg.columns[c]) for c in cols}
            mask = host_exec.filter_mask(seg, pred)
            return {c: _as_column(seg.columns[c].materialize()[mask]) for c in cols}
        return {c: _as_column(seg.columns[c].materialize()) for c in cols}

    if not locations:
        return _empty_frame(columns or [])
    with ThreadPoolExecutor(max_workers=max(1, parallelism)) as pool:
        frames = list(pool.map(one, locations))
    return _concat(frames)


def write_table(
    controller,
    table: str,
    df,
    rows_per_segment: int = 1_000_000,
    segment_name_prefix: str | None = None,
) -> list[str]:
    """Chunk a frame into segments and push them. The controller must
    already know the table's schema/config (AddTable first)."""
    from pinot_tpu_torch.segment.builder import SegmentBuilder

    schema = controller.get_schema(table)
    if schema is None:
        raise KeyError(f"no schema for table {table!r}")
    config = controller.get_table(table)
    builder = SegmentBuilder(schema, config)
    prefix = segment_name_prefix or f"{table}_df"
    names = list(df.columns) if hasattr(df, "columns") else list(df)
    n = len(np.asarray(df[names[0]])) if names else 0
    missing = [name for name in schema.columns if name not in names]
    if missing and n:
        raise KeyError(f"DataFrame missing schema column {missing[0]!r}")
    cols = {name: _as_column(df[name]) for name in schema.columns} if n else {}
    pushed = []
    for i, start in enumerate(range(0, n, rows_per_segment)):
        data = {name: v[start : start + rows_per_segment] for name, v in cols.items()}
        seg = builder.build(data, f"{prefix}_{i}")
        # both handles expose upload_segment (RemoteControllerClient wraps
        # the write-tempdir-tar-push dance internally)
        controller.upload_segment(table, seg)
        pushed.append(seg.name)
    return pushed


def read_table_via_servers(
    controller,
    table: str,
    columns: list[str] | None = None,
    parallelism: int = 4,
    where: str | None = None,
) -> dict[str, np.ndarray]:
    """Table scan into a frame reading from the SERVERS rather than the
    deep store — the reference Spark connector's direct-server scan path
    (pinot-connectors/.../PinotServerDataFetcher reading via server gRPC).
    One task per (server, segment batch): the same streamed-selection
    surface the broker uses, so filter pushdown and segment pruning run
    server-side and the deep store never spins up. Works with an in-process
    Controller or a RemoteControllerClient."""
    servers = controller.servers()
    ideal = controller.ideal_state(table)
    # one owner per segment: first listed replica (the Spark connector picks
    # one server per split the same way)
    per_server: dict[str, list[str]] = {}
    for seg, owners in sorted(ideal.items()):
        # ideal-state entries are {server_id: state}; take the first ONLINE
        # replica as the split owner
        owner_list = [s for s, st in owners.items() if st == "ONLINE"] if isinstance(owners, dict) else list(owners)
        if owner_list:
            per_server.setdefault(owner_list[0], []).append(seg)
    # streamed selection frames carry positional column labels; the split
    # results re-label to the real projection (schema order for SELECT *)
    if columns is None:
        schema = controller.get_schema(table)
        if schema is None:
            raise KeyError(f"no schema for table {table!r}")
        out_names = list(schema.columns)
    else:
        out_names = list(columns)
    col_sql = ", ".join(out_names)
    base_sql = f"SELECT {col_sql} FROM {table}"
    if where:
        base_sql += f" WHERE {where}"
    # LIMIT sized to the actual doc count: a huge constant limit would make
    # the selection kernel allocate limit-sized index buffers
    meta = controller.all_segment_metadata(table)
    seg_docs = {s: int(m.get("numDocs", 0)) for s, m in meta.items()}

    def one(item) -> dict[str, np.ndarray]:
        sid, segs = item
        sql = f"{base_sql} LIMIT {max(1, sum(seg_docs.get(s, 0) for s in segs))}"
        handle = servers.get(sid)
        if handle is None:
            raise KeyError(f"segment owner {sid!r} not in controller instance registry")
        frames = []
        stream = handle.execute_partials_stream(table, sql, segs)
        for frame, _matched, _docs, *_rest in stream:
            # in-process and HTTP handles both yield column frames (dicts;
            # the reference's in-process frames are DataFrames)
            if frame and len(next(iter(frame.values()))):
                frames.append({c: _as_column(v) for c, v in zip(out_names, frame.values())})
        if not frames:
            return _empty_frame(out_names)
        return _concat(frames)

    if not per_server:
        # segment-less table still answers with the schema/projection labels
        return _empty_frame(out_names)
    with ThreadPoolExecutor(max_workers=max(1, parallelism)) as pool:
        frames = list(pool.map(one, sorted(per_server.items())))
    return _concat(frames)
