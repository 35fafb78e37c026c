"""The port's filesystems, record readers and batch segment-generation jobs
against the JAX package's.

The corpus is tests/test_io.py's 25 cases. Each runs through both packages
on the same inputs: the filesystems must answer alike, the readers give the
same columns (dtype and values), the jobs build the same segments (every
column bit-equal) under the same names, and pushed tables answer the same
rows through each package's Broker. The distributed runner pushes over both
packages' ControllerHTTPService from worker processes that load no torch
and are never forked.
"""

import json
import struct
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import pinot_tpu.cluster as r_cluster
import pinot_tpu.common as r_common
import pinot_tpu.io as r_io
import pinot_tpu.io.batch as r_batch
import pinot_tpu.io.fs as r_fs
import pinot_tpu.io.readers as r_readers
import pinot_tpu.query as r_query
import pinot_tpu.segment as r_segment
import pinot_tpu_torch.cluster as p_cluster
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.io as p_io
import pinot_tpu_torch.io.batch as p_batch
import pinot_tpu_torch.io.fs as p_fs
import pinot_tpu_torch.io.readers as p_readers
import pinot_tpu_torch.query as p_query
import pinot_tpu_torch.segment as p_segment
from pinot_tpu.cluster.http import ControllerHTTPService as RControllerHTTPService
from pinot_tpu_torch.cluster.http import ControllerHTTPService as PControllerHTTPService

REF = SimpleNamespace(name="ref", cluster=r_cluster, common=r_common, io=r_io, batch=r_batch, fs=r_fs,
                      readers=r_readers, segment=r_segment, http=RControllerHTTPService,
                      engine=lambda segs: r_query.QueryEngine(segs),
                      server=lambda sid: r_cluster.Server(sid), broker=lambda c: r_cluster.Broker(c))
PORT = SimpleNamespace(name="port", cluster=p_cluster, common=p_common, io=p_io, batch=p_batch, fs=p_fs,
                       readers=p_readers, segment=p_segment, http=PControllerHTTPService,
                       engine=lambda segs: p_query.QueryEngine(segs, device="cpu"),
                       server=lambda sid: p_cluster.Server(sid, device="cpu"),
                       broker=lambda c: p_cluster.Broker(c, device="cpu"))
PKGS = (REF, PORT)


def _same_column(a: np.ndarray, b: np.ndarray) -> bool:
    """Bit-equal: the same dtype and bytes; objects equal one by one (same
    type), NaN equal to NaN."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == object:
        return all(
            (np.array_equal(x, y) if isinstance(x, np.ndarray) else
             type(x) is type(y) and (x == y or (isinstance(x, float) and x != x and y != y)))
            for x, y in zip(a, b)
        )
    return a.tobytes() == b.tobytes()


def assert_same_columns(ref: dict, port: dict):
    assert list(port) == list(ref)
    for c in ref:
        assert _same_column(np.asarray(ref[c]), np.asarray(port[c])), (c, ref[c][:8], port[c][:8])


def assert_same_segments(ref_segs, port_segs):
    assert [(s.name, s.n_docs) for s in port_segs] == [(s.name, s.n_docs) for s in ref_segs]
    for r, p in zip(ref_segs, port_segs):
        assert_same_columns({c: ci.materialize() for c, ci in r.columns.items()},
                            {c: ci.materialize() for c, ci in p.columns.items()})


def _schema(pkg):
    dt = pkg.common.DataType
    return pkg.common.Schema.build("events", dimensions=[("kind", dt.STRING)], metrics=[("value", dt.LONG)])


def _both(fn):
    """fn(pkg) for each package; asserts the two results equal and returns
    the port's."""
    out = {pkg.name: fn(pkg) for pkg in PKGS}
    assert out["port"] == out["ref"]
    return out["port"]


# -- filesystems ------------------------------------------------------------


def test_local_fs_roundtrip(tmp_path):
    def run(pkg):
        fs = pkg.io.LocalFS()
        root = str(tmp_path / pkg.name)
        fs.mkdir(f"{root}/a/b")
        fs.write_bytes(f"{root}/a/b/x.txt", b"hello")
        steps = [fs.exists(f"{root}/a/b/x.txt"), fs.length(f"{root}/a/b/x.txt"), fs.read_bytes(f"{root}/a/b/x.txt"),
                 fs.is_directory(f"{root}/a"),
                 [f.removeprefix(root) for f in fs.list_files(f"{root}/a", recursive=True)],
                 fs.copy(f"{root}/a/b/x.txt", f"{root}/y.txt"), fs.move(f"{root}/y.txt", f"{root}/z.txt"),
                 fs.exists(f"{root}/y.txt"), fs.delete(f"{root}/z.txt"),
                 fs.delete(f"{root}/a"), fs.delete(f"{root}/a", force=True)]
        return steps

    assert _both(run) == [True, 5, b"hello", True, ["/a/b/x.txt"], True, True, False, True, False, True]


def test_local_fs_file_uri_scheme(tmp_path):
    def run(pkg):
        fs = pkg.io.get_fs("file:///")
        fs.write_bytes(f"file://{tmp_path}/{pkg.name}.txt", b"via-uri")
        return type(fs).__name__, fs.read_bytes(f"file://{tmp_path}/{pkg.name}.txt")

    assert _both(run) == ("LocalFS", b"via-uri")


def test_mem_fs_roundtrip():
    def run(pkg):
        fs = pkg.io.MemFS()
        fs.write_bytes("mem://bucket/dir/a.csv", b"1,2")
        fs.write_bytes("mem://bucket/dir/sub/b.csv", b"3,4")
        return [fs.exists("mem://bucket/dir/a.csv"), fs.length("mem://bucket/dir/a.csv"),
                fs.is_directory("mem://bucket/dir"), fs.list_files("mem://bucket/dir"),
                fs.list_files("mem://bucket/dir", recursive=True), fs.last_modified("mem://bucket/dir/a.csv"),
                fs.move("mem://bucket/dir/a.csv", "mem://bucket/dir/c.csv"), fs.exists("mem://bucket/dir/a.csv"),
                fs.copy("mem://bucket/dir/c.csv", "mem://bucket/d.csv"), fs.delete("mem://bucket/dir"),
                fs.delete("mem://bucket/dir", force=True), fs.exists("mem://bucket/dir/c.csv"),
                fs.read_bytes("mem://bucket/d.csv")]

    out = _both(run)
    assert out[3] == ["/bucket/dir/a.csv"] and len(out[4]) == 2 and out[-3:] == [True, False, b"1,2"]


def test_get_fs_unknown_scheme_raises():
    def run(pkg):
        with pytest.raises(ValueError) as ei:
            pkg.io.get_fs("s3-unregistered://bucket/x")
        return str(ei.value)

    assert "no PinotFS" in _both(run)


def test_register_custom_fs():
    def run(pkg):
        fs = pkg.io.MemFS()
        pkg.io.register_fs("customscheme", fs)
        return pkg.io.get_fs("customscheme://x/y") is fs

    assert _both(run) is True


# -- record readers ---------------------------------------------------------


def _read(pkg, path, fmt=None):
    return pkg.io.open_record_reader(path, fmt).read_columns()


def test_csv_reader(tmp_path):
    p = tmp_path / "d.csv"
    p.write_text("name,age,score,mixed,empty\nalice,30,1.5,7,\nbob,41,2.25,x,\n")
    rows = _both(lambda pkg: list(pkg.io.CSVRecordReader(p)))
    assert rows[0] == {"name": "alice", "age": 30, "score": 1.5, "mixed": 7, "empty": None}
    ref, port = (pkg.io.CSVRecordReader(p).read_columns() for pkg in PKGS)
    assert_same_columns(ref, port)
    assert [port[c].dtype for c in ("age", "score", "name", "mixed")] == [np.int64, np.float64, object, object]
    # int64 -> float64 -> object, by whole column (a delimiter other than ',')
    t = "a|b|c\n1|1.5|q\n-7|2|r\n"
    ref, port = (pkg.io.CSVRecordReader(text=t, delimiter="|").read_columns() for pkg in PKGS)
    assert_same_columns(ref, port)
    assert [port[c].dtype for c in "abc"] == [np.int64, np.float64, object]

    def past_int64(pkg):
        # an integer past int64 is not promoted: numpy's OverflowError escapes
        # the reference's int64 -> float64 -> object chain (ROADMAP Queue C)
        with pytest.raises(OverflowError):
            pkg.io.CSVRecordReader(text="a\n1\n9223372036854775808\n").read_columns()
        return True

    assert _both(past_int64)


def test_json_array_and_jsonl(tmp_path):
    arr = tmp_path / "a.json"
    arr.write_text(json.dumps([{"x": 1, "meta": {"k": "v"}, "s": "p"}, {"x": 2, "meta": {"k": "w"}, "s": None}]))
    rows = _both(lambda pkg: list(pkg.io.JSONRecordReader(arr)))
    assert rows[0]["x"] == 1 and json.loads(rows[0]["meta"]) == {"k": "v"}
    assert_same_columns(*(_read(pkg, arr) for pkg in PKGS))
    jl = tmp_path / "b.jsonl"
    jl.write_text('{"x": 3, "f": 1.5}\n\n{"x": 4, "f": 2}\n')
    assert [r["x"] for r in _both(lambda pkg: list(pkg.io.JSONRecordReader(jl)))] == [3, 4]
    ref, port = (_read(pkg, jl) for pkg in PKGS)
    assert_same_columns(ref, port)
    assert port["f"].dtype == np.float64


def test_parquet_reader(tmp_path):
    pa = pytest.importorskip("pyarrow")
    import datetime

    import pyarrow.parquet as pq

    t = pa.table({"k": ["a", "b", "c"], "v": [1, 2, 3]})
    p = tmp_path / "t.parquet"
    pq.write_table(t, p)
    ref, port = (_read(pkg, p) for pkg in PKGS)
    assert_same_columns(ref, port)
    assert list(port["v"]) == [1, 2, 3] and list(port["k"]) == ["a", "b", "c"]
    # nulls and the other column types convert as the reference's pandas does
    t = pa.table({
        "s": ["a", None, "c"], "i": [1, None, 3], "f": pa.array([1.5, None, 2.0], pa.float32()),
        "b": [True, None, False], "b2": [True, False, True], "ts": pa.array([1, 2, None], pa.timestamp("ms")),
        "d": pa.array([datetime.date(2020, 1, 1), None, datetime.date(2020, 1, 3)]),
        "ls": pa.array(["x", None, "z"], pa.large_string()), "i8": pa.array([1, 2, 3], pa.int8()),
    })
    pq.write_table(t, tmp_path / "n.parquet")
    ref, port = (_read(pkg, tmp_path / "n.parquet") for pkg in PKGS)
    assert_same_columns(ref, port)
    # ORC through pyarrow.orc
    orc = pytest.importorskip("pyarrow.orc")
    orc.write_table(pa.table({"k": ["a", None], "v": [1, 2], "x": [0.5, None]}), tmp_path / "o.orc")
    assert_same_columns(*(_read(pkg, tmp_path / "o.orc") for pkg in PKGS))
    assert _both(lambda pkg: [sorted(r) for r in pkg.io.open_record_reader(tmp_path / "o.orc")]) == [["k", "v", "x"]] * 2


def test_open_record_reader_by_format_and_unknown(tmp_path):
    p = tmp_path / "data.txt"
    p.write_text("a,b\n1,2\n")

    def run(pkg):
        kind = type(pkg.io.open_record_reader(p, fmt="csv")).__name__
        with pytest.raises(ValueError) as ei:
            pkg.io.open_record_reader(p)
        return kind, str(ei.value), sorted(pkg.readers._BY_EXT)

    assert _both(run)[0] == "CSVRecordReader"


def test_avro_gated():
    def run(pkg):
        with pytest.raises((ImportError, ValueError)) as ei:
            pkg.io.open_record_reader("x.avro")
        return type(ei.value).__name__

    assert _both(run) in ("ImportError", "ValueError")


# -- batch jobs -------------------------------------------------------------


def _job(pkg, **kw):
    return pkg.io.SegmentGenerationJobSpec(table_name="events", schema=_schema(pkg), **kw)


def _segments_of(pkg, dirs):
    return [pkg.segment.load_segment(d) for d in dirs]


def test_segment_creation_job_local(tmp_path):
    inputs = tmp_path / "in"
    inputs.mkdir()
    for i in range(3):
        (inputs / f"in{i}.csv").write_text("kind,value\n" + "".join(f"k{j % 2},{j + i}\n" for j in range(10)))
    dirs, files = {}, []
    for pkg in PKGS:
        spec = _job(pkg, input_dir_uri=str(inputs), include_file_name_pattern="in*.csv",
                    output_dir_uri=str(tmp_path / pkg.name), parallelism=2)
        dirs[pkg.name] = pkg.io.run_segment_generation_job(spec, **({"report": files} if pkg is PORT else {}))
    assert [Path(d).relative_to(tmp_path / "port") for d in dirs["port"]] == [
        Path(d).relative_to(tmp_path / "ref") for d in dirs["ref"]]
    segs = {pkg.name: _segments_of(pkg, dirs[pkg.name]) for pkg in PKGS}
    assert_same_segments(segs["ref"], segs["port"])
    rows = _both(lambda pkg: [pkg.engine(segs[pkg.name]).execute(q).rows for q in (
        "SELECT COUNT(*) FROM events", "SELECT SUM(value) FROM events WHERE kind = 'k0'")])
    assert rows[0] == [[30]] and rows[1][0][0] > 0
    assert [(Path(f["file"]).name, f["segment"], f["rows"]) for f in files] == [
        (f"in{i}.csv", f"events_{i}", 10) for i in range(3)]
    assert all(f["write_s"] >= 0 and "push_s" not in f for f in files)


def _cluster(pkg, root):
    controller = pkg.cluster.Controller(pkg.cluster.PropertyStore(), root / pkg.name / "deepstore")
    controller.register_server("server_0", pkg.server("server_0"))
    controller.add_schema(_schema(pkg))
    controller.add_table(pkg.common.TableConfig("events"))
    return controller


def _hosted(pkg, controller, table="events"):
    srv = controller.servers()["server_0"]
    return [srv.get_segment_object(table, n) for n in sorted(controller.ideal_state(table))]


def test_segment_creation_and_push_job(tmp_path):
    """SegmentCreationAndTarPush: built segments land on cluster servers and
    are queryable through the broker."""
    (tmp_path / "in.jsonl").write_text("\n".join(json.dumps({"kind": f"k{i % 3}", "value": i}) for i in range(20)))
    out = {}
    for pkg in PKGS:
        controller = _cluster(pkg, tmp_path)
        spec = _job(pkg, input_dir_uri=str(tmp_path), job_type="SegmentCreationAndTarPush",
                    include_file_name_pattern="*.jsonl")
        names = pkg.io.run_segment_generation_job(spec, controller=controller)
        rows = pkg.broker(controller).execute("SELECT kind, COUNT(*) FROM events GROUP BY kind ORDER BY kind").rows
        out[pkg.name] = (names, rows, _hosted(pkg, controller))
    assert_same_segments(out["ref"][2], out["port"][2])
    assert out["port"][:2] == out["ref"][:2]
    assert out["port"][0] == ["events_0"] and [r[1] for r in out["port"][1]] == [7, 7, 6]


def test_job_from_mem_fs(tmp_path):
    """Inputs on a non-local PinotFS stage through copy-to-local."""
    out, files = {}, []
    for pkg in PKGS:
        fs = pkg.io.MemFS()
        pkg.io.register_fs("memjob", fs)
        fs.write_bytes("memjob://in/part.csv", b"kind,value\nk0,5\nk1,6\n")
        controller = _cluster(pkg, tmp_path)
        spec = _job(pkg, input_dir_uri="memjob://in", job_type="SegmentCreationAndTarPush")
        kw = {"report": files} if pkg is PORT else {}
        out[pkg.name] = (pkg.io.run_segment_generation_job(spec, controller=controller, **kw), _hosted(pkg, controller))
    assert_same_segments(out["ref"][1], out["port"][1])
    assert out["port"][0] == out["ref"][0] == ["events_0"]
    assert files[0]["file"] == "/in/part.csv" and files[0]["push_s"] >= 0  # MemFS lists keys, not URIs


def _double(cols):
    cols["value"] = cols["value"] * 2
    return cols


def test_job_transform_hook(tmp_path):
    """Ingestion transform (RecordTransformer analog) runs before build."""
    (tmp_path / "x.csv").write_text("kind,value\nk0,1\nk1,2\n")
    segs = {}
    for pkg in PKGS:
        spec = _job(pkg, input_dir_uri=str(tmp_path), include_file_name_pattern="*.csv",
                    output_dir_uri=str(tmp_path / pkg.name), transform=_double)
        segs[pkg.name] = _segments_of(pkg, pkg.io.run_segment_generation_job(spec))
    assert_same_segments(segs["ref"], segs["port"])
    assert _both(lambda pkg: pkg.engine(segs[pkg.name]).execute("SELECT SUM(value) FROM events").rows) == [[6.0]]


def test_job_no_inputs_raises(tmp_path):
    def run(pkg):
        spec = _job(pkg, input_dir_uri=str(tmp_path), output_dir_uri=str(tmp_path / "o"))
        with pytest.raises(FileNotFoundError) as ei:
            pkg.io.run_segment_generation_job(spec)
        return str(ei.value)

    _both(run)


# -- the other input formats (Protobuf, Thrift, CLP) -------------------------


def test_clp_reader_roundtrip():
    lines = [
        "2024-01-01 ERROR connection to 10.0.0.5 failed after 3 retries",
        "user user_42 logged in from host web-07 in 0.25 seconds",
        "regex \\d matched 007 and -0 and 12345678901234567890 at 1.50",
    ]
    rows = _both(lambda pkg: list(pkg.readers.CLPRecordReader(text="\n".join(lines))))
    for line, row in zip(lines, rows):
        assert "\\d" in row["logtype"] or "\\f" in row["logtype"]
        assert p_readers.CLPRecordReader.decode_row(row) == line
    r1, r2 = (p_readers.CLPRecordReader.encode_line(s) for s in ("job 12 done in 3.5 s", "job 99 done in 7.25 s"))
    assert r1["logtype"] == r2["logtype"]


def test_protobuf_reader_gated_message_cls(tmp_path):
    def run(pkg):
        with pytest.raises(ValueError) as ei:
            pkg.readers.ProtobufRecordReader(tmp_path / "x.pb")
        return str(ei.value)

    assert "message_cls" in _both(run)


def test_protobuf_reader_decodes_length_delimited_messages(tmp_path):
    """A message class built from a descriptor; varint-delimited messages
    decode to the same rows in both packages."""
    pytest.importorskip("google.protobuf")
    from google.protobuf import descriptor_pb2, descriptor_pool
    from google.protobuf.internal.encoder import _VarintBytes
    from google.protobuf.message_factory import GetMessageClass

    fdp = descriptor_pb2.FileDescriptorProto(name="ev.proto", package="t")
    msg = fdp.message_type.add(name="Ev")
    for num, (name, typ) in enumerate((("kind", 9), ("value", 3), ("score", 1)), 1):
        msg.field.add(name=name, number=num, type=typ, label=1)
    cls = GetMessageClass(descriptor_pool.DescriptorPool().Add(fdp).message_types_by_name["Ev"])
    blob = b"".join(_VarintBytes(len(b)) + b for b in (
        cls(kind="a", value=7, score=1.5).SerializeToString(), cls(kind="b", value=-3).SerializeToString()))
    (tmp_path / "rows.pb").write_bytes(blob)
    rows = _both(lambda pkg: list(pkg.readers.ProtobufRecordReader(tmp_path / "rows.pb", message_cls=cls)))
    assert rows == [{"kind": "a", "value": 7, "score": 1.5}, {"kind": "b", "value": -3, "score": 0.0}]


def test_thrift_reader_requires_field_map(tmp_path):
    def run(pkg):
        with pytest.raises(ValueError) as ei:
            pkg.readers.ThriftRecordReader(tmp_path / "x.thrift")
        return str(ei.value)

    assert "field_map" in _both(run)


def _enc_field(ftype, fid, payload):
    return struct.pack(">bh", ftype, fid) + payload


def _enc_string(s):
    b = s.encode()
    return struct.pack(">i", len(b)) + b


def _enc_struct(fields):
    return b"".join(fields) + b"\x00"


def test_thrift_reader_decodes_binary_protocol(tmp_path):
    """Back-to-back TBinaryProtocol structs with every scalar wire type, a
    list, a map and a nested struct decode into the same rows, and
    read_columns promotes numerics alike."""
    rec1 = _enc_struct([
        _enc_field(10, 1, struct.pack(">q", 123456789012)),
        _enc_field(11, 2, _enc_string("alice")),
        _enc_field(4, 3, struct.pack(">d", 2.5)),
        _enc_field(2, 4, b"\x01"),
        _enc_field(8, 5, struct.pack(">i", -7)),
        _enc_field(15, 6, struct.pack(">bi", 8, 2) + struct.pack(">i", 10) + struct.pack(">i", 20)),
        _enc_field(13, 7, struct.pack(">bbi", 11, 8, 1) + _enc_string("k") + struct.pack(">i", 5)),
        _enc_field(12, 8, _enc_struct([_enc_field(6, 1, struct.pack(">h", 3))])),
        _enc_field(3, 9, struct.pack(">b", -2)),
        _enc_field(11, 10, struct.pack(">i", 2) + b"\xff\xfe"),  # BINARY: not UTF-8, stays bytes
    ])
    rec2 = _enc_struct([
        _enc_field(10, 1, struct.pack(">q", 42)),
        _enc_field(11, 2, _enc_string("bob")),
        _enc_field(4, 3, struct.pack(">d", -1.25)),
        _enc_field(2, 4, b"\x00"),
        _enc_field(8, 5, struct.pack(">i", 9)),
    ])
    path = tmp_path / "rows.thrift"
    path.write_bytes(rec1 + rec2)
    fmap = {1: "uid", 2: "name", 3: "score", 4: "active", 5: "delta", 6: "tags", 7: "attrs", 8: "sub", 9: "b"}
    rows = _both(lambda pkg: list(pkg.readers.ThriftRecordReader(path, field_map=fmap)))
    assert rows[0]["uid"] == 123456789012 and rows[0]["tags"] == [10, 20] and rows[0]["attrs"] == {"k": 5}
    assert rows[0]["sub"] == {1: 3} and rows[0]["field_10"] == b"\xff\xfe"
    assert rows[1] == {"uid": 42, "name": "bob", "score": -1.25, "active": False, "delta": 9}
    (tmp_path / "two.thrift").write_bytes(rec2 + rec2)
    ref, port = (pkg.readers.ThriftRecordReader(tmp_path / "two.thrift", field_map=fmap).read_columns() for pkg in PKGS)
    assert_same_columns(ref, port)


def test_thrift_reader_field_map_from_thrift_spec(tmp_path):
    class FakeThrift:
        # thriftpy2-style: dict {fid: (ttype, name, ...)}
        thrift_spec = {1: (10, "uid", False), 2: (11, "name", False)}

    rec = _enc_field(10, 1, struct.pack(">q", 7)) + _enc_field(11, 2, _enc_string("hi")) + b"\x00"
    (tmp_path / "one.thrift").write_bytes(rec)
    rows = _both(lambda pkg: list(pkg.readers.ThriftRecordReader(tmp_path / "one.thrift", thrift_cls=FakeThrift)))
    assert rows == [{"uid": 7, "name": "hi"}]


def test_clp_ingestion_to_segment(tmp_path):
    """CLP-encoded logs land as queryable columns (logtype dict-encoded,
    vars as MV columns) — the pinot-clp-log table shape."""
    lines = [f"request {i} served in {i * 1.5 + 0.25} ms" for i in range(100)] + [
        f"error code {i} from host-{i}" for i in range(50)
    ]
    out = {}
    for pkg in PKGS:
        rows = list(pkg.readers.CLPRecordReader(text="\n".join(lines)))
        dt = pkg.common.DataType
        schema = pkg.common.Schema.build("logs", dimensions=[("logtype", dt.STRING)], metrics=[])
        schema.add(pkg.common.FieldSpec("dictionaryVars", dt.STRING, single_value=False))
        schema.add(pkg.common.FieldSpec("encodedVars", dt.DOUBLE, single_value=False))
        seg = pkg.segment.SegmentBuilder(schema).build(rows, "l0")
        res = pkg.engine([seg]).execute(
            "SELECT logtype, COUNT(*) FROM logs GROUP BY logtype ORDER BY COUNT(*) DESC LIMIT 5")
        out[pkg.name] = (seg, res.rows)
    assert_same_segments([out["ref"][0]], [out["port"][0]])
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1][0][1] == 100 and len(out["port"][1]) == 2


def test_distributed_segment_generation_job(tmp_path, monkeypatch):
    """Distributed runner: worker processes build partitions and tar-push
    over each package's controller HTTP service. The port's workers are
    never forked and load no torch."""
    import multiprocessing as mp

    for i in range(5):
        (tmp_path / f"part{i}.jsonl").write_text(
            "\n".join(json.dumps({"kind": f"k{j % 3}", "value": 100 * i + j}) for j in range(12)))
    methods, files = [], []
    real = mp.get_context
    out = {}
    for pkg in PKGS:
        controller = _cluster(pkg, tmp_path)
        svc = pkg.http(controller)
        try:
            spec = _job(pkg, input_dir_uri=str(tmp_path), job_type="SegmentCreationAndTarPush",
                        include_file_name_pattern="part*.jsonl")
            if pkg is PORT:
                monkeypatch.setattr(mp, "get_context", lambda m=None: methods.append(m) or real(m))
            names = pkg.batch.run_distributed_segment_generation_job(
                spec, n_workers=3, controller_url=f"http://127.0.0.1:{svc.port}",
                **({"report": files} if pkg is PORT else {}))
            monkeypatch.setattr(mp, "get_context", real)
            res = pkg.broker(controller).execute("SELECT COUNT(*), SUM(value) FROM events")
            out[pkg.name] = (sorted(names), res.rows, _hosted(pkg, controller))
        finally:
            svc.stop()
    assert_same_segments(out["ref"][2], out["port"][2])
    assert out["port"][:2] == out["ref"][:2]
    assert len(out["port"][0]) == 5
    assert out["port"][1] == [[60, float(sum(100 * i + j for i in range(5) for j in range(12)))]]
    assert methods and "fork" not in methods
    assert sorted(f["segment"] for f in files) == out["port"][0]
    assert not any(f["torch"] for f in files) and len({f["pid"] for f in files}) > 1


def test_distributed_job_local_output(tmp_path):
    """SegmentCreation mode: workers write to a shared output dir."""
    inputs = tmp_path / "in"
    inputs.mkdir()
    for i in range(4):
        (inputs / f"in{i}.csv").write_text("kind,value\n" + "".join(f"k{j % 2},{j}\n" for j in range(8)))
    segs = {}
    for pkg in PKGS:
        spec = _job(pkg, input_dir_uri=str(inputs), include_file_name_pattern="in*.csv",
                    output_dir_uri=str(tmp_path / pkg.name))
        dirs = pkg.batch.run_distributed_segment_generation_job(spec, n_workers=2)
        segs[pkg.name] = sorted(_segments_of(pkg, dirs), key=lambda s: s.name)
    assert_same_segments(segs["ref"], segs["port"])
    assert _both(lambda pkg: pkg.engine(segs[pkg.name]).execute("SELECT COUNT(*) FROM events").rows) == [[32]]


def test_thrift_reader_apache_style_tuple_spec(tmp_path):
    class ApacheThrift:
        # Apache Thrift generated shape: (None, (fid, ttype, name, ...), ...)
        thrift_spec = (None, (1, 10, "uid", None, None), (2, 11, "name", None, None))

    rec = _enc_field(10, 1, struct.pack(">q", 9)) + _enc_field(11, 2, _enc_string("ok")) + b"\x00"
    (tmp_path / "apache.thrift").write_bytes(rec)
    rows = _both(lambda pkg: list(pkg.readers.ThriftRecordReader(tmp_path / "apache.thrift", thrift_cls=ApacheThrift)))
    assert rows == [{"uid": 9, "name": "ok"}]


@pytest.mark.parametrize(
    "blob",
    [
        _enc_field(11, 1, struct.pack(">i", -5)) + b"\x00",  # negative string length
        _enc_field(11, 1, struct.pack(">i", 1 << 20) + b"hi"),  # length past the end
        _enc_field(10, 1, struct.pack(">q", 5)),  # struct without its STOP byte
        _enc_field(15, 1, struct.pack(">bi", 10, 1 << 20)),  # a list too long for the file
        _enc_field(9, 1, b"") + b"\x00",  # an unknown wire type
    ],
    ids=["negative_length", "past_end", "no_stop", "long_list", "bad_type"],
)
def test_thrift_reader_corrupt_lengths_fail_loudly(tmp_path, blob):
    (tmp_path / "bad.thrift").write_bytes(blob)

    def run(pkg):
        with pytest.raises(ValueError) as ei:
            list(pkg.readers.ThriftRecordReader(tmp_path / "bad.thrift", field_map={1: "s"}))
        return str(ei.value)

    msg = _both(run)
    assert "corrupt" in msg or "unsupported" in msg or "truncated" in msg
