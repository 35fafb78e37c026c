"""The port's object-store and HDFS PinotFS plugins against the JAX
package's, over in-process protocol stubs.

The corpus is tests/test_cloud_fs.py's 10 cases (ADLS Gen2 and WebHDFS)
and tests/test_s3fs.py's 5 (S3, and gs:// on GCS's S3 XML API); the stub
servers are theirs, with a log of every request. Each case drives both
packages' plugin through the same exercise against the same stub: the
answers must be equal, and so must every request, byte for byte (method,
path and query, headers and body) - at a fixed clock, so the ADLS Shared
Key and S3 SigV4 signatures are the same bytes too.
"""

import datetime
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace
from urllib.parse import parse_qs, unquote, urlparse

import numpy as np
import pytest

import pinot_tpu.common as r_common
import pinot_tpu.io.adls as r_adls
import pinot_tpu.io.fs as r_fs
import pinot_tpu.io.hdfs as r_hdfs
import pinot_tpu.io.s3 as r_s3
import pinot_tpu.query as r_query
import pinot_tpu.segment as r_segment
import pinot_tpu_torch.common as p_common
import pinot_tpu_torch.io.adls as p_adls
import pinot_tpu_torch.io.fs as p_fs
import pinot_tpu_torch.io.hdfs as p_hdfs
import pinot_tpu_torch.io.s3 as p_s3
import pinot_tpu_torch.query as p_query
import pinot_tpu_torch.segment as p_segment
from pinot_tpu.query.transforms import apply_string_func as r_apply
from pinot_tpu_torch.query.transforms import apply_string_func as p_apply

REF = SimpleNamespace(name="ref", adls=r_adls, hdfs=r_hdfs, s3=r_s3, fs=r_fs)
PORT = SimpleNamespace(name="port", adls=p_adls, hdfs=p_hdfs, s3=p_s3, fs=p_fs)
PKGS = (REF, PORT)


class _FixedClock(datetime.datetime):
    @classmethod
    def now(cls, tz=None):
        return datetime.datetime(2024, 5, 17, 12, 34, 56, tzinfo=tz)


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """Both packages sign with the same clock: the x-amz-date / x-ms-date
    headers, and so the signatures, are comparable. (Every module that
    imports pandas or torch is imported at the top, before the patch.)"""
    monkeypatch.setattr(datetime, "datetime", _FixedClock)


def _record(stub, handler) -> bytes:
    """Log one request (method, path and query, headers, body) and return
    its body."""
    n = int(handler.headers.get("Content-Length", 0) or 0)
    body = handler.rfile.read(n) if n else b""
    stub.log.append((handler.command, handler.path, sorted(handler.headers.items()), body))
    return body


# ---------------------------------------------------------------------------
# the reference tests' stubs (tests/test_cloud_fs.py, tests/test_s3fs.py)
# ---------------------------------------------------------------------------


class _AdlsStub:
    """Minimal ADLS Gen2 dfs endpoint: path-addressed files + directories."""

    def __init__(self):
        self.files: dict[tuple[str, str], bytes] = {}  # (fs, path) -> content
        self.dirs: set[tuple[str, str]] = set()
        self.log: list = []
        self.auth_failures: list[str] = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _fp(self):
                p = urlparse(self.path)
                parts = unquote(p.path).lstrip("/").split("/", 1)
                return parts[0], (parts[1] if len(parts) > 1 else ""), parse_qs(p.query)

            def _check_auth(self):
                a = self.headers.get("Authorization", "")
                if not (a.startswith("SharedKey ") and ":" in a and self.headers.get("x-ms-date")):
                    stub.auth_failures.append(self.path)

            def do_PUT(self):

                body = _record(stub, self)
                self._check_auth()
                fs, path, q = self._fp()
                src = self.headers.get("x-ms-rename-source")
                if src:
                    sfs, spath = unquote(src).lstrip("/").split("/", 1)
                    moved = False
                    if (sfs, spath) in stub.files:
                        stub.files[(fs, path)] = stub.files.pop((sfs, spath))
                        moved = True
                    for (f2, p2) in [k for k in list(stub.files) if k[0] == sfs and k[1].startswith(spath + "/")]:
                        stub.files[(fs, path + p2[len(spath):])] = stub.files.pop((f2, p2))
                        moved = True
                    if (sfs, spath) in stub.dirs:
                        stub.dirs.discard((sfs, spath))
                        stub.dirs.add((fs, path))
                        moved = True
                    self.send_response(201 if moved else 404)
                    self.end_headers()
                    return
                res = q.get("resource", [""])[0]
                if res == "directory":
                    stub.dirs.add((fs, path))
                elif res == "file":
                    stub.files[(fs, path)] = b""
                self.send_response(201)
                self.end_headers()

            def do_PATCH(self):

                body = _record(stub, self)
                self._check_auth()
                fs, path, q = self._fp()
                action = q.get("action", [""])[0]
                if action == "append":
                    pos = int(q.get("position", ["0"])[0])
                    cur = stub.files.get((fs, path), b"")
                    stub.files[(fs, path)] = cur[:pos] + body
                self.send_response(202 if action == "append" else 200)
                self.end_headers()

            def do_GET(self):

                body = _record(stub, self)
                self._check_auth()
                fs, path, q = self._fp()
                if q.get("resource") == ["filesystem"]:
                    directory = q.get("directory", [""])[0]
                    recursive = q.get("recursive", ["false"])[0] == "true"
                    prefix = directory.rstrip("/") + "/" if directory else ""
                    paths = []
                    names = set()
                    for (f2, p2), content in stub.files.items():
                        if f2 != fs or not p2.startswith(prefix):
                            continue
                        rel = p2[len(prefix):]
                        if not recursive and "/" in rel:
                            continue
                        names.add(p2)
                        paths.append({"name": p2, "contentLength": len(content)})
                    for (f2, d2) in stub.dirs:
                        if f2 == fs and d2.startswith(prefix) and d2 not in names and d2 != directory:
                            rel = d2[len(prefix):]
                            if recursive or "/" not in rel:
                                paths.append({"name": d2, "isDirectory": "true"})
                    body = json.dumps({"paths": paths}).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                data = stub.files.get((fs, path))
                if data is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_HEAD(self):

                body = _record(stub, self)
                self._check_auth()
                fs, path, _ = self._fp()
                if (fs, path) in stub.files:
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(stub.files[(fs, path)])))
                    self.send_header("Last-Modified", "Wed, 01 Jan 2025 00:00:00 GMT")
                    self.send_header("x-ms-resource-type", "file")
                    self.end_headers()
                elif (fs, path) in stub.dirs or any(
                    f2 == fs and p2.startswith(path.rstrip("/") + "/") for (f2, p2) in stub.files
                ):
                    self.send_response(200)
                    self.send_header("x-ms-resource-type", "directory")
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_DELETE(self):

                body = _record(stub, self)
                self._check_auth()
                fs, path, _ = self._fp()
                hit = False
                if (fs, path) in stub.files:
                    del stub.files[(fs, path)]
                    hit = True
                for k in [k for k in list(stub.files) if k[0] == fs and k[1].startswith(path.rstrip("/") + "/")]:
                    del stub.files[k]
                    hit = True
                if (fs, path) in stub.dirs:
                    stub.dirs.discard((fs, path))
                    hit = True
                self.send_response(200 if hit else 404)
                self.end_headers()

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()




class _HdfsStub:
    """Minimal WebHDFS namenode: /webhdfs/v1{path}?op=..."""

    def __init__(self, redirect_create: bool = False):
        self.files: dict[str, bytes] = {}
        self.dirs: set[str] = {"/"}
        self.log: list = []
        self.redirect_create = redirect_create
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _pq(self):
                p = urlparse(self.path)
                path = unquote(p.path)
                assert path.startswith("/webhdfs/v1")
                return path[len("/webhdfs/v1"):] or "/", parse_qs(p.query)

            def _json(self, doc, code=200):
                body = json.dumps(doc).encode()
                self.send_response(code)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_PUT(self):

                body = _record(stub, self)
                path, q = self._pq()
                op = q.get("op", [""])[0].upper()
                if op == "MKDIRS":
                    stub.dirs.add(path.rstrip("/") or "/")
                    self._json({"boolean": True})
                elif op == "CREATE":
                    if stub.redirect_create and "datanode" not in q:
                        self.send_response(307)
                        self.send_header(
                            "Location",
                            f"http://127.0.0.1:{stub.server.server_address[1]}/webhdfs/v1"
                            + path + "?op=CREATE&datanode=1",
                        )
                        self.send_header("Content-Length", "0")
                        self.end_headers()
                        return
                    stub.files[path] = body
                    self.send_response(201)
                    self.send_header("Content-Length", "0")
                    self.end_headers()
                elif op == "RENAME":
                    dst = q.get("destination", [""])[0]
                    moved = False
                    if path in stub.files:
                        stub.files[dst] = stub.files.pop(path)
                        moved = True
                    for p2 in [p for p in list(stub.files) if p.startswith(path.rstrip("/") + "/")]:
                        stub.files[dst + p2[len(path.rstrip("/")):]] = stub.files.pop(p2)
                        moved = True
                    if path in stub.dirs:
                        stub.dirs.discard(path)
                        stub.dirs.add(dst)
                        moved = True
                    self._json({"boolean": moved})

            def do_GET(self):

                body = _record(stub, self)
                path, q = self._pq()
                op = q.get("op", [""])[0].upper()
                if op == "OPEN":
                    data = stub.files.get(path)
                    if data is None:
                        self._json({"RemoteException": {"message": "not found"}}, 404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(data)))
                    self.end_headers()
                    self.wfile.write(data)
                elif op == "GETFILESTATUS":
                    if path in stub.files:
                        self._json({"FileStatus": {"type": "FILE", "length": len(stub.files[path]), "modificationTime": 1735689600000, "pathSuffix": ""}})
                    elif path.rstrip("/") in stub.dirs or path == "/" or any(
                        p.startswith(path.rstrip("/") + "/") for p in stub.files
                    ):
                        self._json({"FileStatus": {"type": "DIRECTORY", "length": 0, "modificationTime": 1735689600000, "pathSuffix": ""}})
                    else:
                        self._json({"RemoteException": {"message": "not found"}}, 404)
                elif op == "LISTSTATUS":
                    base = path.rstrip("/")
                    entries = {}
                    for p, content in stub.files.items():
                        if p.startswith(base + "/"):
                            rel = p[len(base) + 1 :]
                            head = rel.split("/", 1)[0]
                            if "/" in rel:
                                entries[head] = {"pathSuffix": head, "type": "DIRECTORY", "length": 0, "modificationTime": 1735689600000}
                            else:
                                entries[head] = {"pathSuffix": head, "type": "FILE", "length": len(content), "modificationTime": 1735689600000}
                    for d in stub.dirs:
                        if d.startswith(base + "/"):
                            head = d[len(base) + 1 :].split("/", 1)[0]
                            entries.setdefault(head, {"pathSuffix": head, "type": "DIRECTORY", "length": 0, "modificationTime": 1735689600000})
                    if not entries and base not in stub.dirs and base != "":
                        self._json({"RemoteException": {"message": "not found"}}, 404)
                        return
                    self._json({"FileStatuses": {"FileStatus": sorted(entries.values(), key=lambda e: e["pathSuffix"])}})

            def do_DELETE(self):

                body = _record(stub, self)
                path, q = self._pq()
                hit = False
                if path in stub.files:
                    del stub.files[path]
                    hit = True
                for p2 in [p for p in list(stub.files) if p.startswith(path.rstrip("/") + "/")]:
                    del stub.files[p2]
                    hit = True
                if path.rstrip("/") in stub.dirs:
                    stub.dirs.discard(path.rstrip("/"))
                    hit = True
                self._json({"boolean": hit})

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def url(self):
        return f"http://127.0.0.1:{self.server.server_address[1]}"

    def stop(self):
        self.server.shutdown()




class _S3Stub:
    """Minimal S3-compatible object store."""

    def __init__(self):
        self.objects: dict[tuple[str, str], bytes] = {}
        self.log: list = []
        self.auth_failures: list[str] = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):
                pass

            def _bk(self):
                p = urlparse(self.path)
                parts = unquote(p.path).lstrip("/").split("/", 1)
                return parts[0], (parts[1] if len(parts) > 1 else ""), parse_qs(p.query)

            def _check_auth(self):
                auth = self.headers.get("Authorization", "")
                if not (
                    auth.startswith("AWS4-HMAC-SHA256 Credential=")
                    and "SignedHeaders=" in auth
                    and "Signature=" in auth
                    and self.headers.get("x-amz-date")
                    and self.headers.get("x-amz-content-sha256")
                ):
                    stub.auth_failures.append(self.path)

            def do_PUT(self):

                body = _record(stub, self)
                self._check_auth()
                bucket, key, _ = self._bk()
                src = self.headers.get("x-amz-copy-source")
                if src:
                    sb, sk = unquote(src).lstrip("/").split("/", 1)
                    stub.objects[(bucket, key)] = stub.objects[(sb, sk)]
                else:
                    stub.objects[(bucket, key)] = body
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def do_GET(self):

                body = _record(stub, self)
                self._check_auth()
                bucket, key, q = self._bk()
                if q.get("list-type") == ["2"]:
                    prefix = q.get("prefix", [""])[0]
                    keys = sorted(
                        k for (b, k) in stub.objects if b == bucket and k.startswith(prefix)
                    )
                    body = (
                        '<?xml version="1.0"?><ListBucketResult>'
                        + "".join(f"<Contents><Key>{k}</Key></Contents>" for k in keys)
                        + "</ListBucketResult>"
                    ).encode()
                    self.send_response(200)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                    return
                data = stub.objects.get((bucket, key))
                if data is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def do_HEAD(self):

                body = _record(stub, self)
                self._check_auth()
                bucket, key, _ = self._bk()
                data = stub.objects.get((bucket, key))
                if data is None:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Length", str(len(data)))
                self.send_header("Last-Modified", "Wed, 01 Jan 2025 00:00:00 GMT")
                self.end_headers()

            def do_DELETE(self):

                body = _record(stub, self)
                self._check_auth()
                bucket, key, _ = self._bk()
                if (bucket, key) in stub.objects:
                    del stub.objects[(bucket, key)]
                    self.send_response(204)
                else:
                    self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.port = self.httpd.server_address[1]
        threading.Thread(target=self.httpd.serve_forever, daemon=True).start()

    def stop(self):
        self.httpd.shutdown()


# ---------------------------------------------------------------------------
# both packages against one stub
# ---------------------------------------------------------------------------


def _clear(stub) -> None:
    """Back to an empty store with an empty log (WebHDFS keeps its root)."""
    for name in ("files", "objects"):
        if hasattr(stub, name):
            getattr(stub, name).clear()
    if hasattr(stub, "dirs"):
        stub.dirs.clear()
        if isinstance(stub, _HdfsStub):
            stub.dirs.add("/")
    stub.log.clear()


def _run_both(stub, make_fs, exercise):
    """exercise(fs, pkg) for each package against `stub`, cleared before
    each: the answers and the request logs must be equal."""
    out = {}
    for pkg in PKGS:
        _clear(stub)
        result = exercise(make_fs(pkg), pkg)
        out[pkg.name] = (result, list(stub.log))
    assert out["port"][0] == out["ref"][0]
    assert len(out["port"][1]) == len(out["ref"][1])
    for i, (p, r) in enumerate(zip(out["port"][1], out["ref"][1])):
        assert p == r, (i, p, r)
    return out["port"]


@pytest.fixture()
def adls():
    stub = _AdlsStub()
    yield stub, lambda pkg: pkg.adls.AdlsGen2FS(endpoint=stub.url, account="testacct", account_key="a2V5a2V5")
    stub.stop()


@pytest.fixture(params=[False, True], ids=["direct", "redirect"])
def hdfs(request):
    stub = _HdfsStub(redirect_create=request.param)
    yield stub, lambda pkg: pkg.hdfs.WebHdfsFS(endpoint=stub.url)
    stub.stop()


@pytest.fixture()
def s3():
    stub = _S3Stub()
    yield stub, lambda pkg: pkg.s3.S3FS(endpoint=f"http://127.0.0.1:{stub.port}", access_key="test-key",
                                         secret_key="test-secret", region="us-east-1", timeout=5.0)
    stub.stop()


def _contract_exercise(fs, base: str) -> list:
    fs.write_bytes(f"{base}/a/x.bin", b"hello")
    fs.write_bytes(f"{base}/a/y.bin", b"world!")
    files = fs.list_files(f"{base}/a")
    out = [fs.exists(f"{base}/a/x.bin"), fs.exists(f"{base}/a/zzz.bin"), fs.read_bytes(f"{base}/a/y.bin"),
           fs.length(f"{base}/a/y.bin"), fs.last_modified(f"{base}/a/x.bin"), files,
           fs.is_directory(f"{base}/a"), fs.is_directory(f"{base}/a/x.bin"),
           fs.move(f"{base}/a/x.bin", f"{base}/b/x2.bin"), fs.exists(f"{base}/a/x.bin"),
           fs.read_bytes(f"{base}/b/x2.bin"), fs.copy(f"{base}/b/x2.bin", f"{base}/c/x3.bin"),
           fs.read_bytes(f"{base}/c/x3.bin"), fs.delete(f"{base}/c/x3.bin", force=True),
           fs.exists(f"{base}/c/x3.bin")]
    assert any(f.endswith("x.bin") for f in files) and any(f.endswith("y.bin") for f in files)
    return out


def _segment_roundtrip(fs, base: str, tmp_path) -> tuple:
    src = tmp_path / "seg"
    (src / "sub").mkdir(parents=True, exist_ok=True)
    (src / "meta.json").write_bytes(b'{"n": 1}')
    (src / "sub" / "data.npz").write_bytes(b"\x00" * 128)
    fs.copy_from_local(src, f"{base}/segments/seg1")
    dst = tmp_path / "back"
    fs.copy_to_local(f"{base}/segments/seg1", dst)
    return fs.exists(f"{base}/segments/seg1/meta.json"), (dst / "meta.json").read_bytes(), \
        (dst / "sub" / "data.npz").read_bytes()


# -- ADLS Gen2 and WebHDFS (tests/test_cloud_fs.py) ---------------------------


def test_adls_contract(adls):
    stub, make = adls
    result, log = _run_both(stub, make, lambda fs, pkg: _contract_exercise(fs, "abfs://deepstore"))
    assert result[0] is True and result[1] is False and result[-1] is False
    assert stub.auth_failures == []  # every request carried a SharedKey header
    assert any(h[0] == "Authorization" and h[1].startswith("SharedKey testacct:") for h in log[0][2])


def test_adls_segment_roundtrip(adls, tmp_path):
    stub, make = adls
    result, _ = _run_both(stub, make, lambda fs, pkg: _segment_roundtrip(fs, "abfs://deepstore", tmp_path / pkg.name))
    assert result == (True, b'{"n": 1}', b"\x00" * 128)


def test_hdfs_contract(hdfs):
    stub, make = hdfs
    result, log = _run_both(stub, make, lambda fs, pkg: _contract_exercise(fs, "hdfs://nn1/data"))
    assert result[0] is True and result[4] == 1735689600.0
    assert any("datanode=1" in r[1] for r in log) == stub.redirect_create


def test_hdfs_segment_roundtrip(hdfs, tmp_path):
    stub, make = hdfs
    result, _ = _run_both(stub, make, lambda fs, pkg: _segment_roundtrip(fs, "hdfs://nn1/data", tmp_path / pkg.name))
    assert result == (True, b'{"n": 1}', b"\x00" * 128)


def test_adls_copy_directory_with_subdir(adls):
    """Directory copy skips subdirectory entries."""
    stub, make = adls

    def run(fs, pkg):
        fs.mkdir("abfs://deepstore/src/sub")
        fs.write_bytes("abfs://deepstore/src/top.bin", b"t")
        fs.write_bytes("abfs://deepstore/src/sub/deep.bin", b"d")
        return (fs.copy("abfs://deepstore/src", "abfs://deepstore/dst"),
                fs.read_bytes("abfs://deepstore/dst/top.bin"), fs.read_bytes("abfs://deepstore/dst/sub/deep.bin"))

    assert _run_both(stub, make, run)[0] == (True, b"t", b"d")


def test_adls_container_root_copy_to_local(adls, tmp_path):
    """copy_to_local from the bare container root keeps full path names."""
    stub, make = adls

    def run(fs, pkg):
        fs.write_bytes("abfs://deepstore/rootfile.bin", b"r")
        fs.write_bytes("abfs://deepstore/d/nested.bin", b"n")
        dst = tmp_path / pkg.name
        fs.copy_to_local("abfs://deepstore", dst)
        return (dst / "rootfile.bin").read_bytes(), (dst / "d" / "nested.bin").read_bytes()

    assert _run_both(stub, make, run)[0] == (b"r", b"n")


def test_regexpreplace_java_group_refs():
    """tests/test_cloud_fs.py's REGEXP_REPLACE case: $N group references,
    $N followed by a digit, and $0 as the whole match."""
    cases = [(["ab"], ("(a)(b)", "$2$1")), (["ab"], ("(a)(b)", "$12")), (["a"], ("(a)", "$0x"))]
    got = {name: [fn("regexpreplace", np.asarray(v, dtype=object), a)[0].tolist() for v, a in cases]
           for name, fn in (("ref", r_apply), ("port", p_apply))}
    assert got["port"] == got["ref"] == [["ba"], ["a2"], ["ax"]]


def test_hdfs_cross_namenode_move_rejected(hdfs):
    stub, make = hdfs

    def run(fs, pkg):
        fs.write_bytes("hdfs://nn1/data/f.bin", b"x")
        with pytest.raises(ValueError) as ei:
            fs.move("hdfs://nn1/data/f.bin", "hdfs://nn2/data/f.bin")
        return str(ei.value)

    assert "cross-namenode" in _run_both(stub, make, run)[0]


def test_adls_move_missing_source_returns_false(adls):
    stub, make = adls
    assert _run_both(stub, make, lambda fs, pkg: fs.move("abfs://deepstore/missing.bin", "abfs://deepstore/dst.bin"))[0] is False


def test_scheme_registry(adls, hdfs, monkeypatch):
    """Registered plugins resolve by scheme; unregistered abfs / hdfs URIs
    resolve lazily to each package's plugin, configured from the
    environment."""
    (a_stub, a_make), (h_stub, h_make) = adls, hdfs
    monkeypatch.setenv("ADLS_ENDPOINT", a_stub.url)
    monkeypatch.setenv("ADLS_ACCOUNT", "envacct")
    monkeypatch.setenv("HDFS_ENDPOINT", h_stub.url)
    out = {}
    for pkg in PKGS:
        for s in ("abfs", "abfss", "adl", "hdfs"):
            monkeypatch.delitem(pkg.fs._registry, s, raising=False)
        lazy = (pkg.fs.get_fs("abfss://deepstore/x"), pkg.fs.get_fs("adl://deepstore/x"), pkg.fs.get_fs("hdfs://nn1/x"))
        a_fs, h_fs = a_make(pkg), h_make(pkg)
        pkg.fs.register_fs("abfs", a_fs)
        pkg.fs.register_fs("hdfs", h_fs)
        out[pkg.name] = ([type(f).__name__ for f in lazy], lazy[0] is lazy[1], lazy[0].endpoint, lazy[0].account,
                         lazy[2].endpoint, pkg.fs.get_fs("abfs://deepstore/x") is a_fs,
                         pkg.fs.get_fs("hdfs://nn1/x") is h_fs)
        for s in ("abfs", "abfss", "adl", "hdfs"):
            pkg.fs._registry.pop(s, None)
    assert out["port"] == out["ref"]
    assert out["port"][0] == ["AdlsGen2FS", "AdlsGen2FS", "WebHdfsFS"] and out["port"][-2:] == (True, True)


# -- S3 (tests/test_s3fs.py) --------------------------------------------------


def test_object_roundtrip(s3):
    stub, make = s3

    def run(fs, pkg):
        fs.write_bytes("s3://bkt/a/b.bin", b"hello world")
        return (fs.exists("s3://bkt/a/b.bin"), fs.read_bytes("s3://bkt/a/b.bin"), fs.length("s3://bkt/a/b.bin"),
                fs.last_modified("s3://bkt/a/b.bin"), fs.exists("s3://bkt/none"))

    result, log = _run_both(stub, make, run)
    assert result == (True, b"hello world", 11, 1735689600.0, False)
    assert not stub.auth_failures, stub.auth_failures
    auth = dict(log[0][2])["Authorization"]
    assert auth.startswith("AWS4-HMAC-SHA256 Credential=test-key/20240517/us-east-1/s3/aws4_request")


def test_list_copy_move_delete(s3):
    stub, make = s3

    def run(fs, pkg):
        for i in range(3):
            fs.write_bytes(f"s3://bkt/dir/f{i}", bytes([i]))
        fs.write_bytes("s3://bkt/dir/sub/deep", b"x")
        return (fs.is_directory("s3://bkt/dir"), fs.list_files("s3://bkt/dir"),
                fs.list_files("s3://bkt/dir", recursive=True), fs.copy("s3://bkt/dir/f0", "s3://bkt/copy0"),
                fs.read_bytes("s3://bkt/copy0"), fs.move("s3://bkt/dir", "s3://bkt/moved"),
                fs.exists("s3://bkt/dir/f1"), fs.read_bytes("s3://bkt/moved/f1"),
                fs.delete("s3://bkt/moved"), fs.delete("s3://bkt/moved", force=True), fs.exists("s3://bkt/moved"))

    result, _ = _run_both(stub, make, run)
    assert result[1] == ["s3://bkt/dir/f0", "s3://bkt/dir/f1", "s3://bkt/dir/f2"] and len(result[2]) == 4
    assert result[-3:] == (False, True, False)


def test_segment_deep_store_roundtrip(s3, tmp_path):
    """Push a real segment directory to s3://, download it elsewhere, load
    it and query: the deep-store flow over the object store. Both packages
    write the same segment files, so the PUTs are the same bytes."""
    stub, make = s3
    rng = np.random.default_rng(4)
    data = {
        "k": np.asarray([f"k{i % 5}" for i in range(1000)], dtype=object),
        "v": rng.integers(0, 100, 1000).astype(np.int64),
    }
    mods = {"ref": (r_common, r_segment, lambda s: r_query.QueryEngine(s)),
            "port": (p_common, p_segment, lambda s: p_query.QueryEngine(s, device="cpu"))}

    def run(fs, pkg):
        common, segment, engine = mods[pkg.name]
        dt = common.DataType
        schema = common.Schema.build("t", dimensions=[("k", dt.STRING)], metrics=[("v", dt.LONG)])
        seg_dir = segment.write_segment(segment.SegmentBuilder(schema).build(data, "s0"), tmp_path / pkg.name / "out")
        fs.copy_from_local(seg_dir, "s3://deepstore/t/s0")
        local = tmp_path / pkg.name / "downloaded"
        fs.copy_to_local("s3://deepstore/t/s0", local)
        return engine([segment.load_segment(local)]).execute("SELECT SUM(v) FROM t WHERE k = 'k2'").rows

    result, log = _run_both(stub, make, run)
    assert result == [[float(data["v"][data["k"] == "k2"].sum())]]
    assert any(r[0] == "PUT" and r[3] for r in log)


def test_get_fs_resolves_s3_scheme(monkeypatch):
    monkeypatch.setenv("S3_ENDPOINT", "http://127.0.0.1:1")
    monkeypatch.setenv("AWS_REGION", "eu-west-1")
    out = {}
    for pkg in PKGS:
        monkeypatch.delitem(pkg.fs._registry, "s3", raising=False)
        got = pkg.fs.get_fs("s3://bucket/key")
        out[pkg.name] = (type(got).__name__, got.endpoint, got.region, pkg.fs.get_fs("s3://other/x") is got)
        pkg.fs._registry.pop("s3", None)
    assert out["port"] == out["ref"] == ("S3FS", "http://127.0.0.1:1", "eu-west-1", True)


def test_gs_scheme_rides_s3_plugin(s3, monkeypatch):
    """gs:// resolves to the S3 plugin against the GCS-interop endpoint."""
    stub, _ = s3
    monkeypatch.setenv("GCS_ENDPOINT", f"http://127.0.0.1:{stub.port}")

    def make(pkg):
        monkeypatch.delitem(pkg.fs._registry, "gs", raising=False)
        return pkg.fs.get_fs("gs://bkt/obj")

    def run(fs, pkg):
        fs.write_bytes("gs://bkt/a/b", b"gcs")
        out = (type(fs).__name__, fs.read_bytes("gs://bkt/a/b"), fs.list_files("gs://bkt/a"))
        pkg.fs._registry.pop("gs", None)
        return out

    assert _run_both(stub, make, run)[0] == ("S3FS", b"gcs", ["gs://bkt/a/b"])
