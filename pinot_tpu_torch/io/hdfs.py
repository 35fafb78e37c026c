"""HDFS PinotFS plugin over the WebHDFS REST API — stdlib HTTP, no SDK.

Reference parity: HadoopPinotFS (pinot-plugins/pinot-file-system/
pinot-hdfs/.../HadoopPinotFS.java) implementing the PinotFS contract over
HDFS. URIs are `hdfs://namenode[:port]/path`; requests go to the WebHDFS
endpoint (`http://{namenode}:{http_port}/webhdfs/v1{path}?op=...`). The
in-process stub in tests/test_torch_cloud_fs.py is the tests' conformance
target; the wire surface is the documented WebHDFS ops: MKDIRS,
CREATE (with optional 307 redirect to a datanode, followed transparently),
OPEN, GETFILESTATUS, LISTSTATUS, DELETE, RENAME.

Config via constructor or env: HDFS_ENDPOINT (full `http://host:port`
override for every namenode, e.g. the stub), HDFS_HTTP_PORT (default 9870),
HDFS_USER (user.name query param).
"""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.parse
import urllib.request

from pinot_tpu_torch.io.fs import PinotFS


def _uri_path(uri: str) -> tuple[str, str]:
    p = urllib.parse.urlparse(uri)
    if p.scheme != "hdfs":
        raise ValueError(f"not an hdfs uri: {uri}")
    return p.netloc, p.path or "/"


class WebHdfsFS(PinotFS):
    """PinotFS over WebHDFS (the HTTP face of the reference's HadoopPinotFS)."""

    def __init__(
        self,
        endpoint: str | None = None,
        user: str | None = None,
        http_port: int | None = None,
        timeout: float = 30.0,
    ):
        self.endpoint = (endpoint or os.environ.get("HDFS_ENDPOINT") or "").rstrip("/")
        self.http_port = int(http_port or os.environ.get("HDFS_HTTP_PORT", "9870"))
        self.user = user or os.environ.get("HDFS_USER", "pinot")
        self.timeout = timeout

    def _base(self, netloc: str) -> str:
        if self.endpoint:
            return self.endpoint
        host = netloc.split(":")[0] if netloc else "localhost"
        return f"http://{host}:{self.http_port}"

    def _request(self, method: str, uri: str, op: str, query: dict | None = None, payload: bytes | None = None):
        netloc, path = _uri_path(uri)
        q = {"op": op, "user.name": self.user}
        q.update(query or {})
        qs = urllib.parse.urlencode(sorted(q.items()))
        url = self._base(netloc) + "/webhdfs/v1" + urllib.parse.quote(path, safe="/") + "?" + qs
        req = urllib.request.Request(url, data=payload, method=method)
        try:
            return urllib.request.urlopen(req, timeout=self.timeout)
        except urllib.error.HTTPError as e:
            if e.code == 307 and payload is not None:
                # two-step CREATE/APPEND: follow the datanode redirect
                loc = e.headers.get("Location")
                req2 = urllib.request.Request(loc, data=payload, method=method)
                return urllib.request.urlopen(req2, timeout=self.timeout)
            raise

    def _status(self, uri: str) -> dict | None:
        try:
            with self._request("GET", uri, "GETFILESTATUS") as r:
                return json.loads(r.read())["FileStatus"]
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return None
            raise

    # -- PinotFS contract ------------------------------------------------------

    def mkdir(self, uri: str) -> None:
        with self._request("PUT", uri, "MKDIRS"):
            pass

    def write_bytes(self, uri: str, data: bytes) -> None:
        with self._request("PUT", uri, "CREATE", {"overwrite": "true"}, payload=data):
            pass

    def read_bytes(self, uri: str) -> bytes:
        with self._request("GET", uri, "OPEN") as r:
            return r.read()

    def exists(self, uri: str) -> bool:
        return self._status(uri) is not None

    def length(self, uri: str) -> int:
        st = self._status(uri)
        if st is None:
            raise FileNotFoundError(uri)
        return int(st.get("length", 0))

    def last_modified(self, uri: str) -> float:
        st = self._status(uri)
        if st is None:
            raise FileNotFoundError(uri)
        return float(st.get("modificationTime", 0)) / 1000.0

    def is_directory(self, uri: str) -> bool:
        st = self._status(uri)
        return st is not None and st.get("type") == "DIRECTORY"

    def delete(self, uri: str, force: bool = False) -> bool:
        if self.is_directory(uri) and not force and self.list_files(uri):
            return False
        with self._request("DELETE", uri, "DELETE", {"recursive": "true"}) as r:
            return bool(json.loads(r.read()).get("boolean", False))

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        if not overwrite and self.exists(dst):
            return False
        s_netloc, _spath = _uri_path(src)
        d_netloc, dpath = _uri_path(dst)
        if s_netloc and d_netloc and s_netloc != d_netloc:
            # WebHDFS RENAME is path-only within one namenode; a silent
            # same-cluster rename would misreport a cross-cluster move
            raise ValueError(f"cross-namenode move not supported: {src} -> {dst}")
        with self._request("PUT", src, "RENAME", {"destination": dpath}) as r:
            return bool(json.loads(r.read()).get("boolean", False))

    # copy/copy_to_local/copy_from_local: directory-aware PinotFS defaults

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        return [f for f, _ in self.list_entries(uri, recursive)]

    def list_entries(self, uri: str, recursive: bool = False) -> list[tuple[str, bool]]:
        netloc, path = _uri_path(uri)
        try:
            with self._request("GET", uri, "LISTSTATUS") as r:
                statuses = json.loads(r.read())["FileStatuses"]["FileStatus"]
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return []
            raise
        out: list[tuple[str, bool]] = []
        prefix = f"hdfs://{netloc}" if netloc else "hdfs://"
        for st in statuses:
            child = prefix + path.rstrip("/") + "/" + st["pathSuffix"]
            is_dir = st.get("type") == "DIRECTORY"
            out.append((child, is_dir))
            if recursive and is_dir:
                out.extend(self.list_entries(child, recursive=True))
        return sorted(out)
