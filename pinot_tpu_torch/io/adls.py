"""Azure Data Lake Storage Gen2 PinotFS plugin: the real ADLS Gen2 (dfs)
REST protocol over stdlib HTTP with Azure Shared Key signing — no SDK.

Reference parity: ADLSGen2PinotFS (pinot-plugins/pinot-file-system/
pinot-adls/.../ADLSGen2PinotFS.java) implementing the PinotFS contract over
a hierarchical-namespace store. URIs are `abfs://filesystem/path/...`
(filesystem = container). The in-process stub in
tests/test_torch_cloud_fs.py is the tests' conformance target; the wire surface is the
documented dfs API: create (PUT ?resource=file|directory), append/flush
(PATCH ?action=append|flush), read (GET), getProperties (HEAD), delete
(DELETE ?recursive=), list (GET /{fs}?resource=filesystem&directory=...),
rename (PUT with x-ms-rename-source).

Config via constructor or env: ADLS_ENDPOINT (e.g. the stub's URL, or
`https://{account}.dfs.core.windows.net`), ADLS_ACCOUNT, ADLS_ACCOUNT_KEY
(base64, Shared Key auth).
"""

from __future__ import annotations

import base64
import datetime
import hashlib
import hmac
import json
import os
import urllib.error
import urllib.parse
import urllib.request

from pinot_tpu_torch.io.fs import PinotFS


def _uri_parts(uri: str) -> tuple[str, str]:
    p = urllib.parse.urlparse(uri)
    if p.scheme not in ("abfs", "abfss", "adl"):
        raise ValueError(f"not an abfs uri: {uri}")
    return p.netloc, p.path.lstrip("/")


class AdlsGen2FS(PinotFS):
    """PinotFS over the ADLS Gen2 dfs REST API with Shared Key auth."""

    def __init__(
        self,
        endpoint: str | None = None,
        account: str | None = None,
        account_key: str | None = None,
        timeout: float = 30.0,
    ):
        self.account = account or os.environ.get("ADLS_ACCOUNT", "devaccount")
        self.endpoint = (
            endpoint
            or os.environ.get("ADLS_ENDPOINT")
            or f"https://{self.account}.dfs.core.windows.net"
        ).rstrip("/")
        self.account_key = account_key or os.environ.get("ADLS_ACCOUNT_KEY", "")
        self.timeout = timeout

    # -- Shared Key signing ---------------------------------------------------

    def _sign(self, method: str, path: str, query: dict, headers: dict, length: int) -> str:
        """Azure Storage Shared Key: HMAC-SHA256 over the canonicalized
        request with the base64-decoded account key."""
        canon_headers = "".join(
            f"{k}:{headers[k]}\n" for k in sorted(h for h in headers if h.startswith("x-ms-"))
        )
        canon_resource = f"/{self.account}{path}"
        for k in sorted(query):
            canon_resource += f"\n{k.lower()}:{query[k]}"
        string_to_sign = "\n".join(
            [
                method,
                "",  # Content-Encoding
                "",  # Content-Language
                str(length) if length else "",
                "",  # Content-MD5
                headers.get("content-type", ""),
                "",  # Date (x-ms-date used instead)
                "",  # If-Modified-Since
                "",  # If-Match
                "",  # If-None-Match
                "",  # If-Unmodified-Since
                "",  # Range
                canon_headers + canon_resource,
            ]
        )
        key = base64.b64decode(self.account_key) if self.account_key else b""
        sig = base64.b64encode(
            hmac.new(key, string_to_sign.encode("utf-8"), hashlib.sha256).digest()
        ).decode()
        return f"SharedKey {self.account}:{sig}"

    def _request(
        self,
        method: str,
        path: str,
        query: dict | None = None,
        payload: bytes = b"",
        extra_headers: dict | None = None,
    ):
        query = dict(query or {})
        headers = {
            "x-ms-date": datetime.datetime.now(datetime.timezone.utc).strftime(
                "%a, %d %b %Y %H:%M:%S GMT"
            ),
            "x-ms-version": "2023-11-03",
        }
        if extra_headers:
            headers.update(extra_headers)
        # sign the SAME path string the URL carries: Azure recomputes the
        # signature from the percent-encoded request path
        quoted = urllib.parse.quote(path, safe="/")
        headers["Authorization"] = self._sign(method, quoted, query, headers, len(payload))
        qs = urllib.parse.urlencode(sorted(query.items()))
        url = self.endpoint + quoted + (f"?{qs}" if qs else "")
        req = urllib.request.Request(
            url,
            data=payload if method in ("PUT", "POST", "PATCH") else None,
            headers=headers,
            method=method,
        )
        return urllib.request.urlopen(req, timeout=self.timeout)

    # -- PinotFS contract ------------------------------------------------------

    def mkdir(self, uri: str) -> None:
        fs, path = _uri_parts(uri)
        with self._request("PUT", f"/{fs}/{path}", {"resource": "directory"}):
            pass

    def write_bytes(self, uri: str, data: bytes) -> None:
        fs, path = _uri_parts(uri)
        with self._request("PUT", f"/{fs}/{path}", {"resource": "file"}):
            pass
        if data:
            with self._request(
                "PATCH", f"/{fs}/{path}", {"action": "append", "position": "0"}, payload=data
            ):
                pass
        with self._request(
            "PATCH", f"/{fs}/{path}", {"action": "flush", "position": str(len(data))}
        ):
            pass

    def read_bytes(self, uri: str) -> bytes:
        fs, path = _uri_parts(uri)
        with self._request("GET", f"/{fs}/{path}") as r:
            return r.read()

    def _props(self, uri: str):
        fs, path = _uri_parts(uri)
        return self._request("HEAD", f"/{fs}/{path}")

    def exists(self, uri: str) -> bool:
        try:
            with self._props(uri):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def length(self, uri: str) -> int:
        with self._props(uri) as r:
            return int(r.headers.get("Content-Length", 0))

    def last_modified(self, uri: str) -> float:
        from email.utils import parsedate_to_datetime

        with self._props(uri) as r:
            lm = r.headers.get("Last-Modified")
            return parsedate_to_datetime(lm).timestamp() if lm else 0.0

    def is_directory(self, uri: str) -> bool:
        if not _uri_parts(uri)[1]:
            return True  # bare container root
        try:
            with self._props(uri) as r:
                return r.headers.get("x-ms-resource-type", "file") == "directory"
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def delete(self, uri: str, force: bool = False) -> bool:
        fs, path = _uri_parts(uri)
        if self.is_directory(uri) and not force:
            if self.list_files(uri):
                return False
        try:
            with self._request("DELETE", f"/{fs}/{path}", {"recursive": "true"}):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        if not overwrite and self.exists(dst):
            return False
        sfs, spath = _uri_parts(src)
        dfs, dpath = _uri_parts(dst)
        try:
            with self._request(
                "PUT",
                f"/{dfs}/{dpath}",
                {"mode": "legacy"},
                extra_headers={"x-ms-rename-source": f"/{sfs}/{spath}"},
            ):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False  # PinotFS contract: missing source -> False
            raise

    # copy/copy_to_local/copy_from_local: directory-aware PinotFS defaults
    # (the dfs API has no server-side copy; ADLSGen2PinotFS downloads and
    # re-uploads the same way)

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        return [f for f, _ in self.list_entries(uri, recursive)]

    def list_entries(self, uri: str, recursive: bool = False) -> list[tuple[str, bool]]:
        fs, path = _uri_parts(uri)
        scheme = urllib.parse.urlparse(uri).scheme
        base_query = {"resource": "filesystem", "recursive": "true" if recursive else "false"}
        if path:
            base_query["directory"] = path
        entries: list[tuple[str, bool]] = []
        continuation: str | None = None
        while True:  # follow x-ms-continuation (5000-path pages)
            query = dict(base_query)
            if continuation:
                query["continuation"] = continuation
            try:
                with self._request("GET", f"/{fs}", query) as r:
                    doc = json.loads(r.read())
                    continuation = r.headers.get("x-ms-continuation")
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    return []
                raise
            entries.extend(
                (
                    f"{scheme}://{fs}/{p['name']}",
                    str(p.get("isDirectory", "false")).lower() == "true",
                )
                for p in doc.get("paths", [])
            )
            if not continuation:
                break
        return sorted(entries)
