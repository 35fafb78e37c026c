"""S3 PinotFS plugin: the real S3 REST protocol over stdlib HTTP with AWS
Signature V4 signing — no SDK dependency.

Reference parity: S3PinotFS (pinot-plugins/pinot-file-system/pinot-s3/.../
S3PinotFS.java) implementing the PinotFS contract over an object store.
URIs are `s3://bucket/key/...`. Path-style addressing
(`{endpoint}/{bucket}/{key}`) so it works against any S3-compatible endpoint
(AWS, MinIO, or the in-process stub in tests/test_torch_cloud_fs.py, the
conformance target of the tests).

Config via constructor or env: S3_ENDPOINT (default AWS regional endpoint),
AWS_ACCESS_KEY_ID, AWS_SECRET_ACCESS_KEY, AWS_REGION.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import os
import urllib.error
import urllib.parse
import urllib.request
import xml.etree.ElementTree as ET
from pathlib import Path

from pinot_tpu_torch.io.fs import PinotFS


def _uri_parts(uri: str) -> tuple[str, str]:
    p = urllib.parse.urlparse(uri)
    if p.scheme not in ("s3", "gs"):
        # gs:// rides the same plugin via GCS's S3-compatible XML API
        raise ValueError(f"not an s3/gs uri: {uri}")
    return p.netloc, p.path.lstrip("/")


def _uri_scheme(uri: str) -> str:
    return urllib.parse.urlparse(uri).scheme or "s3"


class S3FS(PinotFS):
    """PinotFS over the S3 REST API (GET/PUT/DELETE/HEAD/ListObjectsV2)."""

    def __init__(
        self,
        endpoint: str | None = None,
        access_key: str | None = None,
        secret_key: str | None = None,
        region: str | None = None,
        timeout: float = 30.0,
    ):
        self.region = region or os.environ.get("AWS_REGION", "us-east-1")
        self.endpoint = (
            endpoint
            or os.environ.get("S3_ENDPOINT")
            or f"https://s3.{self.region}.amazonaws.com"
        ).rstrip("/")
        self.access_key = access_key or os.environ.get("AWS_ACCESS_KEY_ID", "")
        self.secret_key = secret_key or os.environ.get("AWS_SECRET_ACCESS_KEY", "")
        self.timeout = timeout

    # -- SigV4 ----------------------------------------------------------------

    def _sign(self, method: str, path: str, query: dict, payload: bytes) -> dict:
        """AWS Signature Version 4 headers for one request."""
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        host = urllib.parse.urlparse(self.endpoint).netloc
        payload_hash = hashlib.sha256(payload).hexdigest()

        canonical_query = "&".join(
            f"{urllib.parse.quote(k, safe='')}={urllib.parse.quote(str(v), safe='')}"
            for k, v in sorted(query.items())
        )
        headers = {
            "host": host,
            "x-amz-content-sha256": payload_hash,
            "x-amz-date": amz_date,
        }
        signed_headers = ";".join(sorted(headers))
        canonical_headers = "".join(f"{k}:{headers[k]}\n" for k in sorted(headers))
        canonical_request = "\n".join(
            [
                method,
                urllib.parse.quote(path, safe="/"),
                canonical_query,
                canonical_headers,
                signed_headers,
                payload_hash,
            ]
        )
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join(
            [
                "AWS4-HMAC-SHA256",
                amz_date,
                scope,
                hashlib.sha256(canonical_request.encode()).hexdigest(),
            ]
        )

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(("AWS4" + self.secret_key).encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        return {
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={signature}"
            ),
        }

    def _request(
        self,
        method: str,
        bucket: str,
        key: str = "",
        query: dict | None = None,
        payload: bytes = b"",
        extra_headers: dict | None = None,
    ):
        query = query or {}
        path = f"/{bucket}/{key}" if key else f"/{bucket}"
        headers = self._sign(method, path, query, payload)
        if extra_headers:
            headers.update(extra_headers)
        qs = urllib.parse.urlencode(sorted(query.items()))
        url = self.endpoint + urllib.parse.quote(path, safe="/") + (f"?{qs}" if qs else "")
        req = urllib.request.Request(url, data=payload if method in ("PUT", "POST") else None,
                                     headers=headers, method=method)
        return urllib.request.urlopen(req, timeout=self.timeout)

    # -- PinotFS contract ------------------------------------------------------

    def mkdir(self, uri: str) -> None:
        pass  # object stores have no directories

    def write_bytes(self, uri: str, data: bytes) -> None:
        bucket, key = _uri_parts(uri)
        with self._request("PUT", bucket, key, payload=data):
            pass

    def read_bytes(self, uri: str) -> bytes:
        bucket, key = _uri_parts(uri)
        with self._request("GET", bucket, key) as r:
            return r.read()

    def exists(self, uri: str) -> bool:
        bucket, key = _uri_parts(uri)
        try:
            with self._request("HEAD", bucket, key):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return bool(self._list_keys(bucket, key.rstrip("/") + "/", max_keys=1))
            raise

    def length(self, uri: str) -> int:
        bucket, key = _uri_parts(uri)
        with self._request("HEAD", bucket, key) as r:
            return int(r.headers.get("Content-Length", 0))

    def last_modified(self, uri: str) -> float:
        from email.utils import parsedate_to_datetime

        bucket, key = _uri_parts(uri)
        with self._request("HEAD", bucket, key) as r:
            lm = r.headers.get("Last-Modified")
            return parsedate_to_datetime(lm).timestamp() if lm else 0.0

    def delete(self, uri: str, force: bool = False) -> bool:
        bucket, key = _uri_parts(uri)
        children = self._list_keys(bucket, key.rstrip("/") + "/")
        if children:
            if not force:
                return False
            for child in children:
                with self._request("DELETE", bucket, child):
                    pass
            return True
        try:
            with self._request("DELETE", bucket, key):
                return True
        except urllib.error.HTTPError as e:
            if e.code == 404:
                return False
            raise

    def copy(self, src: str, dst: str) -> bool:
        sb, sk = _uri_parts(src)
        db, dk = _uri_parts(dst)
        src_keys = self._list_keys(sb, sk.rstrip("/") + "/")
        pairs = (
            [(k, dk.rstrip("/") + k[len(sk.rstrip("/")):]) for k in src_keys]
            if src_keys
            else [(sk, dk)]
        )
        for s_key, d_key in pairs:
            with self._request(
                "PUT", db, d_key, extra_headers={"x-amz-copy-source": f"/{sb}/{s_key}"}
            ):
                pass
        return True

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        if not overwrite and self.exists(dst):
            return False
        self.copy(src, dst)
        self.delete(src, force=True)
        return True

    def is_directory(self, uri: str) -> bool:
        bucket, key = _uri_parts(uri)
        if not key:
            return True
        return bool(self._list_keys(bucket, key.rstrip("/") + "/", max_keys=1))

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        bucket, key = _uri_parts(uri)
        scheme = _uri_scheme(uri)
        prefix = key.rstrip("/") + "/" if key else ""
        keys = self._list_keys(bucket, prefix)
        out = []
        for k in keys:
            rel = k[len(prefix):]
            if recursive or "/" not in rel:
                out.append(f"{scheme}://{bucket}/{k}")
        return sorted(out)

    def _list_keys(self, bucket: str, prefix: str, max_keys: int | None = None) -> list[str]:
        """ListObjectsV2 with continuation. max_keys caps the TOTAL (None =
        unbounded); the page size stays 1000 regardless, so large prefixes
        never silently truncate."""
        keys: list[str] = []
        token = None
        while True:
            query = {"list-type": "2", "prefix": prefix, "max-keys": "1000"}
            if token:
                query["continuation-token"] = token
            with self._request("GET", bucket, query=query) as r:
                root = ET.fromstring(r.read())
            ns = ""
            if root.tag.startswith("{"):
                ns = root.tag.split("}")[0] + "}"
            keys.extend(e.text for e in root.iter(f"{ns}Key"))
            if max_keys is not None and len(keys) >= max_keys:
                return keys[:max_keys]
            token_el = root.find(f"{ns}NextContinuationToken")
            if token_el is None or not token_el.text:
                return keys
            token = token_el.text

    # directory-aware local transfer (segment dirs are multi-file)

    def copy_to_local(self, uri: str, local_path: str | Path) -> None:
        bucket, key = _uri_parts(uri)
        children = self._list_keys(bucket, key.rstrip("/") + "/")
        if not children:
            super().copy_to_local(uri, local_path)
            return
        base = key.rstrip("/")
        scheme = _uri_scheme(uri)
        for child in children:
            dst = Path(local_path) / child[len(base) + 1 :]
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_bytes(self.read_bytes(f"{scheme}://{bucket}/{child}"))

    def list_entries(self, uri: str, recursive: bool = False) -> list[tuple[str, bool]]:
        # object stores list objects only — never directories
        return [(f, False) for f in self.list_files(uri, recursive)]

    # copy_from_local: the directory-aware PinotFS default
