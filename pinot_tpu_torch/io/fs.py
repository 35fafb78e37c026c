"""Filesystem SPI: pluggable storage behind URI schemes.

Reference parity: PinotFS (pinot-spi/.../filesystem/PinotFS.java) with
LocalPinotFS (pinot-spi/.../filesystem/LocalPinotFS.java:47) and the plugin
registry (pinot-plugins/pinot-file-system/: S3, GCS, ADLS, HDFS). Here:
LocalFS over the OS filesystem, MemFS for tests (and as the template for
object-store plugins). Deep store (segment push targets) and batch-job
inputs resolve through `get_fs(uri)` by scheme; `s3`, `gs`, `abfs` / `abfss`
/ `adl` and `hdfs` resolve to the REST plugins (io/s3.py, io/adls.py,
io/hdfs.py), imported at their first use.

This is the JAX package's `io/fs.py`; nothing in it touches a device.
"""

from __future__ import annotations

import shutil
import threading
from pathlib import Path, PurePosixPath
from urllib.parse import urlparse


class PinotFS:
    """URI-based filesystem contract (PinotFS.java method set)."""

    def mkdir(self, uri: str) -> None:
        raise NotImplementedError

    def delete(self, uri: str, force: bool = False) -> bool:
        raise NotImplementedError

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        raise NotImplementedError

    def exists(self, uri: str) -> bool:
        raise NotImplementedError

    def length(self, uri: str) -> int:
        raise NotImplementedError

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        raise NotImplementedError

    def is_directory(self, uri: str) -> bool:
        raise NotImplementedError

    def last_modified(self, uri: str) -> float:
        raise NotImplementedError

    def read_bytes(self, uri: str) -> bytes:
        raise NotImplementedError

    def write_bytes(self, uri: str, data: bytes) -> None:
        raise NotImplementedError

    def list_entries(self, uri: str, recursive: bool = False) -> list[tuple[str, bool]]:
        """(child uri, is_directory) pairs. Default re-probes each entry;
        plugins whose listing already carries the type (ADLS isDirectory,
        WebHDFS type) override to avoid a round-trip per entry."""
        return [(f, self.is_directory(f)) for f in self.list_files(uri, recursive)]

    # -- directory-aware transfer defaults (shared by the remote plugins;
    # built on the primitives above, so any PinotFS gets them for free) ------

    @staticmethod
    def _rel_path(base_uri: str, child_uri: str) -> str:
        base = urlparse(base_uri).path.strip("/")
        child = urlparse(child_uri).path.lstrip("/")
        return child[len(base) + 1 :] if base else child

    def copy(self, src: str, dst: str) -> bool:
        if self.is_directory(src):
            for f, is_dir in self.list_entries(src, recursive=True):
                if is_dir:
                    continue
                self.write_bytes(dst.rstrip("/") + "/" + self._rel_path(src, f), self.read_bytes(f))
            return True
        self.write_bytes(dst, self.read_bytes(src))
        return True

    def copy_to_local(self, uri: str, local_path: str | Path) -> None:
        if self.is_directory(uri):
            for f, is_dir in self.list_entries(uri, recursive=True):
                if is_dir:
                    continue
                target = Path(local_path) / self._rel_path(uri, f)
                target.parent.mkdir(parents=True, exist_ok=True)
                target.write_bytes(self.read_bytes(f))
            return
        Path(local_path).parent.mkdir(parents=True, exist_ok=True)
        Path(local_path).write_bytes(self.read_bytes(uri))

    def copy_from_local(self, local_path: str | Path, uri: str) -> None:
        local_path = Path(local_path)
        if local_path.is_dir():
            for f in sorted(local_path.rglob("*")):
                if f.is_file():
                    rel = f.relative_to(local_path)
                    self.write_bytes(uri.rstrip("/") + "/" + str(rel), f.read_bytes())
            return
        self.write_bytes(uri, local_path.read_bytes())


def _local_path(uri: str) -> Path:
    p = urlparse(uri)
    if p.scheme in ("", "file"):
        return Path(p.path if p.scheme else uri)
    raise ValueError(f"not a local uri: {uri}")


class LocalFS(PinotFS):
    """LocalPinotFS parity: direct OS filesystem under file:// or bare paths."""

    def mkdir(self, uri: str) -> None:
        _local_path(uri).mkdir(parents=True, exist_ok=True)

    def delete(self, uri: str, force: bool = False) -> bool:
        p = _local_path(uri)
        if not p.exists():
            return False
        if p.is_dir():
            if any(p.iterdir()) and not force:
                return False
            shutil.rmtree(p)
        else:
            p.unlink()
        return True

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        s, d = _local_path(src), _local_path(dst)
        if d.exists():
            if not overwrite:
                return False
            self.delete(dst, force=True)
        d.parent.mkdir(parents=True, exist_ok=True)
        shutil.move(str(s), str(d))
        return True

    def copy(self, src: str, dst: str) -> bool:
        s, d = _local_path(src), _local_path(dst)
        d.parent.mkdir(parents=True, exist_ok=True)
        if s.is_dir():
            shutil.copytree(s, d, dirs_exist_ok=True)
        else:
            shutil.copy2(s, d)
        return True

    def exists(self, uri: str) -> bool:
        return _local_path(uri).exists()

    def length(self, uri: str) -> int:
        return _local_path(uri).stat().st_size

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        p = _local_path(uri)
        it = p.rglob("*") if recursive else p.iterdir()
        return sorted(str(c) for c in it if c.is_file())

    def is_directory(self, uri: str) -> bool:
        return _local_path(uri).is_dir()

    def last_modified(self, uri: str) -> float:
        return _local_path(uri).stat().st_mtime

    def read_bytes(self, uri: str) -> bytes:
        return _local_path(uri).read_bytes()

    def write_bytes(self, uri: str, data: bytes) -> None:
        from pinot_tpu_torch.common.durability import atomic_write_bytes

        p = _local_path(uri)
        p.parent.mkdir(parents=True, exist_ok=True)
        # crash mid-write must leave the previous object or none, never a
        # torn one (object stores give this for free; match it locally)
        atomic_write_bytes(p, data)


class MemFS(PinotFS):
    """In-memory filesystem keyed by posix-normalized paths — the test double
    and the shape an object-store plugin takes (flat key space, directories
    implied by prefixes)."""

    def __init__(self):
        self._files: dict[str, tuple[bytes, float]] = {}
        self._dirs: set[str] = set()
        self._lock = threading.Lock()
        self._clock = 0.0

    @staticmethod
    def _key(uri: str) -> str:
        p = urlparse(uri)
        return str(PurePosixPath("/") / p.netloc / p.path.lstrip("/")) if p.scheme else str(PurePosixPath(uri))

    def mkdir(self, uri: str) -> None:
        with self._lock:
            self._dirs.add(self._key(uri))

    def delete(self, uri: str, force: bool = False) -> bool:
        k = self._key(uri)
        with self._lock:
            if k in self._files:
                del self._files[k]
                return True
            children = [f for f in self._files if f.startswith(k + "/")]
            if k in self._dirs or children:
                if children and not force:
                    return False
                for f in children:
                    del self._files[f]
                self._dirs.discard(k)
                return True
            return False

    def move(self, src: str, dst: str, overwrite: bool = True) -> bool:
        s, d = self._key(src), self._key(dst)
        with self._lock:
            if s in self._files:
                if d in self._files and not overwrite:
                    return False
                self._files[d] = self._files.pop(s)
                return True
            moved = False
            for f in list(self._files):
                if f.startswith(s + "/"):
                    self._files[d + f[len(s):]] = self._files.pop(f)
                    moved = True
            return moved

    def copy(self, src: str, dst: str) -> bool:
        s, d = self._key(src), self._key(dst)
        with self._lock:
            if s in self._files:
                self._files[d] = self._files[s]
                return True
            copied = False
            for f in list(self._files):
                if f.startswith(s + "/"):
                    self._files[d + f[len(s):]] = self._files[f]
                    copied = True
            return copied

    def exists(self, uri: str) -> bool:
        k = self._key(uri)
        with self._lock:
            return k in self._files or k in self._dirs or any(f.startswith(k + "/") for f in self._files)

    def length(self, uri: str) -> int:
        with self._lock:
            return len(self._files[self._key(uri)][0])

    def list_files(self, uri: str, recursive: bool = False) -> list[str]:
        k = self._key(uri)
        with self._lock:
            out = []
            for f in self._files:
                if not f.startswith(k + "/"):
                    continue
                rel = f[len(k) + 1:]
                if recursive or "/" not in rel:
                    out.append(f)
            return sorted(out)

    def is_directory(self, uri: str) -> bool:
        k = self._key(uri)
        with self._lock:
            return k in self._dirs or any(f.startswith(k + "/") for f in self._files)

    def last_modified(self, uri: str) -> float:
        with self._lock:
            return self._files[self._key(uri)][1]

    def read_bytes(self, uri: str) -> bytes:
        with self._lock:
            return self._files[self._key(uri)][0]

    def write_bytes(self, uri: str, data: bytes) -> None:
        with self._lock:
            self._clock += 1
            self._files[self._key(uri)] = (bytes(data), self._clock)


_registry: dict[str, PinotFS] = {}
_registry_lock = threading.Lock()


def register_fs(scheme: str, fs: PinotFS) -> None:
    """Plugin registration (PinotFSFactory.register parity)."""
    with _registry_lock:
        _registry[scheme] = fs


def get_fs(uri: str) -> PinotFS:
    scheme = urlparse(uri).scheme or "file"
    with _registry_lock:
        fs = _registry.get(scheme)
    if fs is None:
        if scheme == "file":
            fs = LocalFS()
            register_fs("file", fs)
        elif scheme == "mem":
            fs = MemFS()
            register_fs("mem", fs)
        elif scheme == "s3":
            from pinot_tpu_torch.io.s3 import S3FS

            fs = S3FS()  # endpoint/credentials from env (S3_ENDPOINT, AWS_*)
            register_fs("s3", fs)
        elif scheme == "gs":
            # GCS serves the S3-compatible XML API (interoperability mode):
            # the S3 plugin against storage.googleapis.com with HMAC keys
            # (GCS_ENDPOINT / AWS_ACCESS_KEY_ID overrideable via env)
            import os

            from pinot_tpu_torch.io.s3 import S3FS

            fs = S3FS(endpoint=os.environ.get("GCS_ENDPOINT", "https://storage.googleapis.com"))
            register_fs("gs", fs)
        elif scheme in ("abfs", "abfss", "adl"):
            from pinot_tpu_torch.io.adls import AdlsGen2FS

            fs = AdlsGen2FS()  # endpoint/key from env (ADLS_ENDPOINT, ADLS_*)
            for s in ("abfs", "abfss", "adl"):
                register_fs(s, fs)
        elif scheme == "hdfs":
            from pinot_tpu_torch.io.hdfs import WebHdfsFS

            fs = WebHdfsFS()  # endpoint from env (HDFS_ENDPOINT / HDFS_HTTP_PORT)
            register_fs("hdfs", fs)
        else:
            raise ValueError(
                f"no PinotFS registered for scheme {scheme!r}; register via register_fs"
            )
    return fs
