"""Crash-consistent file writes (atomic replace + fsync discipline).

Reference parity: Pinot persists segment files via write-to-temp-then-rename,
so a crashed writer never leaves a half-written file behind. The JAX
package's `common/durability.py`; here the segment file (`segment.ptseg`,
segment/store.py) funnels through `atomic_write_bytes`:

    tmp file in the SAME directory  ->  write + flush + fsync(file)
        ->  os.rename(tmp, path)     ->  fsync(directory)

POSIX rename is atomic within a filesystem, so a reader (or a restart)
observes either the complete old file or the complete new one, never a torn
mix; the directory fsync makes the rename itself durable.

Fault injection: the payload flows through the `storage.write` fault point
before it reaches the tmp file. A `torn`-mode rule simulates SIGKILL at an
arbitrary byte offset: the helper persists exactly the torn prefix to the
TMP file (never the target) and re-raises, which is what a real crash leaves
behind; `bitflip` / `truncate` corrupt the payload in flight; `enospc`
surfaces as a real OSError(ENOSPC) with the tmp file cleaned up.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path

from pinot_tpu_torch.common.faults import FAULTS, TornWriteFault

_counter_lock = threading.Lock()
_counter = 0


def _tmp_path(path: Path) -> Path:
    """Unique sibling tmp name: in `path`'s directory, so the final rename
    never crosses a filesystem boundary, and never ending in a durable
    suffix (`.ptseg`, `.json`) that readers key on."""
    global _counter
    with _counter_lock:
        _counter += 1
        n = _counter
    return path.parent / f".{path.name}.tmp.{os.getpid()}.{n}"


def fsync_dir(directory: Path) -> None:
    """fsync a directory so a just-renamed entry survives power loss."""
    try:
        fd = os.open(str(directory), os.O_RDONLY)
    except OSError:
        return  # platform without directory open semantics
    try:
        os.fsync(fd)
    except OSError:
        pass  # some filesystems reject directory fsync; the rename still landed
    finally:
        os.close(fd)


def atomic_write_bytes(path: Path | str, data: bytes, fsync: bool = True) -> None:
    """Atomically replace `path` with `data`. A crash at any point leaves
    either the old complete file or the new complete file; a torn write can
    only hit the tmp sibling, which readers ignore."""
    path = Path(path)
    tmp = _tmp_path(path)
    try:
        data = FAULTS.maybe_fail("storage.write", data)
    except TornWriteFault as tf:
        # the simulated SIGKILL landed mid-write: persist exactly the torn
        # prefix where a real crash would leave it (the tmp file), then
        # propagate as the process death
        tmp.write_bytes(data[: tf.offset])
        raise
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            if fsync:
                f.flush()
                os.fsync(f.fileno())
        os.rename(tmp, path)
    except BaseException:
        try:
            tmp.unlink()
        except OSError:
            pass
        raise
    if fsync:
        fsync_dir(path.parent)


def atomic_write_text(path: Path | str, text: str, fsync: bool = True) -> None:
    atomic_write_bytes(path, text.encode("utf-8"), fsync=fsync)


def atomic_write_json(path: Path | str, doc, fsync: bool = True, **dumps_kw) -> None:
    atomic_write_bytes(path, json.dumps(doc, **dumps_kw).encode("utf-8"), fsync=fsync)
