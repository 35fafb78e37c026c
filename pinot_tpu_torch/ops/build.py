"""Build and load the package's CUDA sources.

Each `ops/csrc/<name>.cu` compiles with nvcc for Hopper (sm_90a) into a
shared library with a plain C interface, loaded with ctypes: no PyTorch
headers take part, so a build takes seconds. A library builds at first use
into `pinot_tpu_torch/_build/`, named by a digest of its source, the shared
headers (`csrc/*.cuh`) and the flags, so an edited source never loads a stale
build. Concurrent builders each write a private file and rename it into
place.

A failed build raises; nothing here falls back to another implementation.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the CUDA kernels cannot be built")
    return found


def library_path(name: str) -> Path:
    # the source, every header a source may include, and the flags
    src = b"".join(p.read_bytes() for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: list[str]) -> dict[str, dict]:
    """Compile every named source that has no current build, all nvcc
    processes started together. Returns per name {"seconds", "cached",
    "log"} (log: nvcc's register and shared-memory report)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = []
    for name in names:
        target = library_path(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "cached": True, "log": ""}
            continue
        fd, tmp = tempfile.mkstemp(prefix=f".{name}-", suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((name, target, tmp, proc, time.perf_counter()))
    failures = []
    for name, target, tmp, proc, t0 in procs:
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, target)
        report[name] = {"seconds": seconds, "cached": False, "log": log}
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _LIBS[name] = lib
        return lib
