"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
into `build/seesaw_tpu_torch/lib<name>-<hash>.so` at the repository root,
keyed by a hash of the source and the flags, then loaded with `ctypes`.
`load_libraries` builds several sources at once, one nvcc each, under an
exclusive `flock` on `build/seesaw_tpu_torch/build.lock`: processes that
start cold together (the shards' processes of one mesh) build each library
once per machine, and a process that dies releases its lock.
Nothing is built while a module is imported: the wrappers call
`load_library` inside the function that launches the kernel.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "seesaw_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # name -> seconds nvcc took in this process


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(name: str):
    src = _CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return src, BUILD_DIR / f"lib{name}-{digest}.so"


@contextlib.contextmanager
def _machine_lock():
    """The build directory's lock file, held exclusively."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "build.lock", "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def load_libraries(*names: str) -> dict[str, ctypes.CDLL]:
    """Compile every `csrc/<name>.cu` that has no build of its exact source
    yet, one nvcc process per source, all started together, and return the
    loaded libraries (cached for the life of the process). The check and
    the build hold the machine's build lock."""
    with _lock:
        if all(name in _libs for name in names):
            return {name: _libs[name] for name in names}
        with _machine_lock():
            return _build_and_load(names)


def _build_and_load(names) -> dict[str, ctypes.CDLL]:
    """Build what has no build yet and load every library (under the locks)."""
    builds = []
    for name in names:
        if name in _libs:
            continue
        src, so = _target(name)
        if not so.exists():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            )
            builds.append((name, src, so, tmp, proc, time.perf_counter()))
    failed = []
    for name, src, so, tmp, proc, t0 in builds:
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed to build {src}:\n{out}\n{err}")
            continue
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
        build_seconds[name] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(_target(name)[1]))
    return {name: _libs[name] for name in names}


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if no build of this exact source exists, and
    return the loaded library."""
    return load_libraries(name)[name]
