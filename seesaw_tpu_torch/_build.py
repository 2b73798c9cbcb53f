"""Build and load the port's CUDA kernels at first use.

Each `csrc/<name>.cu` has a plain C interface and is compiled with `nvcc`
into `build/seesaw_tpu_torch/lib<name>-<hash>.so` at the repository root,
keyed by a hash of the source and the flags, then loaded with `ctypes`.
Nothing is built while a module is imported: the wrappers call
`load_library` inside the function that launches the kernel.
"""
from __future__ import annotations

import ctypes
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


def load_library(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` if no build of this exact source exists, and
    return the loaded library (cached for the life of the process)."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        src = _CSRC / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src}:\n{proc.stdout}\n{proc.stderr}"
                )
            os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
            build_seconds[name] = time.perf_counter() - t0
        lib = ctypes.CDLL(str(so))
        _libs[name] = lib
        return lib
