"""Native JPEG decode pool (ctypes over native/jpeg_pool.cpp).

The port's own copy of `seesaw_tpu/runtime/jpeg_decode.py`. The decode stage
of ingestion runs in C++ worker threads (file read + libjpeg decode into RGB
buffers, no GIL on the hot path); Python submits paths and iterates completed
(id, HxWx3 uint8) arrays. The port builds the shared source with g++ on first
use into `build/seesaw_tpu_torch/` (never over the JAX package's library in
`native/`). Where the toolchain or the libjpeg headers are missing, PIL
decodes on host threads instead; `native_available()` says which one runs.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterable, Iterator, Optional, Tuple

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "jpeg_pool.cpp"
_LIB_PATH = _REPO / "build" / "seesaw_tpu_torch" / "libjpeg_pool_torch.so"
_build_lock = threading.Lock()
_lib = None
_lib_failed = False  # memoized: never re-run a failing compile


def _load_native():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _build_lock:
        if _lib is not None or _lib_failed:
            return _lib
        if not _SRC.exists():
            _lib_failed = True
            return None
        if (not _LIB_PATH.exists()) or _LIB_PATH.stat().st_mtime < _SRC.stat().st_mtime:
            # build beside, then rename: concurrent processes see a whole
            # library or none
            tmp = _LIB_PATH.with_suffix(f".{os.getpid()}.tmp")
            try:
                _LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run(
                    ["g++", "-O2", "-shared", "-fPIC", "-pthread",
                     "-o", str(tmp), str(_SRC), "-ljpeg"],
                    check=True, capture_output=True,
                )
                os.replace(tmp, _LIB_PATH)
            except (subprocess.CalledProcessError, FileNotFoundError, OSError):
                _lib_failed = True
                return None
        try:
            lib = ctypes.CDLL(str(_LIB_PATH))
        except OSError:
            _lib_failed = True
            return None
        P = ctypes.c_void_p
        lib.jp_create.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.jp_create.restype = P
        lib.jp_destroy.argtypes = [P]
        lib.jp_submit.argtypes = [P, ctypes.c_int64, ctypes.c_char_p]
        lib.jp_submit.restype = ctypes.c_int
        lib.jp_pending.argtypes = [P]
        lib.jp_pending.restype = ctypes.c_int64
        lib.jp_poll.argtypes = [
            P, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ]
        lib.jp_poll.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    """Whether `decode_pool` decodes with the native C++ pool (else PIL)."""
    return _load_native() is not None


class NativeJpegPool:
    """C++ decode pool: submit(id, path), iterate results()."""

    def __init__(self, n_threads: int = 8, max_w: int = 8192, max_h: int = 8192):
        lib = _load_native()
        if lib is None:
            raise RuntimeError("native jpeg pool unavailable")
        self._lib = lib
        self._pool = lib.jp_create(n_threads, max_w, max_h)
        self._buf = np.empty(max_w * max_h * 3, dtype=np.uint8)
        self._closed = False

    def _live_pool(self):
        if self._pool is None:  # closed: a NULL pointer would segfault in C++
            raise RuntimeError("jpeg pool is closed")
        return self._pool

    def submit(self, job_id: int, path: str):
        rc = self._lib.jp_submit(self._live_pool(), job_id, str(path).encode())
        if rc != 0:
            raise RuntimeError("submit after close")

    def pending(self) -> int:
        return int(self._lib.jp_pending(self._live_pool()))

    def poll(self) -> Optional[Tuple[int, Optional[np.ndarray]]]:
        """One completed (id, HxWx3 array) or (id, None) for a failed decode;
        None when nothing is ready yet."""
        self._live_pool()
        jid = ctypes.c_int64()
        w = ctypes.c_int()
        h = ctypes.c_int()
        rc = self._lib.jp_poll(
            self._pool, ctypes.byref(jid), ctypes.byref(w), ctypes.byref(h),
            self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self._buf.size,
        )
        if rc == 0:
            return None
        if rc == -2:
            return int(jid.value), None
        n = h.value * w.value * 3
        return int(jid.value), self._buf[:n].reshape(h.value, w.value, 3).copy()

    def close(self):
        if not self._closed:
            self._closed = True
            self._lib.jp_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_pool(paths: Iterable[str], n_threads: int = 8,
                prefer_native: bool = True) -> Iterator[Tuple[int, Optional[np.ndarray]]]:
    """Yield (index, RGB array or None) for each path, roughly in completion
    order; native C++ pool when available, PIL thread pool otherwise."""
    paths = list(paths)
    if prefer_native and _load_native() is not None:
        import time

        pool = NativeJpegPool(n_threads=n_threads)
        try:
            # bounded submission window: submitting everything up front lets
            # the C++ workers decode far ahead of a slow consumer and buffer
            # the whole dataset's RGB frames in the results deque (multi-GB
            # at 100k+ images); keep at most `window` jobs in flight
            window = max(4 * n_threads, 8)
            next_i = 0
            done = 0
            while done < len(paths):
                while next_i < len(paths) and (next_i - done) < window:
                    pool.submit(next_i, paths[next_i])
                    next_i += 1
                out = pool.poll()
                if out is None:
                    time.sleep(0.0005)
                    continue
                done += 1
                yield out
        finally:
            pool.close()
        return

    from concurrent.futures import ThreadPoolExecutor

    import PIL.Image

    def dec(item):
        i, p = item
        try:
            return i, np.asarray(PIL.Image.open(p).convert("RGB"))
        except Exception:
            return i, None

    with ThreadPoolExecutor(n_threads) as ex:
        yield from ex.map(dec, enumerate(paths))
