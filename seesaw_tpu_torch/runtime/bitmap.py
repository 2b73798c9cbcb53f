"""Integer-set bitmaps for session bookkeeping (seen / accepted / returned).

The port's own copy of `seesaw_tpu/runtime/bitmap.py`: an API-compatible
subset of pyroaring's ``BitMap``/``FrozenBitMap``, backed by the native C++
roaring implementation in `native/roaring.cpp`. The port builds that source
with g++ on first use into `build/seesaw_tpu_torch/` (never over the JAX
package's own library in `native/`), and falls back to a pure-Python ``set``
when no C++ toolchain is available.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parent.parent.parent
_SRC = _REPO / "native" / "roaring.cpp"
_LIB_PATH = _REPO / "build" / "seesaw_tpu_torch" / "libroaring_torch.so"
_build_lock = threading.Lock()
_lib = None
_lib_failed = False  # memoized: never re-run a failing compile per BitMap()


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
                    ["g++", "-O2", "-shared", "-fPIC", "-o", str(tmp), str(_SRC)],
                    check=True,
                    capture_output=True,
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
        P, U32, U64 = ctypes.c_void_p, ctypes.c_uint32, ctypes.c_uint64
        PU32 = ctypes.POINTER(ctypes.c_uint32)
        PU8 = ctypes.POINTER(ctypes.c_uint8)
        argtypes = {
            "rb_create": [], "rb_free": [P], "rb_add": [P, U32],
            "rb_add_many": [P, PU32, U64], "rb_remove": [P, U32],
            "rb_contains": [P, U32], "rb_contains_many": [P, PU32, U64, PU8],
            "rb_cardinality": [P], "rb_clear": [P], "rb_to_array": [P, PU32],
            "rb_copy": [P], "rb_union_update": [P, P], "rb_difference": [P, P],
            "rb_intersection": [P, P], "rb_equals": [P, P],
        }
        for name, at in argtypes.items():
            getattr(lib, name).argtypes = at
        lib.rb_create.restype = ctypes.c_void_p
        lib.rb_copy.restype = ctypes.c_void_p
        lib.rb_difference.restype = ctypes.c_void_p
        lib.rb_intersection.restype = ctypes.c_void_p
        lib.rb_cardinality.restype = ctypes.c_uint64
        lib.rb_contains.restype = ctypes.c_int
        lib.rb_equals.restype = ctypes.c_int
        for name in ("rb_free", "rb_add", "rb_remove", "rb_clear", "rb_union_update",
                     "rb_to_array", "rb_add_many", "rb_contains_many"):
            getattr(lib, name).restype = None
        _lib = lib
        return _lib


def _as_u32(values) -> np.ndarray:
    arr = np.asarray(list(values) if not isinstance(values, np.ndarray) else values)
    return np.ascontiguousarray(arr, dtype=np.uint32)


class BitMap:
    """Mutable sorted set of uint32, native-backed when possible."""

    __slots__ = ("_ptr", "_set", "_free")

    def __init__(self, values=None, _ptr=None):
        lib = _load_native()
        self._free = lib.rb_free if lib is not None else None
        if lib is not None:
            self._set = None
            if _ptr is not None:
                self._ptr = _ptr
            else:
                self._ptr = lib.rb_create()
                if values is not None:
                    BitMap.update(self, values)
        else:
            self._ptr = None
            self._set = set()
            if _ptr is None and values is not None:
                self._set.update(int(v) for v in values)

    def __del__(self):
        # _free is captured per-instance: module globals (_lib) may already be
        # torn down when __del__ runs at interpreter shutdown.
        ptr = getattr(self, "_ptr", None)
        free = getattr(self, "_free", None)
        if ptr and free is not None:
            # raw int is converted via the declared [c_void_p] argtypes; do not
            # touch the ctypes module here — it may be gone at shutdown.
            free(ptr)
            self._ptr = None

    # -- mutation ----------------------------------------------------------
    def add(self, v: int):
        if self._ptr:
            _lib.rb_add(ctypes.c_void_p(self._ptr), ctypes.c_uint32(int(v)))
        else:
            self._set.add(int(v))

    def remove(self, v: int):
        # pyroaring parity: remove raises on a missing element, discard is
        # the silent variant
        if int(v) not in self:
            raise KeyError(v)
        self.discard(v)

    def discard(self, v: int):
        if self._ptr:
            _lib.rb_remove(ctypes.c_void_p(self._ptr), ctypes.c_uint32(int(v)))
        else:
            self._set.discard(int(v))

    def update(self, values):
        if self._ptr:
            arr = _as_u32(values)
            if arr.size:
                _lib.rb_add_many(
                    ctypes.c_void_p(self._ptr),
                    arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    ctypes.c_uint64(arr.size),
                )
        else:
            self._set.update(int(v) for v in values)

    def clear(self):
        if self._ptr:
            _lib.rb_clear(ctypes.c_void_p(self._ptr))
        else:
            self._set.clear()

    # -- queries -----------------------------------------------------------
    def __contains__(self, v) -> bool:
        if self._ptr:
            return bool(_lib.rb_contains(ctypes.c_void_p(self._ptr), ctypes.c_uint32(int(v))))
        return int(v) in self._set

    def contains_many(self, values) -> np.ndarray:
        """Vectorized membership over a uint32 array -> bool array."""
        arr = _as_u32(values)
        if self._ptr:
            out = np.empty(arr.size, dtype=np.uint8)
            if arr.size:
                _lib.rb_contains_many(
                    ctypes.c_void_p(self._ptr),
                    arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                    ctypes.c_uint64(arr.size),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                )
            return out.astype(bool)
        return np.fromiter((int(v) in self._set for v in arr), dtype=bool, count=arr.size)

    def __len__(self) -> int:
        if self._ptr:
            return int(_lib.rb_cardinality(ctypes.c_void_p(self._ptr)))
        return len(self._set)

    def to_array(self) -> np.ndarray:
        if self._ptr:
            n = len(self)
            out = np.empty(n, dtype=np.uint32)
            if n:
                _lib.rb_to_array(
                    ctypes.c_void_p(self._ptr),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
                )
            return out
        return np.array(sorted(self._set), dtype=np.uint32)

    def __iter__(self):
        return iter(self.to_array().tolist())

    def __array__(self, dtype=None):
        arr = self.to_array()
        return arr.astype(dtype) if dtype is not None else arr

    def copy(self) -> "BitMap":
        if self._ptr:
            return BitMap(_ptr=_lib.rb_copy(ctypes.c_void_p(self._ptr)))
        bm = BitMap()
        bm._set = set(self._set)
        return bm

    # -- set algebra -------------------------------------------------------
    def difference(self, other: "BitMap") -> "BitMap":
        if self._ptr and other._ptr:
            return BitMap(
                _ptr=_lib.rb_difference(ctypes.c_void_p(self._ptr), ctypes.c_void_p(other._ptr))
            )
        bm = BitMap()
        bm._set = set(self.to_array().tolist()) - set(other.to_array().tolist())
        return bm

    __sub__ = difference

    def union(self, other: "BitMap") -> "BitMap":
        out = self.copy()
        out.update(other.to_array())
        return out

    __or__ = union

    def intersection(self, other: "BitMap") -> "BitMap":
        if self._ptr and other._ptr:
            return BitMap(
                _ptr=_lib.rb_intersection(ctypes.c_void_p(self._ptr), ctypes.c_void_p(other._ptr))
            )
        bm = BitMap()
        bm._set = set(self.to_array().tolist()) & set(other.to_array().tolist())
        return bm

    __and__ = intersection

    def __eq__(self, other) -> bool:
        if not isinstance(other, BitMap):
            return NotImplemented
        if self._ptr and other._ptr:
            return bool(_lib.rb_equals(ctypes.c_void_p(self._ptr), ctypes.c_void_p(other._ptr)))
        return np.array_equal(self.to_array(), other.to_array())

    # defining __eq__ sets __hash__ to None: the mutable BitMap is
    # unhashable (pyroaring parity — a dict entry keyed by mutating content
    # would silently become unreachable); FrozenBitMap hashes below
    __hash__ = None

    def __repr__(self):
        vals = self.to_array()
        head = ", ".join(map(str, vals[:8]))
        more = ", ..." if len(vals) > 8 else ""
        return f"{type(self).__name__}([{head}{more}]) len={len(vals)}"


class FrozenBitMap(BitMap):
    """Immutable view — mutators raise."""

    def _frozen(self, *a, **k):
        raise TypeError("FrozenBitMap is immutable")

    add = remove = discard = update = clear = _frozen

    def __hash__(self):
        return hash(self.to_array().tobytes())
