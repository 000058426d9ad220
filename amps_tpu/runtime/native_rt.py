"""ctypes bindings for the native host runtime (libampsrt.so).

The library is built from ``native/ampsrt.cc`` with g++ at first use,
into ``native/build/`` (listed in .gitignore), so every machine runs a
binary built from the tree it checked out.  The build is atomic:
compiled to a temporary name and renamed into place under a file lock,
so concurrent importers (test workers) never load a half-written file.
Plain C ABI (no pybind11).  Callers must check ``available()``: without
a toolchain every binding is unavailable.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
from typing import Optional

import numpy as np

_DIR = os.path.join(os.path.dirname(__file__), "native")
_SRC = os.path.join(_DIR, "ampsrt.cc")
_SO = os.path.join(_DIR, "build", "libampsrt.so")
_lib: Optional[ctypes.CDLL] = None


def build(so_path: str = _SO) -> bool:
    """Compile ampsrt.cc into ``so_path`` unless it exists; True when
    the library is there afterwards."""
    os.makedirs(os.path.dirname(so_path), exist_ok=True)
    with open(so_path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so_path):
            return True
        tmp = f"{so_path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-Wall",
                            "-Wextra", "-std=c++17", "-o", tmp, _SRC],
                           check=True, capture_output=True)
            os.replace(tmp, so_path)
            return True
        except (OSError, subprocess.CalledProcessError):
            return False
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    if not build():
        return None
    lib = ctypes.CDLL(_SO)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i8p = ctypes.POINTER(ctypes.c_int8)
    lib.amps_focc_bch_encode.argtypes = [u8p, u8p]
    lib.amps_recc_bch_encode.argtypes = [u8p, u8p]
    lib.amps_recc_bch_decode.argtypes = [u8p, u8p]
    lib.amps_recc_bch_decode.restype = ctypes.c_int
    lib.amps_manchester_encode.argtypes = [u8p, ctypes.c_int, ctypes.c_int, i8p]
    lib.amps_manchester_decode.argtypes = [u8p, ctypes.c_int, u8p]
    lib.amps_manchester_decode.restype = ctypes.c_int
    lib.amps_trigger_scan.argtypes = [u8p, ctypes.c_long, u8p, ctypes.c_long]
    lib.amps_trigger_scan.restype = ctypes.c_long
    lib.amps_ring_create.argtypes = [ctypes.c_size_t]
    lib.amps_ring_create.restype = ctypes.c_void_p
    lib.amps_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.amps_ring_write.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.amps_ring_write.restype = ctypes.c_size_t
    lib.amps_ring_read.argtypes = [ctypes.c_void_p, u8p, ctypes.c_size_t]
    lib.amps_ring_read.restype = ctypes.c_size_t
    lib.amps_ring_read_available.argtypes = [ctypes.c_void_p]
    lib.amps_ring_read_available.restype = ctypes.c_size_t
    lib.amps_ring_write_available.argtypes = [ctypes.c_void_p]
    lib.amps_ring_write_available.restype = ctypes.c_size_t
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.uint8))


def _ptr(a, typ=ctypes.c_uint8):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def focc_bch_encode(info28) -> np.ndarray:
    lib = _load()
    src = _u8(info28)
    out = np.zeros(40, np.uint8)
    lib.amps_focc_bch_encode(_ptr(src), _ptr(out))
    return out


def recc_bch_encode(info36) -> np.ndarray:
    lib = _load()
    src = _u8(info36)
    out = np.zeros(48, np.uint8)
    lib.amps_recc_bch_encode(_ptr(src), _ptr(out))
    return out


def recc_bch_decode(rx48):
    lib = _load()
    src = _u8(rx48)
    out = np.zeros(36, np.uint8)
    ok = lib.amps_recc_bch_decode(_ptr(src), _ptr(out))
    return out, bool(ok)


def manchester_encode(bits, sps: int = 1) -> np.ndarray:
    lib = _load()
    src = _u8(bits)
    out = np.zeros(len(src) * 2 * sps, np.int8)
    lib.amps_manchester_encode(_ptr(src), len(src), sps, _ptr(out, ctypes.c_int8))
    return out


def manchester_decode(symbols01):
    lib = _load()
    src = _u8(symbols01)
    nbits = len(src) // 2
    out = np.zeros(nbits, np.uint8)
    bad = lib.amps_manchester_decode(_ptr(src), nbits, _ptr(out))
    return out, int(bad)


def trigger_scan(haystack01, needle01) -> int:
    lib = _load()
    hay, nee = _u8(haystack01), _u8(needle01)
    return int(lib.amps_trigger_scan(_ptr(hay), len(hay), _ptr(nee), len(nee)))


class Ring:
    """SPSC byte ring buffer backed by the native implementation."""

    def __init__(self, capacity_pow2: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("libampsrt unavailable")
        self._lib = lib
        self._h = lib.amps_ring_create(capacity_pow2)
        if not self._h:
            raise ValueError("capacity must be a power of two")

    def write(self, data) -> int:
        buf = np.ascontiguousarray(np.frombuffer(bytes(data), np.uint8))
        return int(self._lib.amps_ring_write(self._h, _ptr(buf), len(buf)))

    def read(self, n: int) -> bytes:
        out = np.zeros(n, np.uint8)
        got = self._lib.amps_ring_read(self._h, _ptr(out), n)
        return out[:got].tobytes()

    @property
    def readable(self) -> int:
        return int(self._lib.amps_ring_read_available(self._h))

    @property
    def writable(self) -> int:
        return int(self._lib.amps_ring_write_available(self._h))

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.amps_ring_destroy(self._h)
            self._h = None
