"""ctypes bindings for the native IO runtime (csrc/libcctpu_io.so).

The native library implements the .vec decoder and the deterministic
negative-window miner in C++ (the production data-loading hot path);
data/vec.py and data/negreader.py are the portable Python twins. Loaders
prefer the native path when the library is built and fall back silently.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _find_lib():
    if os.environ.get("CCTPU_NO_NATIVE"):
        return None
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    cands = [
        os.environ.get("CCTPU_IO_LIB"),
        os.path.join(here, "csrc", "libcctpu_io.so"),
    ]
    for c in cands:
        if c and os.path.exists(c):
            return c
    return None


def get_lib():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _find_lib()
    if path is None:
        return None
    try:
        # RTLD_LOCAL+DEEPBIND: the lib links system OpenCV 4.x while the
        # process may hold cv2's OpenCV 5 — keep symbol namespaces apart
        mode = ctypes.RTLD_LOCAL | getattr(os, "RTLD_DEEPBIND", 0)
        lib = ctypes.CDLL(path, mode=mode)
    except OSError:
        return None
    lib.cctpu_vec_open.restype = ctypes.c_void_p
    lib.cctpu_vec_open.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.cctpu_vec_read.restype = ctypes.c_int
    lib.cctpu_vec_read.argtypes = [
        ctypes.c_void_p,
        ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.cctpu_vec_close.argtypes = [ctypes.c_void_p]
    lib.cctpu_vec_write.restype = ctypes.c_int
    lib.cctpu_vec_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
        ctypes.c_int,
    ]
    lib.cctpu_neg_open.restype = ctypes.c_void_p
    lib.cctpu_neg_open.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
    lib.cctpu_neg_next.restype = ctypes.c_int
    lib.cctpu_neg_next.argtypes = [
        ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int,
    ]
    lib.cctpu_neg_close.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


def native_read_vec(path: str):
    """(count, vecsize) uint8 array via the native decoder, or None."""
    lib = get_lib()
    if lib is None:
        return None
    count = ctypes.c_int()
    vecsize = ctypes.c_int()
    h = lib.cctpu_vec_open(path.encode(), ctypes.byref(count), ctypes.byref(vecsize))
    if not h:
        return None
    out = np.empty((count.value, vecsize.value), np.uint8)
    got = lib.cctpu_vec_read(
        h, 0, count.value, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    )
    lib.cctpu_vec_close(h)
    if got != count.value:
        return None
    return out


def native_write_vec(path: str, samples: np.ndarray) -> bool:
    lib = get_lib()
    if lib is None:
        return False
    s = np.ascontiguousarray(samples.reshape(samples.shape[0], -1), np.uint8)
    n = lib.cctpu_vec_write(
        path.encode(),
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        s.shape[0],
        s.shape[1],
    )
    return n == s.shape[0]


class NativeNegReader:
    """Native miner with take_batch semantics identical to
    data/negreader.NegReader (byte-equivalence-tested)."""

    def __init__(self, bg_path: str, win_w: int, win_h: int):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native IO library not available")
        self._lib = lib
        self.win_w, self.win_h = win_w, win_h
        self._h = lib.cctpu_neg_open(bg_path.encode(), win_w, win_h)
        if not self._h:
            raise FileNotFoundError(f"no backgrounds in {bg_path}")

    def take_batch(self, n: int) -> np.ndarray:
        out = np.empty((n, self.win_h, self.win_w), np.uint8)
        got = self._lib.cctpu_neg_next(
            self._h, out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n
        )
        return out[:got]

    def close(self):
        if self._h:
            self._lib.cctpu_neg_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
