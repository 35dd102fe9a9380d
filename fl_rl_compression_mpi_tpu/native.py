"""ctypes bindings for the native host runtime (``csrc/flrlio.cpp``).

Loads ``_native/libflrlio.so``; if absent, builds it once with g++ (the
image bakes the toolchain) and caches the handle.  Every entry point has a
pure-NumPy fallback in the callers, so `get_native()` returning ``None``
(no toolchain, build failure) only costs speed, never correctness.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_NATIVE = None
_TRIED = False

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SO_PATH = os.path.join(_PKG_DIR, "_native", "libflrlio.so")
_SRC_PATH = os.path.join(os.path.dirname(_PKG_DIR), "csrc", "flrlio.cpp")

_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")


class Native:
    """Typed wrapper over the C ABI."""

    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.flrl_file_size.restype = ctypes.c_int64
        lib.flrl_file_size.argtypes = [ctypes.c_char_p]
        lib.flrl_read_file.restype = ctypes.c_int
        lib.flrl_read_file.argtypes = [ctypes.c_char_p, _u8p, ctypes.c_int64]
        lib.flrl_read_range.restype = ctypes.c_int
        lib.flrl_read_range.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, _u8p]
        lib.flrl_write_file.restype = ctypes.c_int
        lib.flrl_write_file.argtypes = [ctypes.c_char_p, _u8p,
                                        ctypes.c_int64]
        lib.flrl_write_container.restype = ctypes.c_int
        lib.flrl_write_container.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, _u8p, ctypes.c_uint64,
            _u8p, ctypes.c_uint64]
        lib.flrl_fl_encode.restype = ctypes.c_int64
        lib.flrl_fl_encode.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int, _u8p, _u8p]
        lib.flrl_fl_decode.restype = ctypes.c_int
        lib.flrl_fl_decode.argtypes = [
            _u8p, ctypes.c_int64, _u8p, ctypes.c_int64, ctypes.c_int,
            _u8p, ctypes.c_int64]
        lib.flrl_fl_fold.restype = ctypes.c_int64
        lib.flrl_fl_fold.argtypes = [_u32p, _u8p, ctypes.c_int64,
                                     ctypes.c_int, _u8p]
        lib.flrl_fl_unfold.restype = ctypes.c_int
        lib.flrl_fl_unfold.argtypes = [_u8p, ctypes.c_int64, _u8p,
                                       ctypes.c_int64, ctypes.c_int64,
                                       ctypes.c_int, _u32p]
        lib.flrl_rl_encode.restype = ctypes.c_int64
        lib.flrl_rl_encode.argtypes = [_u8p, ctypes.c_int64, _u8p, _u8p]
        lib.flrl_rl_decode.restype = ctypes.c_int64
        lib.flrl_rl_decode.argtypes = [_u8p, _u8p, ctypes.c_int64, _u8p,
                                       ctypes.c_int64]

    # -- file I/O ----------------------------------------------------------

    def read_file(self, path: str) -> np.ndarray:
        size = self._lib.flrl_file_size(path.encode())
        if size < 0:
            raise IOError(f"[FileIO] Cannot open file {path}")
        out = np.empty(size, np.uint8)
        if size and self._lib.flrl_read_file(path.encode(), out, size) != 0:
            raise IOError(f"[FileIO] Cannot read file content {path}")
        return out

    def read_range(self, path: str, off: int, length: int) -> np.ndarray:
        out = np.empty(length, np.uint8)
        if length and self._lib.flrl_read_range(
                path.encode(), off, length, out) != 0:
            raise IOError(f"[FileIO] Cannot read file content {path}")
        return out

    def write_file(self, path: str, data: np.ndarray) -> None:
        data = np.ascontiguousarray(data, np.uint8)
        if self._lib.flrl_write_file(path.encode(), data, data.size) != 0:
            raise IOError(f"[FileIO] Cannot write file {path}")

    def write_container(self, path: str, input_size: int, a: np.ndarray,
                        b: np.ndarray) -> None:
        a = np.ascontiguousarray(a, np.uint8)
        b = np.ascontiguousarray(b, np.uint8)
        if self._lib.flrl_write_container(
                path.encode(), input_size, a, a.size, b, b.size) != 0:
            raise IOError(f"[FileIO] Cannot write file {path}")

    # -- host codecs -------------------------------------------------------

    def fl_encode(self, data: np.ndarray, frame_length: int = 128):
        data = np.ascontiguousarray(data, np.uint8)
        n = data.size
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        frames = -(-n // frame_length)
        bits = np.empty(frames, np.uint8)
        values = np.empty(n + frame_length, np.uint8)
        vsz = self._lib.flrl_fl_encode(data, n, frame_length, bits, values)
        if vsz < 0:
            raise ValueError("fl_encode: bad arguments")
        return bits, values[:vsz].copy()

    def fl_decode(self, output_size: int, bits: np.ndarray,
                  values: np.ndarray, frame_length: int = 128) -> np.ndarray:
        bits = np.ascontiguousarray(bits, np.uint8)
        values = np.ascontiguousarray(values, np.uint8)
        if output_size == 0:
            return np.zeros(0, np.uint8)
        if bits.size == 0 or values.size == 0:
            # A nonzero claimed size with empty payload must be a tagged
            # error, not a silently empty output.
            raise ValueError(
                "fl_decode: corrupt container (empty bits/values for "
                f"claimed size {output_size})")
        out = np.empty(output_size, np.uint8)
        rc = self._lib.flrl_fl_decode(bits, bits.size, values, values.size,
                                      frame_length, out, output_size)
        if rc != 0:
            raise ValueError(f"fl_decode: corrupt stream (rc={rc})")
        return out

    def fl_fold(self, fields: np.ndarray, bits: np.ndarray, n: int,
                frame_length: int = 128) -> np.ndarray:
        """Fields (u32) + bits → byte-exact packed stream."""
        fields = np.ascontiguousarray(fields, np.uint32)
        bits = np.ascontiguousarray(bits, np.uint8)
        if n == 0:
            return np.zeros(0, np.uint8)
        values = np.empty(n + frame_length, np.uint8)
        vsz = self._lib.flrl_fl_fold(fields, bits, n, frame_length, values)
        if vsz < 0:
            raise ValueError("fl_fold: bad arguments")
        return values[:vsz].copy()

    def fl_unfold(self, values: np.ndarray, bits: np.ndarray, n: int,
                  frame_length: int = 128) -> np.ndarray:
        """Packed stream + bits → fields (u32), zero-padded tail."""
        values = np.ascontiguousarray(values, np.uint8)
        bits = np.ascontiguousarray(bits, np.uint8)
        if n == 0:
            return np.zeros(0, np.uint32)
        frames = -(-n // frame_length)
        if bits.size < frames:
            raise ValueError(
                "fl_unfold: corrupt container (bits array shorter than "
                f"frame count: {bits.size} < {frames})")
        fields = np.empty(frames * (frame_length // 4), np.uint32)
        rc = self._lib.flrl_fl_unfold(values, values.size, bits, bits.size,
                                      n, frame_length, fields)
        if rc != 0:
            raise ValueError(f"fl_unfold: corrupt stream (rc={rc})")
        return fields

    def rl_encode(self, data: np.ndarray):
        data = np.ascontiguousarray(data, np.uint8)
        n = data.size
        if n == 0:
            return np.zeros(0, np.uint8), np.zeros(0, np.uint8)
        counts = np.empty(n, np.uint8)
        values = np.empty(n, np.uint8)
        r = self._lib.flrl_rl_encode(data, n, counts, values)
        return counts[:r].copy(), values[:r].copy()

    def rl_decode(self, counts: np.ndarray, values: np.ndarray) -> np.ndarray:
        counts = np.ascontiguousarray(counts, np.uint8)
        values = np.ascontiguousarray(values, np.uint8)
        if counts.size != values.size:
            raise ValueError(
                "rl_decode: corrupt container (counts/values length "
                f"mismatch: {counts.size} != {values.size})")
        cap = int(counts.astype(np.int64).sum())
        out = np.empty(cap, np.uint8)
        n = self._lib.flrl_rl_decode(counts, values, counts.size, out, cap)
        if n < 0:
            raise ValueError("rl_decode: corrupt stream")
        return out[:n]


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-fPIC", "-shared",
           "-fopenmp", "-o", _SO_PATH, _SRC_PATH]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def get_native() -> Native | None:
    """Load (building on first use) the native library, or None."""
    global _NATIVE, _TRIED
    if _NATIVE is not None or _TRIED:
        return _NATIVE
    with _LOCK:
        if _NATIVE is not None or _TRIED:
            return _NATIVE
        _TRIED = True
        if os.environ.get("FLRL_NO_NATIVE"):
            return None
        if os.path.exists(_SRC_PATH):
            stale = (not os.path.exists(_SO_PATH)
                     or os.path.getmtime(_SO_PATH)
                     < os.path.getmtime(_SRC_PATH))
            if stale and not _build():
                return None
        try:
            _NATIVE = Native(ctypes.CDLL(_SO_PATH))
        except OSError:
            _NATIVE = None
    return _NATIVE
