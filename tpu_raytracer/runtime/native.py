"""ctypes bindings for the native C++ runtime (PNG encode, pixel convert).

Builds the shared library on first use with g++ (no pip deps); falls back
to numpy / zlib paths if no toolchain is available, so the framework stays
importable everywhere.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(__file__)
_SRCS = [os.path.join(_HERE, "native", "png_writer.cpp"),
         os.path.join(_HERE, "native", "bvh_builder.cpp")]
_SRC = _SRCS[0]
_LIB = os.path.join(_HERE, "native", "libtpurt.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", *_SRCS,
           "-o", _LIB, "-lz", "-lpthread"]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        src_mtime = max(os.path.getmtime(s) for s in _SRCS)
        if not os.path.exists(_LIB) or os.path.getmtime(_LIB) < src_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
            lib.tpurt_write_png.restype = ctypes.c_int
            lib.tpurt_write_png.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int]
            lib.tpurt_linear_to_srgb_u8.restype = None
            lib.tpurt_linear_to_srgb_u8.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int]
            lib.tpurt_depad_rows.restype = None
            lib.tpurt_depad_rows.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int]
            lib.tpurt_build_bvh.restype = ctypes.c_int
            lib.tpurt_build_bvh.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
            _lib = lib
        except OSError:
            _lib = None
        return _lib


def write_png(path: str, img_u8: np.ndarray) -> None:
    """Fast PNG save (zlib level 1, filter None); utils/png fallback."""
    img_u8 = np.ascontiguousarray(img_u8)
    assert img_u8.dtype == np.uint8 and img_u8.ndim == 3
    h, w, c = img_u8.shape
    lib = get_lib()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if lib is not None and c in (3, 4):
        rc = lib.tpurt_write_png(path.encode(), img_u8.ctypes.data, w, h, c)
        if rc == 0:
            return
    from ..utils import png

    png.write(path, img_u8, level=1)


def linear_to_srgb_u8(img_f32: np.ndarray, n_threads: int | None = None
                      ) -> np.ndarray:
    """Gamma-2.2 encode linear floats to u8 (native multithreaded path)."""
    img_f32 = np.ascontiguousarray(img_f32, np.float32)
    lib = get_lib()
    if lib is None:
        return (np.power(np.clip(img_f32, 0, 1), 1 / 2.2) * 255 + 0.5
                ).astype(np.uint8)
    out = np.empty(img_f32.shape, np.uint8)
    lib.tpurt_linear_to_srgb_u8(
        img_f32.ctypes.data, out.ctypes.data, img_f32.size,
        n_threads or os.cpu_count() or 4)
    return out
