"""Native (C++) host-preprocessing bindings via ctypes.

``lib()`` returns the loaded shared object, compiling it on first use with
the system g++ (build.py).  All entry points degrade gracefully: when the
toolchain or .so is unavailable, callers fall back to the numpy
implementations in data/transforms.py (same math, slower).
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

_SO_PATH = os.path.join(os.path.dirname(__file__), "libpreprocess.so")
# Must equal preprocess.cpp's preprocess_abi_version(); bump both on any
# exported-signature or semantics change.
_ABI_VERSION = 2


def lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        # Env toggle (not a monkeypatch) so it reaches loader worker
        # processes, which start from a clean forkserver helper.
        if os.environ.get("RANGECLIP_NATIVE", "").lower() in ("off", "0"):
            return None
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        here = os.path.dirname(_SO_PATH)
        src_mtime = max(
            (os.path.getmtime(os.path.join(here, f))
             for f in os.listdir(here) if f.endswith(".cpp") or f == "build.py"),
            default=0.0,
        )
        stale = (os.path.exists(_SO_PATH)
                 and os.path.getmtime(_SO_PATH) < src_mtime)
        if stale or not os.path.exists(_SO_PATH):
            try:
                from rangeclip.native.build import build

                build()  # make-style: rebuild when any source is newer
            except Exception:
                # No toolchain.  An existing .so may still be usable (the
                # staleness can be a spurious .py mtime bump): load it and
                # let the symbol binding below decide — a genuinely old
                # .so missing current symbols returns None there.
                pass
        if not os.path.exists(_SO_PATH):
            return None
        try:
            cdll = ctypes.CDLL(_SO_PATH)
        except OSError:
            return None

        try:
            i64, f32p, i32p = (ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_float),
                               ctypes.POINTER(ctypes.c_int32))
            cdll.nearest_resize_f32.argtypes = [f32p, f32p, i64, i64, i64,
                                                i64, i64]
            cdll.nearest_resize_i32.argtypes = [i32p, i32p, i64, i64, i64,
                                                i64]
            cdll.lower_median_f32.argtypes = [f32p, i64]
            cdll.lower_median_f32.restype = ctypes.c_float
            cdll.median_normalize_f32.argtypes = [f32p, i64]
            cdll.depth_transform_f32.argtypes = [f32p, f32p, i64, i64, i64,
                                                 i64]
            ci = ctypes.c_int
            cdll.png_header.argtypes = [
                ctypes.c_char_p, ctypes.POINTER(ci), ctypes.POINTER(ci),
                ctypes.POINTER(ci), ctypes.POINTER(ci),
            ]
            cdll.png_header.restype = ci
            cdll.png_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_void_p, ctypes.c_long,
            ]
            cdll.png_decode.restype = ci
            # ABI stamp: symbol-name presence alone cannot detect a stale
            # .so whose exported functions changed semantics or argument
            # lists (preprocess.cpp preprocess_abi_version) — a mismatch
            # means the rebuild failed and numpy must take over.
            cdll.preprocess_abi_version.restype = ctypes.c_int64
            if cdll.preprocess_abi_version() != _ABI_VERSION:
                return None
        except AttributeError:  # .so predates a source change
            return None
        _LIB = cdll
        return _LIB


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def depth_transform_native(depth: np.ndarray, size) -> Optional[np.ndarray]:
    """Fused nearest-resize + lower-median normalize; None if unavailable."""
    l = lib()
    if l is None:
        return None
    src = np.ascontiguousarray(depth, np.float32)
    h_out, w_out = size
    dst = np.empty((h_out, w_out), np.float32)
    l.depth_transform_f32(_fptr(src), _fptr(dst), src.shape[0], src.shape[1],
                          h_out, w_out)
    return dst


def segmentation_resize_native(seg: np.ndarray, size) -> Optional[np.ndarray]:
    l = lib()
    if l is None:
        return None
    src = np.ascontiguousarray(seg, np.int32)
    h_out, w_out = size
    dst = np.empty((h_out, w_out), np.int32)
    l.nearest_resize_i32(_iptr(src), _iptr(dst), src.shape[0], src.shape[1],
                         h_out, w_out)
    return dst


def decode_png_native(path: str) -> Optional[np.ndarray]:
    """Decode a PNG to pixels byte-identical with PIL: uint8 [H, W] /
    [H, W, 3] or uint16 [H, W].  Returns None (caller falls back to PIL)
    when the library is unavailable or the file uses an unsupported shape
    (palette, alpha, interlaced, non-PNG).

    PIL's decoder holds the GIL and costs ~22 of the ~26 ms per-sample
    dataset load at 480x640 (85%); this zlib+unfilter path is the
    dataset's decode fast path."""
    import ctypes as _ct

    l = lib()
    if l is None:
        return None
    w = _ct.c_int()
    h = _ct.c_int()
    ch = _ct.c_int()
    bits = _ct.c_int()
    p = path.encode()
    if l.png_header(p, _ct.byref(w), _ct.byref(h), _ct.byref(ch),
                    _ct.byref(bits)) != 0:
        return None
    dtype = np.uint16 if bits.value == 16 else np.uint8
    shape = (h.value, w.value) if ch.value == 1 else (h.value, w.value, 3)
    out = np.empty(shape, dtype)
    if l.png_decode(p, out.ctypes.data_as(_ct.c_void_p),
                    _ct.c_long(out.nbytes)) != 0:
        return None
    return out
