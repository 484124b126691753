"""ctypes binding for the scaled JPEG decoder (``jpeg_decode.cpp``;
counterpart of ``tennis_tpu/native/jpeg.py``).

``decode_jpeg_file(path, min_short)`` returns an RGB uint8 array decoded with
the smallest M/8 DCT downscale whose short side still covers ``min_short``
(the geometry stage's input requirement), or ``None`` when the native library
is unavailable or the file is not a decodable JPEG: callers fall back to cv2.
``jpeg_dims``/``jpeg_dims_file`` are the header-only variants (no pixel
decode). Built on first use against the system libjpeg(-turbo) into
``tennis_torch/build/``, like ``tennis_torch/native``'s batch ops; the
``HAVE_NATIVE_JPEG`` attribute (built on first access) says whether it is
there.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "jpeg_decode.cpp")

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _load():
    global _lib, _lib_failed
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        from tennis_torch.native import load_shared

        lib = load_shared(_SRC, link=("-ljpeg",))
        if lib is None:
            _lib_failed = True
            return None
        u8p = ctypes.POINTER(ctypes.c_ubyte)
        i32p = ctypes.POINTER(ctypes.c_int)
        lib.tjp_dims.restype = ctypes.c_int
        lib.tjp_dims.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, i32p,
                                 i32p, i32p]
        lib.tjp_decode.restype = ctypes.c_int
        lib.tjp_decode.argtypes = [u8p, ctypes.c_size_t, ctypes.c_int, u8p,
                                   ctypes.c_long, i32p, i32p]
        _lib = lib
        return lib


def __getattr__(name):
    if name == "HAVE_NATIVE_JPEG":  # built on first access, not at import
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _dims(data: bytes, min_short: int | None):
    """The library and JPEG-magic guard, then ``tjp_dims``: ``(lib, buf,
    h, w, scale)`` with the ctypes out-params filled, or None on any
    failure."""
    lib = _load()
    if lib is None or len(data) < 4 or data[:2] != b"\xff\xd8":
        return None
    buf = (ctypes.c_ubyte * len(data)).from_buffer_copy(data)
    h = ctypes.c_int()
    w = ctypes.c_int()
    scale = ctypes.c_int()
    if lib.tjp_dims(buf, len(data), int(min_short or 0), ctypes.byref(h),
                    ctypes.byref(w), ctypes.byref(scale)):
        return None
    return lib, buf, h, w, scale


def _read_jpeg_bytes(path: str):
    """The file's bytes when its name is a JPEG's; None otherwise or on a
    read failure."""
    if not path.lower().endswith((".jpg", ".jpeg")):
        return None
    try:
        with open(path, "rb") as f:
            return f.read()
    except OSError:
        return None


def decode_jpeg(data: bytes, min_short: int | None = None):
    """RGB uint8 (H, W, 3) from an in-memory JPEG, DCT-downscaled to the
    smallest M/8 that keeps the short side >= ``min_short``; None on any
    failure."""
    pre = _dims(data, min_short)
    if pre is None:
        return None
    lib, buf, h, w, scale = pre
    out = np.empty((h.value, w.value, 3), np.uint8)
    rc = lib.tjp_decode(
        buf, len(data), scale.value,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), out.nbytes,
        ctypes.byref(h), ctypes.byref(w),
    )
    if rc or (h.value, w.value) != out.shape[:2]:
        return None
    return out


def jpeg_dims(data: bytes):
    """Header-only (height, width) of an in-memory JPEG, no pixel decode;
    None when the native library is unavailable or the buffer is not a
    JPEG."""
    pre = _dims(data, 0)
    if pre is None:
        return None
    _, _, h, w, _ = pre
    return (h.value, w.value)


def jpeg_dims_file(path: str):
    data = _read_jpeg_bytes(path)
    return None if data is None else jpeg_dims(data)


def decode_jpeg_file(path: str, min_short: int | None = None):
    data = _read_jpeg_bytes(path)
    return None if data is None else decode_jpeg(data, min_short)
