"""ctypes bindings for the native host-side batch ops (``batch_ops.cpp``;
counterpart of ``tennis_tpu/native/__init__.py``).

Each C++ source of this directory is compiled on first use with the system
compiler into a shared library under ``tennis_torch/build/``, whose file
name carries a hash of the source (an edited source is rebuilt, a stale
library never loaded); nothing is written beside the sources. A pure-numpy
fallback keeps everything working where no compiler exists; the
``HAVE_NATIVE`` attribute (built on first access) reports which path is
active. This is host code: no device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(os.path.dirname(_HERE), "build")
_SRC = os.path.join(_HERE, "batch_ops.cpp")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")

# library file name -> True where this process compiled it
built: dict[str, bool] = {}
_load_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path(src: str, link: tuple[str, ...] = (),
                 build_dir: str = BUILD) -> str:
    """Where the library of ``src`` lives: ``<build_dir>/lib<stem>-<hash of
    the source, the flags and the link line>.so``."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS + link).encode())
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(build_dir, f"lib{stem}-{digest.hexdigest()[:12]}.so")


def build_shared(src: str, link: tuple[str, ...] = (),
                 build_dir: str = BUILD) -> str | None:
    """The path of ``src``'s library, built unless it exists; None when no
    compiler (or library to link) is there or ``build_dir`` is not
    writable: the caller's fallback then runs.

    Safe under concurrent first use (loader workers, several processes on
    one checkout): the processes that build serialize on ``<lib>.lock``,
    and each compiles to a private temporary file that lands by an atomic
    ``os.replace``, so no process loads half a library and a killed build
    leaves only a stray temporary file."""
    import fcntl

    lib = library_path(src, link, build_dir)
    if os.path.exists(lib):
        return lib
    try:
        os.makedirs(build_dir, exist_ok=True)
        lock = open(lib + ".lock", "w")
    except OSError:
        return None
    with lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(lib):
            return lib  # another process built it while this one waited
        tmp = f"{lib}.tmp.{os.getpid()}"
        try:
            for cc in ("c++", "g++", "clang++"):
                try:
                    subprocess.run([cc, *CXX_FLAGS, src, "-o", tmp, *link],
                                   check=True, capture_output=True)
                except (FileNotFoundError, subprocess.CalledProcessError):
                    continue
                os.replace(tmp, lib)
                built[os.path.basename(lib)] = True
                return lib
            return None
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def load_shared(src: str, link: tuple[str, ...] = ()):
    """``ctypes.CDLL`` of ``src``'s library, built on first use; None where
    it cannot be built or loaded (an unloadable file is removed, so that the
    next process builds it again)."""
    lib = build_shared(src, link)
    if lib is None:
        return None
    try:
        return ctypes.CDLL(lib)
    except OSError:
        try:
            os.remove(lib)
        except OSError:
            pass
        return None


def _load():
    global _lib, _lib_failed
    with _load_lock:
        if _lib is not None or _lib_failed:
            return _lib
        lib = load_shared(_SRC)
        if lib is None:
            _lib_failed = True
            return None
        i64p = ctypes.POINTER(ctypes.c_int64)
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.skipgram_lookup.restype = ctypes.c_int64
        lib.skipgram_lookup.argtypes = [i64p, ctypes.c_int64, i64p, i64p,
                                        ctypes.c_int64, f32p, i64p, i64p,
                                        ctypes.c_int64]
        lib.cbow_lookup.restype = ctypes.c_int64
        lib.cbow_lookup.argtypes = [i64p, i64p, ctypes.c_int64, i64p, i64p,
                                    ctypes.c_int64, f32p, i64p, i64p,
                                    ctypes.c_int64]
        lib.center_context_pairs.restype = ctypes.c_int64
        lib.center_context_pairs.argtypes = [i64p, i64p, ctypes.c_int64,
                                             ctypes.c_int64, ctypes.c_uint64,
                                             i64p, i64p, ctypes.c_int64]
        _lib = lib
        return lib


def __getattr__(name):
    if name == "HAVE_NATIVE":  # built on first access, not at import
        return _load() is not None
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _i64(a):
    return np.ascontiguousarray(a, dtype=np.int64)


def _ptr(a, typ):
    return a.ctypes.data_as(ctypes.POINTER(typ))


def skipgram_lookup(indices, subwordidxs, subwordidxsptr, offset=0):
    """COO (data, row, col) of word+subword units per center row: the
    compiled counterpart of the reference's numba kernel."""
    indices = _i64(indices)
    subwordidxs = _i64(subwordidxs)
    subwordidxsptr = _i64(subwordidxsptr)
    lib = _load()
    if lib is None:
        return _skipgram_lookup_np(indices, subwordidxs, subwordidxsptr, offset)
    n = lib.skipgram_lookup(
        _ptr(indices, ctypes.c_int64), len(indices),
        _ptr(subwordidxs, ctypes.c_int64), _ptr(subwordidxsptr, ctypes.c_int64),
        offset, None, None, None, 0,
    )
    data = np.empty(n, np.float32)
    row = np.empty(n, np.int64)
    col = np.empty(n, np.int64)
    lib.skipgram_lookup(
        _ptr(indices, ctypes.c_int64), len(indices),
        _ptr(subwordidxs, ctypes.c_int64), _ptr(subwordidxsptr, ctypes.c_int64),
        offset, _ptr(data, ctypes.c_float), _ptr(row, ctypes.c_int64),
        _ptr(col, ctypes.c_int64), n,
    )
    return data, row, col


def cbow_lookup(context_row, context_col, subwordidxs, subwordidxsptr, offset=0):
    """COO for CBOW context rows: the compiled counterpart of the
    reference's numba kernel."""
    context_row = _i64(context_row)
    context_col = _i64(context_col)
    subwordidxs = _i64(subwordidxs)
    subwordidxsptr = _i64(subwordidxsptr)
    lib = _load()
    if lib is None:
        return _cbow_lookup_np(context_row, context_col, subwordidxs,
                               subwordidxsptr, offset)
    n = lib.cbow_lookup(
        _ptr(context_row, ctypes.c_int64), _ptr(context_col, ctypes.c_int64),
        len(context_col), _ptr(subwordidxs, ctypes.c_int64),
        _ptr(subwordidxsptr, ctypes.c_int64), offset, None, None, None, 0,
    )
    data = np.empty(n, np.float32)
    row = np.empty(n, np.int64)
    col = np.empty(n, np.int64)
    lib.cbow_lookup(
        _ptr(context_row, ctypes.c_int64), _ptr(context_col, ctypes.c_int64),
        len(context_col), _ptr(subwordidxs, ctypes.c_int64),
        _ptr(subwordidxsptr, ctypes.c_int64), offset,
        _ptr(data, ctypes.c_float), _ptr(row, ctypes.c_int64),
        _ptr(col, ctypes.c_int64), n,
    )
    return data, row, col


def center_context_pairs(sentences, window: int, seed: int = 0):
    """All (center, context) skip-gram pairs with per-position reduced
    windows. ``sentences``: list of int lists. Returns (centers, contexts)
    int64 arrays; the numpy fallback draws its windows from another
    generator, so the two paths give other pairs."""
    tokens = _i64(np.concatenate([np.asarray(s, np.int64) for s in sentences])
                  if sentences else np.zeros(0, np.int64))
    sent_ptr = _i64(np.concatenate([[0], np.cumsum([len(s) for s in sentences])]))
    lib = _load()
    if lib is None:
        return _center_context_pairs_np(sentences, window, seed)
    n = lib.center_context_pairs(
        _ptr(tokens, ctypes.c_int64), _ptr(sent_ptr, ctypes.c_int64),
        len(sentences), window, seed, None, None, 0,
    )
    centers = np.empty(n, np.int64)
    contexts = np.empty(n, np.int64)
    lib.center_context_pairs(
        _ptr(tokens, ctypes.c_int64), _ptr(sent_ptr, ctypes.c_int64),
        len(sentences), window, seed, _ptr(centers, ctypes.c_int64),
        _ptr(contexts, ctypes.c_int64), n,
    )
    return centers, contexts


# ------------------------------------------------------------ numpy fallbacks


def _skipgram_lookup_np(indices, subwordidxs, subwordidxsptr, offset):
    data, row, col = [], [], []
    for i, idx in enumerate(indices):
        start, end = subwordidxsptr[idx], subwordidxsptr[idx + 1]
        w = 1.0 / (1 + end - start)
        row.append(i); col.append(idx); data.append(w)
        for s in subwordidxs[start:end]:
            row.append(i); col.append(s + offset); data.append(w)
    return (np.asarray(data, np.float32), np.asarray(row, np.int64),
            np.asarray(col, np.int64))


def _cbow_lookup_np(context_row, context_col, subwordidxs, subwordidxsptr,
                    offset):
    num_rows = int(context_row.max()) + 1 if len(context_row) else 0
    row_counts = np.bincount(context_row, minlength=num_rows)
    data, row, col = [], [], []
    for r, idx in zip(context_row, context_col):
        start, end = subwordidxsptr[idx], subwordidxsptr[idx + 1]
        w = 1.0 / (1 + end - start) / row_counts[r]
        row.append(r); col.append(idx); data.append(w)
        for s in subwordidxs[start:end]:
            row.append(r); col.append(s + offset); data.append(w)
    return (np.asarray(data, np.float32), np.asarray(row, np.int64),
            np.asarray(col, np.int64))


def _center_context_pairs_np(sentences, window, seed):
    """A window r drawn uniform in [1, window] per position from
    ``default_rng(seed)``, then every neighbour within r."""
    rng = np.random.default_rng(seed)
    centers, contexts = [], []
    for s in sentences:
        s = list(s)
        for t in range(len(s)):
            r = int(rng.integers(1, window + 1))
            for d in range(-r, r + 1):
                if d == 0 or not (0 <= t + d < len(s)):
                    continue
                centers.append(s[t])
                contexts.append(s[t + d])
    return np.asarray(centers, np.int64), np.asarray(contexts, np.int64)
