"""Lazily-built native helpers (C, via ctypes).

`lib()` returns the loaded shared library or None when no C compiler is
available — callers keep a numpy fallback.  The build is one `cc -O3
-shared` invocation, cached in ~/.cache/fibers_tpu_torch keyed by source
hash, so installs stay pure-Python and the first call on a new machine
pays ~1 s once.  (A copy of fibers_tpu/native/__init__.py with its own
cache directory.)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_SRC = os.path.join(os.path.dirname(__file__), "packio.c")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    with open(_SRC, "rb") as f:
        src = f.read()
    tag = hashlib.sha256(src).hexdigest()[:16]
    cache = os.environ.get(
        "FIBERS_NATIVE_CACHE",
        os.path.join(os.path.expanduser("~"), ".cache", "fibers_tpu_torch"))
    os.makedirs(cache, exist_ok=True)
    so = os.path.join(cache, f"packio-{tag}.so")
    if os.path.exists(so):
        return so
    cc = os.environ.get("CC", "cc")
    tmp = so + f".tmp.{os.getpid()}"
    base = [cc, "-O3", "-shared", "-fPIC", "-o", tmp, _SRC]
    try:
        # OpenMP when available (gcc/clang); plain build as fallback
        subprocess.run(base + ["-fopenmp"], check=True,
                       capture_output=True, timeout=120)
    except Exception:
        try:
            subprocess.run(base, check=True, capture_output=True,
                           timeout=120)
        except Exception:
            return None
    os.replace(tmp, so)
    return so


def lib():
    """The loaded native library, or None (numpy fallbacks apply)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("FIBERS_NO_NATIVE") == "1":
            return None
        so = _build()
        if so is None:
            return None
        try:
            cdll = ctypes.CDLL(so)
        except OSError:
            return None

        cdll.pack_trk_records.argtypes = [
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        cdll.pack_trk_records.restype = None

        cdll.unpack_trk_records.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
        ]
        cdll.unpack_trk_records.restype = ctypes.c_int64

        cdll.decode_delta_lines.argtypes = [
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
        ]
        cdll.decode_delta_lines.restype = None

        cdll.decode_delta_trk_records.argtypes = [
            ctypes.POINTER(ctypes.c_int8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        cdll.decode_delta_trk_records.restype = None

        cdll.decode_delta6_trk_records.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
        ]
        cdll.decode_delta6_trk_records.restype = None

        cdll.unpack_sext6.argtypes = [
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int8),
        ]
        cdll.unpack_sext6.restype = None

        cdll.gather_quant_u16.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        cdll.gather_quant_u16.restype = None

        cdll.gather_quant_u8.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        cdll.gather_quant_u8.restype = None

        cdll.gather_quant_u12.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        cdll.gather_quant_u12.restype = None

        cdll.gather_rows_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float),
        ]
        cdll.gather_rows_f32.restype = None

        cdll.rumba_signal_u16.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint16),
        ]
        cdll.rumba_signal_u16.restype = None

        cdll.rumba_signal_u12.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8),
        ]
        cdll.rumba_signal_u12.restype = None

        _lib = cdll
        return _lib


def as_f32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def as_i32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def as_i64_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def as_i8_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))


def as_u16_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16))


def as_u8_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def as_u32_ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))
