"""ctypes bindings to the native codec library (csrc/libtkq.so).

Built from csrc/tkq.cpp with make at first use (or by ``make -C csrc``) if a
toolchain is present; every entry point degrades to the NumPy reference
implementation when the library is unavailable. See csrc/tkq.cpp for provenance (the reference's C/C++
loader+quant layer equivalent).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path

import numpy as np

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_LIB: ctypes.CDLL | None = None
_TRIED = False

KIND_CODE = {"q4": 4, "q5": 5, "q6": 6, "q8": 8}
GGML_KIND_CODE = {12: 4, 13: 5, 14: 6, 8: 8}  # GGMLType value -> native code


_STATUS = "not tried"


def _build() -> Path | None:
    """Build csrc/libtkq.so from the tracked source (``make -C csrc``) unless
    a build newer than the source is already there. The library is built
    for the machine it runs on (-march=native) and is never committed."""
    global _STATUS
    so = _CSRC / "libtkq.so"
    if so.exists() and so.stat().st_mtime >= (_CSRC / "tkq.cpp").stat().st_mtime:
        return so
    try:
        subprocess.run(
            ["make", "-C", str(_CSRC)], check=True,
            capture_output=True, timeout=300,
        )
    except subprocess.CalledProcessError as e:
        _STATUS = f"build failed: {(e.stderr or b'').decode()[-400:]}"
        return None
    except (OSError, subprocess.TimeoutExpired) as e:
        _STATUS = f"build failed: {e}"
        return None
    return so if so.exists() else None


def native_status() -> str:
    """'loaded' or why the NumPy codecs are in use instead."""
    get_lib()
    return _STATUS


def get_lib() -> ctypes.CDLL | None:
    global _LIB, _TRIED, _STATUS
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    if os.environ.get("TKQ_NO_NATIVE"):
        _STATUS = "disabled by TKQ_NO_NATIVE"
        return None
    so = _build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:
        _STATUS = f"load failed: {e}"
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tkq_repack_kmajor.argtypes = [
        ctypes.c_int, u8p, ctypes.c_int64, ctypes.c_int64,
        u8p, u8p, f32p, f32p, ctypes.c_int,
    ]
    lib.tkq_repack_kmajor.restype = ctypes.c_int
    lib.tkq_dequantize.argtypes = [ctypes.c_int, u8p, f32p, ctypes.c_int64, ctypes.c_int]
    lib.tkq_dequantize.restype = ctypes.c_int
    for q in ("q4k", "q6k", "q80"):
        fn = getattr(lib, f"tkq_quantize_{q}")
        fn.argtypes = [f32p, ctypes.c_int64, u8p, ctypes.c_int]
        fn.restype = ctypes.c_int
    _LIB = lib
    _STATUS = "loaded"
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32(a: np.ndarray | None):
    if a is None:
        return ctypes.cast(None, ctypes.POINTER(ctypes.c_float))
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def repack_kmajor_native(kind: str, raw: np.ndarray, N: int, K: int) -> dict | None:
    """Native kmajor repack; returns arrays dict or None if unsupported."""
    lib = get_lib()
    code = KIND_CODE.get(kind)
    if lib is None or code is None:
        return None
    g = 16 if kind == "q6" else 32
    qs = np.zeros((K if kind == "q8" else K // 2, N), np.uint8)
    qh = None
    if kind == "q5":
        qh = np.zeros((K // 8, N), np.uint8)
    elif kind == "q6":
        qh = np.zeros((K // 4, N), np.uint8)
    scales = np.empty((K // g, N), np.float32)
    mins = None if kind == "q8" else np.empty((K // g, N), np.float32)
    raw = np.ascontiguousarray(raw)
    rc = lib.tkq_repack_kmajor(
        code, _u8(raw), N, K, _u8(qs),
        _u8(qh) if qh is not None else ctypes.cast(None, ctypes.POINTER(ctypes.c_uint8)),
        _f32(scales), _f32(mins), 0,
    )
    if rc != 0:
        return None
    out = {"qs": qs.view(np.int8) if kind == "q8" else qs, "scales": scales}
    if qh is not None:
        out["qh"] = qh
    if mins is not None:
        out["mins"] = mins
    return out


def quantize_native(x: np.ndarray, ggml_type_value: int) -> np.ndarray | None:
    """Native quantize for Q4_K / Q6_K / Q8_0; None if unsupported."""
    lib = get_lib()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, np.float32)
    n = x.size
    if ggml_type_value == 12 and n % 256 == 0:  # Q4_K
        out = np.empty(n // 256 * 144, np.uint8)
        rc = lib.tkq_quantize_q4k(_f32(x), n, _u8(out), 0)
    elif ggml_type_value == 14 and n % 256 == 0:  # Q6_K
        out = np.empty(n // 256 * 210, np.uint8)
        rc = lib.tkq_quantize_q6k(_f32(x), n, _u8(out), 0)
    elif ggml_type_value == 8 and n % 32 == 0:  # Q8_0
        out = np.empty(n // 32 * 34, np.uint8)
        rc = lib.tkq_quantize_q80(_f32(x), n, _u8(out), 0)
    else:
        return None
    return out if rc == 0 else None


def dequantize_native(ggml_type_value: int, raw: np.ndarray, nelem: int) -> np.ndarray | None:
    lib = get_lib()
    code = GGML_KIND_CODE.get(ggml_type_value)
    if lib is None or code is None:
        return None
    out = np.empty(nelem, np.float32)
    raw = np.ascontiguousarray(raw)
    rc = lib.tkq_dequantize(code, _u8(raw), _f32(out), nelem, 0)
    return out if rc == 0 else None
