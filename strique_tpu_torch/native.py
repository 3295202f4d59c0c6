"""ctypes binding of the port's native host prep (csrc/strique_native.cpp).

The port's own copy of ``strique_tpu/native.py``'s preprocessing
binding, over its own copy of the C++ source (the preprocessing half of
``native/strique_native.cpp``).  The library builds with ``g++`` at
first use into ``build/strique_tpu_torch/`` (gitignored), with
``native/Makefile``'s flags: ``-ffp-contract=off`` keeps the f64
affine ``x*scale + offset`` a separate multiply and add, as NumPy
rounds it (an FMA moves the flt channel by ~1 ulp, and the reported
log_p with it).  It is rebuilt when the source is newer.  Where no
compiler exists, :func:`available` is False and the counter takes the
NumPy host prep (``ops/signal.py``) -- host work either way, not a
device path.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

from ._build import CSRC_DIR, build_dir

CXX_FLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-std=c++17", "-fPIC", "-Wall",
             "-shared"]

_lib = None
_tried = False
_lock = threading.Lock()


def _compile() -> str | None:
    src = os.path.join(CSRC_DIR, "strique_native.cpp")
    out = os.path.join(build_dir(), "libstrique_native.so")
    if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
        return out
    os.makedirs(build_dir(), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, "-o", tmp, src], check=True,
                       capture_output=True, timeout=300)
    except (OSError, subprocess.SubprocessError):
        return None
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _tried
    with _lock:
        if _lib is None and not _tried:
            _tried = True
            path = _compile()
            if path is not None:
                lib = ctypes.CDLL(path)
                dp = ctypes.POINTER(ctypes.c_double)
                fp = ctypes.POINTER(ctypes.c_float)
                up = ctypes.POINTER(ctypes.c_uint8)
                lib.preprocess_read_lut.argtypes = [dp, ctypes.c_int64, dp, fp, dp, up, fp]
                lib.preprocess_read_lut.restype = None
                _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def preprocess_read_lut(raw: np.ndarray, model_const: tuple,
                        flt32_out: np.ndarray, q_out: np.ndarray,
                        lut_out: np.ndarray) -> np.ndarray:
    """Native upload-oriented preprocessing.

    Writes flt32 (float32), morph quantization bins (uint8), and the
    256-entry float32 morph level table into the caller's buffers (which
    may be views into a batch upload buffer); returns flt float64 for
    host-side exact log-p computation.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    rawd = np.ascontiguousarray(raw, dtype=np.float64)
    n = len(rawd)
    model = np.asarray(model_const, dtype=np.float64)
    flt64 = np.empty(n, np.float64)
    if not (flt32_out.dtype == np.float32 and flt32_out.flags.c_contiguous
            and q_out.dtype == np.uint8 and q_out.flags.c_contiguous
            and lut_out.dtype == np.float32 and len(lut_out) == 256
            and len(flt32_out) >= n and len(q_out) >= n):
        raise ValueError("preprocess_read_lut: buffers of the wrong type or size")
    lib.preprocess_read_lut(
        rawd.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n,
        model.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        flt32_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        flt64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        q_out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        lut_out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return flt64
