"""ctypes binding of the port's native host library (csrc/strique_native.cpp).

The port's own copy of ``strique_tpu/native.py``'s preprocessing
binding, over its own copy of the C++ source (the preprocessing half of
``native/strique_native.cpp``).  The library also holds the port's batch
decode of Viterbi paths (:func:`decode_paths`: one call a batch gives
each gated-in read's repeat count and float64 log_p, as the NumPy
``ops.viterbi.count_repeats`` and ``path_logp_f64`` give them, sum for
sum).  The library builds with ``g++`` at
first use into ``build/strique_tpu_torch/`` (gitignored), with
``native/Makefile``'s flags: ``-ffp-contract=off`` keeps the f64
affine ``x*scale + offset`` a separate multiply and add, as NumPy
rounds it (an FMA moves the flt channel by ~1 ulp, and the reported
log_p with it), and keeps the decode's emission terms NumPy's.  It is
rebuilt when the source is newer.  Where no compiler exists,
:func:`available` is False and the counter takes the NumPy host prep
(``ops/signal.py``) and the NumPy decode -- host work either way, not a
device path.  A ctypes call releases the interpreter lock, so the
submit thread runs while the main thread decodes.
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
                i64 = ctypes.c_int64
                vp = ctypes.c_void_p
                lib.decode_paths.argtypes = [i64, vp, i64, vp, vp, i64, *[vp] * 11]
                lib.decode_paths.restype = i64
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


class DecodeTables:
    """One HMM's contiguous host tables for :func:`decode_paths`, built
    once an HMM (the counter caches them); ``log_trans`` is the HMM's own
    float64 matrix, never copied."""

    def __init__(self, chm):
        f64 = lambda a: np.ascontiguousarray(a, dtype=np.float64)
        self.n_states = chm.n_states
        sigma = f64(chm.sigma)
        # path_logp_f64's normal constant, by NumPy's own log, once a state
        self.c = f64(-0.5 * np.log(2 * np.pi * sigma**2))
        self.mu = f64(chm.mu)
        self.sigma = sigma
        self.is_uniform = np.ascontiguousarray(chm.is_uniform, dtype=np.uint8)
        self.log_uni = f64(chm.log_uni)
        self.log_start = f64(chm.log_start)
        self.log_end = f64(chm.log_end)
        self.log_trans = f64(chm.log_trans)
        self.count_states = np.ascontiguousarray(chm.meta["count_states"], dtype=np.int64)
        if self.log_trans.shape != (self.n_states, self.n_states):
            raise ValueError(f"log_trans of shape {self.log_trans.shape} for "
                             f"{self.n_states} states")

    def pointers(self) -> list:
        return [a.ctypes.data for a in (self.c, self.mu, self.sigma, self.is_uniform,
                                        self.log_uni, self.log_start, self.log_end,
                                        self.log_trans, self.count_states)]


def decode_paths(paths, segments, tables: DecodeTables) -> tuple[np.ndarray, np.ndarray]:
    """Count-state visits (int64) and float64 log_p of each row, in one call.

    ``paths[r]``: row r's Viterbi path, at least as long as
    ``segments[r]``, its float64 observations (a view into the read's flt
    channel; every step of it is decoded).  The paths are read as uint8
    where every one is uint8 (the copy to the host of an HMM of up to 256
    states), else as int32.  ``visits[r]`` is ``count_repeats``' sum
    before its offsets; ``log_p[r]`` is ``path_logp_f64(segments[r],
    paths[r], chm)``.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n_rows = len(paths)
    if len(segments) != n_rows:
        raise ValueError("decode_paths: one segment a path")
    paths = [np.asarray(p) for p in paths]
    dtype = np.uint8 if all(p.dtype == np.uint8 for p in paths) else np.int32
    paths = [np.ascontiguousarray(p, dtype=dtype) for p in paths]
    segments = [np.ascontiguousarray(s, dtype=np.float64) for s in segments]
    lens = np.array([len(s) for s in segments], dtype=np.int64)
    if n_rows and (lens.min() < 1 or any(len(p) < n for p, n in zip(paths, lens))):
        raise ValueError("decode_paths: every row needs at least one step, and a path "
                         "as long as its segment")
    path_ptrs = np.array([p.ctypes.data for p in paths], dtype=np.uintp)
    seg_ptrs = np.array([s.ctypes.data for s in segments], dtype=np.uintp)
    visits = np.zeros(n_rows, np.int64)
    log_p = np.zeros(n_rows, np.float64)
    bad = lib.decode_paths(n_rows, path_ptrs.ctypes.data, np.dtype(dtype).itemsize,
                           seg_ptrs.ctypes.data, lens.ctypes.data, tables.n_states,
                           *tables.pointers(), visits.ctypes.data, log_p.ctypes.data)
    if bad >= 0:
        raise IndexError(f"decode_paths: row {bad}'s path holds a state outside "
                         f"[0, {tables.n_states})")
    return visits, log_p
