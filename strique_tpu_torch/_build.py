"""Build and bind the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file compiles with ``nvcc`` (one process per file,
all started together) and links into ONE shared library with a plain C
interface, loaded through ``ctypes`` (pointers and the CUDA stream
travel as ``c_void_p``).  No PyTorch headers are included,
so a cold build takes seconds, not the minutes of
``torch.utils.cpp_extension.load``.

  * The library lands in ``build/strique_tpu_torch/`` beside the
    package and is rebuilt whenever a source is newer than it.
  * ``-fmad=false`` keeps every ``a + b*c`` as a separate rounded
    multiply and add, matching the reference's uncontracted f32
    expression trees (the native host build pins ``-ffp-contract=off``
    for the same reason); fast-math is never used.
  * Each C entry point returns ``cudaGetLastError()``; :func:`launch`
    raises on a non-zero code.  Kernels launch on PyTorch's current
    stream of the tensors' device and never synchronise.

``LAUNCHES`` counts kernel launches per wrapper: a wrapper adds one
exactly where it launches its kernel, so a run can show that the main
path went through the kernels (chip_smoke.py reads it).
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xcompiler", "-fPIC"]

LAUNCHES = {
    "align_forward_wave": 0,
    "align_forward_wave_multi": 0,
    "align_forward_wave_table": 0,  # the same kernels, TABLE score mode
    "align_forward_wave_multi_table": 0,
    "align_forward_wave_cluster": 0,  # TABLE mode on a cluster of CTAs a row
    "align_forward_wave_multi_cluster": 0,
    "align_forward_ckpt": 0,
    "align_window_from_state": 0,
    "align_forward_ckpt_table": 0,  # rows 5-6, TABLE score mode
    "align_window_from_state_table": 0,
    "align_forward_ckpt_cluster": 0,  # rows 5-6, TABLE mode on a cluster
    "align_window_from_state_cluster": 0,
    "align_forward_col": 0,
    "align_forward_col_table": 0,  # the column kernel, TABLE score mode
    "align_forward_col_cluster": 0,  # ... on a cluster of CTAs a row
    "traceback_pointers": 0,
    "traceback_pointers_col": 0,  # the same wrapper, column layout
    "viterbi_forward_factored": 0,
    "viterbi_forward_factored_diag": 0,  # the same wrapper, diagonal-only slot layout
    "viterbi_forward_factored_cluster": 0,  # the cluster form (SP past 1024), each layout
    "viterbi_forward_factored_diag_cluster": 0,
    "viterbi_forward_dense_resident": 0,  # the dense forward's modes (dense_mode)
    "viterbi_forward_dense_slice": 0,
    "viterbi_forward_dense_stream": 0,
    "viterbi_backward_batch": 0,
    "viterbi_backward_wide": 0,  # the same wrapper, the wide variant (SP past 1024)
}

_lib = None
_lock = threading.Lock()
BUILD_INFO: dict = {}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C signatures of the entry points (see the csrc/*.cu headers)
_SIGNATURES = {
    # sig, tmpl, nact, mrow, ptr, bottom; B, N, MP, tmpl_stride, neg_h;
    # go_h, go_v, ge_h, ge_v, off, dmin, g; stream
    "wave_align_launch": [_P] * 6 + [_I] * 5 + [_F] * 7 + [_P],
    # K, MPC -> the clusters of K CTAs of MPC lanes the card runs at once
    # (a query, not a launch: no stream)
    "wave_cluster_capacity": [_I] * 2,
    # bins, lut, levels, lidx, nact, mrow, ptr, bottom; B, N, MP, UP,
    # per_row, ctas, mpc, neg_h; go_h, go_v, ge_h, ge_v, off, dmin, g;
    # stream
    "wave_table_launch": [_P] * 8 + [_I] * 8 + [_F] * 7 + [_P],
    # sig, tmpl, nact, mrow, bottom, ck_s1, ck_s2, ck_ih, ck_c; B, N, MP,
    # tmpl_stride, ckpt_steps, neg_h; go_h, go_v, ge_h, ge_v, off, dmin,
    # g; stream
    "wave_ckpt_launch": [_P] * 9 + [_I] * 6 + [_F] * 7 + [_P],
    # bins, lut, levels, lidx, nact, mrow, bottom, ck_s1, ck_s2, ck_ih,
    # ck_c; B, NB, ND, MP, UP, per_row, ctas, mpc, ckpt_steps, neg_h;
    # go_h, go_v, ge_h, ge_v, off, dmin, g; stream
    "wave_ckpt_table_launch": [_P] * 11 + [_I] * 10 + [_F] * 7 + [_P],
    # sig_win, r_init, tmpl, steps, s1, s2, ih, c, cold, ptr; B, W, MP,
    # tmpl_stride, neg_h; go_h, go_v, ge_h, ge_v, off, dmin, g; stream
    "wave_window_launch": [_P] * 10 + [_I] * 5 + [_F] * 7 + [_P],
    # bins, lut, levels, lidx, t0, steps, s1, s2, ih, c, cold, ptr; B, NB,
    # W, MP, UP, per_row, ctas, mpc, neg_h; go_h, go_v, ge_h, ge_v, off,
    # dmin, g; stream
    "wave_window_table_launch": [_P] * 12 + [_I] * 9 + [_F] * 7 + [_P],
    # sig, tmpl, nact, ptr, bottom; B, N, MP, m, neg_h;
    # go_h, go_v, ge_h, ge_v, off, dmin, g; stream
    "col_align_launch": [_P] * 5 + [_I] * 5 + [_F] * 7 + [_P],
    # bins, lut, levels, lidx, nact, ptr, bottom; B, N, MP, UP, ctas,
    # mpc, m, neg_h; go_h, go_v, ge_h, ge_v, off, dmin, g; stream
    "col_table_launch": [_P] * 7 + [_I] * 8 + [_F] * 7 + [_P],
    # K, MPC -> the clusters of K CTAs of MPC lanes the card runs at once
    # (a query, not a launch: no stream)
    "col_cluster_capacity": [_I] * 2,
    # ptr, j_end, m_start, is_gap, jpos, j_begin; B, MP, m_out, col; stream
    "traceback_launch": [_P] * 6 + [_I] * 4 + [_P],
    # obs, tact, start, mu, sigma, uni, luni, lsig, src, w, ramp, counts
    # (host), sc, fin, acc; B, T, SP, layout; stream
    "viterbi_fwd_launch": [_P] * 15 + [_I] * 4 + [_P],
    # the same, then C (CTAs a read)
    "viterbi_fwd_cluster_launch": [_P] * 15 + [_I] * 5 + [_P],
    # SP, layout, C -> the clusters of C CTAs a read the card runs at once
    # (a query, not a launch: no stream)
    "viterbi_fwd_cluster_capacity": [_I] * 3,
    # obs, tact, trans, start, mu, sigma, uni, luni, lsig, sc, fin, acc;
    # B, T, SP, K (CTAs a read); stream
    "viterbi_dense_resident_launch": [_P] * 12 + [_I] * 4 + [_P],
    # the same, then slice (0 or 1)
    "viterbi_dense_stream_launch": [_P] * 12 + [_I] * 5 + [_P],
    # sc, transT, last, tact, path; B, T, SP; stream
    "viterbi_bwd_launch": [_P] * 5 + [_I] * 3 + [_P],
    "viterbi_bwd_wide_launch": [_P] * 5 + [_I] * 3 + [_P],
}


def build_dir() -> str:
    return os.path.join(os.path.dirname(_PKG_DIR), "build", "strique_tpu_torch")


def _sources() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cu"))


def _headers() -> list[str]:
    return sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                  if f.endswith(".cuh"))


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return cand if os.path.exists(cand) else "nvcc"


def build(force: bool = False) -> str:
    """Compile csrc/*.cu into the shared library if stale; return its path.

    One ``nvcc -c`` per source, all started together, then one link.
    """
    out_dir = build_dir()
    lib_path = os.path.join(out_dir, "libstrique_torch_kernels.so")
    srcs = _sources()
    newest = max(os.path.getmtime(p) for p in srcs + _headers())
    if force or not os.path.exists(lib_path) or os.path.getmtime(lib_path) < newest:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{os.getpid()}.tmp"
        objs = [os.path.join(out_dir, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
        procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o, s],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(srcs, objs)]
        logs = [p.communicate()[0] for p in procs]
        BUILD_INFO["ptxas"] = "".join(logs)
        failed = [(s, p.returncode, log) for s, p, log in zip(srcs, procs, logs) if p.returncode]
        if not failed:
            tmp = f"{lib_path}.{tag}"
            link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs], capture_output=True,
                                  text=True)
            if link.returncode:
                failed = [("link", link.returncode, link.stderr)]
            else:
                os.replace(tmp, lib_path)
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{os.path.basename(s)} ({rc}):\n{log}" for s, rc, log in failed))
        BUILD_INFO["built"] = True
    else:
        BUILD_INFO.setdefault("built", False)
    return lib_path


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            handle = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(handle, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = handle
    return _lib


def launch(name: str, device, *args) -> None:
    """Call C entry point ``name`` with ``args`` on ``device``'s current
    stream (the device made current for the launch); raise on an error."""
    import torch

    with torch.cuda.device(device):
        err = getattr(lib(), name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
