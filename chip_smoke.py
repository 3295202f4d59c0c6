#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and run its counting path on one GPU.

    python3 chip_smoke.py [--seed S] [--out results.json]

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Print the card's name and its ``nvidia-smi`` name and power limit;
   exit non-zero when CUDA is unavailable.
2. Build every kernel of ``strique_tpu_torch/csrc`` (nvcc) and print
   the build seconds.
3. Hold each kernel against its plain PyTorch twin on the card, at a
   small random shape and at the bench shape (64 rows, npad 24576,
   MP 896; Viterbi T 6144, SP 256): integer outputs exactly equal, f32
   outputs bit-equal (max_abs_err 0).  The two-pass kernels run at
   B=8: N=4096, M=40, ckpt_steps 512 (cold and warm windows) and the
   bench template at N=24576, ckpt_steps 16384; bottom taps, written
   checkpoint slots and written pointer words equal.  The Viterbi pair
   also runs at the ultra-long segment length (B=8, T 55296).  The
   column-sweep kernel and its column-layout traceback run at the small
   and bench shapes (64 rows, N 24576, MP 896), the dense Viterbi
   forward at the small, bench (B 64, T 6144, SP 256) and ultra shapes.
   Print kernel and plain times.
4. Count the c9orf72 repeat (100 units) in 128 noisy '+' reads of
   ~22k samples, through detect_submit -> detect_middle ->
   detect_finish in batches of 64, then 24 '-' reads (a partial batch:
   the fused per-row-template wave route), with a seeded synthetic
   6-mer pore model.  Every count must be exact, every kernel of the
   split path must have launched in this phase, and the first 8 '+'
   results must equal the port's plain CPU path.  Print reads/s beside
   the card's power limit.
4b. The ultra-long route: 8 noisy '+' reads of ~1.1M samples with 1200
   units through the same counter, once with ``STRIQUE_PTR_BUDGET_GB=2``
   (the bucket's ~4.7 GB width-8 plane does not fit: the two-pass
   kernels run, the one-pass wave kernel must not) and once with 8 (the
   one-pass route at 8 rows a call).  Counts 8/8 exact on both routes,
   and the two routes' result tuples equal.  Print each route's seconds.
4c. One more pass of each path under torch.profiler: wall time, device
   time by kernel and the busy share.
4d. The knob routes: the '+' and '-' passes of phase 4 once under
   ``STRIQUE_ALIGN_KERNEL=col`` (column kernel and column traceback on
   the '+' batches; the '-' partial batch stays on the fused wave
   kernel, as in the reference) and once under
   ``STRIQUE_DENSE_VITERBI=1`` (dense forward instead of the factored
   one), each with a fresh counter so its HMM cache sees the knob.
   Counts exact, result tuples equal to phase 4's, the knob's kernels
   launched and the ones it replaces not; reads/s of each route, and one
   profiled '+' pass of each.
5. Print the kernel table as one JSON line (per kernel: launches on its
   path, max_abs_err against its twin, ms, plain_ms, the bound of
   ``bound()`` and library_ms), then the final
   ``{"ok": true, "device": ...}`` line.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPEATS = 100
BATCH = 64
ULTRA_REPEATS = 1200
ULTRA_T = 55296  # Viterbi segment length of an ultra-long read, padded to 512

# published peaks of one H100 SXM (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # FP32 outside the tensor cores
F64_OPS_PER_S = 34e12  # FP64 outside the tensor cores
# f32 operations per DP cell, counted from wave_align.cu's expression
# tree (pointer modes; the score-only pass drops the 6 of the pointer
# code); col_align.cu's tree counts the same 23 (its prefix max takes
# the place of the running column max); the f64 |d|^1.2 counts as 2 FP64 operations (a log and an exp,
# a lower bound of pow's cost)
WAVE_F32_PER_CELL = 23
CKPT_F32_PER_CELL = 17
POW_F64_PER_CELL = 2

SPLIT_KERNELS = ("align_forward_wave", "align_forward_wave_multi", "traceback_pointers",
                 "viterbi_forward_factored", "viterbi_backward_batch")
KNOBS = {"col": ("STRIQUE_ALIGN_KERNEL", "col"), "dense": ("STRIQUE_DENSE_VITERBI", "1")}
SOURCES = {
    "align_forward_wave": ("strique_tpu_torch/csrc/wave_align.cu",
                           "strique_tpu/ops/align_pallas.py:639"),
    "align_forward_wave_multi": ("strique_tpu_torch/csrc/wave_align.cu",
                                 "strique_tpu/ops/align_pallas.py:684"),
    "align_forward_ckpt": ("strique_tpu_torch/csrc/wave_align.cu",
                           "strique_tpu/ops/align_pallas.py:788"),
    "align_window_from_state": ("strique_tpu_torch/csrc/wave_align.cu",
                                "strique_tpu/ops/align_pallas.py:834"),
    "traceback_pointers": ("strique_tpu_torch/csrc/traceback.cu",
                           "strique_tpu/ops/align.py:235"),
    "viterbi_forward_factored": ("strique_tpu_torch/csrc/viterbi_fwd.cu",
                                 "strique_tpu/ops/viterbi_pallas.py:470"),
    "viterbi_backward_batch": ("strique_tpu_torch/csrc/viterbi_bwd.cu",
                               "strique_tpu/ops/viterbi_pallas.py:308"),
    "align_forward_col": ("strique_tpu_torch/csrc/col_align.cu",
                          "strique_tpu/ops/align_pallas.py:322"),
    "traceback_pointers_col": ("strique_tpu_torch/csrc/traceback.cu",
                               "strique_tpu/ops/align.py:235"),
    "viterbi_forward_dense": ("strique_tpu_torch/csrc/viterbi_dense.cu",
                              "strique_tpu/ops/viterbi_pallas.py:183"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def once_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rates of their types, whichever is larger
    (no PyTorch call computes these functions: library_ms is null)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def wave_cells(n_act, m_rows) -> float:
    """DP cells the inputs need: sum over rows of n * m."""
    return float((n_act.double() * m_rows.double()).sum())


def valid_ptr_mask(n_act, m_rows, nwords):
    """(ND/8, B) mask of pointer words a row's kernel writes (t < n + m, in 8s)."""
    import torch

    words = (n_act.to(torch.int64) + m_rows.to(torch.int64) + 7) // 8
    q = torch.arange(nwords, device=n_act.device)[:, None]
    return q < words[None, :]


def check_wave(pm_templates, shape_name, B, N, params, multi, rng, results):
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align_cuda as AC

    dev = torch.device("cuda")
    t_pre, t_suf = pm_templates
    sig = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for b in range(B):
        t = t_pre if (not multi or b < B // 2) else t_suf
        st = int(rng.integers(0, max(1, N // 2 - len(t))))
        sig[b, st : st + len(t)] = t + rng.normal(0, 1.0, len(t)).astype(np.float32)
    na = rng.integers(N // 2, N + 1, B).astype(np.int32)
    if multi:
        rows, ms = AC.pad_template_rows([t_pre, t_suf])
        tmpl = np.concatenate([np.repeat(rows[0:1], B // 2, 0), np.repeat(rows[1:2], B - B // 2, 0)])
        mr = np.concatenate([np.full(B // 2, ms[0], np.int32), np.full(B - B // 2, ms[1], np.int32)])
    else:
        tmpl, m = AC.pad_template(t_pre)
        mr = np.full(B, m, np.int32)
    s_d = torch.from_numpy(sig).to(dev)
    n_d = torch.from_numpy(na).to(dev)
    t_d = torch.from_numpy(tmpl).to(dev)
    m_d = torch.from_numpy(mr).to(dev)
    if multi:
        run_k = lambda: AC.align_forward_wave_multi(s_d, n_d, t_d, m_d, params)
        run_p = lambda: AC._wave_plain(s_d, t_d, n_d, m_d, params)
        name = "align_forward_wave_multi"
    else:
        run_k = lambda: AC.align_forward_wave(s_d, n_d, t_d, params, int(mr[0]))
        run_p = lambda: AC._wave_plain(s_d, t_d, n_d, m_d, params)
        name = "align_forward_wave"
    (ptr_k, bot_k), _ = once_ms(run_k)
    (ptr_p, bot_p), plain_ms = once_ms(run_p)
    mask = valid_ptr_mask(n_d, m_d, ptr_k.shape[0])
    ptr_eq = bool(torch.equal(ptr_k[mask], ptr_p[mask]))
    bot_err = float((bot_k.double() - bot_p.double()).abs().max())
    ok = ptr_eq and bot_err == 0.0
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES[name] = 0
    print(f"  {name} [{shape_name} B={B} N={N} MP={tmpl.shape[1]}]: pointers "
          f"{'equal' if ptr_eq else 'DIFFER'}, bottom max_abs_err {bot_err}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    if not ok:
        fail(f"{name} disagrees with its plain twin at the {shape_name} shape")
    cells = wave_cells(n_d, m_d)
    nbytes = (4 * (sig.size + tmpl.size) + 8 * B + 4 * int(mask.sum()) * tmpl.shape[1]
              + 4 * bot_k.numel())
    results[name] = {"max_abs_err": bot_err, "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, WAVE_F32_PER_CELL * cells, POW_F64_PER_CELL * cells)}
    return ptr_k, bot_k, n_d, m_d


def check_traceback(ptr, j_end, m_d, shape_name, results, col=False):
    """The traceback of a diagonal (wave) or, with ``col``, a column plane
    against its twin, walking back from ``j_end``."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL

    B = j_end.shape[0]
    m_out = int(m_d.max())
    name = "traceback_pointers_col" if col else "traceback_pointers"
    run_k = lambda: AL.traceback_pointers(ptr, j_end, m_out, packed=True if col else "diag",
                                          m_start=m_d)
    run_p = lambda: AL._traceback_plain(ptr, j_end, m_d, m_out, col=col)
    got, _ = once_ms(run_k)
    ref, plain_ms = once_ms(run_p)
    err = 0
    for k in ("is_gap", "jpos", "j_begin"):
        err = max(err, int((got[k].to(torch.int64) - ref[k].to(torch.int64)).abs().max()))
    ms = cuda_ms(run_k, 5)
    _build.LAUNCHES[name] = 0
    print(f"  {name} [{shape_name} B={B}]: max_abs_err {err}; kernel {ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms", flush=True)
    if err != 0:
        fail(f"{name} kernel disagrees with its plain twin at the {shape_name} shape")
    # the walk reads one pointer word per step: m + (j_end - j_begin) steps a row
    steps = float((m_d.double() + (j_end - got["j_begin"]).double()).sum())
    nbytes = 4 * steps + B * m_out * 5 + 4 * B + 8 * B
    results[name] = {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms,
                     **bound(nbytes, 10 * steps)}


def check_col(template, shape_name, B, N, params, rng, results):
    """The column kernel (row 8) against its twin, then the column-layout
    traceback on the plane it wrote."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC

    dev = torch.device("cuda")
    sig = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for b in range(B):
        st = int(rng.integers(0, max(1, N // 2 - len(template))))
        sig[b, st : st + len(template)] = template + rng.normal(0, 1.0, len(template))
    tmpl, m = AC.pad_template(template)
    s_d = torch.from_numpy(sig).to(dev)
    n_d = torch.from_numpy(rng.integers(N // 2, N + 1, B).astype(np.int32)).to(dev)
    t_d = torch.from_numpy(tmpl).to(dev)
    m_d = torch.full((B,), m, dtype=torch.int32, device=dev)
    run_k = lambda: AC.align_forward_col(s_d, n_d, t_d, params, m)
    (ptr_k, bot_k), _ = once_ms(run_k)
    (ptr_p, bot_p), plain_ms = once_ms(lambda: AC._col_plain(s_d, t_d, n_d, params, m))
    mask = valid_ptr_mask(n_d, torch.zeros_like(n_d), ptr_k.shape[0])  # (j-1)//8 < ceil(n/8)
    ptr_eq = bool(torch.equal(ptr_k[mask], ptr_p[mask]))
    bot_err = float((bot_k.double() - bot_p.double()).abs().max())
    del ptr_p, bot_p
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES["align_forward_col"] = 0
    print(f"  align_forward_col [{shape_name} B={B} N={N} MP={tmpl.shape[1]}]: pointers "
          f"{'equal' if ptr_eq else 'DIFFER'}, bottom max_abs_err {bot_err}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    if not (ptr_eq and bot_err == 0.0):
        fail(f"align_forward_col disagrees with its plain twin at the {shape_name} shape")
    cells = wave_cells(n_d, m_d)
    nbytes = (4 * (sig.size + tmpl.size) + 4 * B + 4 * int(mask.sum()) * tmpl.shape[1]
              + 4 * bot_k.numel())
    results["align_forward_col"] = {"max_abs_err": bot_err, "ms": ms, "plain_ms": plain_ms,
                                    **bound(nbytes, WAVE_F32_PER_CELL * cells,
                                            POW_F64_PER_CELL * cells)}
    b0 = torch.full((B, 1), float(AL._b0(params, m)), device=dev)
    j_end = torch.argmax(torch.cat([b0, bot_k], dim=1), dim=1).to(torch.int32)
    check_traceback(ptr_k, j_end, m_d, shape_name, results, col=True)


def viterbi_inputs(pm, B, T, rng, repeats):
    """(B, T) noisy c9orf72 segments of repeats/2..repeats units, and their lengths."""
    import numpy as np
    import torch

    from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX

    obs = np.zeros((B, T), np.float32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(max(1, repeats // 2), repeats + 1))
        s = pm.generate_signal(PREFIX[-50:] + REPEAT * n + SUFFIX[:50], samples=8, noise=True,
                               rng=rng).astype(np.float32)[:T]
        obs[b, : len(s)] = s
        lens[b] = len(s)
    dev = torch.device("cuda")
    return torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev)


def check_dense(pm, chm, shape_name, B, T, rng, results, repeats=REPEATS):
    """The dense Viterbi forward (row 7) against its twin; rows below
    each read's length, fin and acc."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import viterbi_cuda as VC

    ph = VC.PaddedHMM(chm, torch.device("cuda"))
    o_d, l_d = viterbi_inputs(pm, B, T, rng, repeats)
    run_k = lambda: VC.viterbi_forward_dense(o_d, l_d, ph)
    (sc_k, fin_k, acc_k), _ = once_ms(run_k)
    (sc_p, fin_p, acc_p), plain_ms = once_ms(lambda: VC._fwd_dense_plain(o_d, l_d, ph))
    live = torch.arange(T, device=o_d.device)[:, None] < l_d[None, :]
    err = max(float((sc_k[live] - sc_p[live]).abs().max()),
              float((fin_k - fin_p).abs().max()), float((acc_k - acc_p).abs().max()))
    del sc_p
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES["viterbi_forward_dense"] = 0
    print(f"  viterbi_forward_dense [{shape_name} B={B} T={T} SP={ph.sp}]: max_abs_err {err}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    if err != 0.0:
        fail(f"dense forward kernel disagrees with its plain twin at the {shape_name} shape")
    sp = ph.sp
    steps = float(l_d.double().sum())
    # per step and state pair an add and a max; per state 8 for the
    # emission and the row-max rescale
    f32 = steps * (2 * sp * sp + 8 * sp)
    nbytes = 4 * (B * T + sp * sp + 6 * sp + steps * sp + B * sp + 2 * B)
    results["viterbi_forward_dense"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                        **bound(nbytes, f32)}


def check_viterbi(pm, chm, shape_name, B, T, rng, results, repeats=REPEATS):
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import viterbi_cuda as VC

    dev = torch.device("cuda")
    ph = VC.PaddedHMM(chm, dev)
    o_d, l_d = viterbi_inputs(pm, B, T, rng, repeats)
    (sc_k, fin_k, acc_k), _ = once_ms(lambda: VC.viterbi_forward_factored(o_d, l_d, ph))
    (sc_p, fin_p, acc_p), plain_ms = once_ms(lambda: VC._fwd_plain(o_d, l_d, ph))
    live = torch.arange(T, device=dev)[:, None] < l_d[None, :]
    err = max(float((sc_k[live] - sc_p[live]).abs().max()),
              float((fin_k - fin_p).abs().max()), float((acc_k - acc_p).abs().max()))
    ms = cuda_ms(lambda: VC.viterbi_forward_factored(o_d, l_d, ph), 3)
    _build.LAUNCHES["viterbi_forward_factored"] = 0
    print(f"  viterbi_forward_factored [{shape_name} B={B} T={T} SP={ph.sp}]: "
          f"max_abs_err {err}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    if err != 0.0:
        fail(f"factored forward kernel disagrees with its plain twin at the {shape_name} shape")
    sp = ph.sp
    live_cells = float(l_d.double().sum()) * sp
    diag_offs, chain_spec = ph.fspec
    n_rolls = len(diag_offs) + sum(len(a) + len(b) for a, b in chain_spec)
    # per (step, state): an add and a max per roll, 3 per chain (ramp in,
    # cummax, ramp out), 8 for the emission and the row-max rescale
    f32 = live_cells * (2 * n_rolls + 3 * len(chain_spec) + 8)
    nbytes = 4 * (B * T + live_cells + B * sp + B) + 4 * (n_rolls + len(chain_spec) + 5) * sp
    results["viterbi_forward_factored"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           **bound(nbytes, f32)}

    last = torch.argmax(fin_k + ph.end, dim=1)
    run_k = lambda: VC.viterbi_backward_batch(sc_k, last, l_d, ph.transT)
    path_k, _ = once_ms(run_k)
    path_p, plain_ms = once_ms(lambda: VC._bwd_plain(sc_k, last, l_d, ph.transT))
    perr = int((path_k.to(torch.int64) - path_p.to(torch.int64)).abs().max())
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES["viterbi_backward_batch"] = 0
    print(f"  viterbi_backward_batch [{shape_name} B={B} T={T}]: max_abs_err {perr}; "
          f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    if perr != 0:
        fail(f"backward kernel disagrees with its plain twin at the {shape_name} shape")
    # one score row and one transition row per visited step; 3 f32 ops a state
    nbytes = 4 * (live_cells + sp * sp + B * T + 2 * B)
    results["viterbi_backward_batch"] = {"max_abs_err": float(perr), "ms": ms,
                                         "plain_ms": plain_ms, **bound(nbytes, 3 * live_cells)}


def written_slots(n_act, m: int, nd: int, ckpt_steps: int):
    """(n_ck, B) mask of the checkpoint slots a row's pass 1 writes (it
    stops at round_up(n + m, 8))."""
    import torch

    stop = torch.clamp_max((n_act.to(torch.int64) + m + 7) // 8 * 8, nd)
    g = torch.arange(nd // ckpt_steps, device=n_act.device)[:, None]
    return (g + 1) * ckpt_steps <= stop[None, :]


def check_longread(template, shape_name, B, N, params, ckpt_steps, cold_rows, rng, results):
    """Kernel rows 5 and 6 against their twins on one pass-1 state.

    Rows < ``cold_rows`` carry the template near the signal's start
    (their pass-2 window starts cold when the span bound allows it), the
    others in its second half.
    """
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC

    dev = torch.device("cuda")
    m = len(template)
    sig = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for b in range(B):
        lo, hi = (0, min(600, N - m)) if b < cold_rows else (N // 2, N - m)
        st = int(rng.integers(lo, max(lo + 1, hi)))
        sig[b, st : st + m] = template + rng.normal(0, 1.0, m).astype(np.float32)
    n_d = torch.from_numpy(rng.integers(N - N // 8, N + 1, B).astype(np.int32)).to(dev)
    st = AL._longread_pass1(torch.from_numpy(sig).to(dev), n_d, template, params, ckpt_steps)
    cks, mp, nd = st["ckpt_steps"], st["mp"], st["N"] + st["mp"]
    m_rows = torch.full((B,), st["m"], dtype=torch.int32, device=dev)
    run_k = lambda: AC.align_forward_ckpt(st["sig"], n_d, st["tmpl"], params, st["m"],
                                          cks // AC.CHUNK)
    (bot_k, ck_k), _ = once_ms(run_k)
    (bot_p, ck_p), plain_ms = once_ms(
        lambda: AC._ckpt_plain(st["sig"], st["tmpl"], n_d, m_rows, params, cks))
    slots = written_slots(n_d, st["m"], nd, cks)
    bot_err = float((bot_k.double() - bot_p.double()).abs().max())
    ck_eq = all(torch.equal(a[slots], b[slots]) for a, b in zip(ck_k, ck_p))
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES["align_forward_ckpt"] = 0
    print(f"  align_forward_ckpt [{shape_name} B={B} N={st['N']} MP={mp} ckpt_steps={cks}]: "
          f"{int(slots.sum())} written slots {'equal' if ck_eq else 'DIFFER'}, bottom "
          f"max_abs_err {bot_err}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms", flush=True)
    if not (ck_eq and bot_err == 0.0):
        fail(f"align_forward_ckpt disagrees with its plain twin at the {shape_name} shape")
    cells = wave_cells(n_d, m_rows)
    nbytes = 4 * (st["sig"].numel() + mp + 2 * B + bot_k.numel() + 4 * int(slots.sum()) * mp)
    results["align_forward_ckpt"] = {"max_abs_err": bot_err, "ms": ms, "plain_ms": plain_ms,
                                     **bound(nbytes, CKPT_F32_PER_CELL * cells,
                                             POW_F64_PER_CELL * cells)}

    w = AL.window_inputs(st)
    n_cold = int(w["cold"].sum())
    args = (w["sig_win"], w["r_init"], w["state4"], w["cold"], w["steps_needed"], st["tmpl"],
            params)
    run_k = lambda: AC.align_window_from_state(*args, st["m"])
    ptr_k, _ = once_ms(run_k)
    ptr_p, plain_ms = once_ms(lambda: AC._window_plain(*args))
    words = valid_ptr_mask(w["steps_needed"], torch.zeros_like(n_d), ptr_k.shape[0])
    ptr_eq = bool(torch.equal(ptr_k[words], ptr_p[words]))
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES["align_window_from_state"] = 0
    print(f"  align_window_from_state [{shape_name} B={B} W={w['sig_win'].shape[1]} MP={mp}, "
          f"{n_cold} cold / {B - n_cold} warm rows]: pointers "
          f"{'equal' if ptr_eq else 'DIFFER'}; kernel {ms:.3f} ms, plain {plain_ms:.1f} ms",
          flush=True)
    if not ptr_eq:
        fail(f"align_window_from_state disagrees with its plain twin at the {shape_name} shape")
    if 0 < cold_rows < B and not 0 < n_cold < B:
        fail(f"the {shape_name} shape was meant to cover cold and warm windows, got {n_cold} cold")
    cells = wave_cells(w["steps_needed"], m_rows)
    nbytes = (4 * (w["sig_win"].numel() + 5 * B * mp + mp + 2 * B)
              + 4 * int(words.sum()) * mp)
    results["align_window_from_state"] = {
        "max_abs_err": 0.0 if ptr_eq else float("inf"), "ms": ms, "plain_ms": plain_ms,
        **bound(nbytes, WAVE_F32_PER_CELL * cells, POW_F64_PER_CELL * cells)}


def profile_pass(label: str, fn, card: str) -> None:
    """Run ``fn`` once under torch.profiler; print wall time, device time
    by kernel and the device's busy share (kernel time over wall)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"profile [{label}]: wall {wall_ms:.2f} ms, device kernels {total:.2f} ms, busy share "
          f"{total / wall_ms:.3f}; card: {card}", flush=True)
    for key, ms, n in rows[:8]:
        print(f"  {ms:10.3f} ms  {n:4d} x  {key[:90]}", flush=True)


def run_pipeline(counter, sigs, strand):
    """bench.py's three-stage loop: batch k's Viterbi overlaps batch k+1's align."""
    out = []
    pending = []
    for b0 in range(0, len(sigs), BATCH):
        pending.append(counter.detect_submit("c9orf72", sigs[b0 : b0 + BATCH], strand))
        if len(pending) >= 2:
            pending[-2] = counter.detect_middle(pending[-2])
        if len(pending) >= 3:
            out += counter.detect_finish(pending.pop(0))
    for state in pending:
        out += counter.detect_finish(state)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the measurements as JSON here")
    args = ap.parse_args()

    # -- phase 1: the card --------------------------------------------------
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np

        from strique_tpu_torch import _build, native
        from strique_tpu_torch.detect.counter import RepeatCounter
        from strique_tpu_torch.pore_model import PoreModel
        from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, smoke_workload,
                                                 ultralong_workload, write_pore_model)
    except ImportError as e:
        fail(f"the port is not importable from this directory: {e}")
    if "jax" in sys.modules or "strique_tpu" in sys.modules:
        fail("jax or the JAX package was imported")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"device: {kind} ({torch.cuda.device_count()} visible); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi.stdout.strip() if smi.returncode == 0 else card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    host_prep = threading.Thread(target=native.available)  # g++ beside the nvcc builds
    host_prep.start()
    try:
        _build.build(force=True)
        _build.lib()
    except Exception as e:  # noqa: BLE001 - any build failure is fatal here
        fail(f"kernel build failed: {e}")
    host_prep.join()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
          f"source; native host prep {'built' if native.available() else 'UNAVAILABLE'})",
          flush=True)
    for line in _build.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or ("spill" in line and not line.strip().startswith("0 bytes")):
            print(f"  ptxas: {line.strip()}", flush=True)

    # -- phase 3: every kernel against its plain twin -----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    model = write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=args.seed)
    pm = PoreModel(model)
    counter = RepeatCounter(model, device="cuda")
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    tc = counter.targets["c9orf72"][0]
    rng = np.random.default_rng(args.seed + 7)
    params = counter.align_params
    small = (rng.uniform(60, 120, 40).astype(np.float32), rng.uniform(60, 120, 28).astype(np.float32))
    bench_t = (tc.prefix_ext, tc.suffix_ext)
    results: dict = {}
    print("kernels vs plain twins:", flush=True)
    try:
        for shape_name, B, N, tmpls in (("small", 8, 512, small), ("bench", 64, 24576, bench_t)):
            for multi in (False, True):
                ptr, bot, n_d, m_d = check_wave(tmpls, shape_name, B, N, params, multi, rng,
                                                results)
                if multi:
                    j_end = (torch.argmax(bot, dim=1).to(torch.int32) + 1 - m_d).clamp_min(0)
                    check_traceback(ptr, j_end.to(torch.int32), m_d, shape_name, results)
                del ptr, bot
                torch.cuda.empty_cache()
            check_col(tmpls[0], shape_name, B, N, params, rng, results)
            torch.cuda.empty_cache()
        for shape_name, B, T in (("small", 8, 512), ("bench", 64, 6144)):
            check_viterbi(pm, tc.repeat_hmm, shape_name, B, T, rng, results)
            check_dense(pm, tc.repeat_hmm, shape_name, B, T, rng, results)
        # the ultra-long route's segments: ~9x the bench T (rescale and acc)
        check_viterbi(pm, tc.repeat_hmm, "ultra", 8, ULTRA_T, rng, {}, repeats=ULTRA_REPEATS)
        check_dense(pm, tc.repeat_hmm, "ultra", 8, ULTRA_T, rng, {}, repeats=ULTRA_REPEATS)
        check_longread(small[0], "small", 8, 4096, params, 512, 4, rng, results)
        # the bench template's span bound (29,581 steps) exceeds ND: all windows cold
        check_longread(tc.prefix_ext, "bench", 8, 24576, params, 16384, 0, rng, results)
        torch.cuda.empty_cache()
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"kernel comparison raised {type(e).__name__}: {e}")

    # -- phase 4: the counting path end to end ------------------------------
    warm, plus, minus = smoke_workload(pm, args.seed, n_warm=BATCH, n_plus=128, n_minus=24,
                                       repeats=REPEATS)
    print(f"workload: {len(plus)} '+' reads of {len(plus[0])} samples, {len(minus)} '-' reads "
          f"of {len(minus[0])} samples, {REPEATS} repeat units", flush=True)
    try:
        run_pipeline(counter, warm, "+")  # first use: allocator and host pools
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res_plus = run_pipeline(counter, plus, "+")
        dt_plus = time.perf_counter() - t0
        t1 = time.perf_counter()
        res_minus = run_pipeline(counter, minus, "-")
        dt_minus = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
    except Exception as e:  # noqa: BLE001
        fail(f"counting path raised {type(e).__name__}: {e}")
    ok_plus = sum(int(r[0] == REPEATS) for r in res_plus)
    ok_minus = sum(int(r[0] == REPEATS) for r in res_minus)
    rps = len(plus) / dt_plus
    print(f"counts: {ok_plus}/{len(plus)} (+) and {ok_minus}/{len(minus)} (-) exact", flush=True)
    print(f"throughput: {rps:.2f} reads/s on the '+' pass ({len(plus)} reads in "
          f"{dt_plus:.3f} s); '-' partial batch {dt_minus * 1e3:.1f} ms; card: {card}",
          flush=True)
    print(f"launches in the counting run: {json.dumps(launches)}", flush=True)
    if ok_plus != len(plus) or ok_minus != len(minus):
        fail("inexact repeat counts: " + str([r[0] for r in res_plus + res_minus
                                               if r[0] != REPEATS][:10]))
    for name in SPLIT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the counting path")
    if not all(np.isfinite(r[1]) and np.isfinite(r[2]) and np.isfinite(r[3])
               for r in res_plus + res_minus):
        fail("non-finite scores or log_p")
    ref_counter = RepeatCounter(model, device="cpu")
    ref_counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    ref = ref_counter.detect_many("c9orf72", plus[:8], "+")
    if [tuple(r) for r in ref] != [tuple(r) for r in res_plus[:8]]:
        fail("the first 8 '+' results differ from the plain CPU path")
    print("first 8 '+' result tuples equal the plain CPU path", flush=True)

    # -- phase 4b: the ultra-long two-pass route -----------------------------
    ultra = ultralong_workload(pm, args.seed, repeats=ULTRA_REPEATS)
    print(f"ultra-long workload: {len(ultra)} '+' reads of {len(ultra[0])} samples, "
          f"{ULTRA_REPEATS} repeat units", flush=True)
    runs = {}
    try:
        # 2 GiB: the bucket's ~4.7 GB width-8 plane does not fit (two-pass);
        # 8 GiB: it does at 8 rows a call (the one-pass route)
        for route, budget in (("two-pass", "2"), ("one-pass", "8")):
            os.environ["STRIQUE_PTR_BUDGET_GB"] = budget
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = counter.detect_many("c9orf72", ultra, "+")
            torch.cuda.synchronize()
            runs[route] = (res, time.perf_counter() - t0, dict(_build.LAUNCHES))
    except Exception as e:  # noqa: BLE001
        fail(f"ultra-long path raised {type(e).__name__}: {e}")
    finally:
        os.environ.pop("STRIQUE_PTR_BUDGET_GB", None)
    for route, (res, dt, lc) in runs.items():
        ok = sum(int(r[0] == ULTRA_REPEATS) for r in res)
        print(f"ultra-long {route}: {ok}/{len(res)} exact in {dt:.3f} s "
              f"(STRIQUE_PTR_BUDGET_GB={'2' if route == 'two-pass' else '8'}); card: {card}; "
              f"launches {json.dumps({k: v for k, v in lc.items() if v})}", flush=True)
        if ok != len(res):
            fail(f"inexact ultra-long counts on the {route} route: {[r[0] for r in res]}")
        if not all(np.isfinite(r[1]) and np.isfinite(r[2]) and np.isfinite(r[3]) for r in res):
            fail(f"non-finite scores or log_p on the {route} route")
    two_launches = runs["two-pass"][2]
    if (two_launches["align_forward_ckpt"] <= 0 or two_launches["align_window_from_state"] <= 0
            or two_launches["align_forward_wave"] or two_launches["align_forward_wave_multi"]):
        fail("the two-pass run did not go through the checkpoint and window kernels alone")
    if runs["one-pass"][2]["align_forward_ckpt"]:
        fail("the one-pass run took the two-pass route")
    if [tuple(r) for r in runs["two-pass"][0]] != [tuple(r) for r in runs["one-pass"][0]]:
        fail("two-pass result tuples differ from the one-pass route's")
    print("ultra-long two-pass result tuples equal the one-pass route's", flush=True)
    for name in ("align_forward_ckpt", "align_window_from_state"):
        launches[name] = two_launches[name]

    # -- phase 4c: where the device time goes --------------------------------
    try:
        profile_pass("split path, 128 '+' reads", lambda: run_pipeline(counter, plus, "+"), card)
        os.environ["STRIQUE_PTR_BUDGET_GB"] = "2"
        profile_pass("ultra-long two-pass, 8 reads",
                     lambda: counter.detect_many("c9orf72", ultra, "+"), card)
    except Exception as e:  # noqa: BLE001
        fail(f"profiled pass raised {type(e).__name__}: {e}")
    finally:
        os.environ.pop("STRIQUE_PTR_BUDGET_GB", None)

    # -- phase 4d: the knob routes (column alignment, dense Viterbi) ---------
    knob_rps = {}
    for route, (var, value) in KNOBS.items():
        os.environ[var] = value
        try:
            kc = RepeatCounter(model, device="cuda")  # a fresh HMM cache sees the knob
            kc.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
            run_pipeline(kc, warm, "+")
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            k_plus = run_pipeline(kc, plus, "+")
            dt = time.perf_counter() - t0
            plus_lc = dict(_build.LAUNCHES)
            k_minus = run_pipeline(kc, minus, "-")
            lc = dict(_build.LAUNCHES)
            profile_pass(f"{var}={value}, 128 '+' reads", lambda: run_pipeline(kc, plus, "+"),
                         card)
        except Exception as e:  # noqa: BLE001
            fail(f"the {var}={value} route raised {type(e).__name__}: {e}")
        finally:
            os.environ.pop(var, None)
        ok_p = sum(int(r[0] == REPEATS) for r in k_plus)
        ok_m = sum(int(r[0] == REPEATS) for r in k_minus)
        knob_rps[route] = len(plus) / dt
        print(f"{var}={value}: {ok_p}/{len(plus)} (+) and {ok_m}/{len(minus)} (-) exact; "
              f"{knob_rps[route]:.2f} reads/s on the '+' pass ({dt:.3f} s); card: {card}; "
              f"launches {json.dumps({k: v for k, v in lc.items() if v})}", flush=True)
        if ok_p != len(plus) or ok_m != len(minus):
            fail(f"inexact repeat counts on the {var}={value} route")
        if [tuple(r) for r in k_plus + k_minus] != [tuple(r) for r in res_plus + res_minus]:
            fail(f"the {var}={value} route's result tuples differ from the default route's")
        if route == "col":
            minus_multi = lc["align_forward_wave_multi"] - plus_lc["align_forward_wave_multi"]
            if (plus_lc["align_forward_col"] <= 0 or plus_lc["traceback_pointers_col"] <= 0
                    or plus_lc["align_forward_wave"] != 0 or minus_multi <= 0):
                fail("the column route's '+' pass did not run the column kernel and traceback "
                     "alone, or its '-' partial batch left the fused wave kernel")
            for name in ("align_forward_col", "traceback_pointers_col"):
                launches[name] = lc[name]
        else:
            if lc["viterbi_forward_dense"] <= 0 or lc["viterbi_forward_factored"] != 0:
                fail("the dense route did not decode with the dense forward alone")
            launches["viterbi_forward_dense"] = lc["viterbi_forward_dense"]
    print("both knob routes' result tuples equal the default route's", flush=True)

    # -- phase 5: report ----------------------------------------------------
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (src, rep) in SOURCES.items()]
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": card, "kind": kind, "build_s": build_s, "reads_per_sec": rps,
                       "plus_s": dt_plus, "minus_s": dt_minus,
                       "ultra_s": {k: v[1] for k, v in runs.items()},
                       "knob_reads_per_sec": knob_rps, "kernels": kernels},
                      fp, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
