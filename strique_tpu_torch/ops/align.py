"""Semi-global affine flank alignment: batching, end columns, traceback.

Counterpart of ``strique_tpu/ops/align.py`` on the split path:
``align_core`` (full 64-row wave calls against one template) and
``align_fused_pair`` (both flanks of a partial batch in one
per-row-template call), each followed by the leftmost-argmax end column
and the diagonal-layout traceback.

The traceback is ``csrc/traceback.cu`` (one thread walks one row) on
the card -- the reference runs it as an XLA ``while_loop``
(align.py:198-237), not as a Pallas kernel -- and
``_traceback_plain`` (the same walk, vectorised over rows) on the CPU.

Ultra-long reads: where even a width-8 pointer plane exceeds
``ptr_budget_bytes``, ``align_core`` routes the bucket to the exact
checkpointed two-pass route (``align_longread_sharded``, groups of 8
rows on one device): pass 1 (``align_forward_ckpt``) gives each row's
score and end column and checkpoints the diagonal state; pass 2
(``align_window_from_state``) recomputes pointers over a window that
holds the whole optimal path, resumed from the checkpoint at its start,
and the usual traceback walks it in window steps.  The windows are
gathered on the device (``_gather_windows``, as the reference does).
Configurations without a span bound (horizontal gaps free or positive)
raise ``ValueError`` there.  Spreading the groups over several cards
is not ported yet (``devices`` of more than one raises).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import _build
from .align_cuda import (BATCH_WAVE, CHUNK, NEG, _round_up, align_forward_ckpt,
                         align_forward_wave, align_forward_wave_multi, align_window_from_state,
                         kernel_batch, pad_template, pad_template_rows, ptr_budget_bytes,
                         wave_span_bound_steps)

MAT_M, MAT_H, MAT_V = 0, 1, 2

# DP-cell accounting: each wave call adds its issued cells (rows x
# diagonal steps x template lanes).  Host-side integers only.
KERNEL_STATS = {"cells": 0, "calls": 0}


def _count_cells(rows: int, steps: int, lanes: int) -> None:
    KERNEL_STATS["cells"] += int(rows) * int(steps) * int(lanes)
    KERNEL_STATS["calls"] += 1


def reset_kernel_stats() -> None:
    KERNEL_STATS["cells"] = 0
    KERNEL_STATS["calls"] = 0


def kernel_stats() -> dict:
    return dict(KERNEL_STATS)


def _traceback_plain(ptr, j_end, m_start, m_out: int):
    """Diagonal-layout traceback, all rows at once (see traceback_pointers)."""
    B = j_end.shape[0]
    dev = j_end.device
    rows = torch.arange(B, device=dev)
    iota = torch.arange(m_out, device=dev)

    def lookup(jc, ic):
        t = torch.clamp_min(ic + jc - 1, 0)
        word = ptr[t // 8, rows, torch.clamp_min(ic, 0)]
        nib = (word >> (4 * (t % 8)).to(torch.int32)) & 15
        return torch.where(jc > 0, nib.to(torch.int64), MAT_V | 8)

    i = m_start.to(torch.int64).clone()
    j = j_end.to(torch.int64).clone()
    byte = lookup(j, i)
    cur = byte & 3
    is_gap = torch.zeros((B, m_out), dtype=torch.bool, device=dev) | (j < 0)[:, None]
    jpos = torch.zeros((B, m_out), dtype=torch.int64, device=dev)
    while True:
        active = i > 0
        if not bool(active.any()):
            break
        is_m, is_h, is_v = cur == MAT_M, cur == MAT_H, cur == MAT_V
        sel = ((is_m | is_v) & active)[:, None] & (iota[None, :] == (i - 1)[:, None])
        is_gap = torch.where(sel, is_v[:, None], is_gap)
        jpos = torch.where(sel, (j - 1)[:, None], jpos)
        ni = torch.where(is_h, i, i - 1)
        nj = torch.where(is_v, j, j - 1)
        nbyte = lookup(nj, ni)
        # diag layout: the V-extend bit lives at the cell stepped to
        ext = torch.where(is_h, (byte >> 2) & 1, (nbyte >> 3) & 1)
        stay = ~is_m & (ext == 1)
        ncur = torch.where(stay, cur, torch.where(ni > 0, nbyte & 3, MAT_M))
        i = torch.where(active, ni, i)
        j = torch.where(active, nj, j)
        cur = torch.where(active, ncur, cur)
        byte = torch.where(active, nbyte, byte)
    return {"is_gap": is_gap, "jpos": jpos.to(torch.int32), "j_begin": j.to(torch.int32)}


def _traceback_cuda(ptr, j_end, m_start, m_out: int):
    B = j_end.shape[0]
    dev = j_end.device
    p = ptr.contiguous()
    je = j_end.to(torch.int32).contiguous()
    ms = m_start.to(torch.int32).contiguous()
    is_gap = torch.empty((B, m_out), dtype=torch.uint8, device=dev)
    jpos = torch.empty((B, m_out), dtype=torch.int32, device=dev)
    j_begin = torch.empty((B,), dtype=torch.int32, device=dev)
    _build.launch(
        "traceback_diag_launch", dev,
        p.data_ptr(), je.data_ptr(), ms.data_ptr(), is_gap.data_ptr(),
        jpos.data_ptr(), j_begin.data_ptr(), B, p.shape[2], m_out)
    _build.LAUNCHES["traceback_pointers"] += 1
    return {"is_gap": is_gap.bool(), "jpos": jpos, "j_begin": j_begin}


def traceback_pointers(ptr, j_end, m: int, packed: str = "diag", m_start=None):
    """Walk the diagonal-major pointer plane back from (m_start, j_end).

    ptr (ND/8, B, MP) int32 as the wave kernel writes it; j_end (B,);
    ``m_start`` (B,) per-row start rows (default ``m``), ``m`` the
    output width.  Returns per-template-element gap flags and signal
    positions plus ``j_begin``.  Tie-breaks and the V-extend read follow
    the reference walk (ops/align.py ``traceback_pointers``,
    packed='diag') step for step.
    """
    if packed != "diag":
        raise NotImplementedError("only the wave kernel's diagonal layout is ported")
    B = j_end.shape[0]
    if (ptr.dtype != torch.int32 or ptr.dim() != 3 or ptr.shape[1] != B
            or not 0 <= int(m) < ptr.shape[2]):
        raise ValueError("ptr must be an (ND/8, B, MP) int32 plane with m < MP")
    if m_start is None:
        m_start = torch.full_like(j_end, int(m))
    if m_start.shape != (B,) or ptr.device != j_end.device or m_start.device != j_end.device:
        raise ValueError("j_end and m_start are (B,) tensors on the plane's device")
    if j_end.device.type == "cuda":
        return _traceback_cuda(ptr, j_end, m_start, int(m))
    if j_end.device.type == "cpu":
        return _traceback_plain(ptr, j_end, m_start, int(m))
    raise ValueError(f"traceback runs on cuda or cpu tensors, got {j_end.device}")


def _b0(params, m):
    """Virtual column 0's bottom score: the whole template in one vertical gap."""
    return np.float32(params.gap_open_v) + np.float32(params.gap_extension_v) * np.float32(m - 1)


def _align_batch_wave(signals, n_actual, template_padded, params, m_actual: int):
    ptr, bottom_steps = align_forward_wave(signals, n_actual, template_padded,
                                           params, m_actual)
    B, N = signals.shape
    bottom_cols = bottom_steps[:, m_actual : m_actual + N]
    b0 = torch.full((B, 1), float(_b0(params, m_actual)), device=signals.device)
    bottom = torch.cat([b0, bottom_cols], dim=1)
    j_end = torch.argmax(bottom, dim=1)  # first maximum: leftmost end column
    score = bottom.gather(1, j_end[:, None])[:, 0]
    tb = traceback_pointers(ptr, j_end.to(torch.int32), m_actual)
    return {"score": score, "j_end": j_end.to(torch.int32), **tb}


def _align_batch_wave_multi(signals, n_actual, tmpl_rows, m_rows, params, m_max: int):
    ptr, bottom_steps = align_forward_wave_multi(signals, n_actual, tmpl_rows,
                                                 m_rows, params)
    # leftmost max over columns incl. the virtual column 0: argmax in
    # step space is argmax in column space (a per-row constant shift)
    tstar = torch.argmax(bottom_steps, dim=1)  # first maximum
    smax = bottom_steps.gather(1, tstar[:, None])[:, 0]
    m_r = m_rows.to(torch.int32)
    jstar = tstar.to(torch.int32) + 1 - m_r
    b0 = (float(np.float32(params.gap_open_v))
          + float(np.float32(params.gap_extension_v)) * (m_r.to(torch.float32) - 1.0))
    j_end = torch.where(b0 >= smax, 0, jstar).to(torch.int32)
    score = torch.maximum(b0, smax)
    tb = traceback_pointers(ptr, j_end, m_max, m_start=m_r)
    return {"score": score, "j_end": j_end, **tb}


def _pad_rows(x, rows: int, value):
    if x.shape[0] >= rows:
        return x
    pad = torch.full((rows - x.shape[0],) + tuple(x.shape[1:]), value,
                     dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _gather_windows(sig, t0, W: int, mp: int):
    """Per-row pass-2 windows gathered on the device (align.py ``_gather_windows``).

    sig_win[r] = a_r[t0 .. t0+W) and r_init[r] = reversed a_r[t0-mp .. t0),
    0.0 outside the signal.
    """
    ext = torch.nn.functional.pad(sig, (mp, W))
    t0 = t0.to(torch.int64)[:, None]
    sig_win = ext.gather(1, t0 + mp + torch.arange(W, device=sig.device))
    r_init = ext.gather(1, t0 + torch.arange(mp, device=sig.device)).flip(1)
    return sig_win.contiguous(), r_init.contiguous()


def restart_state(ckpts, slot, cold):
    """Pass-2 restart state (S1, S2, Ih, C), each (B, MP), from pass-1 planes.

    Row r takes slot ``slot[r]`` of the four (n_ck, B, MP) checkpoint
    planes; rows with ``cold`` set take the cold-start values instead
    (their slot is ignored), as the reference's ``_longread_pass2``.
    """
    B = slot.shape[0]
    mp = ckpts[0].shape[2]
    dev = ckpts[0].device
    rows = torch.arange(B, device=dev)
    s = slot.to(device=dev, dtype=torch.int64).clamp_min(0)
    is_cold = (cold.to(dev) != 0)[:, None]
    lane0 = torch.arange(mp, device=dev) == 0
    cold_vals = (torch.where(lane0, 0.0, NEG).to(torch.float32), NEG, NEG, NEG)
    return tuple(torch.where(is_cold, cv, plane[s, rows]).contiguous()
                 for plane, cv in zip(ckpts, cold_vals))


def _longread_pass1(signals, n_actual, template_np, params, ckpt_steps: int) -> dict:
    """Two-pass pass 1: score-only forward with checkpoints (queued, no sync)."""
    B, N = signals.shape
    if B % 8:
        raise ValueError(f"two-pass groups are multiples of 8 rows, got {B}")
    tmpl_np, m = pad_template(np.asarray(template_np, np.float32))
    mp = tmpl_np.shape[1]
    bound = wave_span_bound_steps(params, m)
    if bound is None:
        raise ValueError(
            "two-pass alignment needs negative horizontal gap costs "
            "(no span bound exists otherwise); use the one-pass kernel")
    # every warm restart t0 (a checkpoint boundary) lies past the column-0
    # boundary region: pass 2 forces boundary state only for cold rows
    ckpt_chunks = max(ckpt_steps // CHUNK, -(-mp // CHUNK), 1)
    ckpt_steps = ckpt_chunks * CHUNK
    nd = _round_up(N + mp, ckpt_steps)  # ND divides the checkpoint stride
    if nd - mp > N:
        signals = torch.nn.functional.pad(signals, (0, nd - mp - N))
        N = nd - mp
    tmpl = torch.from_numpy(tmpl_np).to(signals.device)
    _count_cells(B, N + mp, mp)  # pass 1 (score-only forward)
    bottom_steps, ckpts = align_forward_ckpt(signals, n_actual, tmpl, params, m, ckpt_chunks)
    return {"bottom_steps": bottom_steps, "ckpts": ckpts, "sig": signals, "tmpl": tmpl,
            "params": params, "m": m, "mp": mp, "bound": bound, "ckpt_steps": ckpt_steps,
            "B": B, "N": N, "W": _round_up(bound + ckpt_steps, CHUNK)}


def window_inputs(st: dict) -> dict:
    """Pass-2 inputs of a pass-1 state: end columns, windows, restart state.

    Score and leftmost ``j_end`` come from the step-space bottoms
    (column j at step m+j-1; virtual column 0 = the full-template
    vertical gap).  Each row's window [t0, t0+W) starts on a checkpoint
    boundary at or before t_end - bound, so every step the traceback
    can visit lies inside it; rows with t0 == 0 start cold.
    """
    params, m, mp, B, N, W = (st[k] for k in ("params", "m", "mp", "B", "N", "W"))
    dev = st["sig"].device
    b0 = torch.full((B, 1), float(_b0(params, m)), device=dev)
    bottom = torch.cat([b0, st["bottom_steps"][:, m : m + N]], dim=1)
    j_end = torch.argmax(bottom, dim=1)  # first maximum: leftmost end column
    cks = st["ckpt_steps"]
    t_end = j_end + m - 1
    t0 = (t_end - st["bound"]).clamp_min(0) // cks * cks
    cold = (t0 == 0).to(torch.int32)
    sig_win, r_init = _gather_windows(st["sig"], t0, W, mp)
    return {"j_end": j_end, "score": bottom.gather(1, j_end[:, None])[:, 0], "t0": t0,
            "sig_win": sig_win, "r_init": r_init,
            "state4": restart_state(st["ckpts"], t0 // cks - 1, cold), "cold": cold,
            "steps_needed": (t_end - t0 + 1).to(torch.int32)}


def _longread_pass2(st: dict) -> dict:
    """Two-pass pass 2: window recompute from the restart state, then the
    traceback in window steps, shifted back by t0."""
    w = window_inputs(st)
    m = st["m"]
    _count_cells(st["B"], st["W"], st["mp"])  # pass 2 (windowed pointer recompute)
    ptr = align_window_from_state(w["sig_win"], w["r_init"], w["state4"], w["cold"],
                                  w["steps_needed"], st["tmpl"], st["params"], m)
    t0 = w["t0"]
    tb = traceback_pointers(ptr, (w["j_end"] - t0).to(torch.int32), m)
    t0_32 = t0.to(torch.int32)
    return {"score": w["score"], "j_end": w["j_end"].to(torch.int32), "is_gap": tb["is_gap"],
            "jpos": tb["jpos"] + t0_32[:, None], "j_begin": tb["j_begin"] + t0_32}


def align_batch_longread(signals, n_actual, template_np, params, ckpt_steps: int = 16384):
    """Checkpointed two-pass alignment of a group of rows (B % 8 == 0).

    Exact by construction: pass 1 runs the score-only wave with
    diagonal-state checkpoints every ``ckpt_steps``; pass 2 recomputes
    pointers over a window that provably holds the optimal path,
    resuming from the checkpoint at its start, so pointers and
    tracebacks equal the one-pass plane's.  Device memory per row is
    O(ND/ckpt_steps + W) instead of O(ND).  Returns align_core's dict.
    """
    return _longread_pass2(_longread_pass1(signals, n_actual, template_np, params, ckpt_steps))


def align_longread_sharded(signals, n_actual, template_np, params, devices=None,
                           ckpt_steps: int = 16384, group: int = 8):
    """The two-pass route in groups of ``group`` rows on one device.

    Every group's pass 1 is queued before the first pass 2 runs, as the
    reference does.  The reference round-robins the groups over
    ``devices``; here at most one device is accepted (the multi-GPU
    slice is not ported yet).
    """
    if devices is not None and len(devices) > 1:
        raise NotImplementedError(
            "round-robin of two-pass groups over several devices is not ported yet (ROADMAP)")
    if devices:
        signals, n_actual = signals.to(devices[0]), n_actual.to(devices[0])
    B = signals.shape[0]
    n_act = n_actual.to(torch.int32)
    states = [_longread_pass1(_pad_rows(signals[g0 : g0 + group], group, 0.0),
                              _pad_rows(n_act[g0 : g0 + group], group, 1),
                              template_np, params, ckpt_steps)
              for g0 in range(0, B, group)]
    outs = [_longread_pass2(st) for st in states]
    return {k: torch.cat([o[k] for o in outs])[:B] for k in outs[0]}


def align_core(signals, n_actual, template_np, params):
    """Align B reads against one template; returns a dict of (B, ...) tensors.

    signals (B, N) f32 on the target device; ``template_np`` a host
    array (its length is static).  Rows run in wave calls of
    :func:`kernel_batch` rows; the tail pads with length-1 rows.  Past
    the pointer budget even at width 8, the bucket takes the two-pass
    route (:func:`align_longread_sharded`).
    """
    dev = signals.device
    B, N = signals.shape
    npad = (-N) % CHUNK
    if npad:
        signals = torch.nn.functional.pad(signals, (0, npad))
    tmpl_np, m = pad_template(np.asarray(template_np, np.float32))
    mp = tmpl_np.shape[1]
    n_cols = signals.shape[1] + mp
    if n_cols * 8 * mp // 2 > ptr_budget_bytes(dev):
        if wave_span_bound_steps(params, m) is None:
            raise ValueError(
                "the pointer plane exceeds the memory budget even at width 8, and the "
                "two-pass route needs negative horizontal gap costs (no span bound "
                "exists otherwise)")
        return align_longread_sharded(signals, n_actual, template_np, params)
    tmpl = torch.from_numpy(tmpl_np).to(dev)
    n_act = n_actual.to(torch.int32)
    outs = []
    b0 = 0
    while b0 < B:
        kb = kernel_batch(B - b0, n_cols=n_cols, mp=mp, device=dev)
        end = b0 + kb
        sl = _pad_rows(signals[b0:end], kb, 0.0)
        na = _pad_rows(n_act[b0:end], kb, 1)
        _count_cells(kb, n_cols, mp)
        outs.append(_align_batch_wave(sl, na, tmpl, params, m))
        b0 = end
    return {k: torch.cat([o[k] for o in outs])[:B] for k in outs[0]}


def align_fused_pair(signals, n_actual, t_pre, t_suf, params):
    """Both flank alignments of a batch, fused into one row stream when it pays.

    A wave call costs its longest row whatever its width, so when the
    per-flank tail is at most half a call (0 < B % 64 <= 32) the rows
    [read0 x prefix .. readB x prefix, read0 x suffix ..] run as
    per-row-template calls -- the same fusion rule as the reference
    (ops/align.py:324-334).  Otherwise two :func:`align_core` calls.
    Returns (pre, suf).
    """
    t_pre = np.asarray(t_pre, np.float32)
    t_suf = np.asarray(t_suf, np.float32)
    dev = signals.device
    B, N = signals.shape
    tail = B % BATCH_WAVE
    use_fuse = 0 < tail <= BATCH_WAVE // 2
    if use_fuse:
        tmpl_rows_np, ms = pad_template_rows([t_pre, t_suf])
        mp = tmpl_rows_np.shape[1]
        nd = _round_up(N, CHUNK) + mp
        if nd * 8 * mp // 2 > ptr_budget_bytes(dev):
            use_fuse = False
    if not use_fuse:
        return (align_core(signals, n_actual, t_pre, params),
                align_core(signals, n_actual, t_suf, params))

    npad = (-N) % CHUNK
    if npad:
        signals = torch.nn.functional.pad(signals, (0, npad))
    m_max = int(ms.max())
    n_act = n_actual.to(torch.int32)
    sig2 = torch.cat([signals, signals])
    na2 = torch.cat([n_act, n_act])
    rows2 = torch.from_numpy(np.concatenate([np.repeat(tmpl_rows_np[0:1], B, axis=0),
                                             np.repeat(tmpl_rows_np[1:2], B, axis=0)])).to(dev)
    ms2 = torch.from_numpy(np.concatenate([np.full(B, ms[0], np.int32),
                                           np.full(B, ms[1], np.int32)])).to(dev)
    n_cols = sig2.shape[1] + mp
    outs = []
    b0 = 0
    R = 2 * B
    while b0 < R:
        kb = kernel_batch(R - b0, n_cols=n_cols, mp=mp, device=dev)
        end = b0 + kb
        sl = _pad_rows(sig2[b0:end], kb, 0.0)
        na = _pad_rows(na2[b0:end], kb, 1)
        tr = _pad_rows(rows2[b0:end], kb, 1e30)
        mr = _pad_rows(ms2[b0:end], kb, 1)
        _count_cells(kb, n_cols, mp)
        outs.append(_align_batch_wave_multi(sl, na, tr, mr, params, m_max))
        b0 = end
    out = {k: torch.cat([o[k] for o in outs])[:R] for k in outs[0]}
    pre = {k: (v[:B, : len(t_pre)] if v.ndim == 2 else v[:B]) for k, v in out.items()}
    suf = {k: (v[B:, : len(t_suf)] if v.ndim == 2 else v[B:]) for k, v in out.items()}
    return pre, suf


def _nearest_positions(is_gap: np.ndarray, jpos: np.ndarray, n: int) -> np.ndarray:
    """Per template element, the nearest signal index in alignment view space.

    NumPy copy of ``strique_tpu.ops.align._nearest_positions`` (that
    module imports jax); tests pin the two equal.  Matched elements map
    exactly; elements inside a vertical gap run of length L at left
    neighbour j map to j if (r+1) <= (L-r) for in-run offset r, else j+1.
    """
    m = len(jpos)
    pos = jpos.astype(np.int64).copy()
    g = np.asarray(is_gap, dtype=bool)
    if g.any():
        jp = jpos.astype(np.int64)
        start = g & ~(np.concatenate(([False], g[:-1]))
                      & (np.concatenate(([np.int64(-1)], jp[:-1])) == jp))
        run_id = np.cumsum(start) - 1
        starts_idx = np.flatnonzero(start)
        lengths = np.bincount(run_id[g])
        r = np.arange(m) - starts_idx[np.maximum(run_id, 0)]
        L = lengths[np.maximum(run_id, 0)]
        pos[g] = np.where((r + 1) <= (L - r), jp, jp + 1)[g]
    return np.clip(pos, 0, n - 1)
