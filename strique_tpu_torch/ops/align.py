"""Semi-global affine flank alignment: batching, end columns, traceback.

Counterpart of ``strique_tpu/ops/align.py`` on the split path:
``align_core`` (wave calls against one template) and
``align_fused_pair`` (both flanks of a batch in one per-row-template
row stream), each followed by the leftmost-argmax end column and the
diagonal-layout traceback.

Both take the reads as f32 signals or, with ``lut``, in morph form: u8
bins plus each read's 256-entry f32 level table, as the counter uploads
them.  The wave route then runs the morph-form kernel calls
(``align_forward_wave_morph`` / ``_multi_morph``: TABLE score mode where
the template's score table fits shared memory), and so do the
two-pass route (``align_forward_ckpt_morph``,
``align_window_from_state_morph``) and the column route
(``align_forward_col_morph``).  The template's rule
(``align_cuda.wave_table_ctas``, ``col_table_ctas``) gives the fewest
CTAs a row can take: one, or a thread-block cluster whose CTAs split
the lanes and each hold a table of their own lanes' levels (the split
form of ``template_levels``), so a template past one CTA's table keeps
the TABLE mode.  Only a template past every cluster's table runs POW:
the two-pass route decodes ``lut[bins]`` to f32 first, and the morph
entry points of the other two do so.

Call widths, CTAs and fusion follow the device: on the card every wave
call's CTAs a row and rows come from ``align_cuda.wave_launch_plan``
(the shortest predicted call set, from the rule's CTAs up, within the
SM count and the pointer budget), and both flanks fuse whenever the
plan takes their 2B rows in one call (:func:`fuse_flanks`); each
morph-form column call's from ``align_cuda.col_launch_plan`` (the same
choice over the column kernel's cluster form, for a template past one
CTA's table).  On the CPU
the reference's 64-row widths and partial-batch fusion rule stay.

``STRIQUE_ALIGN_KERNEL=col`` (read on every ``align_core`` and
``align_fused_pair`` call, as the reference reads it) swaps the wave
kernel for the column-sweep kernel (``align_forward_col`` or, on morph
input, ``align_forward_col_morph``) and the column-layout traceback
(``_align_batch_col``).  As in the reference,
the fusion rule of ``align_fused_pair`` decides first -- under the knob
the reference's partial-batch rule, on the card too, so full batches
reach the column kernel -- and a fused partial batch still runs the
per-row-template wave kernel; the two-pass route is the wave form's
alone.

The traceback is ``csrc/traceback.cu`` (one warp walks one row from a
shared-memory ring of the pointer plane's upcoming word groups) on
the card -- the reference runs it as an XLA ``while_loop``
(align.py:198-237), not as a Pallas kernel -- and
``_traceback_plain`` (the same walk, vectorised over rows) on the CPU.

Ultra-long reads: where even a width-8 pointer plane exceeds
``ptr_budget_bytes``, ``align_core`` routes the bucket to the exact
checkpointed two-pass route (``align_longread_sharded``, groups of
:func:`two_pass_group` rows on one device: 8 on the CPU; on a card the
launch plan's, pass 1 and pass 2 each at its step): pass 1
(``align_forward_ckpt``) gives each row's score
and end column and checkpoints the diagonal state; pass 2
(``align_window_from_state``) recomputes pointers over a window that
holds the whole optimal path, resumed from the checkpoint at its start,
and the usual traceback walks it in window steps.  f32 windows are
gathered on the device (``_gather_windows``, as the reference does);
morph-form windows read the bins row in place.  On the card
``align_fused_pair`` runs both flanks' two-pass routes as one
per-row-template row stream, so a group's pass 1 covers both flanks.
Configurations without a span bound (horizontal gaps free or positive)
raise ``ValueError`` there.  With ``devices`` (a list, a device
possibly repeated) the groups round-robin over them, each at most a
device's share of the rows and every pass 1 queued before the first
pass 2, as the reference spreads its groups over a mesh; the rows come
back in order on the input's device.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import _build
from ..utils import trace
from .align_cuda import (BATCH_WAVE, CHUNK, NEG, _distinct_rows, _round_up, align_forward_ckpt,
                         align_forward_ckpt_morph, align_forward_col, align_forward_col_morph,
                         align_forward_wave, align_forward_wave_morph, align_forward_wave_multi,
                         align_forward_wave_multi_morph, align_window_from_state,
                         align_window_from_state_morph, col_launch_plan, col_table_ctas,
                         kernel_batch, morph_decode, pad_template, pad_template_rows,
                         ptr_budget_bytes, sm_count, template_levels, two_pass_group,
                         wave_launch_plan, wave_span_bound_steps, wave_table_ctas)

MAT_M, MAT_H, MAT_V = 0, 1, 2
CKPT_STEPS = 16384  # the two-pass route's checkpoint stride (the reference's)

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


def _traceback_plain(ptr, j_end, m_start, m_out: int, col: bool = False):
    """Traceback of the diagonal (or, with ``col``, the column) layout,
    all rows at once (see traceback_pointers)."""
    B = j_end.shape[0]
    dev = j_end.device
    rows = torch.arange(B, device=dev)
    iota = torch.arange(m_out, device=dev)
    mp = ptr.shape[2]

    def lookup(jc, ic):
        if col:  # row i at lane i-1; row 0 wraps to lane MP-1, as the reference indexes
            t = torch.clamp_min(jc - 1, 0)
            lane = torch.remainder(ic - 1, mp)
        else:
            t = torch.clamp_min(ic + jc - 1, 0)
            lane = torch.clamp_min(ic, 0)
        word = ptr[t // 8, rows, lane]
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
        # diag layout: the V-extend bit lives at the cell stepped to;
        # column layout: at the current cell
        ext = torch.where(is_h, (byte >> 2) & 1, ((byte if col else nbyte) >> 3) & 1)
        stay = ~is_m & (ext == 1)
        ncur = torch.where(stay, cur, torch.where(ni > 0, nbyte & 3, MAT_M))
        i = torch.where(active, ni, i)
        j = torch.where(active, nj, j)
        cur = torch.where(active, ncur, cur)
        byte = torch.where(active, nbyte, byte)
    return {"is_gap": is_gap, "jpos": jpos.to(torch.int32), "j_begin": j.to(torch.int32)}


def _traceback_cuda(ptr, j_end, m_start, m_out: int, col: bool):
    B = j_end.shape[0]
    dev = j_end.device
    p = ptr.contiguous()
    je = j_end.to(torch.int32).contiguous()
    ms = m_start.to(torch.int32).contiguous()
    # the kernel writes 0/1 bytes: a bool tensor's storage
    is_gap = torch.empty((B, m_out), dtype=torch.bool, device=dev)
    jpos = torch.empty((B, m_out), dtype=torch.int32, device=dev)
    j_begin = torch.empty((B,), dtype=torch.int32, device=dev)
    _build.launch(
        "traceback_launch", dev,
        p.data_ptr(), je.data_ptr(), ms.data_ptr(), is_gap.data_ptr(),
        jpos.data_ptr(), j_begin.data_ptr(), B, p.shape[2], m_out, int(col))
    _build.LAUNCHES["traceback_pointers_col" if col else "traceback_pointers"] += 1
    return {"is_gap": is_gap, "jpos": jpos, "j_begin": j_begin}


def traceback_pointers(ptr, j_end, m: int, packed="diag", m_start=None):
    """Walk a pointer plane back from (m_start, j_end).

    ``packed='diag'``: ptr (ND/8, B, MP) int32 as the wave kernel writes
    it; ``packed=True``: ptr (N/8, B, MP) as the column kernel writes it.
    j_end (B,); ``m_start`` (B,) per-row start rows (default ``m``),
    ``m`` the output width.  Returns per-template-element gap flags and
    signal positions plus ``j_begin``.  Tie-breaks and the V-extend read
    follow the reference walk (ops/align.py ``traceback_pointers``) step
    for step, in either layout.
    """
    if packed is not True and packed != "diag":
        raise ValueError(
            "the pointer layout is the wave kernel's diagonal one (packed='diag') or the "
            "column kernel's (packed=True)")
    col = packed is True
    B = j_end.shape[0]
    if (ptr.dtype != torch.int32 or ptr.dim() != 3 or ptr.shape[1] != B
            or not 0 <= int(m) < ptr.shape[2]):
        raise ValueError("ptr must be an (ND/8, B, MP) int32 plane with m < MP")
    if m_start is None:
        m_start = torch.full_like(j_end, int(m))
    if m_start.shape != (B,) or ptr.device != j_end.device or m_start.device != j_end.device:
        raise ValueError("j_end and m_start are (B,) tensors on the plane's device")
    if j_end.device.type == "cuda":
        return _traceback_cuda(ptr, j_end, m_start, int(m), col)
    if j_end.device.type == "cpu":
        return _traceback_plain(ptr, j_end, m_start, int(m), col)
    raise ValueError(f"traceback runs on cuda or cpu tensors, got {j_end.device}")


def _b0(params, m):
    """Virtual column 0's bottom score: the whole template in one vertical gap."""
    return np.float32(params.gap_open_v) + np.float32(params.gap_extension_v) * np.float32(m - 1)


def _end_and_traceback(ptr, bottom_cols, params, m_actual: int, packed):
    """Score and leftmost end column over columns 0..N (virtual column 0
    = the whole template in one vertical gap), then the traceback."""
    B = bottom_cols.shape[0]
    b0 = torch.full((B, 1), float(_b0(params, m_actual)), device=bottom_cols.device)
    bottom = torch.cat([b0, bottom_cols], dim=1)
    j_end = torch.argmax(bottom, dim=1)  # first maximum: leftmost end column
    score = bottom.gather(1, j_end[:, None])[:, 0]
    tb = traceback_pointers(ptr, j_end.to(torch.int32), m_actual, packed=packed)
    return {"score": score, "j_end": j_end.to(torch.int32), **tb}


def _align_batch_wave(signals, n_actual, template_padded, params, m_actual: int):
    """One wave call and its traceback."""
    ptr, bottom_steps = align_forward_wave(signals, n_actual, template_padded, params, m_actual)
    N = signals.shape[1]
    return _end_and_traceback(ptr, bottom_steps[:, m_actual : m_actual + N], params, m_actual,
                              "diag")


def _align_batch_wave_morph(bins, lut, n_actual, levels, lidx, params, m_actual: int):
    """``_align_batch_wave`` on morph-form reads: (B, N) u8 bins, their
    (B, 256) level tables, and the template as ``template_levels`` of its
    (1, MP) lane layout."""
    ptr, bottom_steps = align_forward_wave_morph(bins, lut, n_actual, levels, lidx, params,
                                                 m_actual)
    N = bins.shape[1]
    return _end_and_traceback(ptr, bottom_steps[:, m_actual : m_actual + N], params, m_actual,
                              "diag")


def _align_batch_col(signals, n_actual, template_padded, params, m_actual: int):
    """Column-kernel counterpart of ``_align_batch_wave`` (the reference's
    ``_align_batch_pallas``)."""
    ptr, bottom_cols = align_forward_col(signals, n_actual, template_padded, params, m_actual)
    return _end_and_traceback(ptr, bottom_cols, params, m_actual, True)


def _align_batch_col_morph(bins, lut, n_actual, levels, lidx, params, m_actual: int):
    """``_align_batch_col`` on morph-form reads (as ``_align_batch_wave_morph``)."""
    ptr, bottom_cols = align_forward_col_morph(bins, lut, n_actual, levels, lidx, params,
                                               m_actual)
    return _end_and_traceback(ptr, bottom_cols, params, m_actual, True)


def _align_batch_wave_multi(signals, n_actual, tmpl_rows, m_rows, params, m_max: int):
    """Per-row-template counterpart of ``_align_batch_wave``."""
    ptr, bottom_steps = align_forward_wave_multi(signals, n_actual, tmpl_rows, m_rows, params)
    return _multi_end_and_traceback(ptr, bottom_steps, m_rows, params, m_max)


def _align_batch_wave_multi_morph(bins, lut, n_actual, levels, lidx, m_rows, params,
                                  m_max: int):
    """``_align_batch_wave_multi`` on morph-form reads; (levels, lidx) is
    ``template_levels`` of the (B, MP) template rows."""
    ptr, bottom_steps = align_forward_wave_multi_morph(bins, lut, n_actual, levels, lidx,
                                                       m_rows, params)
    return _multi_end_and_traceback(ptr, bottom_steps, m_rows, params, m_max)


def _end_columns(bottom_steps, m_rows, params):
    """Score and leftmost end column of each row from its step-space
    bottom taps (column j at step m_row + j - 1), with the virtual column
    0 (the whole template in one vertical gap): (j_end int32, score)."""
    # leftmost max over columns incl. the virtual column 0: argmax in
    # step space is argmax in column space (a per-row constant shift)
    tstar = torch.argmax(bottom_steps, dim=1)  # first maximum
    smax = bottom_steps.gather(1, tstar[:, None])[:, 0]
    m_r = m_rows.to(torch.int32)
    jstar = tstar.to(torch.int32) + 1 - m_r
    b0 = (float(np.float32(params.gap_open_v))
          + float(np.float32(params.gap_extension_v)) * (m_r.to(torch.float32) - 1.0))
    return torch.where(b0 >= smax, 0, jstar).to(torch.int32), torch.maximum(b0, smax)


def _multi_end_and_traceback(ptr, bottom_steps, m_rows, params, m_max: int):
    """Score, end column and traceback of a per-row-template call."""
    j_end, score = _end_columns(bottom_steps, m_rows, params)
    tb = traceback_pointers(ptr, j_end, m_max, m_start=m_rows.to(torch.int32))
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


def _ckpt_geometry(N: int, mp: int, ckpt_steps: int) -> tuple[int, int, int]:
    """(ckpt_chunks, ckpt_steps, ND) of a pass 1 over N samples and MP
    lanes.  The stride is whole chunks and at least MP, so every warm
    restart t0 (a checkpoint boundary) lies past the column-0 boundary
    region (pass 2 forces boundary state only for cold rows); ND is a
    multiple of it."""
    ckpt_chunks = max(ckpt_steps // CHUNK, -(-mp // CHUNK), 1)
    ckpt_steps = ckpt_chunks * CHUNK
    return ckpt_chunks, ckpt_steps, _round_up(N + mp, ckpt_steps)


def _span_bounds(params, ms) -> np.ndarray:
    """:func:`wave_span_bound_steps` of each template length."""
    bounds = [wave_span_bound_steps(params, int(m)) for m in ms]
    if None in bounds:
        raise ValueError(
            "two-pass alignment needs negative horizontal gap costs "
            "(no span bound exists otherwise); use the one-pass kernel")
    return np.asarray(bounds, np.int64)


def _window_steps(bound: int, ckpt_steps: int) -> int:
    """Pass 2's window W: the span bound plus a checkpoint stride."""
    return _round_up(bound + ckpt_steps, CHUNK)


def _table_form(tmpl_np: np.ndarray, ctas: int, dev):
    """(levels, lidx) of template rows on ``dev`` for a TABLE call of
    ``ctas`` CTAs a row: the one-CTA form of ``template_levels`` (also
    for POW, ``ctas`` 0, whose morph calls decode through it), or the
    split form of a cluster."""
    levels, lidx = template_levels(tmpl_np, ctas if ctas > 1 else None)
    return torch.from_numpy(levels).to(dev), torch.from_numpy(lidx).to(dev)


def _pass1_rows(signals, n_actual, tmpl_np, ms, params, ckpt_steps: int, lut=None,
                ctas: int = 1) -> dict:
    """Two-pass pass 1 of a group of rows (queued, no sync).

    ``tmpl_np`` (1, MP) with ``ms`` one length, or (B, MP) with a length
    per row.  ``signals`` (B, N) f32 or, with ``lut``, u8 bins read in
    place by the TABLE score mode on ``ctas`` CTAs a row (the caller has
    checked that the template fits :func:`wave_table_ctas`'s table).
    """
    B, N = signals.shape
    if B % 8:
        raise ValueError(f"two-pass groups are multiples of 8 rows, got {B}")
    dev = signals.device
    mp = tmpl_np.shape[1]
    bounds = _span_bounds(params, ms)
    ckpt_chunks, ckpt_steps, nd = _ckpt_geometry(N, mp, ckpt_steps)
    m_rows = torch.from_numpy(np.broadcast_to(np.asarray(ms, np.int32), (B,)).copy()).to(dev)
    m_arg = int(ms[0]) if tmpl_np.shape[0] == 1 else m_rows
    _count_cells(B, nd, mp)  # pass 1 (score-only forward)
    if lut is None:
        if nd - mp > N:  # the f32 row padded with 0.0 to ND - MP samples
            signals = torch.nn.functional.pad(signals, (0, nd - mp - N))
        tmpl = torch.from_numpy(tmpl_np).to(dev)
        bottom_steps, ckpts = align_forward_ckpt(signals, n_actual, tmpl, params, m_arg,
                                                 ckpt_chunks)
        score_in = {"tmpl": tmpl}
    else:
        levels, lidx = _table_form(tmpl_np, ctas, dev)
        bottom_steps, ckpts = align_forward_ckpt_morph(signals, lut, n_actual, levels, lidx,
                                                       params, m_arg, ckpt_chunks, nd)
        score_in = {"levels": levels, "lidx": lidx}
    return {"bottom_steps": bottom_steps, "ckpts": ckpts, "sig": signals, "lut": lut,
            **score_in, "params": params, "m": int(np.max(ms)), "m_rows": m_rows, "mp": mp,
            "bound": torch.from_numpy(np.broadcast_to(bounds, (B,)).copy()).to(dev),
            "ckpt_steps": ckpt_steps, "B": B, "N": nd - mp,
            "W": _window_steps(int(bounds.max()), ckpt_steps)}


def _longread_pass1(signals, n_actual, template_np, params, ckpt_steps: int, lut=None) -> dict:
    """Two-pass pass 1 of a group of rows against one template: score-only
    forward with checkpoints (queued, no sync).  ``lut``: morph-form
    input, as in :func:`align_core`."""
    tmpl_np, m = pad_template(np.asarray(template_np, np.float32))
    ctas = 1 if lut is None else wave_table_ctas(tmpl_np)
    return _pass1_rows(signals, n_actual, tmpl_np, np.array([m]), params, ckpt_steps, lut, ctas)


def window_inputs(st: dict) -> dict:
    """Pass-2 inputs of a pass-1 state: end columns and restart state, and
    for f32 rows the gathered windows.

    Score and leftmost ``j_end`` come from the step-space bottoms
    (:func:`_end_columns`).  Each row's window [t0, t0+W) starts on a
    checkpoint boundary at or before t_end - bound (its own template's
    bound), so every step the traceback can visit lies inside it; rows
    with t0 == 0 start cold.  Morph-form rows need no gathered window:
    the TABLE window reads the bins row from t0 on.
    """
    params, mp, W = st["params"], st["mp"], st["W"]
    m_r = st["m_rows"]
    j_end, score = _end_columns(st["bottom_steps"], m_r, params)
    cks = st["ckpt_steps"]
    t_end = j_end + m_r - 1
    t0 = (t_end - st["bound"]).clamp_min(0) // cks * cks
    cold = (t0 == 0).to(torch.int32)
    w = {"j_end": j_end, "score": score, "t0": t0,
         "state4": restart_state(st["ckpts"], t0 // cks - 1, cold), "cold": cold,
         "steps_needed": (t_end - t0 + 1).to(torch.int32)}
    if st["lut"] is None:
        w["sig_win"], w["r_init"] = _gather_windows(st["sig"], t0, W, mp)
    return w


def _longread_pass2(st: dict, m_out: int | None = None) -> dict:
    """Two-pass pass 2: window recompute from the restart state, then the
    traceback in window steps, shifted back by t0; ``m_out`` the output
    width (default the group's longest template)."""
    w = window_inputs(st)
    m = st["m"]
    _count_cells(st["B"], st["W"], st["mp"])  # pass 2 (windowed pointer recompute)
    if st["lut"] is None:
        ptr = align_window_from_state(w["sig_win"], w["r_init"], w["state4"], w["cold"],
                                      w["steps_needed"], st["tmpl"], st["params"], m)
    else:
        ptr = align_window_from_state_morph(st["sig"], st["lut"], w["t0"], w["state4"],
                                            w["cold"], w["steps_needed"], st["levels"],
                                            st["lidx"], st["params"], m, st["W"])
    t0 = w["t0"]
    tb = traceback_pointers(ptr, (w["j_end"] - t0).to(torch.int32), m if m_out is None else m_out,
                            m_start=st["m_rows"])
    t0_32 = t0.to(torch.int32)
    return {"score": w["score"], "j_end": w["j_end"], "is_gap": tb["is_gap"],
            "jpos": tb["jpos"] + t0_32[:, None], "j_begin": tb["j_begin"] + t0_32}


def align_batch_longread(signals, n_actual, template_np, params, ckpt_steps: int = CKPT_STEPS,
                         lut=None):
    """Checkpointed two-pass alignment of a group of rows (B % 8 == 0).

    Exact by construction: pass 1 runs the score-only wave with
    diagonal-state checkpoints every ``ckpt_steps``; pass 2 recomputes
    pointers over a window that provably holds the optimal path,
    resuming from the checkpoint at its start, so pointers and
    tracebacks equal the one-pass plane's.  Device memory per row is
    O(ND/ckpt_steps + W) instead of O(ND).  Returns align_core's dict.
    """
    return _longread_pass2(_longread_pass1(signals, n_actual, template_np, params, ckpt_steps,
                                           lut))


def _pad_rows_np(x: np.ndarray, rows: int, value) -> np.ndarray:
    if x.shape[0] >= rows:
        return x
    return np.concatenate([x, np.full((rows - x.shape[0],) + x.shape[1:], value, x.dtype)])


def _two_pass_rows(signals, n_actual, tmpl_np, ms, params, ckpt_steps: int, lut=None,
                   devices=None) -> dict:
    """The two-pass route over a row stream: one template (``tmpl_np``
    (1, MP), ``ms`` one length) or one per row ((B, MP), (B,) lengths;
    pad rows get an all-+1e30 template of length 1).  Groups of
    :func:`two_pass_group` rows, round-robin over ``devices`` (default
    the input's device); with several devices a group takes at most its
    share of the rows, so that each device gets one.  Every group's
    pass 1 is queued before the first pass 2 runs, as the reference
    does.  The outputs come back to the input's device, rows in order."""
    B, N = signals.shape
    devs = list(devices) if devices else [signals.device]
    share = -(-B // len(devs))
    mp = tmpl_np.shape[1]
    per_row = tmpl_np.shape[0] > 1
    n_act = n_actual.to(torch.int32)
    m_out = int(np.max(ms))
    _, cks, nd = _ckpt_geometry(N, mp, ckpt_steps)
    w_steps = _window_steps(int(_span_bounds(params, np.unique(ms)).max()), cks)
    # the rows' CTAs (0: POW on f32 rows): every group's at least, so
    # that its pad rows change nothing; the plan reads the distinct rows
    ctas = 0 if lut is None else wave_table_ctas(tmpl_np)
    plan_rows = _distinct_rows(tmpl_np)[0]
    states = []
    g0 = 0
    while g0 < B:
        dev = devs[len(states) % len(devs)]
        c, kb = wave_launch_plan(min(B - g0, share), plan_rows, w_steps, dev, sm_count(dev),
                                 ctas, pass1_steps=nd)
        sl = slice(g0, g0 + kb)
        states.append(_pass1_rows(
            _pad_rows(signals[sl], kb, 0).to(dev), _pad_rows(n_act[sl], kb, 1).to(dev),
            _pad_rows_np(tmpl_np[sl], kb, 1e30) if per_row else tmpl_np,
            _pad_rows_np(ms[sl], kb, 1) if per_row else ms, params, ckpt_steps,
            None if lut is None else _pad_rows(lut[sl], kb, 0.0).to(dev), c))
        g0 += kb
    outs = [_longread_pass2(st, m_out) for st in states]
    return {k: torch.cat([o[k].to(signals.device) for o in outs])[:B] for k in outs[0]}


def align_longread_sharded(signals, n_actual, template_np, params, devices=None,
                           ckpt_steps: int = CKPT_STEPS, lut=None):
    """The two-pass route against one template, in groups of
    :func:`two_pass_group` rows round-robin over ``devices`` (a list, a
    device possibly repeated; default the input's device).

    ``lut``: morph-form input read in place (TABLE score mode; the
    caller decodes templates past the table to f32).  Every group's pass
    1 is queued before the first pass 2 runs, as the reference does; the
    outputs come back to the input's device.  Each group's rows are its
    own, so any device list gives the single device's outputs.
    """
    tmpl_np, m = pad_template(np.asarray(template_np, np.float32))
    return _two_pass_rows(signals, n_actual, tmpl_np, np.array([m]), params, ckpt_steps,
                          lut=lut, devices=devices)


def takes_two_pass(N: int, mp: int, device) -> bool:
    """Whether a bucket of N signal samples against MP template lanes
    takes the two-pass route: its width-8 pointer plane is past
    :func:`ptr_budget_bytes`.  Never under ``STRIQUE_ALIGN_KERNEL=col``,
    whose route has no two-pass form."""
    return (os.environ.get("STRIQUE_ALIGN_KERNEL") != "col"
            and (_round_up(N, CHUNK) + mp) * 8 * mp // 2 > ptr_budget_bytes(device))


def _fits_table(tmpl_np: np.ndarray) -> bool:
    """Whether the (R, MP) template rows fit the wave kernel's TABLE
    score mode, on one CTA a row or on a cluster."""
    return wave_table_ctas(tmpl_np) > 0


def _pad_signals(signals, lut):
    """Pad f32 signals to a multiple of CHUNK samples (0.0 fill); morph
    bins must come padded (0.0 is no level of their table)."""
    npad = (-signals.shape[1]) % CHUNK
    if npad and lut is not None:
        raise ValueError(f"morph bins must be padded to a multiple of {CHUNK} samples")
    return torch.nn.functional.pad(signals, (0, npad)) if npad else signals


def align_core(signals, n_actual, template_np, params, lut=None, devices=None):
    """Align B reads against one template; returns a dict of (B, ...) tensors.

    signals (B, N) f32 on the target device or, with ``lut`` (B, 256)
    f32, (B, N) u8 morph bins (N a multiple of 128); ``template_np`` a
    host array (its length is static).  Rows run in wave calls of
    :func:`kernel_batch` rows; the tail pads with length-1 rows.  Past
    the pointer budget even at width 8, the bucket takes the two-pass
    route (:func:`align_longread_sharded`), on morph input in the TABLE
    score mode where the template fits ``wave_table_ctas``'s table (one
    CTA a row, or a cluster: calls as wide as their CTAs fit the card).
    ``STRIQUE_ALIGN_KERNEL=col`` runs column-kernel calls instead
    (pointer plane N/8 x rows x MP, no two-pass route), as the reference
    does, on morph input in the TABLE score mode where the template fits
    ``col_table_ctas``'s table.  Past its table each route decodes morph
    input to f32.  ``devices``: where the two-pass route's groups run
    (round-robin); the other routes run on the input's device, as the
    reference's in-jit route ignores its devices.
    """
    dev = signals.device
    B = signals.shape[0]
    signals = _pad_signals(signals, lut)
    tmpl_np, m = pad_template(np.asarray(template_np, np.float32))
    mp = tmpl_np.shape[1]
    col = os.environ.get("STRIQUE_ALIGN_KERNEL") == "col"
    n_cols = signals.shape[1] + (0 if col else mp)
    two_pass = takes_two_pass(signals.shape[1], mp, dev)
    # CTAs a row of the TABLE mode (0: POW on the decoded f32)
    ctas = 1 if lut is None else (col_table_ctas if col else wave_table_ctas)(tmpl_np)
    if lut is not None and two_pass and ctas == 0:
        signals, lut = morph_decode(signals, lut), None
    if two_pass:
        if wave_span_bound_steps(params, m) is None:
            raise ValueError(
                "the pointer plane exceeds the memory budget even at width 8, and the "
                "two-pass route needs negative horizontal gap costs (no span bound "
                "exists otherwise)")
        return align_longread_sharded(signals, n_actual, template_np, params, devices, lut=lut)
    if lut is None:
        tmpl = torch.from_numpy(tmpl_np).to(dev)
    forms = {}  # (levels, lidx) by the CTAs a row of a call
    n_act = n_actual.to(torch.int32)
    outs = []
    b0 = 0
    while b0 < B:
        if lut is None:
            c, kb = ctas, kernel_batch(B - b0, n_cols=n_cols, mp=mp, device=dev,
                                       ctas=max(ctas, 1))
        elif col:
            c, kb = col_launch_plan(B - b0, tmpl_np, n_cols, dev, ctas=ctas)
        else:
            c, kb = wave_launch_plan(B - b0, tmpl_np, n_cols, dev, sm_count(dev), ctas=ctas)
        if lut is not None and c not in forms:
            forms[c] = _table_form(tmpl_np, c, dev)
        end = b0 + kb
        sl = _pad_rows(signals[b0:end], kb, 0)
        na = _pad_rows(n_act[b0:end], kb, 1)
        _count_cells(kb, n_cols, mp)
        if lut is None:
            run = _align_batch_col if col else _align_batch_wave
            outs.append(run(sl, na, tmpl, params, m))
        else:
            run = _align_batch_col_morph if col else _align_batch_wave_morph
            outs.append(run(sl, _pad_rows(lut[b0:end], kb, 0.0), na, *forms[c], params, m))
        b0 = end
    return {k: torch.cat([o[k] for o in outs])[:B] for k in outs[0]}


def fuse_flanks(B: int, N: int, tmpl_rows, device, sms: int | None = None,
                ctas: int | None = None) -> bool:
    """Whether :func:`align_fused_pair` runs both flanks of a B-read batch
    as one per-row-template row stream (N signal columns; ``tmpl_rows``
    the (2, MP) flank rows of :func:`pad_template_rows`; ``ctas`` their
    TABLE rule's CTAs a row as :func:`wave_launch_plan` takes it, 0 for
    POW).

    Card rule (a CUDA device, or any device when ``sms`` is given, and
    ``STRIQUE_ALIGN_KERNEL`` not ``col``): whenever the launch plan's
    first call over the 2B rows takes them all -- one launch in place of
    two.  The reference's rule otherwise (ops/align.py:324-334: a wave
    call costs its longest row whatever its width, so fuse when the
    per-flank tail is at most half a 64-row call, 0 < B % 64 <= 32).
    Either only while a width-8 pointer plane fits
    :func:`ptr_budget_bytes`.
    """
    mp = np.shape(tmpl_rows)[1]
    n_cols = _round_up(N, CHUNK) + mp
    if n_cols * 8 * mp // 2 > ptr_budget_bytes(device):
        return False
    if sms is None:
        sms = sm_count(device)
    if sms is not None and os.environ.get("STRIQUE_ALIGN_KERNEL") != "col":
        return wave_launch_plan(2 * B, tmpl_rows, n_cols, device, sms, ctas=ctas)[1] >= 2 * B
    return 0 < B % BATCH_WAVE <= BATCH_WAVE // 2


def _two_pass_pair(B: int, N: int, mp: int, params, device) -> bool:
    """Whether :func:`align_fused_pair` runs both flanks' two-pass routes
    as one row stream: on the card's rule (a CUDA device, and
    ``STRIQUE_ALIGN_KERNEL`` not ``col``), where a width-8 pointer plane
    exceeds :func:`ptr_budget_bytes` and a span bound exists.  The CPU
    keeps the reference's two :func:`align_core` calls."""
    return (sm_count(device) is not None and takes_two_pass(N, mp, device)
            and wave_span_bound_steps(params, 1) is not None)


def _split_flanks(out: dict, B: int, m_pre: int, m_suf: int):
    """(pre, suf) of a fused row stream's outputs: rows [0, B) and [B, 2B),
    per-element fields cut to each flank's length."""
    pre = {k: (v[:B, :m_pre] if v.ndim == 2 else v[:B]) for k, v in out.items()}
    suf = {k: (v[B:, :m_suf] if v.ndim == 2 else v[B:]) for k, v in out.items()}
    return pre, suf


def align_fused_pair(signals, n_actual, t_pre, t_suf, params, lut=None, devices=None):
    """Both flank alignments of a batch, fused into one row stream when
    :func:`fuse_flanks` says so: the rows [read0 x prefix .. readB x
    prefix, read0 x suffix ..] run as per-row-template calls.  Past the
    pointer budget on the card the same row stream takes the two-pass
    route (:func:`_two_pass_pair`): pass 1 of both flanks in one launch a
    group.  Otherwise two :func:`align_core` calls.  ``lut``: morph-form
    input, as in :func:`align_core`; ``devices``: where the two-pass
    groups run (round-robin), as in :func:`align_core`.  Returns (pre,
    suf).
    """
    t_pre = np.asarray(t_pre, np.float32)
    t_suf = np.asarray(t_suf, np.float32)
    dev = signals.device
    B, N = signals.shape
    tmpl_rows_np, ms = pad_template_rows([t_pre, t_suf])
    mp = tmpl_rows_np.shape[1]
    # CTAs a row of the row stream's TABLE mode (0: POW)
    ctas = 0 if lut is None else wave_table_ctas(tmpl_rows_np)
    fused = fuse_flanks(B, N, tmpl_rows_np, dev, ctas=ctas)
    if not fused and not _two_pass_pair(B, N, mp, params, dev):
        return (align_core(signals, n_actual, t_pre, params, lut=lut, devices=devices),
                align_core(signals, n_actual, t_suf, params, lut=lut, devices=devices))

    signals = _pad_signals(signals, lut)
    m_max = int(ms.max())
    n_act = n_actual.to(torch.int32)
    sig2 = torch.cat([signals, signals])
    na2 = torch.cat([n_act, n_act])
    R = 2 * B
    if not fused:
        lut2 = None if lut is None else torch.cat([lut, lut])
        if lut2 is not None and ctas == 0:
            sig2, lut2 = morph_decode(sig2, lut2), None
        out = _two_pass_rows(sig2, na2, np.repeat(tmpl_rows_np, B, axis=0), np.repeat(ms, B),
                             params, CKPT_STEPS, lut=lut2, devices=devices)
        return _split_flanks(out, B, len(t_pre), len(t_suf))

    def rows2(x):
        return torch.from_numpy(np.repeat(x, B, axis=0)).to(dev)

    # the first copies from pageable host memory block until the work
    # queued on the stream ran (on the card, the previous batch's kernels)
    with trace.span("align.h2d.wait"):
        if lut is None:
            tmpl2 = rows2(tmpl_rows_np)
        else:
            lut2 = torch.cat([lut, lut])
        ms2 = torch.from_numpy(np.repeat(ms.astype(np.int32), B)).to(dev)
    forms = {}  # the row stream's (levels, lidx) by the CTAs a row of a call
    n_cols = sig2.shape[1] + mp
    outs = []
    b0 = 0
    while b0 < R:
        c, kb = wave_launch_plan(R - b0, tmpl_rows_np, n_cols, dev, sm_count(dev), ctas=ctas)
        if lut is not None and c not in forms:
            forms[c] = tuple(rows2(x) for x in template_levels(tmpl_rows_np, c if c > 1 else None))
        if lut is not None:
            lv2, li2 = forms[c]
        end = b0 + kb
        sl = _pad_rows(sig2[b0:end], kb, 0)
        na = _pad_rows(na2[b0:end], kb, 1)
        mr = _pad_rows(ms2[b0:end], kb, 1)
        _count_cells(kb, n_cols, mp)
        # pad rows: an all-+1e30 template (levels 1e30, every lane index 0)
        if lut is None:
            outs.append(_align_batch_wave_multi(sl, na, _pad_rows(tmpl2[b0:end], kb, 1e30), mr,
                                                params, m_max))
        else:
            outs.append(_align_batch_wave_multi_morph(
                sl, _pad_rows(lut2[b0:end], kb, 0.0), na, _pad_rows(lv2[b0:end], kb, 1e30),
                _pad_rows(li2[b0:end], kb, 0), mr, params, m_max))
        b0 = end
    out = {k: torch.cat([o[k] for o in outs])[:R] for k in outs[0]}
    return _split_flanks(out, B, len(t_pre), len(t_suf))


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
