"""Anti-diagonal Gotoh flank-alignment forward: CUDA kernel + plain twins.

Counterpart of ``strique_tpu/ops/align_pallas.py``'s wavefront kernel,
the Pallas body ``_wave_kernel``, in all four of its calls:

  * ``align_forward_wave`` (one shared template) and
    ``align_forward_wave_multi`` (a template per row): pointers and
    bottom taps; twin ``_wave_plain``;
  * ``align_forward_ckpt``: pass 1 of the ultra-long two-pass route,
    score-only with diagonal-state checkpoints; twin ``_ckpt_plain``;
  * ``align_window_from_state``: pass 2, pointers over a window resumed
    from a checkpoint; twin ``_window_plain``.

The kernel is ``csrc/wave_align.cu`` (one body, compile-time modes);
each twin is the same recurrence in PyTorch ops (``_wave_recurrence``),
used only for tensors on the CPU (and by the on-card comparisons).

Layouts are the reference's, so the traceback and the tests compare
like with like:

  * template lanes: lane i holds template[i-1], lane 0 and the pad
    lanes hold +1e30 (MP a multiple of 128);
  * ``ptr`` (ND/8, B, MP) int32, ND = N + MP diagonal steps: the 4-bit
    code of cell (i, j) sits at word [(i+j-1)//8, row, i], nibble
    (i+j-1) % 8 -- bits 0-1 best matrix (M=0, H=1, V=2), bit 2 Ih
    extends, bit 3 "Iv(i+1, j) extends from here" (stored at its source
    cell);
  * ``bottom`` (B, ND) f32: step t holds the bottom-row score of column
    j = t + 1 - m_row, NEG outside 1 <= j <= n.

Each row stops at its own last useful step, round_up(n + m, 8): pointer
words past it are left unwritten (no traceback reads them) and its
bottom is NEG there, as in the reference.

The score's |d|^1.2 is ``(float)pow((double)d, (double)1.2f)`` on both
sides.  XLA's f32 ``jnp.power`` is not correctly rounded: it differs
from this by one ulp on about 0.065% of inputs (and ``torch.pow`` in
f32 by up to 41 ulp), so scores agree with the reference to that
measured bound; see ROADMAP.md Queue 3.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import _build

NEG = -1e30
LANE = 128
CHUNK = 128
# wave call width: the kernel runs one CTA per row, so a call's time is
# set by its longest row, not by its width; one 64-row shape serves
# every batch (the fusion rule in ops.align keys on it)
BATCH_WAVE = 64
POW_EXP = float(np.float32(1.2))  # the reference's f32 exponent, widened

_DEFAULT_PTR_BUDGET = int(3.5 * (1 << 30))
_ptr_budget_cache: dict = {}


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def pad_template(template) -> tuple[np.ndarray, int]:
    """Template (M,) -> ((1, MP) lane layout with +1e30 pads, M)."""
    m = len(template)
    mp = _round_up(m + 1, LANE)
    out = np.full((1, mp), 1e30, np.float32)
    out[0, 1 : m + 1] = template
    return out, m


def pad_template_rows(templates) -> tuple[np.ndarray, np.ndarray]:
    """Per-row templates -> ((R, MP) lane layout with +1e30 pads, (R,) m)."""
    ms = np.array([len(t) for t in templates], np.int32)
    mp = _round_up(int(ms.max()) + 1, LANE)
    out = np.full((len(templates), mp), 1e30, np.float32)
    for r, t in enumerate(templates):
        out[r, 1 : len(t) + 1] = np.asarray(t, np.float32)
    return out, ms


def ptr_budget_bytes(device=None) -> int:
    """Device-memory budget for one call's pointer plane.

    ``STRIQUE_PTR_BUDGET_GB`` overrides (re-read per call); else 60% of
    the card's free memory at first use (``torch.cuda.mem_get_info``);
    3.5 GB for CPU tensors.
    """
    env = os.environ.get("STRIQUE_PTR_BUDGET_GB")
    if env is not None:
        try:
            return int(float(env) * (1 << 30))
        except ValueError:
            pass
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return _DEFAULT_PTR_BUDGET
    key = dev.index if dev.index is not None else torch.cuda.current_device()
    if key not in _ptr_budget_cache:
        free, _total = torch.cuda.mem_get_info(key)
        _ptr_budget_cache[key] = max(int(free * 0.6), 1 << 28)
    return _ptr_budget_cache[key]


def kernel_batch(b: int | None = None, n_cols: int | None = None,
                 mp: int | None = None, device=None) -> int:
    """Rows per wave call.

    On the card every call is BATCH_WAVE rows wide (a call costs its
    longest row).  On the CPU the plain twin's cost grows with width, so
    a call covers only the remaining rows, rounded up to 8.  With
    ``n_cols``/``mp`` the width shrinks (never below 8) to keep the
    pointer plane inside :func:`ptr_budget_bytes`.
    """
    dev = torch.device(device) if device is not None else torch.device("cpu")
    kb = BATCH_WAVE
    if dev.type != "cuda" and b is not None:
        kb = min(BATCH_WAVE, max(8, _round_up(int(b), 8)))
    if n_cols is not None and mp is not None:
        budget = ptr_budget_bytes(dev)
        while kb > 8 and n_cols * kb * mp // 2 > budget:
            kb -= 8
    return kb


def _f32(x) -> float:
    return float(np.float32(x))


def score_pow(diff: torch.Tensor) -> torch.Tensor:
    """|d|^1.2 rounded as the kernel rounds it: f32 -> f64 pow -> f32."""
    return torch.pow(diff.double(), POW_EXP).float()


def _consts(params) -> dict:
    return {
        "go_h": _f32(params.gap_open_h), "go_v": _f32(params.gap_open_v),
        "ge_h": _f32(params.gap_extension_h), "ge_v": _f32(params.gap_extension_v),
        "off": _f32(params.dist_offset), "dmin": _f32(params.dist_min),
        "g": _f32(max(params.gap_extension_v, params.gap_open_v)),
        "neg_h": bool(params.gap_open_h < 0 and params.gap_extension_h <= 0),
    }


def _check_inputs(signals, n_actual, tmpl, m_rows):
    """Shapes, dtypes and devices the kernel relies on (it indexes by them)."""
    B, N = signals.shape
    if B % 8 or N % CHUNK:
        raise ValueError(f"wave call needs B % 8 == 0 and N % {CHUNK} == 0, got {(B, N)}")
    if signals.dtype != torch.float32 or tmpl.dtype != torch.float32:
        raise TypeError("signals and templates must be float32")
    mp = tmpl.shape[1]
    if mp % LANE or mp > 8192:
        raise ValueError(f"template lanes must be a multiple of {LANE} up to 8192, got {mp}")
    if tmpl.shape[0] not in (1, B) or n_actual.shape != (B,) or m_rows.shape != (B,):
        raise ValueError("one template (or one per row), one length and one m per row")
    for x in (n_actual, tmpl, m_rows):
        if x.device != signals.device:
            raise ValueError("all wave inputs must share one device")
    return B, N, mp


def _wave_recurrence(sig_ext, tmpl, n_actual, m_rows, params, nd: int, t_run: int, *,
                     with_ptr: bool = True, with_bottom: bool = True, ckpt_steps: int = 0,
                     state4=None, cold=None):
    """The wave recurrence in plain PyTorch ops over (B, MP) rows.

    Same expression trees as the reference kernel (align_pallas.py
    ``_wave_kernel``), step for step, in all of its modes.  Lane i at
    step t reads ``sig_ext[:, MP + t - i]``; ``tmpl`` is (1, MP) or
    (B, MP), ``m_rows`` (B,) the template lengths of the bottom taps.
    Runs ``t_run`` of the ``nd`` steps and returns (ptr, bottom, ckpts),
    None for what the mode does not produce:

      * ``with_ptr``: the (nd/8, B, MP) pointer plane;
      * ``with_bottom``: the (B, nd) bottom taps;
      * ``ckpt_steps`` > 0: four (nd/ckpt_steps, B, MP) planes (S1, S2,
        Ih, C), slot g the state after step (g+1)*ckpt_steps - 1;
      * ``state4`` (S1, S2, Ih, C): resume from that state instead of
        the cold start; ``cold`` (B,) then gates the column-0 forcing.
    """
    k = _consts(params)
    B = sig_ext.shape[0]
    mp = tmpl.shape[1]
    dev = sig_ext.device
    lane = torch.arange(mp, device=dev)
    lane_f = lane.to(torch.float32)
    row0 = lane == 0
    s0_col = torch.where(row0, torch.zeros((), device=dev), k["go_v"] + k["ge_v"] * (lane_f - 1.0))
    cv_off = (lane_f + 1.0) * k["g"]
    iv_off = lane_f * k["g"]
    n_act = n_actual.to(torch.int64)
    m_r = m_rows.to(torch.int64)
    if state4 is None:
        s1 = torch.where(row0, 0.0, NEG).to(torch.float32).expand(B, mp).clone()
        s2, ih, c = (torch.full((B, mp), NEG, device=dev) for _ in range(3))
    else:
        s1, s2, ih, c = (x.to(torch.float32).clone() for x in state4)
    force = (torch.ones(B, dtype=torch.bool, device=dev) if cold is None
             else cold.to(device=dev) != 0)
    fill_s = torch.full((B, 1), -k["dmin"] if k["neg_h"] else NEG, device=dev)
    fill_neg = torch.full((B, 1), NEG, device=dev)
    ptr = torch.zeros((nd // 8, B, mp), dtype=torch.int32, device=dev) if with_ptr else None
    bottom = torch.full((B, nd), NEG, device=dev) if with_bottom else None
    ckpts = (tuple(torch.zeros((nd // ckpt_steps, B, mp), device=dev) for _ in range(4))
             if ckpt_steps else None)
    acc = torch.zeros((B, mp), dtype=torch.int32, device=dev)
    m_idx = m_r[:, None]
    for t in range(t_run):
        r = sig_ext[:, t + mp - lane]
        sc = torch.clamp_min(k["off"] - score_pow((r - tmpl).abs()), k["dmin"])
        ih_ext = ih + k["ge_h"]
        ih_open = s1 + k["go_h"]
        new_ih = torch.maximum(ih_ext, ih_open)
        new_m = torch.cat([fill_s, s2[:, :-1]], dim=1) + sc
        q = torch.maximum(new_m, new_ih)
        if not k["neg_h"]:
            q = torch.where(row0, 0.0, q)
        cvec = (q + k["go_v"]) - cv_off
        c_sh = torch.cat([fill_neg, c[:, :-1]], dim=1)
        new_c = torch.maximum(c_sh, cvec)
        new_iv = c_sh + iv_off
        new_s = torch.maximum(q, new_iv)
        if with_ptr:
            which = torch.where(new_m >= new_s, 0, torch.where(new_iv >= new_s, 2, 1))
            code = (which.to(torch.int32)
                    | ((ih_ext >= ih_open).to(torch.int32) << 2)
                    | (((new_iv + k["ge_v"]) >= (new_s + k["go_v"])).to(torch.int32) << 3))
            acc |= code << (4 * (t % 8))
        if t + 1 < mp:
            # the cell (t+1, 0) enters the valid region: pin its column-0
            # boundary (in a resumed window only for rows that start cold)
            new_s[:, t + 1] = torch.where(force, s0_col[t + 1], new_s[:, t + 1])
            new_ih[:, t + 1] = torch.where(force, NEG, new_ih[:, t + 1])
        if with_bottom:
            j = t + 1 - m_r
            live = (j >= 1) & (j <= n_act)
            bottom[:, t] = torch.where(live, new_s.gather(1, m_idx)[:, 0], NEG)
        s2, s1, ih, c = s1, new_s, new_ih, new_c
        if ckpt_steps and (t + 1) % ckpt_steps == 0:
            for plane, x in zip(ckpts, (s1, s2, ih, c)):
                plane[(t + 1) // ckpt_steps - 1] = x
        if with_ptr and t % 8 == 7:
            ptr[t // 8] = acc
            acc = torch.zeros_like(acc)
    return ptr, bottom, ckpts


def _signal_ext(signals, mp: int):
    """Lane i at step t reads a[t - i]: NEG before the signal, 0 past it."""
    B = signals.shape[0]
    dev = signals.device
    return torch.cat([torch.full((B, mp), NEG, device=dev), signals,
                      torch.zeros((B, mp), device=dev)], dim=1)


def _steps_to_run(n_actual, m_rows, nd: int) -> int:
    """Steps the longest row needs: round_up(n + m, 8), at most nd."""
    if n_actual.numel() == 0:
        return 0
    return int(min(nd, _round_up(int((n_actual.to(torch.int64) + m_rows.to(torch.int64)).max()),
                                 8)))


def _wave_plain(signals, tmpl, n_actual, m_rows, params):
    """Plain twin of the pointer-writing wave kernel (rows 1-2):
    (ptr (ND/8, B, MP), bottom (B, ND)), ND = N + MP."""
    mp = tmpl.shape[1]
    nd = signals.shape[1] + mp
    ptr, bottom, _ = _wave_recurrence(_signal_ext(signals, mp), tmpl, n_actual, m_rows, params,
                                      nd, _steps_to_run(n_actual, m_rows, nd))
    return ptr, bottom


def _ckpt_plain(signals, tmpl, n_actual, m_rows, params, ckpt_steps: int):
    """Plain twin of the checkpoint kernel (row 5): (bottom, (S1, S2, Ih, C))."""
    mp = tmpl.shape[1]
    nd = signals.shape[1] + mp
    _, bottom, ckpts = _wave_recurrence(_signal_ext(signals, mp), tmpl, n_actual, m_rows,
                                        params, nd, _steps_to_run(n_actual, m_rows, nd),
                                        with_ptr=False, ckpt_steps=ckpt_steps)
    return bottom, ckpts


def _window_plain(sig_win, r_init, state4, cold, steps_needed, tmpl, params):
    """Plain twin of the window kernel (row 6): ptr (W/8, B, MP).

    Lane i at local step tau reads a[t0 + tau - i]: ``sig_win[tau - i]``
    inside the window, ``r_init[i - tau - 1]`` before it.
    """
    B, W = sig_win.shape
    mp = tmpl.shape[1]
    sig_ext = torch.cat([torch.flip(r_init, dims=[1]), sig_win], dim=1)
    zeros = torch.zeros(B, dtype=torch.int32, device=sig_win.device)
    ptr, _, _ = _wave_recurrence(sig_ext, tmpl, steps_needed, zeros, params, W,
                                 _steps_to_run(steps_needed, zeros, W), with_bottom=False,
                                 state4=state4, cold=cold)
    return ptr


def _wave_cuda(signals, tmpl, n_actual, m_rows, params, counter: str):
    k = _consts(params)
    B, N = signals.shape
    mp = tmpl.shape[1]
    nd = N + mp
    sig = signals.contiguous()
    tm = tmpl.contiguous()
    nact = n_actual.to(torch.int32).contiguous()
    mrow = m_rows.to(torch.int32).contiguous()
    ptr = torch.empty((nd // 8, B, mp), dtype=torch.int32, device=signals.device)
    bottom = torch.empty((B, nd), dtype=torch.float32, device=signals.device)
    tmpl_stride = 0 if tm.shape[0] == 1 else mp
    _build.launch(
        "wave_align_launch", signals.device,
        sig.data_ptr(), tm.data_ptr(), nact.data_ptr(), mrow.data_ptr(),
        ptr.data_ptr(), bottom.data_ptr(),
        B, N, mp, tmpl_stride, int(k["neg_h"]),
        k["go_h"], k["go_v"], k["ge_h"], k["ge_v"], k["off"], k["dmin"], k["g"])
    _build.LAUNCHES[counter] += 1
    return ptr, bottom


def _dispatch(signals, tmpl, n_actual, m_rows, params, counter):
    if _on_card(signals):
        return _wave_cuda(signals, tmpl, n_actual, m_rows, params, counter)
    return _wave_plain(signals, tmpl, n_actual, m_rows, params)


def align_forward_wave(signals, n_actual, template_padded, params, m_actual: int):
    """Wavefront forward DP of B reads against one shared template.

    signals (B, N) f32, N a multiple of 128; template_padded (1, MP).
    Returns (ptr (ND//8, B, MP) int32, bottom (B, ND) f32), ND = N + MP.
    """
    B = signals.shape[0]
    if template_padded.shape[0] != 1 or not 0 < m_actual < template_padded.shape[1]:
        raise ValueError("align_forward_wave takes one (1, MP) template of m < MP samples")
    m_rows = torch.full((B,), int(m_actual), dtype=torch.int32, device=signals.device)
    _check_inputs(signals, n_actual, template_padded, m_rows)
    return _dispatch(signals, template_padded, n_actual, m_rows, params,
                     "align_forward_wave")


def align_forward_wave_multi(signals, n_actual, template_rows, m_rows, params):
    """Wavefront forward DP with a template and length per row (flank fusion).

    template_rows (B, MP); m_rows (B,).  Row r's bottom holds column
    j = t + 1 - m_rows[r].
    """
    _check_inputs(signals, n_actual, template_rows, m_rows)
    if template_rows.shape[0] != signals.shape[0]:
        raise ValueError("one template row per signal row")
    return _dispatch(signals, template_rows, n_actual, m_rows, params,
                     "align_forward_wave_multi")


# ---------------------------------------------------------------------------
# Checkpointed two-pass mode for ultra-long reads (kernel rows 5 and 6)
# ---------------------------------------------------------------------------
#
# Past the pointer budget even a width-8 plane cannot exist.  Pass 1 runs
# the score-only forward and dumps the diagonal state (S1, S2, Ih, C)
# every ckpt_steps; its bottom taps give each row's exact score and end
# column.  Pass 2 re-runs a W-step window WITH pointers from the
# checkpoint at or before t_end - bound (:func:`wave_span_bound_steps`),
# so its pointers equal the one-pass plane's (align_pallas.py:718-740).


def wave_span_bound_steps(params, m: int) -> int | None:
    """Upper bound on an optimal path's diagonal extent, in steps
    (align_pallas.py ``wave_span_bound_steps``).

    None when horizontal gaps are free or positive: no bound exists, and
    such configurations have no two-pass route.
    """
    gap = max(params.gap_open_h, params.gap_extension_h)
    if gap >= 0:
        return None
    raw_min = params.gap_open_v + params.gap_extension_v * (m - 1)
    gain_max = max(params.dist_offset, params.dist_min)  # sc <= max(off, dmin)
    span_cols = m + (m * gain_max - raw_min) / abs(gap)
    return int(np.ceil(span_cols)) + m + 1


def _on_card(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"wave alignment runs on cuda or cpu tensors, got {x.device}")


def _ckpt_cuda(signals, tmpl, n_actual, m_rows, params, ckpt_steps: int):
    k = _consts(params)
    B, N = signals.shape
    mp = tmpl.shape[1]
    nd = N + mp
    dev = signals.device
    sig = signals.contiguous()
    tm = tmpl.contiguous()
    nact = n_actual.to(torch.int32).contiguous()
    mrow = m_rows.to(torch.int32).contiguous()
    bottom = torch.empty((B, nd), dtype=torch.float32, device=dev)
    ckpts = tuple(torch.empty((nd // ckpt_steps, B, mp), dtype=torch.float32, device=dev)
                  for _ in range(4))
    _build.launch(
        "wave_ckpt_launch", dev,
        sig.data_ptr(), tm.data_ptr(), nact.data_ptr(), mrow.data_ptr(), bottom.data_ptr(),
        *(c.data_ptr() for c in ckpts),
        B, N, mp, ckpt_steps, int(k["neg_h"]),
        k["go_h"], k["go_v"], k["ge_h"], k["ge_v"], k["off"], k["dmin"], k["g"])
    _build.LAUNCHES["align_forward_ckpt"] += 1
    return bottom, ckpts


def _window_cuda(sig_win, r_init, state4, cold, steps_needed, tmpl, params):
    k = _consts(params)
    B, W = sig_win.shape
    mp = tmpl.shape[1]
    dev = sig_win.device
    sw = sig_win.contiguous()
    ri = r_init.contiguous()
    tm = tmpl.contiguous()
    st = tuple(x.contiguous() for x in state4)
    steps = steps_needed.to(torch.int32).contiguous()
    cold_i = cold.to(torch.int32).contiguous()
    ptr = torch.empty((W // 8, B, mp), dtype=torch.int32, device=dev)
    _build.launch(
        "wave_window_launch", dev,
        sw.data_ptr(), ri.data_ptr(), tm.data_ptr(), steps.data_ptr(),
        *(x.data_ptr() for x in st), cold_i.data_ptr(), ptr.data_ptr(),
        B, W, mp, int(k["neg_h"]),
        k["go_h"], k["go_v"], k["ge_h"], k["ge_v"], k["off"], k["dmin"], k["g"])
    _build.LAUNCHES["align_window_from_state"] += 1
    return ptr


def align_forward_ckpt(signals, n_actual, template_padded, params, m_actual: int,
                       ckpt_chunks: int):
    """Pass 1: score-only wave forward with diagonal-state checkpoints.

    signals (B, N) f32 with ND = N + MP a multiple of ckpt_chunks*128;
    template_padded (1, MP).  Returns (bottom_steps (B, ND), ckpts), the
    4-tuple of (ND/(ckpt_chunks*128), B, MP) f32 planes (S1, S2, Ih, C):
    slot g holds the state after diagonal step (g+1)*ckpt_chunks*128-1.
    A row stops at round_up(n + m, 8): slots past that stop are left
    unwritten, and pass 2 never reads them.  No pointer plane exists.
    """
    B, N = signals.shape
    mp = template_padded.shape[1]
    if template_padded.shape[0] != 1 or not 0 < m_actual < mp:
        raise ValueError("align_forward_ckpt takes one (1, MP) template of m < MP samples")
    ckpt_steps = int(ckpt_chunks) * CHUNK
    if ckpt_steps <= 0 or (N + mp) % ckpt_steps:
        raise ValueError(f"ND = {N + mp} must be a multiple of the checkpoint stride "
                         f"{ckpt_steps}")
    m_rows = torch.full((B,), int(m_actual), dtype=torch.int32, device=signals.device)
    _check_inputs(signals, n_actual, template_padded, m_rows)
    if _on_card(signals):
        return _ckpt_cuda(signals, template_padded, n_actual, m_rows, params, ckpt_steps)
    return _ckpt_plain(signals, template_padded, n_actual, m_rows, params, ckpt_steps)


def align_window_from_state(sig_win, r_init, state4, cold, steps_needed, template_padded,
                            params, m_actual: int):
    """Pass 2: pointer forward over a W-step window, resumed from saved state.

    sig_win (B, W): a[t0 .. t0+W) per row; r_init (B, MP): lane i holds
    a[t0-1-i] (both 0.0 outside the signal, as the reference's window
    gather pads); state4 (S1, S2, Ih, C), each (B, MP), the state after
    step t0-1 (cold-start values where ``cold`` is 1: only those rows
    pin the column-0 boundary); steps_needed (B,) local steps a row
    needs (it runs round_up(steps, 8), at most W).  Returns the
    (W/8, B, MP) pointer plane in local step space; ``m_actual`` is the
    template length (the reference's discarded bottom tap).
    """
    B, W = sig_win.shape
    mp = template_padded.shape[1]
    if template_padded.shape[0] != 1 or not 0 < m_actual < mp:
        raise ValueError("align_window_from_state takes one (1, MP) template of m < MP samples")
    _check_inputs(sig_win, steps_needed, template_padded, cold)
    if len(state4) != 4 or any(x.shape != (B, mp) or x.dtype != torch.float32
                               or x.device != sig_win.device for x in (r_init, *state4)):
        raise ValueError("r_init and the four state planes are (B, MP) f32 on the window's device")
    if _on_card(sig_win):
        return _window_cuda(sig_win, r_init, state4, cold, steps_needed, template_padded, params)
    return _window_plain(sig_win, r_init, state4, cold, steps_needed, template_padded, params)
