"""Semi-global affine flank alignment, its traceback, bounds and gate.

The recurrence of STRique's flank alignment (reference
scripts/STRique.py:515-585) in the anti-diagonal form the package
states (step t, lane i = template row i, signal column j = t + 1 - i):

    Ih   = max(Ih + ge_h, S[t-1] + go_h)              horizontal gap
    M    = S[t-2] of lane i-1 + score                  match
    Q    = max(M, Ih)
    C    = max(C of lane i-1, Q + go_v - (i+1) g)      running vertical maximum
    Iv   = C of lane i-1 + i g                         vertical gap
    S    = max(Q, Iv)

with score = max(dist_offset - |x - level|^1.2, dist_min), the power
taken in float64 and rounded to float32, and g = max(ge_v, go_v).  Row
0 is free (a flank may start anywhere in the read); column 0 holds the
template in one vertical gap.  Each cell keeps a 4-bit pointer: which
of M, Iv, Ih won (0, 2, 1), whether Ih extended, and whether the
vertical gap extended.  The end column is the leftmost maximum of the
bottom row, the virtual column 0 included; the traceback walks the
pointers from it to row 0.

Plain PyTorch in the float type given (float32 for the reference; a
lower one for the control).  Steps run in blocks; on a card each block
after the first template-width of steps is one CUDA graph replayed,
so the host's launch cost does not set the reference's time.
"""
from __future__ import annotations

import numpy as np
import torch

NEG = -1e30
LANE = 128
MAT_M, MAT_H, MAT_V = 0, 1, 2
POW_EXP = float(np.float32(1.2))
BLOCK = 32


def _f32(x) -> float:
    return float(np.float32(x))


def _consts(params: dict) -> dict:
    return {
        "go_h": _f32(params["gap_open_h"]), "go_v": _f32(params["gap_open_v"]),
        "ge_h": _f32(params["gap_extension_h"]), "ge_v": _f32(params["gap_extension_v"]),
        "off": _f32(params["dist_offset"]), "dmin": _f32(params["dist_min"]),
        "g": _f32(max(params["gap_extension_v"], params["gap_open_v"])),
        "neg_h": bool(params["gap_open_h"] < 0 and params["gap_extension_h"] <= 0),
    }


def lane_templates(templates) -> tuple[np.ndarray, np.ndarray]:
    """Per-row templates -> ((R, MP) f32 lanes, template at lanes 1..m and
    +1e30 elsewhere; (R,) m), MP = m_max + 1 rounded up to 128."""
    ms = np.array([len(t) for t in templates], np.int64)
    mp = -(-(int(ms.max()) + 1) // LANE) * LANE
    out = np.full((len(templates), mp), 1e30, np.float32)
    for r, t in enumerate(templates):
        out[r, 1 : len(t) + 1] = t
    return out, ms


def _replay(body, count: int, device) -> None:
    """Run ``body()`` ``count`` times: on a card one eager run, then the
    rest as replays of one captured CUDA graph."""
    if count <= 0:
        return
    body()
    count -= 1
    if count == 0 or device.type != "cuda":
        for _ in range(count):
            body()
        return
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    for _ in range(count):
        graph.replay()
    torch.cuda.synchronize(device)
    del graph


def wave(sig, n, tmpl, m, params: dict, dtype=torch.float32):
    """The forward pass over R rows.

    sig (R, N) f32 signals, n (R,) their lengths, tmpl (R, MP) lanes,
    m (R,) template lengths, all on one device.  Returns (codes
    (steps, R, MP) u8 pointer codes, bottom (R, steps) in ``dtype``:
    S at lane m of each step where the column lies in 1..n, NEG
    elsewhere)."""
    k = _consts(params)
    dev = sig.device
    R, N = sig.shape
    mp = tmpl.shape[1]
    t_run = int((n + m).max())
    n_blocks = -(-t_run // BLOCK)
    steps = n_blocks * BLOCK
    lane = torch.arange(mp, device=dev)
    lane_f = lane.to(torch.float32)
    row0 = lane == 0
    s0_col = torch.where(row0, torch.zeros((), device=dev),
                         k["go_v"] + k["ge_v"] * (lane_f - 1.0)).to(dtype)
    cv_off = ((lane_f + 1.0) * k["g"]).to(dtype)
    iv_off = (lane_f * k["g"]).to(dtype)
    sig_ext = torch.cat([torch.full((R, mp), NEG, device=dev), sig.to(torch.float32),
                         torch.zeros((R, mp), device=dev)], dim=1)
    last = sig_ext.shape[1] - 1
    tm = tmpl.to(torch.float32)[:, None, :]

    def ext(fill, shape=(R, mp + 1)):
        """A state in the shifted layout: column 0 the lane -1 fill, then lanes."""
        x = torch.empty(shape, dtype=dtype, device=dev)
        x[..., 0] = fill
        return x

    fill_s = -k["dmin"] if k["neg_h"] else NEG
    # the state after the last step and the one before it, the Ih and C rows
    s1, s2, cx = ext(fill_s), ext(fill_s), ext(NEG)
    s1[:, 1:] = torch.where(row0, 0.0, NEG).to(dtype)
    s2[:, 1:] = NEG
    cx[:, 1:] = NEG
    ih = torch.full((R, mp), NEG, dtype=dtype, device=dev)
    # a block's states, step by step, and its four comparisons a cell
    S, C = ext(fill_s, (BLOCK, R, mp + 1)), ext(NEG, (BLOCK, R, mp + 1))
    IH = torch.empty((BLOCK, R, mp), dtype=dtype, device=dev)
    CMP = torch.empty((4, BLOCK, R, mp), dtype=torch.bool, device=dev)
    codes = torch.zeros((steps, R, mp), dtype=torch.uint8, device=dev)
    bottom = torch.full((R, steps), NEG, dtype=dtype, device=dev)
    m_tap = (m.to(torch.int64) + 1)[None, :, None].expand(BLOCK, R, 1)
    ar = torch.arange(BLOCK, device=dev)
    t0 = torch.zeros((), dtype=torch.int64, device=dev)
    back = (mp - lane)[None, :]

    def block(force_at):
        idx = (t0 + ar[:, None] + back).clamp_max(last).reshape(1, -1).expand(R, -1)
        x = sig_ext.gather(1, idx).reshape(R, BLOCK, mp)
        diff = (x - tm).abs()
        scb = torch.clamp_min(k["off"] - torch.pow(diff.double(), POW_EXP).float(), k["dmin"])
        scb = scb.to(dtype)
        for j in range(BLOCK):
            a1 = S[j - 1] if j >= 1 else s1
            a2 = S[j - 2] if j >= 2 else (s1 if j == 1 else s2)
            ac = C[j - 1] if j >= 1 else cx
            aih = IH[j - 1] if j >= 1 else ih
            ih_ext = aih + k["ge_h"]
            ih_open = a1[:, 1:] + k["go_h"]
            new_ih = torch.maximum(ih_ext, ih_open, out=IH[j])
            new_m = a2[:, :-1] + scb[:, j]
            q = torch.maximum(new_m, new_ih)
            if not k["neg_h"]:
                q = torch.where(row0, 0.0, q).to(dtype)
            cvec = (q + k["go_v"]) - cv_off
            c_sh = ac[:, :-1]
            torch.maximum(c_sh, cvec, out=C[j, :, 1:])
            new_iv = c_sh + iv_off
            new_s = torch.maximum(q, new_iv, out=S[j, :, 1:])
            torch.ge(new_m, new_s, out=CMP[0, j])
            torch.ge(new_iv, new_s, out=CMP[1, j])
            torch.ge(ih_ext, ih_open, out=CMP[2, j])
            torch.ge(new_iv + k["ge_v"], new_s + k["go_v"], out=CMP[3, j])
            if force_at is not None and force_at + j + 1 < mp:
                col = force_at + j + 1
                new_s[:, col] = s0_col[col]
                new_ih[:, col] = NEG
        # pointer code: M 0, Ih 1, Iv 2 (ties to M, then Iv); Ih extended
        # (bit 2); vertical gap extended (bit 3)
        which = torch.where(CMP[0], 0, torch.where(CMP[1], 2, 1))
        code = which | (CMP[2].to(torch.int64) << 2) | (CMP[3].to(torch.int64) << 3)
        pos = t0 + ar
        codes.index_copy_(0, pos, code.to(torch.uint8))
        bottom.index_copy_(1, pos, S.gather(2, m_tap)[:, :, 0].T)
        s1.copy_(S[BLOCK - 1])
        s2.copy_(S[BLOCK - 2])
        ih.copy_(IH[BLOCK - 1])
        cx.copy_(C[BLOCK - 1])
        t0.add_(BLOCK)

    # the first template-width of steps pins column 0 (cell (t+1, 0))
    forced = min(n_blocks, -(-mp // BLOCK))
    for b in range(forced):
        block(b * BLOCK)
    _replay(lambda: block(None), n_blocks - forced, dev)
    tpos = torch.arange(steps, device=dev)[None, :]
    j = tpos + 1 - m[:, None].to(torch.int64)
    live = (j >= 1) & (j <= n[:, None].to(torch.int64))
    bottom = torch.where(live, bottom, torch.tensor(NEG, dtype=dtype, device=dev))
    return codes, bottom


def end_columns(bottom, m, params: dict):
    """(j_end (R,) int64, score (R,)): the leftmost maximum of the bottom
    row over columns 0..n, column 0 being the whole template in one
    vertical gap (go_v + ge_v (m - 1), in f32)."""
    tstar = torch.argmax(bottom, dim=1)
    smax = bottom.gather(1, tstar[:, None])[:, 0]
    mm = m.to(torch.int64)
    jstar = tstar + 1 - mm
    b0 = (_f32(params["gap_open_v"])
          + _f32(params["gap_extension_v"]) * (mm.to(torch.float32) - 1.0)).to(bottom.dtype)
    return torch.where(b0 >= smax, 0, jstar), torch.maximum(b0, smax)


def traceback(codes, j_end, m, m_out: int):
    """Walk the pointer codes from (m, j_end) to row 0: (is_gap (R, m_out)
    bool, jpos (R, m_out) int64), per template element whether it sits in
    a vertical gap and the signal index it aligned to."""
    R = j_end.shape[0]
    dev = j_end.device
    rows = torch.arange(R, device=dev)
    iota = torch.arange(m_out, device=dev)

    def lookup(jc, ic):
        t = torch.clamp_min(ic + jc - 1, 0)
        word = codes[t, rows, torch.clamp_min(ic, 0)].to(torch.int64)
        return torch.where(jc > 0, word, MAT_V | 8)

    i = m.to(torch.int64).clone()
    j = j_end.to(torch.int64).clone()
    byte = lookup(j, i)
    cur = byte & 3
    is_gap = torch.zeros((R, m_out), dtype=torch.bool, device=dev) | (j < 0)[:, None]
    jpos = torch.zeros((R, m_out), dtype=torch.int64, device=dev)
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
        # the vertical-extend bit lives at the cell stepped to
        ext = torch.where(is_h, (byte >> 2) & 1, (nbyte >> 3) & 1)
        stay = ~is_m & (ext == 1)
        ncur = torch.where(stay, cur, torch.where(ni > 0, nbyte & 3, MAT_M))
        i = torch.where(active, ni, i)
        j = torch.where(active, nj, j)
        cur = torch.where(active, ncur, cur)
        byte = torch.where(active, nbyte, byte)
    return is_gap, jpos


def nearest_positions(is_gap: np.ndarray, jpos: np.ndarray, n: int) -> np.ndarray:
    """Per template element its signal index: matched elements map to
    their column; an element at offset r of a vertical-gap run of
    length L after column j maps to j if r + 1 <= L - r, else j + 1;
    clipped to [0, n - 1]."""
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


def bounds(pre: tuple, suf: tuple, n: int, trim_prefix: int, trim_suffix: int) -> tuple:
    """One read's bounds and gate from its two flank alignments, each
    (score, is_gap, jpos): (ok, score_prefix, score_suffix,
    prefix_begin, prefix_end, suffix_begin, suffix_end), the scores per
    sample of the flank's span."""
    pos_p = nearest_positions(pre[1], pre[2], n)
    pos_s = nearest_positions(suf[1], suf[2], n)
    span_p = int(pos_p[-1]) - int(pos_p[0])
    span_s = int(pos_s[-1]) - int(pos_s[0])
    score_p, score_s = float(pre[0]), float(suf[0])
    pb, pe = int(pos_p[trim_prefix]), int(pos_p[-1])
    sb, se = int(pos_s[0]), int(pos_s[len(pos_s) - 1 - trim_suffix])
    ok = pb < se and span_p > 0 and score_p > 0.0 and span_s > 0 and score_s > 0.0
    return (ok, score_p / span_p if span_p > 0 else 0.0, score_s / span_s if span_s > 0 else 0.0,
            pb, pe, sb, se)
