"""Anti-diagonal Gotoh flank-alignment forward: CUDA kernel + plain twins.

Counterpart of ``strique_tpu/ops/align_pallas.py``'s wavefront kernel,
the Pallas body ``_wave_kernel``, in all four of its calls:

  * ``align_forward_wave`` (one shared template) and
    ``align_forward_wave_multi`` (a template per row): pointers and
    bottom taps; twin ``_wave_plain``.  Each also has a morph form
    (``align_forward_wave_morph``, ``align_forward_wave_multi_morph``)
    that takes the reads as u8 bins plus a 256-entry f32 level table
    per read, and the template as :func:`template_levels`; twin
    ``_wave_table_plain`` (see "Score modes" below);
  * ``align_forward_ckpt``: pass 1 of the ultra-long two-pass route,
    score-only with diagonal-state checkpoints; twin ``_ckpt_plain``;
    morph form ``align_forward_ckpt_morph``, twin ``_ckpt_table_plain``;
  * ``align_window_from_state``: pass 2, pointers over a window resumed
    from a checkpoint; twin ``_window_plain``; morph form
    ``align_window_from_state_morph`` (the window read from the bins row
    at its offset, no gathered window), twin ``_window_table_plain``.
    Both passes take one template or one per row (both flanks in one
    call).

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

Score modes of every kernel mode (one launch counter each):

  * POW: every cell evaluates the pow above (the f32 entry points);
  * TABLE: a morph-form row meets at most U x 258 distinct
    (template value, signal value) pairs -- U distinct template values
    against the 256 bins, the NEG fill before the read and the 0.0 fill
    past its end -- so the kernel evaluates that :func:`score_table`
    once per row into shared memory and each cell looks its score up.
    Same expression, same values.  A window reads 0.0 on both sides of
    the read, as the f32 window's gather fills.

A morph-form call with the template as :func:`template_levels` of its
rows runs TABLE on one CTA a row when :func:`wave_score_mode` says the
template's lanes fit one thread each and the table fits one block's
shared memory, and otherwise POW on the decoded f32 (``lut[bins]``, the
template rebuilt from its levels): a rule on the shapes, decided before
the launch (for rows 1-2 here, for rows 5-6 by the two-pass route in
``ops.align``, whose morph entry points raise past the table).  With the
template in its split form, ``template_levels(rows, ctas)``, a call runs
TABLE on a thread-block cluster of that many CTAs a row (launch counters
``*_cluster``): each CTA owns :func:`cta_lanes` contiguous lanes and a
score table of only their levels, so templates past one CTA (more than
1024 lanes, or too many levels) keep the table; the twins read the same
levels flattened (:func:`flat_levels`).  :func:`wave_table_ctas` gives
the fewest CTAs whose tables fit; :func:`wave_launch_plan` the CTAs and
rows each call of a route takes on the card, by the step measured at
each CTA count (:data:`WAVE_STEP_US`).  The column kernel has the same
two forms (:func:`col_table_ctas`).
"""
from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import _build

NEG = -1e30
LANE = 128
CHUNK = 128
# the reference's wave call width: one 64-row shape serves every batch
# (its fusion rule in ops.align keys on it); kept for CPU tensors
BATCH_WAVE = 64
POW_EXP = float(np.float32(1.2))  # the reference's f32 exponent, widened
# TABLE score mode: a score row per template level over the 256 bins,
# then NEG (before the read) and 0.0 (past the padded end)
SCORE_COLS = 258
BIN_NEG, BIN_ZERO = 256, 257
SMEM_BYTES = 232448  # dynamic shared memory one block may use on sm_90 (227 KB)
TABLE_MAX_MP = 1024  # TABLE mode on one CTA runs one thread a template lane
# TABLE on a thread-block cluster: up to MAX_CTAS CTAs a row (a portable
# cluster), each of at most MAX_CTA_LANES lanes (one or two a thread in
# the wave kernel, four in the column kernel), up to 8192 lanes a row.
# Each CTA's shared memory starts with its boundary ring (the .cu files'
# RING_FLOATS, in bytes)
MAX_CTAS = 8
MAX_CTA_LANES = 2048
MAX_MP = 8192
WAVE_RING_BYTES = 640
COL_RING_BYTES = 6912  # the CTA ring and the warp rings (col_align.cu CL_FIXED floats)
# The wave kernel's TABLE step, us, by mode and form ("one": one CTA a
# row, at its MP lanes; "cluster": a CTA of a cluster, at its lanes), as
# (lanes, us) points: tools/probe_wave_cluster.py, N 8192, 8 rows of both
# flanks (the slowest MP where lanes repeat), NVIDIA H100 80GB HBM3,
# 700.00 W.  wave_launch_plan predicts a call set's wall from it.
WAVE_STEP_US = {
    "ptr": {"one": ((384, 0.1838), (640, 0.2417), (896, 0.2966)),
            "cluster": ((128, 0.2000), (256, 0.2204), (384, 0.2533), (512, 0.2805),
                        (640, 0.3062), (768, 0.3342), (1152, 0.4774))},
    "ckpt": {"one": ((384, 0.1479), (640, 0.1810), (896, 0.2224)),
             "cluster": ((128, 0.1885), (256, 0.2056), (384, 0.2290), (512, 0.2551),
                         (640, 0.2714), (768, 0.2884), (1152, 0.3497))},
    "window": {"one": ((384, 0.1598), (640, 0.2044), (896, 0.2610)),
               "cluster": ((128, 0.1447), (256, 0.1591), (384, 0.1974), (512, 0.2310),
                           (640, 0.2573), (768, 0.2913), (1152, 0.3834))},
}

# The column kernel's cluster TABLE step, us a column, by the CTA's lanes
# (lanes, us): tools/probe_col_cluster.py, MP 2176, N 28672, 8 rows (2 to
# 6 CTAs), NVIDIA H100 80GB HBM3, 700.00 W.  col_launch_plan predicts a
# call set's wall from it.
COL_STEP_US = ((384, 0.4515), (512, 0.4524), (640, 0.5016), (768, 0.4945), (1152, 0.5620))

_DEFAULT_PTR_BUDGET = int(3.5 * (1 << 30))
_ptr_budget_cache: dict = {}
_cluster_capacity_cache: dict = {}


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


def sm_count(device) -> int | None:
    """Streaming multiprocessors of a CUDA device; None for the CPU."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return None
    return torch.cuda.get_device_properties(dev).multi_processor_count


def cluster_capacity(device, ctas: int, mpc: int, kernel: str = "wave") -> int | None:
    """Clusters of ``ctas`` CTAs of ``mpc`` lanes the card of ``device``
    runs at once, as the wave kernel (``kernel`` "wave") or the column
    kernel ("col") launches them (one CTA an SM): the SMs of a graphics
    processing cluster hold whole clusters only, so fewer than SMs /
    ``ctas`` may fit.  The kernel library's occupancy query, once a card,
    kernel and shape; None for a CPU device."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if dev.type != "cuda":
        return None
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), kernel, ctas,
           mpc)
    if key not in _cluster_capacity_cache:
        with torch.cuda.device(dev):
            _cluster_capacity_cache[key] = int(
                getattr(_build.lib(), f"{kernel}_cluster_capacity")(ctas, mpc))
    return _cluster_capacity_cache[key]


def kernel_batch(b: int | None = None, n_cols: int | None = None,
                 mp: int | None = None, device=None, sms: int | None = None,
                 ctas: int = 1) -> int:
    """Rows per wave call.

    Card rule (a CUDA device, or any device when ``sms`` is given): the
    kernel runs ``ctas`` CTAs per row (one, or a TABLE cluster's), so a
    call whose CTAs fit the SMs costs its longest row; a call is as wide
    as the rows it has, rounded up to 8, up to the largest multiple of 8
    rows whose CTAs fit the SM count (128 rows of one CTA on an H100's
    132 SMs, 64 of two).  CPU rule (the reference's widths, so the
    parity tests compare like with like): BATCH_WAVE rows, or only the
    remaining rows rounded up to 8 when fewer.  With ``n_cols``/``mp``
    the width shrinks (never below 8) to keep the pointer plane inside
    :func:`ptr_budget_bytes`.
    """
    dev = torch.device(device) if device is not None else torch.device("cpu")
    if sms is None:
        sms = sm_count(dev)
    cap = BATCH_WAVE if sms is None else max(8, int(sms) // int(ctas) // 8 * 8)
    kb = cap if b is None else min(cap, max(8, _round_up(int(b), 8)))
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


def cta_lanes(mp: int, ctas: int) -> int:
    """Lanes each CTA of a ``ctas``-CTA cluster owns (the last one may
    own fewer): MP / ctas rounded up to a multiple of 128."""
    return _round_up(-(-int(mp) // int(ctas)), LANE)


def _split_ok(mp: int, ctas: int) -> bool:
    """A cluster split the kernels take: 2..MAX_CTAS CTAs of at most
    MAX_CTA_LANES lanes, none of them empty."""
    mpc = cta_lanes(mp, ctas)
    return (2 <= ctas <= MAX_CTAS and mp <= MAX_MP and mpc <= MAX_CTA_LANES
            and (ctas - 1) * mpc < mp)


def _distinct_rows(tmpl: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The distinct rows of a 2-D array in first-seen order, and each
    row's index among them (``np.unique(axis=0)`` sorts the rows as
    records, slowly enough to show in the host-bound counting passes)."""
    index: dict = {}
    inv = np.array([index.setdefault(r.tobytes(), len(index)) for r in tmpl], np.int64)
    return tmpl[np.unique(inv, return_index=True)[1]], inv


def template_levels(tmpl, ctas: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """A template's distinct values and each lane's index into them.

    ``tmpl`` (R, MP) f32 in the lane layout (:func:`pad_template`, one
    row, or :func:`pad_template_rows`).  Returns (levels (R, UP) f32,
    each row's sorted distinct values padded with +1e30 to the longest
    row's count UP; idx (R, MP) int32 with levels[r, idx[r, i]] ==
    tmpl[r, i] for every lane, the +1e30 pad lanes included).

    With ``ctas`` (the split form of a cluster of that many CTAs a row):
    levels (R, ctas, UP), row r's CTA k's sorted distinct values over its
    lanes [k MPC, (k+1) MPC) (MPC = :func:`cta_lanes`), padded with +1e30
    to the largest count UP of any row and CTA; idx (R, MP) the lane's
    index into its own CTA's values: levels[r, i // MPC, idx[r, i]] ==
    tmpl[r, i].
    """
    tmpl = np.asarray(tmpl, np.float32)
    if ctas is None:
        uniq = [np.unique(row, return_inverse=True) for row in tmpl]
        up = max(len(u) for u, _ in uniq)
        levels = np.full((len(uniq), up), 1e30, np.float32)
        idx = np.empty(tmpl.shape, np.int32)
        for r, (u, inv) in enumerate(uniq):
            levels[r, : len(u)] = u
            idx[r] = inv.reshape(-1)
        return levels, idx
    mpc = cta_lanes(tmpl.shape[1], ctas)
    rows, inv_rows = _distinct_rows(tmpl)
    parts = [[np.unique(row[k * mpc : (k + 1) * mpc], return_inverse=True)
              for k in range(ctas)] for row in rows]
    up = max(len(u) for part in parts for u, _ in part)
    levels = np.full((len(rows), ctas, up), 1e30, np.float32)
    idx = np.zeros(rows.shape, np.int32)
    for r, part in enumerate(parts):
        for k, (u, inv) in enumerate(part):
            levels[r, k, : len(u)] = u
            idx[r, k * mpc : k * mpc + inv.size] = inv.reshape(-1)
    return levels[inv_rows], idx[inv_rows]


def flat_levels(levels, lidx):
    """The split form of :func:`template_levels` as the one-CTA form's
    layout: levels (R, ctas x UP) and each lane's index into them (its
    CTA's block of UP).  The twins read the split form through it."""
    R, ctas, up = levels.shape
    mp = lidx.shape[1]
    rank = torch.arange(mp, device=lidx.device) // cta_lanes(mp, ctas)
    return levels.reshape(R, ctas * up), (lidx + (rank * up).to(lidx.dtype)).to(torch.int32)


def score_table(lut, levels, params) -> torch.Tensor:
    """The TABLE mode's scores: (B, UP, 258) f32.

    Entry [r, u, b] is ``clamp_min(off - score_pow(|x_b - level_u|),
    dmin)`` with x_b = ``lut[r, b]`` for b < 256, NEG for b = 256 (before
    the read) and 0.0 for b = 257 (past the padded end): the value the
    recurrence computes for that (signal value, template value) pair.
    ``levels`` is (1, UP) (shared template) or (B, UP).
    """
    k = _consts(params)
    B = lut.shape[0]
    x = torch.cat([lut, torch.full((B, 1), NEG, device=lut.device),
                   torch.zeros((B, 1), device=lut.device)], dim=1)
    return torch.clamp_min(k["off"] - score_pow((x[:, None, :] - levels[:, :, None]).abs()),
                           k["dmin"])


def wave_score_mode(n_levels: int, mp: int, ctas: int = 1) -> str:
    """The score mode of a morph-form wave call of ``ctas`` CTAs a row.

    One CTA: "table" when the template has at most TABLE_MAX_MP lanes
    and a row's ``n_levels`` x 258 f32 table fits one block's shared
    memory (SMEM_BYTES) behind the kernel's four (MP + 1)-float exchange
    buffers, else "pow".  The cap is 211 levels at MP 896 (a
    ``samples=6`` template of the bench's c9orf72 flanks has 119-142)
    and 209 at MP 1024.  A cluster (``ctas`` > 1, ``n_levels`` the most
    any CTA's lanes use): "table" when the split is one the kernel takes
    (:func:`cta_lanes` <= MAX_CTA_LANES, no CTA empty, MP <= 8192) and
    the CTA's table fits behind its ring (WAVE_RING_BYTES) and its four
    (MPC + 1)-float exchange buffers: 206 levels a CTA at MP 2176 on two
    CTAs of 1152 lanes."""
    if ctas == 1:
        fits = 4 * (4 * (mp + 1) + n_levels * SCORE_COLS) <= SMEM_BYTES
        return "table" if mp <= TABLE_MAX_MP and fits else "pow"
    fits = (WAVE_RING_BYTES + 4 * (4 * (cta_lanes(mp, ctas) + 1) + n_levels * SCORE_COLS)
            <= SMEM_BYTES)
    return "table" if _split_ok(mp, ctas) and fits else "pow"


def _cta_level_counts(tmpl, ctas: int) -> int:
    """The most distinct values any CTA's lanes of any row hold when
    ``ctas`` CTAs split the (R, MP) template rows."""
    mpc = cta_lanes(tmpl.shape[1], ctas)
    return max(len(np.unique(row[k * mpc : (k + 1) * mpc])) for row in tmpl
               for k in range(ctas))


def _table_ctas(tmpl, mode) -> int:
    tmpl = _distinct_rows(np.asarray(tmpl, np.float32))[0]
    for ctas in range(1, MAX_CTAS + 1):
        if ctas > 1 and not _split_ok(tmpl.shape[1], ctas):
            continue
        if mode(_cta_level_counts(tmpl, ctas), tmpl.shape[1], ctas) == "table":
            return ctas
    return 0


def wave_table_ctas(tmpl) -> int:
    """CTAs a row of the wave kernel's TABLE mode takes for the (R, MP)
    template rows: 1 where :func:`wave_score_mode` of one CTA says
    "table" (today's kernel), else the fewest CTAs (2 to MAX_CTAS) whose
    own levels' tables fit (:func:`wave_score_mode` of that many; a row
    stream's rows take the most any row needs); 0 when none does (POW).
    A rule on the template, decided before the launch."""
    return _table_ctas(tmpl, wave_score_mode)


def two_pass_group(rows: int, mp: int, w_steps: int, device, sms: int | None = None,
                   ctas: int = 1) -> int:
    """Rows per two-pass group (one pass-1 and one pass-2 launch) of
    ``ctas`` CTAs a row.

    Card rule (a CUDA device, or any device when ``sms`` is given):
    :func:`kernel_batch`'s width -- the rows it has, up to the largest
    multiple of 8 whose ``ctas`` CTAs a row fit the SM count -- narrowed
    (never below 8) so that pass 2's (W/8, rows, MP) int32 plane fits
    :func:`ptr_budget_bytes`.  A pass-1 row holds no pointer plane, only
    its checkpoints.  CPU rule: the reference's 8 rows, so the parity
    tests compare like with like.
    """
    if sms is None:
        sms = sm_count(device)
    if sms is None:
        return 8
    return kernel_batch(rows, n_cols=w_steps, mp=mp, device=device, sms=sms, ctas=ctas)


def _step_at(pts, x: int) -> float:
    """A step table's us at ``x`` lanes a CTA: linear between its
    measured (lanes, us) points, flat below the first (or with one
    point) and on the last two's slope past the last."""
    if len(pts) == 1 or x <= pts[0][0]:
        return pts[0][1]
    k = min(max(int(np.searchsorted([p[0] for p in pts], x)), 1), len(pts) - 1)
    (x0, y0), (x1, y1) = pts[k - 1], pts[k]
    return y0 + (y1 - y0) * (x - x0) / (x1 - x0)


def wave_step_us(mode: str, mp: int, ctas: int) -> float:
    """The TABLE step of the wave kernel, in us, of a row of ``mp``
    lanes on ``ctas`` CTAs (1: the one-CTA instance), mode "ptr",
    "ckpt" or "window": WAVE_STEP_US at the CTA's lanes (MP on one CTA),
    read by :func:`_step_at`."""
    pts = WAVE_STEP_US[mode]["one" if ctas == 1 else "cluster"]
    return _step_at(pts, mp if ctas == 1 else cta_lanes(mp, ctas))


def _least_calls(rows: int, choices, width, cost) -> tuple[int, int]:
    """The first call (CTAs a row, rows) of the call sequence over
    ``rows`` rows whose summed cost is least: ``choices(r)`` the CTA
    counts a call may take with r rows left, ``width(c, r)`` its rows at
    C, ``cost(c)`` its predicted wall; ties take fewer CTAs."""
    best: dict = {0: (0.0, 0, 0)}  # rows left -> (wall, first call's C, its rows)

    def plan(r: int) -> tuple:
        if r not in best:
            best[r] = min((cost(c) + plan(max(r - kb, 0))[0], c, kb)
                          for c in choices(r) for kb in [width(c, r)])
        return best[r]

    return plan(rows)[1:]


def wave_launch_plan(rows: int, tmpl, n_cols: int, device=None, sms: int | None = None,
                     ctas: int | None = None, pass1_steps: int | None = None
                     ) -> tuple[int, int]:
    """(CTAs a row, rows) of the wave kernel's next call over ``rows``
    rows of the (R, MP) template rows ``tmpl`` (one template or the rows'
    own; repeats cost nothing), decided before the launch.

    A PTR call (``pass1_steps`` None) of ``n_cols`` steps a row, or a
    two-pass group: pass 1 of ``pass1_steps`` steps and pass 2's window
    of ``n_cols``.  ``ctas`` is :func:`wave_table_ctas` of ``tmpl`` if
    the caller has it (0: POW, one CTA).  Card rule (a CUDA device, or
    any device when ``sms`` is given): each call takes a CTA count C >=
    ``ctas`` whose split the kernel takes and whose per-CTA tables fit
    (:func:`wave_score_mode`), and as many rows as fit: the width
    :func:`kernel_batch`'s at C (:func:`two_pass_group`'s for a two-pass
    group), a multiple of 8 whose rows x C fit the SMs, inside
    :func:`ptr_budget_bytes`, and on a card whose clusters all run at
    once (:func:`cluster_capacity`).  Of the call sequences that cover
    the rows, the plan takes the one whose predicted wall is least (each
    call costs its longest row's steps at :func:`wave_step_us`: PTR;
    CKPT then WINDOW) and returns its first call; ties take fewer CTAs.
    A template that fits one CTA takes a cluster only while the rows
    left are few, rows x MAX_CTAS within the SMs (16 on an H100: the
    ultra-long routes' calls); more keep the one-CTA instance.  CPU rule:
    ``ctas`` and the reference's widths, so the CPU parity tests compare
    like with like."""
    tmpl = np.asarray(tmpl, np.float32)
    mp = tmpl.shape[1]
    c_min = wave_table_ctas(tmpl) if ctas is None else int(ctas)
    if sms is None:
        sms = sm_count(device)

    def width(c: int, r: int) -> int:
        if pass1_steps is not None:
            kb = two_pass_group(r, mp, n_cols, device, sms, max(c, 1))
        else:
            kb = kernel_batch(r, n_cols=n_cols, mp=mp, device=device, sms=sms, ctas=max(c, 1))
        cap = cluster_capacity(device, c, cta_lanes(mp, c)) if c > 1 else None
        return kb if cap is None else min(kb, max(8, cap // 8 * 8))

    if sms is None or c_min == 0:
        return c_min, width(c_min, rows)

    def step(c: int) -> float:
        if pass1_steps is None:
            return n_cols * wave_step_us("ptr", mp, c)
        return pass1_steps * wave_step_us("ckpt", mp, c) + n_cols * wave_step_us("window", mp, c)

    if c_min == 1 and rows * MAX_CTAS > sms:
        return 1, width(1, rows)
    ok = [c for c in _cluster_ctas(_distinct_rows(tmpl)[0].tobytes(), mp, c_min, "wave")
          if c == c_min or 8 * c <= sms]
    return _least_calls(rows, lambda r: ok if c_min > 1 or r * MAX_CTAS <= sms else [c_min],
                        width, step)


@functools.lru_cache(maxsize=64)
def _cluster_ctas(tmpl_bytes: bytes, mp: int, c_min: int, kernel: str) -> tuple:
    """The CTA counts from ``c_min`` up to MAX_CTAS whose split the kernel
    ("wave" or "col") takes and whose per-CTA tables fit the distinct (R,
    MP) template rows ``tmpl_bytes`` (f32): a launch plan's choices, once
    a template."""
    rows = np.frombuffer(tmpl_bytes, np.float32).reshape(-1, mp)
    mode = wave_score_mode if kernel == "wave" else col_score_mode
    return tuple(c for c in range(c_min, MAX_CTAS + 1)
                 if c == c_min or (_split_ok(mp, c) and mode(
                     _cta_level_counts(rows, c), mp, c) == "table"))


def morph_decode(bins, lut) -> torch.Tensor:
    """(B, N) u8 bins and (B, 256) f32 level tables -> (B, N) f32 signals."""
    return torch.gather(lut, 1, bins.to(torch.int64))


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


def _pow_scores(sig_ext, tmpl, params):
    """POW mode's cell scores: step t -> (B, MP), lane i scoring
    ``sig_ext[:, MP + t - i]`` against ``tmpl`` ((1, MP) or (B, MP))."""
    k = _consts(params)
    mp = tmpl.shape[1]
    lane = torch.arange(mp, device=sig_ext.device)
    return lambda t: torch.clamp_min(
        k["off"] - score_pow((sig_ext[:, t + mp - lane] - tmpl).abs()), k["dmin"])


def _table_scores(bins, lut, levels, lidx, params, nd: int | None = None, t0=None):
    """TABLE mode's cell scores: step t < ``nd`` (default NB + MP) ->
    (B, MP), read from :func:`score_table` at (lane's level index, bin of
    sample t - i of the row), with bin 256 before the read and 257 past
    its end.  With ``t0`` (B,), a window's: lane i at local step t reads
    sample t0 + t - i, and 257 on both sides of the read."""
    B, nb = bins.shape
    mp = lidx.shape[1]
    dev = bins.device
    nd = nb + mp if nd is None else nd
    tab = score_table(lut, levels, params).reshape(B, -1)
    ext = torch.cat([torch.full((B, mp), BIN_NEG if t0 is None else BIN_ZERO, dtype=torch.int64,
                                device=dev),
                     bins.to(torch.int64),
                     torch.full((B, nd), BIN_ZERO, dtype=torch.int64, device=dev)], dim=1)
    base = (mp - torch.arange(mp, device=dev)).expand(B, mp)
    if t0 is not None:
        base = base + t0.to(device=dev, dtype=torch.int64)[:, None]
    last = ext.shape[1] - 1  # past the row's end, as the pad: bin 257
    row_off = (lidx.to(torch.int64) * SCORE_COLS).expand(B, mp)
    return lambda t: tab.gather(1, row_off + ext.gather(1, (base + t).clamp_max(last)))


def _wave_recurrence(scores, n_actual, m_rows, params, nd: int, t_run: int, mp: int, *,
                     with_ptr: bool = True, with_bottom: bool = True, ckpt_steps: int = 0,
                     state4=None, cold=None):
    """The wave recurrence in plain PyTorch ops over (B, MP) rows.

    Same expression trees as the reference kernel (align_pallas.py
    ``_wave_kernel``), step for step, in all of its modes.  ``scores(t)``
    gives step t's (B, MP) cell scores (:func:`_pow_scores` or
    :func:`_table_scores`); ``m_rows`` (B,) the template lengths of the
    bottom taps.  Runs ``t_run`` of the ``nd`` steps and returns (ptr,
    bottom, ckpts), None for what the mode does not produce:

      * ``with_ptr``: the (nd/8, B, MP) pointer plane;
      * ``with_bottom``: the (B, nd) bottom taps;
      * ``ckpt_steps`` > 0: four (nd/ckpt_steps, B, MP) planes (S1, S2,
        Ih, C), slot g the state after step (g+1)*ckpt_steps - 1;
      * ``state4`` (S1, S2, Ih, C): resume from that state instead of
        the cold start; ``cold`` (B,) then gates the column-0 forcing.
    """
    k = _consts(params)
    B = n_actual.shape[0]
    dev = n_actual.device
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
        sc = scores(t)
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
    ptr, bottom, _ = _wave_recurrence(_pow_scores(_signal_ext(signals, mp), tmpl, params),
                                      n_actual, m_rows, params, nd,
                                      _steps_to_run(n_actual, m_rows, nd), mp)
    return ptr, bottom


def _wave_table_plain(bins, lut, levels, lidx, n_actual, m_rows, params):
    """Plain twin of the TABLE-mode kernel: the same recurrence, each
    cell's score read from :func:`score_table` by (lane's level index,
    sample's bin or sentinel).  (ptr (ND/8, B, MP), bottom (B, ND))."""
    mp = lidx.shape[1]
    nd = bins.shape[1] + mp
    ptr, bottom, _ = _wave_recurrence(_table_scores(bins, lut, levels, lidx, params),
                                      n_actual, m_rows, params, nd,
                                      _steps_to_run(n_actual, m_rows, nd), mp)
    return ptr, bottom


def _ckpt_plain(signals, tmpl, n_actual, m_rows, params, ckpt_steps: int):
    """Plain twin of the checkpoint kernel (row 5): (bottom, (S1, S2, Ih, C))."""
    mp = tmpl.shape[1]
    nd = signals.shape[1] + mp
    _, bottom, ckpts = _wave_recurrence(_pow_scores(_signal_ext(signals, mp), tmpl, params),
                                        n_actual, m_rows, params, nd,
                                        _steps_to_run(n_actual, m_rows, nd), mp,
                                        with_ptr=False, ckpt_steps=ckpt_steps)
    return bottom, ckpts


def _ckpt_table_plain(bins, lut, levels, lidx, n_actual, m_rows, params, ckpt_steps: int,
                      nd: int):
    """Plain twin of the TABLE-mode checkpoint kernel (row 5): nd steps
    over the bins row read in place, 0.0 (bin 257) past it.  (bottom,
    (S1, S2, Ih, C))."""
    mp = lidx.shape[1]
    _, bottom, ckpts = _wave_recurrence(_table_scores(bins, lut, levels, lidx, params, nd),
                                        n_actual, m_rows, params, nd,
                                        _steps_to_run(n_actual, m_rows, nd), mp,
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
    ptr, _, _ = _wave_recurrence(_pow_scores(sig_ext, tmpl, params), steps_needed, zeros,
                                 params, W, _steps_to_run(steps_needed, zeros, W), mp,
                                 with_bottom=False, state4=state4, cold=cold)
    return ptr


def _window_table_plain(bins, lut, t0, state4, cold, steps_needed, levels, lidx, params,
                        W: int):
    """Plain twin of the TABLE-mode window kernel (row 6): lane i at
    local step tau reads the bin of sample t0 + tau - i of its row, 0.0
    (bin 257) outside the read.  ptr (W/8, B, MP)."""
    B = bins.shape[0]
    zeros = torch.zeros(B, dtype=torch.int32, device=bins.device)
    ptr, _, _ = _wave_recurrence(_table_scores(bins, lut, levels, lidx, params, W, t0),
                                 steps_needed, zeros, params, W,
                                 _steps_to_run(steps_needed, zeros, W), lidx.shape[1],
                                 with_bottom=False, state4=state4, cold=cold)
    return ptr


def _param_args(params) -> list:
    """neg_h and the seven f32 constants, as the C entry points take them."""
    k = _consts(params)
    return [int(k["neg_h"]), k["go_h"], k["go_v"], k["ge_h"], k["ge_v"], k["off"], k["dmin"],
            k["g"]]


def _launch(name: str, dev, tensors, *args) -> None:
    """Launch C entry point ``name`` on ``tensors`` (made contiguous and
    held until the launch is queued), then the scalar ``args``."""
    held = [x.contiguous() for x in tensors]
    _build.launch(name, dev, *(x.data_ptr() for x in held), *args)


def _wave_cuda(signals, tmpl, n_actual, m_rows, params, counter: str):
    B, N = signals.shape
    mp = tmpl.shape[1]
    ptr = torch.empty(((N + mp) // 8, B, mp), dtype=torch.int32, device=signals.device)
    bottom = torch.empty((B, N + mp), dtype=torch.float32, device=signals.device)
    _launch("wave_align_launch", signals.device,
            (signals, tmpl, n_actual.to(torch.int32), m_rows.to(torch.int32), ptr, bottom),
            B, N, mp, 0 if tmpl.shape[0] == 1 else mp, *_param_args(params))
    _build.LAUNCHES[counter] += 1
    return ptr, bottom


def _dispatch(signals, tmpl, n_actual, m_rows, params, counter):
    if _on_card(signals):
        return _wave_cuda(signals, tmpl, n_actual, m_rows, params, counter)
    return _wave_plain(signals, tmpl, n_actual, m_rows, params)


def _split_args(levels, mp: int) -> list:
    """UP, per_row, ctas and MPC of a TABLE call's levels: the one-CTA
    form (R, UP) or the split form (R, ctas, UP)."""
    ctas = levels.shape[1] if levels.dim() == 3 else 1
    return [levels.shape[-1], int(levels.shape[0] != 1), ctas, cta_lanes(mp, ctas)]


def _table_counter(name: str, levels) -> str:
    """The launch counter of a TABLE call: one CTA a row, or a cluster."""
    return name + ("_cluster" if levels.dim() == 3 and levels.shape[1] > 1 else "_table")


def _wave_table_cuda(bins, lut, levels, lidx, n_actual, m_rows, params, counter: str):
    B, N = bins.shape
    mp = lidx.shape[1]
    ptr = torch.empty(((N + mp) // 8, B, mp), dtype=torch.int32, device=bins.device)
    bottom = torch.empty((B, N + mp), dtype=torch.float32, device=bins.device)
    _launch("wave_table_launch", bins.device,
            (bins, lut, levels, lidx, n_actual.to(torch.int32), m_rows.to(torch.int32), ptr,
             bottom),
            B, N, mp, *_split_args(levels, mp), *_param_args(params))
    _build.LAUNCHES[counter] += 1
    return ptr, bottom


def _check_morph(bins, lut, n_actual, levels, lidx, m_rows):
    """Shapes, dtypes and devices of a morph-form wave call."""
    B, N = bins.shape
    if B % 8 or N % CHUNK:
        raise ValueError(f"wave call needs B % 8 == 0 and N % {CHUNK} == 0, got {(B, N)}")
    if (bins.dtype != torch.uint8 or lut.dtype != torch.float32
            or levels.dtype != torch.float32 or lidx.dtype != torch.int32):
        raise TypeError("morph form: u8 bins, f32 lut and levels, int32 level indices")
    mp = lidx.shape[1]
    if mp % LANE or mp > 8192:
        raise ValueError(f"template lanes must be a multiple of {LANE} up to 8192, got {mp}")
    if (lut.shape != (B, 256) or levels.shape[0] != lidx.shape[0]
            or lidx.shape[0] not in (1, B) or n_actual.shape != (B,) or m_rows.shape != (B,)):
        raise ValueError("a 256-level lut per row, one template (or one per row), one length "
                         "and one m per row")
    if levels.dim() not in (2, 3) or (levels.dim() == 3 and not 1 <= levels.shape[1] <= MAX_CTAS):
        raise ValueError("levels are (R, UP), or (R, ctas, UP) with 1 to 8 CTAs a row")
    for x in (lut, n_actual, levels, lidx, m_rows):
        if x.device != bins.device:
            raise ValueError("all wave inputs must share one device")


def _dispatch_morph(bins, lut, n_actual, levels, lidx, m_rows, params, counter):
    """TABLE or POW by :func:`wave_score_mode`, then the kernel (CUDA
    tensors) or the mode's twin (CPU tensors).  The split form runs
    TABLE on its cluster (it raises past the table)."""
    if levels.dim() == 3:
        _require_table(levels, lidx)
        if _on_card(bins):
            return _wave_table_cuda(bins, lut, levels, lidx, n_actual, m_rows, params,
                                    _table_counter(counter, levels))
        return _wave_table_plain(bins, lut, *flat_levels(levels, lidx), n_actual, m_rows, params)
    if wave_score_mode(levels.shape[1], lidx.shape[1]) == "pow":
        tmpl = levels.gather(1, lidx.to(torch.int64))
        return _dispatch(morph_decode(bins, lut), tmpl, n_actual, m_rows, params, counter)
    if _on_card(bins):
        return _wave_table_cuda(bins, lut, levels, lidx, n_actual, m_rows, params,
                                counter + "_table")
    return _wave_table_plain(bins, lut, levels, lidx, n_actual, m_rows, params)


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


def align_forward_wave_morph(bins, lut, n_actual, levels, lidx, params, m_actual: int):
    """:func:`align_forward_wave` on morph-form reads: the same outputs
    as on the f32 signals ``lut[bins]`` against the template
    ``levels[0, lidx[0]]``.

    bins (B, N) u8, N a multiple of 128; lut (B, 256) f32; (levels,
    lidx) = :func:`template_levels` of a (1, MP) template, (1, UP) f32
    and (1, MP) int32.  Runs TABLE mode (launch counter
    ``align_forward_wave_table``) where :func:`wave_score_mode` allows,
    else POW mode (``align_forward_wave``).  In the split form,
    ``template_levels(tmpl, ctas)``, TABLE on a cluster of ``ctas`` CTAs
    a row (``align_forward_wave_cluster``; raises past its table).
    """
    B = bins.shape[0]
    if lidx.shape[0] != 1 or not 0 < m_actual < lidx.shape[1]:
        raise ValueError("align_forward_wave_morph takes one (1, MP) template of m < MP samples")
    m_rows = torch.full((B,), int(m_actual), dtype=torch.int32, device=bins.device)
    _check_morph(bins, lut, n_actual, levels, lidx, m_rows)
    return _dispatch_morph(bins, lut, n_actual, levels, lidx, m_rows, params,
                           "align_forward_wave")


def align_forward_wave_multi_morph(bins, lut, n_actual, levels, lidx, m_rows, params):
    """:func:`align_forward_wave_multi` on morph-form reads, a template
    per row: levels (B, UP), lidx (B, MP) from :func:`template_levels`
    of the (B, MP) rows.  TABLE (``align_forward_wave_multi_table``) or
    POW (``align_forward_wave_multi``) by :func:`wave_score_mode`; the
    split form on its cluster (``align_forward_wave_multi_cluster``)."""
    _check_morph(bins, lut, n_actual, levels, lidx, m_rows)
    if lidx.shape[0] != bins.shape[0]:
        raise ValueError("one template row per signal row")
    return _dispatch_morph(bins, lut, n_actual, levels, lidx, m_rows, params,
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


def _ckpt_planes(nd: int, ckpt_steps: int, B: int, mp: int, dev):
    return (torch.empty((B, nd), dtype=torch.float32, device=dev),
            tuple(torch.empty((nd // ckpt_steps, B, mp), dtype=torch.float32, device=dev)
                  for _ in range(4)))


def _ckpt_cuda(signals, tmpl, n_actual, m_rows, params, ckpt_steps: int):
    B, N = signals.shape
    mp = tmpl.shape[1]
    bottom, ckpts = _ckpt_planes(N + mp, ckpt_steps, B, mp, signals.device)
    _launch(
        "wave_ckpt_launch", signals.device,
        (signals, tmpl, n_actual.to(torch.int32), m_rows.to(torch.int32), bottom, *ckpts),
        B, N, mp, 0 if tmpl.shape[0] == 1 else mp, ckpt_steps, *_param_args(params))
    _build.LAUNCHES["align_forward_ckpt"] += 1
    return bottom, ckpts


def _ckpt_table_cuda(bins, lut, levels, lidx, n_actual, m_rows, params, ckpt_steps: int,
                     nd: int):
    B, nb = bins.shape
    mp = lidx.shape[1]
    bottom, ckpts = _ckpt_planes(nd, ckpt_steps, B, mp, bins.device)
    _launch(
        "wave_ckpt_table_launch", bins.device,
        (bins, lut, levels, lidx, n_actual.to(torch.int32), m_rows.to(torch.int32),
               bottom, *ckpts),
        B, nb, nd, mp, *_split_args(levels, mp), ckpt_steps, *_param_args(params))
    _build.LAUNCHES[_table_counter("align_forward_ckpt", levels)] += 1
    return bottom, ckpts


def _window_cuda(sig_win, r_init, state4, cold, steps_needed, tmpl, params):
    B, W = sig_win.shape
    mp = tmpl.shape[1]
    ptr = torch.empty((W // 8, B, mp), dtype=torch.int32, device=sig_win.device)
    _launch(
        "wave_window_launch", sig_win.device,
        (sig_win, r_init, tmpl, steps_needed.to(torch.int32), *state4,
               cold.to(torch.int32), ptr),
        B, W, mp, 0 if tmpl.shape[0] == 1 else mp, *_param_args(params))
    _build.LAUNCHES["align_window_from_state"] += 1
    return ptr


def _window_table_cuda(bins, lut, t0, state4, cold, steps_needed, levels, lidx, params,
                       W: int):
    B, nb = bins.shape
    mp = lidx.shape[1]
    ptr = torch.empty((W // 8, B, mp), dtype=torch.int32, device=bins.device)
    _launch(
        "wave_window_table_launch", bins.device,
        (bins, lut, levels, lidx, t0.to(torch.int32), steps_needed.to(torch.int32),
               *state4, cold.to(torch.int32), ptr),
        B, nb, W, mp, *_split_args(levels, mp), *_param_args(params))
    _build.LAUNCHES[_table_counter("align_window_from_state", levels)] += 1
    return ptr


def _two_pass_m_rows(m_actual, rows: int, B: int, mp: int, device):
    """(B,) template lengths of a two-pass call: ``m_actual`` an int with
    one (1, MP) template, or a (B,) int tensor with a template per row."""
    if isinstance(m_actual, torch.Tensor):
        if m_actual.shape != (B,) or rows not in (1, B):
            raise ValueError("per-row lengths take one template, or one per row, and a "
                             "length per row")
        return m_actual.to(torch.int32)
    if rows != 1 or not 0 < m_actual < mp:
        raise ValueError("a two-pass call takes one (1, MP) template of m < MP samples, or a "
                         "template and a length per row")
    return torch.full((B,), int(m_actual), dtype=torch.int32, device=device)


def _ckpt_stride(nd: int, ckpt_chunks: int) -> int:
    ckpt_steps = int(ckpt_chunks) * CHUNK
    if ckpt_steps <= 0 or nd % ckpt_steps:
        raise ValueError(f"ND = {nd} must be a multiple of the checkpoint stride {ckpt_steps}")
    return ckpt_steps


def _require_table(levels, lidx) -> None:
    """Raise unless the levels' form fits its TABLE mode: one CTA's
    (R, UP), or the split form's cluster (R, ctas, UP)."""
    ctas = levels.shape[1] if levels.dim() == 3 else 1
    if wave_score_mode(levels.shape[-1], lidx.shape[1], ctas) != "table":
        raise ValueError(f"a template of {levels.shape[-1]} levels a CTA at MP {lidx.shape[1]} "
                         f"on {ctas} CTAs does not fit the score table: run the f32 entry point "
                         "on lut[bins]")


def align_forward_ckpt(signals, n_actual, template_padded, params, m_actual,
                       ckpt_chunks: int):
    """Pass 1: score-only wave forward with diagonal-state checkpoints.

    signals (B, N) f32 with ND = N + MP a multiple of ckpt_chunks*128;
    template_padded (1, MP) with ``m_actual`` an int, or (B, MP) with
    ``m_actual`` a (B,) tensor (both flanks in one call).  Returns
    (bottom_steps (B, ND), ckpts), the 4-tuple of
    (ND/(ckpt_chunks*128), B, MP) f32 planes (S1, S2, Ih, C): slot g
    holds the state after diagonal step (g+1)*ckpt_chunks*128-1.  A row
    stops at round_up(n + m, 8): slots past that stop are left
    unwritten, and pass 2 never reads them.  No pointer plane exists.
    """
    B, N = signals.shape
    mp = template_padded.shape[1]
    m_rows = _two_pass_m_rows(m_actual, template_padded.shape[0], B, mp, signals.device)
    ckpt_steps = _ckpt_stride(N + mp, ckpt_chunks)
    _check_inputs(signals, n_actual, template_padded, m_rows)
    if _on_card(signals):
        return _ckpt_cuda(signals, template_padded, n_actual, m_rows, params, ckpt_steps)
    return _ckpt_plain(signals, template_padded, n_actual, m_rows, params, ckpt_steps)


def align_forward_ckpt_morph(bins, lut, n_actual, levels, lidx, params, m_actual,
                             ckpt_chunks: int, nd: int):
    """:func:`align_forward_ckpt` on morph-form reads, TABLE score mode
    (launch counter ``align_forward_ckpt_table``): the same outputs as on
    ``lut[bins]`` padded with 0.0 to ND - MP samples, against the
    template rows ``levels[r, lidx[r]]``.

    bins (B, NB) u8, NB a multiple of 128, read in place; lut (B, 256)
    f32; (levels, lidx) = :func:`template_levels` of (1, MP) or (B, MP)
    rows, ``m_actual`` as in :func:`align_forward_ckpt`; ``nd`` >= NB + MP
    a multiple of ckpt_chunks*128.  A template past
    :func:`wave_score_mode`'s table raises: the caller decodes to f32.
    The split form of (levels, lidx) runs on its cluster (launch counter
    ``align_forward_ckpt_cluster``).
    """
    B, nb = bins.shape
    mp = lidx.shape[1]
    m_rows = _two_pass_m_rows(m_actual, lidx.shape[0], B, mp, bins.device)
    ckpt_steps = _ckpt_stride(nd, ckpt_chunks)
    if nd < nb + mp:
        raise ValueError(f"ND = {nd} steps do not cover {nb} samples and {mp} lanes")
    _check_morph(bins, lut, n_actual, levels, lidx, m_rows)
    _require_table(levels, lidx)
    if _on_card(bins):
        return _ckpt_table_cuda(bins, lut, levels, lidx, n_actual, m_rows, params, ckpt_steps,
                                nd)
    if levels.dim() == 3:
        levels, lidx = flat_levels(levels, lidx)
    return _ckpt_table_plain(bins, lut, levels, lidx, n_actual, m_rows, params, ckpt_steps, nd)


def _check_state(state4, B: int, mp: int, device, *extra) -> None:
    if len(state4) != 4 or any(x.shape != (B, mp) or x.dtype != torch.float32
                               or x.device != device for x in (*extra, *state4)):
        raise ValueError("the four state planes (and r_init) are (B, MP) f32 on the window's "
                         "device")


def align_window_from_state(sig_win, r_init, state4, cold, steps_needed, template_padded,
                            params, m_actual: int):
    """Pass 2: pointer forward over a W-step window, resumed from saved state.

    sig_win (B, W): a[t0 .. t0+W) per row; r_init (B, MP): lane i holds
    a[t0-1-i] (both 0.0 outside the signal, as the reference's window
    gather pads); state4 (S1, S2, Ih, C), each (B, MP), the state after
    step t0-1 (cold-start values where ``cold`` is 1: only those rows
    pin the column-0 boundary); steps_needed (B,) local steps a row
    needs (it runs round_up(steps, 8), at most W); template_padded (1,
    MP) or (B, MP).  Returns the (W/8, B, MP) pointer plane in local
    step space; ``m_actual`` is the (longest) template length (the
    reference's discarded bottom tap).
    """
    B, W = sig_win.shape
    mp = template_padded.shape[1]
    if not 0 < m_actual < mp:
        raise ValueError("align_window_from_state takes templates of m < MP samples")
    _check_inputs(sig_win, steps_needed, template_padded, cold)
    _check_state(state4, B, mp, sig_win.device, r_init)
    if _on_card(sig_win):
        return _window_cuda(sig_win, r_init, state4, cold, steps_needed, template_padded, params)
    return _window_plain(sig_win, r_init, state4, cold, steps_needed, template_padded, params)


def align_window_from_state_morph(bins, lut, t0, state4, cold, steps_needed, levels, lidx,
                                  params, m_actual: int, W: int):
    """:func:`align_window_from_state` on morph-form reads, TABLE score
    mode (launch counter ``align_window_from_state_table``): row r's
    window reads its own bins row from sample ``t0[r]`` on, in place (no
    gathered window), with 0.0 on both sides of the read, as the f32
    window's gather fills.  bins (B, NB) u8, lut (B, 256) f32, t0 (B,),
    (levels, lidx) of (1, MP) or (B, MP) template rows; W a multiple of
    128.  A template past :func:`wave_score_mode`'s table raises.  The
    split form runs on its cluster (``align_window_from_state_cluster``).
    """
    B = bins.shape[0]
    mp = lidx.shape[1]
    if W % CHUNK or W <= 0 or not 0 < m_actual < mp:
        raise ValueError(f"a window of W % {CHUNK} == 0 steps and templates of m < MP samples")
    _check_morph(bins, lut, steps_needed, levels, lidx, cold)
    if t0.shape != (B,) or t0.device != bins.device:
        raise ValueError("t0 is a (B,) tensor on the bins' device")
    _check_state(state4, B, mp, bins.device)
    _require_table(levels, lidx)
    if _on_card(bins):
        return _window_table_cuda(bins, lut, t0, state4, cold, steps_needed, levels, lidx,
                                  params, W)
    if levels.dim() == 3:
        levels, lidx = flat_levels(levels, lidx)
    return _window_table_plain(bins, lut, t0, state4, cold, steps_needed, levels, lidx, params,
                               W)


# ---------------------------------------------------------------------------
# Column-sweep form (kernel row 8, STRIQUE_ALIGN_KERNEL=col)
# ---------------------------------------------------------------------------
#
# The same Gotoh DP swept one signal column per step (align_pallas.py
# ``_align_kernel``): the vertical gap is an inclusive prefix max over the
# template lanes, and the pointer plane is column-major.  Kernel
# ``csrc/col_align.cu``, in the POW score mode on f32 signals
# (``align_forward_col``) or the TABLE score mode on morph-form reads
# (``align_forward_col_morph``, where :func:`col_score_mode` allows).

# the column kernel's exchange: 5 slots x 2 step parities x 32 warps, in
# the same shared memory as the TABLE mode's score table
COL_EXCH_FLOATS = 5 * 2 * 32


def col_score_mode(n_levels: int, mp: int, ctas: int = 1) -> str:
    """The score mode of a morph-form column call of ``ctas`` CTAs a
    row: "table" when the template has at most TABLE_MAX_MP lanes (one
    CTA) or the split is one the kernel takes (a cluster), and the CTA's
    ``n_levels`` x 258 f32 table fits one block's shared memory
    (SMEM_BYTES) beside the one-CTA kernel's COL_EXCH_FLOATS exchange
    floats or the cluster kernel's rings (COL_RING_BYTES), else "pow"
    (on the decoded f32).  The cap is 224 levels at any MP up to 1024 (a
    ``samples=6`` template of the bench's c9orf72 flanks has 119-142),
    218 a CTA on a cluster."""
    fixed = COL_RING_BYTES if ctas > 1 else 4 * COL_EXCH_FLOATS
    fits = fixed + 4 * n_levels * SCORE_COLS <= SMEM_BYTES
    lanes_ok = mp <= TABLE_MAX_MP if ctas == 1 else _split_ok(mp, ctas)
    return "table" if lanes_ok and fits else "pow"


def col_table_ctas(tmpl) -> int:
    """CTAs a row of the column kernel's TABLE mode takes for the (1,
    MP) template, by :func:`col_score_mode`, as :func:`wave_table_ctas`
    does for the wave kernel; 0 = POW.  The fewest that fit: the launch
    plan (:func:`col_launch_plan`) may take more."""
    return _table_ctas(tmpl, col_score_mode)


def col_step_us(mp: int, ctas: int) -> float:
    """The column kernel's cluster TABLE step, in us a column, of a row of
    ``mp`` lanes on ``ctas`` CTAs: COL_STEP_US at the CTA's lanes, read
    by :func:`_step_at`."""
    return _step_at(COL_STEP_US, cta_lanes(mp, ctas))


def col_launch_plan(rows: int, tmpl, n_cols: int, device=None, sms: int | None = None,
                    ctas: int | None = None) -> tuple[int, int]:
    """(CTAs a row, rows) of the column kernel's next call over ``rows``
    rows of the (1, MP) template ``tmpl`` and ``n_cols`` signal columns,
    decided before the launch.  ``ctas`` is :func:`col_table_ctas` of
    ``tmpl`` if the caller has it.

    Card rule (a CUDA device, or any device when ``sms`` is given), for a
    template past one CTA's table (``ctas`` >= 2): each call takes a CTA
    count C from ``ctas`` up to MAX_CTAS whose split the kernel takes and
    whose per-CTA tables fit (:func:`col_score_mode`), and as many rows
    as fit: :func:`kernel_batch`'s width at C, within the clusters the
    card runs at once (:func:`cluster_capacity` of the column kernel).  Of
    the call sequences that cover the rows, the plan takes the one whose
    predicted wall is least (a call costs ``n_cols`` columns at
    :func:`col_step_us`) and returns its first call; ties take fewer
    CTAs.  A template within one CTA (``ctas`` 1) or past every split
    (0: POW) keeps ``ctas`` at kernel_batch's width.  CPU rule: ``ctas``
    and the reference's widths, so the CPU parity tests compare like
    with like."""
    tmpl = np.asarray(tmpl, np.float32)
    mp = tmpl.shape[1]
    c_min = col_table_ctas(tmpl) if ctas is None else int(ctas)
    if sms is None:
        sms = sm_count(device)

    def width(c: int, r: int) -> int:
        kb = kernel_batch(r, n_cols=n_cols, mp=mp, device=device, sms=sms, ctas=max(c, 1))
        cap = cluster_capacity(device, c, cta_lanes(mp, c), "col") if c > 1 else None
        return kb if cap is None else min(kb, max(8, cap // 8 * 8))

    if sms is None or c_min < 2:
        return c_min, width(c_min, rows)
    ok = _cluster_ctas(tmpl.tobytes(), mp, c_min, "col")
    return _least_calls(rows, lambda r: ok, width, lambda c: n_cols * col_step_us(mp, c))


def _cols_to_run(n_actual, N: int) -> int:
    """Columns the longest row needs: round_up(n, 8), at most N."""
    if n_actual.numel() == 0:
        return 0
    return int(min(N, _round_up(int(n_actual.max()), 8)))


def _col_recurrence(scores, n_actual, params, m_actual: int, N: int, mp: int):
    """The column recurrence in plain PyTorch ops over (B, MP) rows:
    (ptr (N/8, B, MP), bottom (B, N)).  ``scores(c)`` gives column c's
    (B, MP) cell scores.

    Step c computes column j = c + 1 with the reference's expression
    trees.  The code of row i sits at lane i-1 (row 0's at lane MP-1,
    never read), nibble c % 8 of word c // 8; bottom[:, c] is S(m, j),
    NEG past the row's length.  Runs round_up(max n, 8) columns; the
    rest of the plane stays 0 and of the bottom NEG.
    """
    k = _consts(params)
    B = n_actual.shape[0]
    dev = n_actual.device
    lane = torch.arange(mp, device=dev)
    lane_f = lane.to(torch.float32)
    row0 = lane == 0
    s = torch.where(row0, 0.0, k["go_v"] + k["ge_v"] * (lane_f - 1.0)).expand(B, mp)
    ih = torch.full((B, mp), NEG, device=dev)
    cv_off = (lane_f + 1.0) * k["g"]
    iv_off = lane_f * k["g"]
    fill_s = torch.full((B, 1), -k["dmin"] if k["neg_h"] else NEG, device=dev)
    fill_neg = torch.full((B, 1), NEG, device=dev)
    zero_i = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    ptr = torch.zeros((N // 8, B, mp), dtype=torch.int32, device=dev)
    bottom = torch.full((B, N), NEG, device=dev)
    n_act = n_actual.to(torch.int64)
    acc = torch.zeros((B, mp), dtype=torch.int32, device=dev)
    for c in range(_cols_to_run(n_actual, N)):
        sc = scores(c)
        ih_ext = ih + k["ge_h"]
        ih_open = s + k["go_h"]
        new_ih = torch.maximum(ih_ext, ih_open)
        new_m = torch.cat([fill_s, s[:, :-1]], dim=1) + sc
        q = torch.maximum(new_m, new_ih)
        if not k["neg_h"]:
            q = torch.where(row0, 0.0, q)
        cvec = torch.cummax((q + k["go_v"]) - cv_off, dim=1).values
        new_iv = torch.cat([fill_neg, cvec[:, :-1]], dim=1) + iv_off
        new_s = torch.maximum(q, new_iv)
        which = torch.where(new_m >= new_s, 0, torch.where(new_iv >= new_s, 2, 1))
        ivx = ((new_iv + k["ge_v"]) >= (new_s + k["go_v"])).to(torch.int32)
        code = (which.to(torch.int32)
                | ((ih_ext >= ih_open).to(torch.int32) << 2)
                | (torch.cat([zero_i, ivx[:, :-1]], dim=1) << 3))
        acc |= torch.roll(code, -1, dims=1) << (4 * (c % 8))
        bottom[:, c] = torch.where(c + 1 <= n_act, new_s[:, m_actual], NEG)
        s, ih = new_s, new_ih
        if c % 8 == 7:
            ptr[c // 8] = acc
            acc = torch.zeros_like(acc)
    return ptr, bottom


def _col_plain(signals, tmpl, n_actual, params, m_actual: int):
    """Plain twin of the column kernel's POW mode: (ptr (N/8, B, MP),
    bottom (B, N)), column c scored against ``signals[:, c]``."""
    k = _consts(params)
    return _col_recurrence(
        lambda c: torch.clamp_min(k["off"] - score_pow((signals[:, c : c + 1] - tmpl).abs()),
                                  k["dmin"]),
        n_actual, params, m_actual, signals.shape[1], tmpl.shape[1])


def _col_table_plain(bins, lut, levels, lidx, n_actual, params, m_actual: int):
    """Plain twin of the column kernel's TABLE mode: the same recurrence,
    lane i scoring column c as :func:`score_table` entry
    [lidx[0, i], bins[:, c]].  (ptr (N/8, B, MP), bottom (B, N))."""
    B = bins.shape[0]
    tab = score_table(lut, levels, params).reshape(B, -1)
    row_off = (lidx.to(torch.int64) * SCORE_COLS).expand(B, -1)
    b64 = bins.to(torch.int64)
    return _col_recurrence(lambda c: tab.gather(1, row_off + b64[:, c : c + 1]), n_actual,
                           params, m_actual, bins.shape[1], lidx.shape[1])


def _col_cuda(signals, tmpl, n_actual, params, m_actual: int):
    B, N = signals.shape
    mp = tmpl.shape[1]
    ptr = torch.empty((N // 8, B, mp), dtype=torch.int32, device=signals.device)
    bottom = torch.empty((B, N), dtype=torch.float32, device=signals.device)
    _launch("col_align_launch", signals.device,
            (signals, tmpl, n_actual.to(torch.int32), ptr, bottom),
            B, N, mp, int(m_actual), *_param_args(params))
    _build.LAUNCHES["align_forward_col"] += 1
    return ptr, bottom


def _col_table_cuda(bins, lut, levels, lidx, n_actual, params, m_actual: int):
    B, N = bins.shape
    mp = lidx.shape[1]
    ptr = torch.empty((N // 8, B, mp), dtype=torch.int32, device=bins.device)
    bottom = torch.empty((B, N), dtype=torch.float32, device=bins.device)
    up, _, ctas, mpc = _split_args(levels, mp)
    _launch("col_table_launch", bins.device,
            (bins, lut, levels, lidx, n_actual.to(torch.int32), ptr, bottom),
            B, N, mp, up, ctas, mpc, int(m_actual), *_param_args(params))
    _build.LAUNCHES[_table_counter("align_forward_col", levels)] += 1
    return ptr, bottom


def align_forward_col(signals, n_actual, template_padded, params, m_actual: int):
    """Column-sweep forward DP of B reads against one shared template.

    Counterpart of the reference's ``align_forward_pallas``.  signals
    (B, N) f32, N a multiple of 128; template_padded (1, MP).  Returns
    (ptr (N//8, B, MP) int32, bottom (B, N) f32): column j's code for
    row i sits in nibble (j-1) % 8 of word [(j-1)//8, row, i-1]
    (``traceback_pointers(packed=True)`` reads it), and bottom[:, j-1]
    is S(m, j), NEG for j > n.  A row stops at round_up(n, 8): pointer
    words past it are left unwritten.  POW score mode (launch counter
    ``align_forward_col``).
    """
    B = signals.shape[0]
    if template_padded.shape[0] != 1 or not 0 < m_actual < template_padded.shape[1]:
        raise ValueError("align_forward_col takes one (1, MP) template of m < MP samples")
    m_rows = torch.full((B,), int(m_actual), dtype=torch.int32, device=signals.device)
    _check_inputs(signals, n_actual, template_padded, m_rows)
    if _on_card(signals):
        return _col_cuda(signals, template_padded, n_actual, params, m_actual)
    return _col_plain(signals, template_padded, n_actual, params, m_actual)


def align_forward_col_morph(bins, lut, n_actual, levels, lidx, params, m_actual: int):
    """:func:`align_forward_col` on morph-form reads: the same outputs as
    on the f32 signals ``lut[bins]`` against the template
    ``levels[0, lidx[0]]``.

    bins (B, N) u8, N a multiple of 128, read in place; lut (B, 256) f32;
    (levels, lidx) = :func:`template_levels` of a (1, MP) template.  Runs
    the TABLE score mode (launch counter ``align_forward_col_table``)
    where :func:`col_score_mode` allows, else the POW mode on the decoded
    f32 (``align_forward_col``).  The split form,
    ``template_levels(tmpl, ctas)``, runs TABLE on a cluster of ``ctas``
    CTAs a row (``align_forward_col_cluster``; raises past its table).
    """
    B = bins.shape[0]
    if lidx.shape[0] != 1 or not 0 < m_actual < lidx.shape[1]:
        raise ValueError("align_forward_col_morph takes one (1, MP) template of m < MP samples")
    m_rows = torch.full((B,), int(m_actual), dtype=torch.int32, device=bins.device)
    _check_morph(bins, lut, n_actual, levels, lidx, m_rows)
    if levels.dim() == 3:
        ctas = levels.shape[1]
        if col_score_mode(levels.shape[2], lidx.shape[1], ctas) != "table":
            raise ValueError(f"a template of {levels.shape[2]} levels a CTA at MP "
                             f"{lidx.shape[1]} on {ctas} CTAs does not fit the column kernel's "
                             "score table: run the f32 entry point on lut[bins]")
        if _on_card(bins):
            return _col_table_cuda(bins, lut, levels, lidx, n_actual, params, m_actual)
        return _col_table_plain(bins, lut, *flat_levels(levels, lidx), n_actual, params,
                                m_actual)
    if col_score_mode(levels.shape[1], lidx.shape[1]) == "pow":
        tmpl = levels.gather(1, lidx.to(torch.int64))
        return align_forward_col(morph_decode(bins, lut), n_actual, tmpl, params, m_actual)
    if _on_card(bins):
        return _col_table_cuda(bins, lut, levels, lidx, n_actual, params, m_actual)
    return _col_table_plain(bins, lut, levels, lidx, n_actual, params, m_actual)
