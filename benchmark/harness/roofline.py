"""Peaks of the card and the least time of the work a window needed.

Peaks are NVIDIA's published figures for one H100 SXM (dense, no
sparsity) at its 700 W limit: FP32 outside the tensor cores 67
TFLOP/s, HBM 3.35 TB/s.  A share is stated against them with the
card's power limit printed beside it.  The score table's float64 power
(per read, a few hundred levels x 258 bins, under 0.1% of a read's
cells) is left out of the count.

Operation counts are those of the kernels' expression trees:

  * alignment, per DP cell (n x m for each read and flank, the read's
    own length, counted once whatever route, pass count or padding
    runs): 19 float32 operations (the recurrence and pointer code with
    the score looked up from the template's table); and half a byte
    of pointer plane written;
  * Viterbi, per (step, state) of each read's repeat segment over the
    HMM's own states: the factored forward's 46 float32 operations (an
    add and a max for each of its 16 rolls, 3 for each of its 2 chains,
    8 for the emission and the rescale) and a 4-byte score written,
    then the backward's 3 operations and that score read back.

A kernel's least time is the larger of operations over the FP32 peak
and bytes over HBM bandwidth; a layer's is the sum of its kernels'.
"""
from __future__ import annotations

F32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

ALIGN_F32_PER_CELL = 19
ALIGN_BYTES_PER_CELL = 0.5
FWD_F32_PER_PAIR = 2 * 16 + 3 * 2 + 8
FWD_BYTES_PER_PAIR = 4
BWD_F32_PER_PAIR = 3
BWD_BYTES_PER_PAIR = 4


def bound_s(f32_ops: float, nbytes: float) -> float:
    return max(f32_ops / F32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def align_bound_s(cells: float) -> float:
    return bound_s(ALIGN_F32_PER_CELL * cells, ALIGN_BYTES_PER_CELL * cells)


def viterbi_bound_s(pairs: float) -> float:
    return (bound_s(FWD_F32_PER_PAIR * pairs, FWD_BYTES_PER_PAIR * pairs)
            + bound_s(BWD_F32_PER_PAIR * pairs, BWD_BYTES_PER_PAIR * pairs))


def layer_kernel_s(kernels, names) -> float | None:
    """Device seconds of the kernels whose name holds one of ``names``;
    None when none of them ran."""
    hits = [(e - s) for s, e, n, _c in kernels if any(k in n for k in names)]
    return sum(hits) / 1e6 if hits else None


def share_pct(bound: float, kernel_s: float | None) -> float | None:
    if kernel_s is None or kernel_s <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / kernel_s
