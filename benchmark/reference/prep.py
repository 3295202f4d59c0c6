"""Host preprocessing of a raw read (reference scripts/STRique.py:590-597).

    flt   = medfilt(raw, 3)                          # zero-padded edges
    morph = floor(clip((flt - median) / MAD * 24 + 127, 0, 255))
    morph = closing(opening(morph, rectangle(1, 8)))
    morph -> minmax-normalised 256-level table (the alignment's input)
    flt   -> minmax-normalised float64 (the Viterbi's input, and log_p's)

NumPy in float64.  The greyscale opening and closing with an 8-wide
footprint anchor erosion at offsets [-4, +3] and dilation at [-3, +4],
each window clipped to the read.
"""
from __future__ import annotations

import numpy as np

from .pore import PoreModel, mean_abs_dev

MORPH_WINDOW = 8
LEVELS = 256


def medfilt3(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    left = np.concatenate([[0.0], x[:-1]])
    right = np.concatenate([x[1:], [0.0]])
    return np.maximum(np.minimum(left, x), np.minimum(np.maximum(left, x), right))


def _window_reduce(x: np.ndarray, left: int, right: int, op) -> np.ndarray:
    n = len(x)
    pad_val = np.inf if op is np.minimum else -np.inf
    ext = np.concatenate([np.full(left, pad_val), x.astype(np.float64), np.full(right, pad_val)])
    out = ext[:n].copy()
    for off in range(1, left + right + 1):
        out = op(out, ext[off : off + n])
    return out


def _erode(x):
    h = MORPH_WINDOW // 2
    return _window_reduce(x, h, MORPH_WINDOW - 1 - h, np.minimum)


def _dilate(x):
    h = MORPH_WINDOW // 2
    return _window_reduce(x, MORPH_WINDOW - 1 - h, h, np.maximum)


def morph_bins(flt: np.ndarray) -> np.ndarray:
    """The quantised, opened and closed signal: values 0..255 (float64)."""
    m = (flt - float(np.median(flt))) / mean_abs_dev(flt)
    m = np.floor(np.clip(m * 24.0 + 127.0, 0, 255))
    return _erode(_dilate(_dilate(_erode(m))))


def prep(raw: np.ndarray, pm: PoreModel):
    """raw -> (bins (n,) u8, lut (256,) f32, flt (n,) f64): the morph bins,
    their minmax level table and the minmax-normalised filtered signal."""
    flt = medfilt3(np.asarray(raw, dtype=np.float64))
    bins = morph_bins(flt)
    aff = pm.norm_minmax(bins)
    lut = np.clip(np.arange(LEVELS, dtype=np.float64) * aff.scale + aff.offset, aff.lo, aff.hi)
    return bins.astype(np.uint8), lut.astype(np.float32), pm.normalize_minmax(flt)
