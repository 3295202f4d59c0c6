"""Signal preprocessing ops: median filter and greyscale morphology.

Replicates the reference preprocessing chain (reference scripts/STRique.py:590-597):

    flt   = medfilt(raw, 3)                         # scipy.signal.medfilt
    morph = clip((flt-median)/MAD*24+127, 0, 255)   # uint8 quantization
    morph = closing(opening(morph, rect(1,8)))      # skimage greyscale morphology
    morph = normalize2model(morph, mode='minmax')
    flt   = normalize2model(flt,  mode='minmax')

Border semantics:
  * ``medfilt`` kernel 3 zero-pads (scipy behavior).
  * skimage ``opening``/``closing`` with rectangle(1,8) lower to
    scipy.ndimage grey ops with an even footprint: erosion anchors at
    offsets [-4,+3], dilation (mirrored footprint) at [-3,+4], reflect
    border — which for contiguous windows equals min/max over the
    window's intersection with the valid range.

The port's own copy of the NumPy host path of
``strique_tpu/ops/signal.py`` (float64): the counter's prep fallback
where the native library cannot be built.  tests/test_torch_copies.py
pins the two equal.
"""
from __future__ import annotations

import numpy as np

MORPH_WINDOW = 8
_ERO_LEFT, _ERO_RIGHT = 4, 3  # offsets [-4, +3]
_DIL_LEFT, _DIL_RIGHT = 3, 4  # offsets [-3, +4]


# ---------------------------------------------------------------------------
# NumPy host path
# ---------------------------------------------------------------------------

def medfilt3(x: np.ndarray) -> np.ndarray:
    """Median filter, kernel 3, zero-padded edges (== scipy.signal.medfilt(x, 3))."""
    x = np.asarray(x, dtype=np.float64)
    left = np.concatenate([[0.0], x[:-1]])
    right = np.concatenate([x[1:], [0.0]])
    return np.maximum(np.minimum(left, x), np.minimum(np.maximum(left, x), right))


def _window_reduce_np(x: np.ndarray, left: int, right: int, op) -> np.ndarray:
    """Reduce over window [i-left, i+right] clipped to the valid range."""
    n = len(x)
    pad_val = np.inf if op is np.minimum else -np.inf
    ext = np.concatenate([np.full(left, pad_val), x.astype(np.float64), np.full(right, pad_val)])
    out = ext[:n].copy()
    for off in range(1, left + right + 1):
        out = op(out, ext[off : off + n])
    return out


def erode_np(x: np.ndarray, window: int = MORPH_WINDOW) -> np.ndarray:
    l = window // 2
    return _window_reduce_np(x, l, window - 1 - l, np.minimum)


def dilate_np(x: np.ndarray, window: int = MORPH_WINDOW) -> np.ndarray:
    l = window // 2
    return _window_reduce_np(x, window - 1 - l, l, np.maximum)


def open_close_np(x: np.ndarray, window: int = MORPH_WINDOW) -> np.ndarray:
    """Greyscale opening followed by closing (reference STRique.py:593-595)."""
    opened = dilate_np(erode_np(x, window), window)
    closed = erode_np(dilate_np(opened, window), window)
    return closed


def quantize_morph_np(flt: np.ndarray, median: float, mad: float) -> np.ndarray:
    """uint8 quantization step (reference STRique.py:591-592). Truncating cast."""
    m = (flt - median) / mad
    m = np.clip(m * 24.0 + 127.0, 0, 255)
    return np.floor(m)  # .astype(uint8) truncates; values are >= 0
