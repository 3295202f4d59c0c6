"""Preprocessing constants shared by the host preprocessing backends.

The port's own copy of ``strique_tpu/ops/prep.py::model_const``.  The
per-read preprocessing chain (reference scripts/STRique.py:590-597:
median filter, uint8 quantization, greyscale open/close, minmax
normalization) runs on the HOST -- the native C++ single pass
(``strique_tpu_torch/native.py``) when a compiler is available, float64
NumPy (``ops/signal.py``) otherwise -- and ships to the device
byte-packed (morph u8 bins with a 256-entry level table,
detect/counter.py).
"""
from __future__ import annotations


def model_const(pm) -> tuple:
    """Static normalization constants of a PoreModel for the native
    preprocessing ABI: (m5_mod, m95_mod, clip_lo, clip_hi) -- the
    model-side tail medians of the minmax mapping (reference
    scripts/STRique.py:152-160) and the model clip range (reference
    :178-179)."""
    return (pm._m5_mod, pm._m95_mod, pm.model_min + 0.5, pm.model_max - 0.5)
