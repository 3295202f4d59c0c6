"""Alignment scoring parameters.

The port's own copy of ``strique_tpu/ops/reference.py::AlignParams``
(the f64 DP oracles of that module stay with the tests).
``convert.align_params_from_jax`` maps the reference's instance onto
this one by its six fields.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class AlignParams:
    """Alignment scoring parameters (reference scripts/STRique.py:507-513 defaults)."""

    dist_offset: float = 16.0
    dist_min: float = 0.0
    gap_open_h: float = -1.0
    gap_open_v: float = -16.0
    gap_extension_h: float = -1.0
    gap_extension_v: float = -16.0
