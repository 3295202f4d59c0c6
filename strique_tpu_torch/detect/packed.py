"""Bounds-row packing of the split pipeline (40 bytes per read).

Counterpart of ``strique_tpu/detect/packed.py``: ``pack_meta`` in
PyTorch on the bounds' device, and the port's own copies of the
host-side decoder ``unpack_meta`` and ``path_itemsize`` (NumPy;
tests/test_torch_copies.py pins them to the originals).

Meta fields (float32 each, exact for the integer-valued entries):
score_p, span_p, score_s, span_s, prefix_begin, prefix_end,
suffix_begin, suffix_end, ok, seg_len.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

META_FIELDS = ("score_p", "span_p", "score_s", "span_s",
               "prefix_begin", "prefix_end", "suffix_begin", "suffix_end",
               "ok", "seg_len")


def path_itemsize(n_states: int) -> int:
    """Bytes per path entry: u8 up to 256 states, u16 beyond."""
    return 1 if n_states <= 256 else 2


def pack_meta(bounds: dict) -> torch.Tensor:
    """Bounds dict -> (B, META_FLOATS) float32 rows on the bounds' device.

    Integer fields are exact in float32 (all are < 2^24).
    """
    return torch.stack([bounds[k].to(torch.float32) for k in META_FIELDS], dim=1)


@dataclass
class ReadResult:
    """Decoded per-read bounds row."""

    ok: bool
    score_prefix: float  # per-sample (span-normalized) scores
    score_suffix: float
    prefix_begin: int
    prefix_end: int
    suffix_begin: int
    suffix_end: int
    seg_len: int
    path: np.ndarray | None  # always None here: paths travel separately


def unpack_meta(meta: np.ndarray) -> list[ReadResult]:
    """Host-side inverse of :func:`pack_meta` ((B, META_FLOATS) float32)."""
    out = []
    for i in range(meta.shape[0]):
        (score_p, span_p, score_s, span_s,
         pb, pe, sb, se, okf, seg_len) = meta[i]
        span_p, span_s = int(span_p), int(span_s)
        out.append(ReadResult(
            ok=bool(okf),
            score_prefix=float(score_p) / span_p if span_p > 0 else 0.0,
            score_suffix=float(score_s) / span_s if span_s > 0 else 0.0,
            prefix_begin=int(pb), prefix_end=int(pe),
            suffix_begin=int(sb), suffix_end=int(se),
            seg_len=int(seg_len), path=None,
        ))
    return out
