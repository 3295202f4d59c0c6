"""Packed batch results: the split pipeline's bounds rows and the fused
route's whole rows.

Counterpart of ``strique_tpu/detect/packed.py``: ``pack_meta`` and
``pack_results`` in PyTorch on the bounds' device, and the port's own
copies of the host-side decoders ``unpack_meta`` and ``unpack_results``
and of ``path_itemsize`` (NumPy; tests/test_torch_copies.py pins them
to the originals).

Per-read row layout of :func:`pack_results` (one D2H for the batch)::

    [ META_FLOATS float32 as bytes | path (u8, or u16-LE when the HMM
      has more than 256 states) ]

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
META_FLOATS = len(META_FIELDS)
META_BYTES = 4 * META_FLOATS


def path_itemsize(n_states: int) -> int:
    """Bytes per path entry: u8 up to 256 states, u16 beyond."""
    return 1 if n_states <= 256 else 2


def pack_meta(bounds: dict) -> torch.Tensor:
    """Bounds dict -> (B, META_FLOATS) float32 rows on the bounds' device.

    Integer fields are exact in float32 (all are < 2^24).
    """
    return torch.stack([bounds[k].to(torch.float32) for k in META_FIELDS], dim=1)


def pack_results(bounds: dict, paths: torch.Tensor, n_states: int) -> torch.Tensor:
    """Bounds dict + (B, T) int paths -> (B, META_BYTES + T * itemsize)
    uint8 rows on the bounds' device; u16 entries little-endian."""
    meta_u8 = pack_meta(bounds).contiguous().view(torch.uint8)
    p = paths.to(torch.int32)
    if path_itemsize(n_states) == 1:
        path_u8 = p.to(torch.uint8)
    else:
        path_u8 = torch.stack([p & 0xFF, (p >> 8) & 0xFF], dim=2).to(torch.uint8)
        path_u8 = path_u8.reshape(p.shape[0], -1)
    return torch.cat([meta_u8, path_u8], dim=1)


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
    path: np.ndarray | None  # int32 Viterbi path, None when gated out or split


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


def unpack_results(packed: np.ndarray, n_states: int) -> list[ReadResult]:
    """Host-side inverse of :func:`pack_results` (numpy, zero-copy views)."""
    meta = packed[:, :META_BYTES].copy().view(np.float32)
    raw_paths = packed[:, META_BYTES:]
    if path_itemsize(n_states) == 2:
        raw_paths = raw_paths.view(np.uint16)
    out = []
    for i in range(packed.shape[0]):
        (score_p, span_p, score_s, span_s,
         pb, pe, sb, se, okf, seg_len) = meta[i]
        span_p, span_s = int(span_p), int(span_s)
        ok = bool(okf)
        out.append(ReadResult(
            ok=ok,
            score_prefix=float(score_p) / span_p if span_p > 0 else 0.0,
            score_suffix=float(score_s) / span_s if span_s > 0 else 0.0,
            prefix_begin=int(pb), prefix_end=int(pe),
            suffix_begin=int(sb), suffix_end=int(se),
            seg_len=int(seg_len),
            path=raw_paths[i].astype(np.int32) if ok else None,
        ))
    return out
