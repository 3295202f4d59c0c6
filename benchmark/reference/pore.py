"""Pore model: k-mer level table, minmax normalisation and signal synthesis.

A frozen copy of the parts of STRique's ``pore_model`` class that
``count`` uses (reference scripts/STRique.py:113-195): the model's
statistics, ``scale2stdv`` (for the mod HMM), the 'minmax' normalisation
and ``generate_signal``.  NumPy in float64.
"""
from __future__ import annotations

import numpy as np


class AffineNorm:
    """y = x * scale + offset, then clip to [lo, hi]."""

    __slots__ = ("scale", "offset", "lo", "hi")

    def __init__(self, scale: float, offset: float, lo: float, hi: float):
        self.scale = float(scale)
        self.offset = float(offset)
        self.lo = float(lo)
        self.hi = float(hi)

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        return np.clip(signal * self.scale + self.offset, self.lo, self.hi)


def mean_abs_dev(signal: np.ndarray) -> float:
    """Mean absolute deviation about the median (reference STRique.py:142-143)."""
    signal = np.asarray(signal, dtype=np.float64)
    return float(np.mean(np.absolute(signal - np.median(signal))))


class PoreModel:
    """k-mer -> (level_mean, level_stdv), from a ``kmer<TAB>mean<TAB>stdv`` file."""

    def __init__(self, model_file: str):
        model_dict = {}
        with open(model_file, "r") as fp:
            for line in fp:
                cols = line.strip().split("\t")[:3]
                if len(cols) < 3:
                    continue
                model_dict[cols[0]] = (float(cols[1]), float(cols[2]))
        if not model_dict:
            raise ValueError(f"empty pore model file: {model_file}")
        self.model_dict = model_dict
        self.kmer = len(next(iter(model_dict)))
        means = np.array([v[0] for v in model_dict.values()], dtype=np.float64)
        stdvs = np.array([v[1] for v in model_dict.values()], dtype=np.float64)
        self.stdvs = stdvs
        min_i = int(np.argmin(means))
        max_i = int(np.argmax(means))
        self.model_min = float(means[min_i] - 6.0 * stdvs[min_i])
        self.model_max = float(means[max_i] + 6.0 * stdvs[max_i])
        q5_mod, q95_mod = np.percentile(means, [1, 99])
        self._m5_mod = float(np.median(means[means < q5_mod]))
        self._m95_mod = float(np.median(means[means > q95_mod]))

    def scale2stdv(self, other: "PoreModel") -> float:
        """median(other's stdvs) / median(this model's) (reference
        STRique.py:145-148)."""
        return float(np.median(other.stdvs) / np.median(self.stdvs))

    def norm_minmax(self, signal: np.ndarray) -> AffineNorm:
        """The 'minmax' mapping of a signal onto the model (reference
        STRique.py:152-160): the medians of its <1st and >99th percentile
        tails onto the model's, clipped to the model's range +- 0.5."""
        signal = np.asarray(signal, dtype=np.float64)
        q5_sig, q95_sig = np.percentile(signal, [1, 99])
        m5_sig = float(np.median(signal[signal < q5_sig]))
        m95_sig = float(np.median(signal[signal > q95_sig]))
        half_sig = (m95_sig - m5_sig) / 2.0
        mid_sig = m5_sig + half_sig
        half_mod = (self._m95_mod - self._m5_mod) / 2.0
        mid_mod = self._m5_mod + half_mod
        scale = half_mod / half_sig
        offset = mid_mod - mid_sig * scale
        return AffineNorm(scale, offset, self.model_min + 0.5, self.model_max - 0.5)

    def normalize_minmax(self, signal: np.ndarray) -> np.ndarray:
        return self.norm_minmax(signal)(np.asarray(signal, dtype=np.float64))

    def kmer_levels(self, sequence: str) -> tuple[np.ndarray, np.ndarray]:
        k = self.kmer
        kmers = [sequence[i : i + k] for i in range(len(sequence) - k + 1)]
        means = np.array([self.model_dict[km][0] for km in kmers], dtype=np.float64)
        stdvs = np.array([self.model_dict[km][1] for km in kmers], dtype=np.float64)
        return means, stdvs

    def template(self, sequence: str, samples: int) -> np.ndarray:
        """The idealised signal of a sequence, ``samples`` per k-mer, as f32
        (a flank template of the alignment)."""
        means, _ = self.kmer_levels(sequence)
        return np.repeat(means, samples).astype(np.float32)
