"""Pore model: k-mer level table, signal normalization and synthesis.

The port's own copy of ``strique_tpu/pore_model.py`` (host-side NumPy in
float64, no JAX); tests/test_torch_copies.py pins the two equal.  It
re-implements the reference ``pore_model`` class (reference:
scripts/STRique.py:113-195).  The data-dependent statistics (medians /
percentiles of tails) stay on the host, which preserves the reference's
exact semantics.
"""
from __future__ import annotations

import numpy as np

__all__ = ["PoreModel", "AffineNorm"]


class AffineNorm:
    """y = x * scale + offset, then clip to [lo, hi] (lo/hi may be -inf/inf)."""

    __slots__ = ("scale", "offset", "lo", "hi")

    def __init__(self, scale: float, offset: float, lo: float = -np.inf, hi: float = np.inf):
        self.scale = float(scale)
        self.offset = float(offset)
        self.lo = float(lo)
        self.hi = float(hi)

    def __call__(self, signal: np.ndarray) -> np.ndarray:
        out = signal * self.scale + self.offset
        if np.isfinite(self.lo) or np.isfinite(self.hi):
            out = np.clip(out, self.lo, self.hi)
        return out


def mean_abs_dev(signal: np.ndarray) -> float:
    """Mean absolute deviation about the median (reference STRique.py:142-143)."""
    signal = np.asarray(signal, dtype=np.float64)
    return float(np.mean(np.absolute(signal - np.median(signal))))


class PoreModel:
    """k-mer -> (level_mean, level_stdv) table with normalization helpers.

    Model file format: tab-separated ``kmer  level_mean  level_stdv [...]``
    rows (reference: models/r9_4_450bps.model, parsed at STRique.py:114-127).
    """

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
        self.model_file = model_file
        self.model_dict = model_dict
        self.kmer = len(next(iter(model_dict.keys())))
        means = np.array([v[0] for v in model_dict.values()], dtype=np.float64)
        stdvs = np.array([v[1] for v in model_dict.values()], dtype=np.float64)
        self._means = means
        self._stdvs = stdvs
        # model statistics (reference STRique.py:121-126)
        self.model_median = float(np.median(means))
        self.model_MAD = float(np.mean(np.absolute(means - self.model_median)))
        min_i = int(np.argmin(means))
        max_i = int(np.argmax(means))
        self.model_min = float(means[min_i] - 6.0 * stdvs[min_i])
        self.model_max = float(means[max_i] + 6.0 * stdvs[max_i])
        # tail medians for 'minmax' normalization (reference STRique.py:152-158);
        # model side is signal-independent, precompute once.
        q5_mod, q95_mod = np.percentile(means, [1, 99])
        self._m5_mod = float(np.median(means[means < q5_mod]))
        self._m95_mod = float(np.median(means[means > q95_mod]))

    # -- statistics --------------------------------------------------------
    def MAD(self, signal: np.ndarray) -> float:
        return mean_abs_dev(signal)

    def scale2stdv(self, other: "PoreModel") -> float:
        """Ratio median(other stdvs)/median(self stdvs) (reference STRique.py:145-148)."""
        return float(np.median(other._stdvs) / np.median(self._stdvs))

    # -- normalization -----------------------------------------------------
    def norm_params(self, signal: np.ndarray, clip: bool = True, mode: str = "median") -> AffineNorm:
        """Compute the affine normalization mapping signal space onto model space.

        Modes replicate reference STRique.py:150-180:
          * ``median``: z-score by median/MAD, rescale to model median/MAD.
          * ``minmax``: medians of the <1st / >99th percentile tails of the
            signal map onto the corresponding model tail medians.
          * ``entropy``: like ``median`` but statistics restricted to a
            change-point mask (sliding-MAD derivative peaks, dilated).
        """
        signal = np.asarray(signal, dtype=np.float64)
        if mode == "minmax":
            q5_sig, q95_sig = np.percentile(signal, [1, 99])
            m5_sig = float(np.median(signal[signal < q5_sig]))
            m95_sig = float(np.median(signal[signal > q95_sig]))
            # nrm = (x - mid_sig)/half_sig * half_mod + mid_mod
            half_sig = (m95_sig - m5_sig) / 2.0
            mid_sig = m5_sig + half_sig
            half_mod = (self._m95_mod - self._m5_mod) / 2.0
            mid_mod = self._m5_mod + half_mod
            scale = half_mod / half_sig
            offset = mid_mod - mid_sig * scale
        elif mode == "entropy":
            mask = self._entropy_mask(signal)
            raw_median = float(np.median(signal[mask]))
            raw_mad = mean_abs_dev(signal[mask])
            scale = self.model_MAD / raw_mad
            offset = self.model_median - raw_median * scale
        else:  # median
            raw_median = float(np.median(signal))
            raw_mad = mean_abs_dev(signal)
            scale = self.model_MAD / raw_mad
            offset = self.model_median - raw_median * scale
        if clip:
            return AffineNorm(scale, offset, self.model_min + 0.5, self.model_max - 0.5)
        return AffineNorm(scale, offset)

    def normalize2model(self, signal: np.ndarray, clip: bool = True, mode: str = "median") -> np.ndarray:
        return self.norm_params(signal, clip=clip, mode=mode)(np.asarray(signal, dtype=np.float64))

    def _entropy_mask(self, signal: np.ndarray, window: int = 500, top_k: int = 50, dilate: int = 750) -> np.ndarray:
        """Change-point mask used by entropy normalization (reference STRique.py:161-168)."""
        from scipy.ndimage import grey_dilation

        n = len(signal)
        # sliding windows with 'mirror' edge extension (reference __sliding_window__:129-140)
        ext = np.concatenate([signal, signal[-1:-window:-1]])
        shape = (n, window)
        strides = (ext.strides[-1], ext.strides[-1])
        win = np.lib.stride_tricks.as_strided(ext, shape=shape, strides=strides)
        med = np.median(win, axis=1, keepdims=True)
        sliding_std = np.mean(np.absolute(win - med), axis=1)
        sliding_std = np.append(sliding_std, sliding_std[-1])
        diff_signal = np.abs(np.diff(sliding_std))
        ind = np.argpartition(diff_signal, -top_k)[-top_k:]
        diff_mask = np.zeros(len(diff_signal), dtype=np.uint8)
        diff_mask[ind] = 1
        diff_mask = grey_dilation(diff_mask, footprint=np.ones((dilate,), dtype=bool))
        return diff_mask.astype(bool)[:n]

    # -- synthesis ---------------------------------------------------------
    def kmer_levels(self, sequence: str) -> tuple[np.ndarray, np.ndarray]:
        """Per-kmer (means, stdvs) for a base sequence."""
        k = self.kmer
        kmers = [sequence[i : i + k] for i in range(len(sequence) - k + 1)]
        means = np.array([self.model_dict[km][0] for km in kmers], dtype=np.float64)
        stdvs = np.array([self.model_dict[km][1] for km in kmers], dtype=np.float64)
        return means, stdvs

    def generate_signal(self, sequence: str, samples: int | None = 10, noise: bool = False,
                        rng: np.random.Generator | None = None) -> np.ndarray:
        """Synthesize an idealized signal for a base sequence (reference STRique.py:182-195).

        ``samples`` fixed repeats per k-mer, or uniform 6..10 when falsy;
        ``noise`` adds per-sample Gaussian noise at the model stdv.
        """
        means, stdvs = self.kmer_levels(sequence)
        if rng is None:
            rng = np.random.default_rng()
        if samples and not noise:
            sig = np.repeat(means, samples)
        elif not noise:
            reps = rng.uniform(6, 10, len(means)).astype(int)
            sig = np.repeat(means, reps)
        else:
            reps = rng.uniform(6, 10, len(means)).astype(int)
            sig = rng.normal(np.repeat(means, reps), np.repeat(stdvs, reps))
        return sig
