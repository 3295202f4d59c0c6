"""Crossing from the JAX package's staged arrays to the port's tensors.

Parity tests build one model with the reference package and hand the
SAME arrays to both packages through these functions, so a difference
in output is a difference in the kernels, not in the staging.  Inputs
are plain NumPy-convertible arrays (``np.asarray`` of a JAX array
works) and duck-typed reference objects; nothing here imports JAX or
the JAX package.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.align import restart_state
from .ops.reference import AlignParams
from .ops.viterbi_cuda import PaddedHMM

_ALIGN_FIELDS = ("dist_offset", "dist_min", "gap_open_h", "gap_open_v",
                 "gap_extension_h", "gap_extension_v")


def align_params_from_jax(params) -> AlignParams:
    """The reference's ``AlignParams`` (or any object with its six fields)
    -> the port's ``AlignParams``."""
    try:
        return AlignParams(**{k: float(getattr(params, k)) for k in _ALIGN_FIELDS})
    except AttributeError as e:
        raise TypeError(f"expected an AlignParams-like object, got {type(params)}") from e


def padded_hmm_from_jax(ph, device="cpu") -> PaddedHMM:
    """The reference ``viterbi_pallas.PaddedHMM`` -> the port's PaddedHMM."""
    fweights = None
    if ph.fspec is not None:
        fweights = tuple(np.asarray(w, np.float32).reshape(-1) for w in ph.fweights)
    return PaddedHMM.from_arrays(
        ph.n_states, np.asarray(ph.trans, np.float32),
        np.asarray(ph.start, np.float32), np.asarray(ph.end, np.float32),
        np.asarray(ph.mu, np.float32), np.asarray(ph.sigma, np.float32),
        np.asarray(ph.uni, np.int32), np.asarray(ph.luni, np.float32),
        ph.fspec, fweights, device=device)


def align_inputs_from_jax(template_rows, m_rows, params, device="cpu"):
    """Padded template rows (R, MP), lengths (R,) and AlignParams -> port inputs.

    Returns (template tensor f32, m tensor int32, the port's AlignParams).
    """
    tmpl = torch.from_numpy(np.array(template_rows, np.float32)).to(device)
    m = torch.from_numpy(np.array(m_rows, np.int32).reshape(-1)).to(device)
    return tmpl, m, align_params_from_jax(params)


def longread_state_from_jax(ckpts, slot, cold, device="cpu"):
    """The reference's pass-1 checkpoint planes -> the port's window state.

    ``ckpts``: the four (n_ck, B, MP) planes (S1, S2, Ih, C) of
    ``align_pallas.align_forward_ckpt``; ``slot`` (B,) the slot each row
    resumes from; ``cold`` (B,) 1 where a row restarts at the signal
    origin (its slot is ignored and it gets cold-start values).
    Returns the 4-tuple of (B, MP) f32 tensors ``align_window_from_state``
    takes, gathered as the reference's ``_longread_pass2`` gathers them.
    """
    planes = tuple(torch.from_numpy(np.array(c, np.float32)).to(device) for c in ckpts)
    slot_t = torch.from_numpy(np.array(slot, np.int64).reshape(-1)).to(device)
    cold_t = torch.from_numpy(np.array(cold, np.int32).reshape(-1)).to(device)
    return restart_state(planes, slot_t, cold_t)
