"""Max-plus Viterbi over the dense HMM, and the host decode of a path.

The forward keeps one score row per read, rescaled by its maximum at
every step:

    val[v] = max_u (st[u] + trans[u, v]) + emit(x_t, v)     (t > 0)
    val[v] = start[v] + emit(x_0, v)                        (t = 0)
    st     = val - max_v val

with emit = log_uni for a uniform state and -log(2 pi)/2 - log(sigma) -
z^2 / 2, z = (x - mu) / sigma, for a normal one; the transitions, start
and end are the float64 log-probabilities rounded to the float type
(-inf to -1e30).  The path ends at the first state maximising
``st + end`` and each step back takes the first state maximising
``st[t-1, u] + trans[u, path[t]]``.  Plain PyTorch in the float type
given; on a card the steps run as replays of one CUDA graph.

The count is the dummy-state visits of the path minus the repeat unit's
offset plus the flanking count; log_p is the path's log-probability
recomputed in float64 on the host (reference scripts/STRique.py:
675-679).  A mod HMM's path gives the methylation pattern, one character
a repeat unit (reference :492-500).
"""
from __future__ import annotations

import numpy as np
import torch

from .align import _replay

NEG = -1e30
_LOG2PI = float(np.log(2.0 * np.pi))
BLOCK = 16


def _tables(chm, dtype, dev) -> dict:
    f32 = lambda x: torch.from_numpy(np.maximum(np.asarray(x, np.float64), NEG)
                                     .astype(np.float32)).to(dev).to(dtype)
    lsig = (-0.5 * _LOG2PI - np.log(chm.sigma.astype(np.float32).astype(np.float64)))
    return {
        "trans": f32(chm.log_trans), "start": f32(chm.log_start), "end": f32(chm.log_end),
        "mu": f32(chm.mu), "sigma": f32(chm.sigma), "luni": f32(chm.log_uni),
        "lsig": f32(lsig), "uni": torch.from_numpy(chm.is_uniform).to(dev),
    }


def decode(segments, chm, device, dtype=torch.float32) -> list:
    """Viterbi paths (int64 arrays, one per segment) of f32 ``segments``."""
    dev = torch.device(device)
    tb = _tables(chm, dtype, dev)
    B = len(segments)
    S = chm.n_states
    lens = np.array([len(s) for s in segments], np.int64)
    T = int(lens.max())
    obs_h = np.zeros((B, T + BLOCK), np.float32)
    for b, s in enumerate(segments):
        obs_h[b, : len(s)] = s
    obs = torch.from_numpy(obs_h).to(dev)
    tact = torch.from_numpy(lens).to(dev)
    steps = 1 + -(-(T - 1) // BLOCK) * BLOCK
    bp = torch.zeros((steps, B, S), dtype=torch.int16, device=dev)
    fin = torch.zeros((B, S), dtype=dtype, device=dev)
    trans = tb["trans"][None]

    def emit(x):  # x (B, k) -> (B, k, S)
        z = (x[:, :, None] - tb["mu"]) / tb["sigma"]
        return torch.where(tb["uni"], tb["luni"], tb["lsig"] - 0.5 * z * z)

    val = tb["start"] + emit(obs[:, :1])[:, 0]
    st = val - val.max(dim=1, keepdim=True).values
    fin.copy_(torch.where((tact == 1)[:, None], st, fin))
    t0 = torch.ones((), dtype=torch.int64, device=dev)
    ar = torch.arange(BLOCK, device=dev)

    def block():
        pos = t0 + ar
        em = emit(obs.index_select(1, pos))
        a = st
        arg_rows = []
        f = fin
        for j in range(BLOCK):
            mx, arg = (a[:, :, None] + trans).max(dim=1)
            val = mx + em[:, j]
            stn = val - val.max(dim=1, keepdim=True).values
            t = t0 + j
            a = torch.where((t < tact)[:, None], stn, a)
            f = torch.where((tact - 1 == t)[:, None], stn, f)
            arg_rows.append(arg.to(torch.int16))
        bp.index_copy_(0, pos, torch.stack(arg_rows))
        st.copy_(a)
        fin.copy_(f)
        t0.add_(BLOCK)

    _replay(block, (steps - 1) // BLOCK, dev)
    last = torch.argmax(fin + tb["end"], dim=1).cpu().numpy()
    bp_h = bp.cpu().numpy()
    paths = []
    for b in range(B):
        n = int(lens[b])
        path = np.empty(n, np.int64)
        path[n - 1] = last[b]
        for t in range(n - 1, 0, -1):
            path[t - 1] = bp_h[t, b, path[t]]
        paths.append(path)
    return paths


def count_repeats(path: np.ndarray, chm) -> int:
    visits = int(chm.meta["count_states"][path].sum())
    return visits - chm.meta["repeat_offset"] + chm.meta["flanking_count"]


def path_logp(obs: np.ndarray, path: np.ndarray, chm) -> float:
    """Log-probability of a path, in float64."""
    obs = np.asarray(obs, dtype=np.float64)
    mu = chm.mu[path]
    sigma = chm.sigma[path]
    norm = -0.5 * np.log(2 * np.pi * sigma**2) - 0.5 * ((obs - mu) / sigma) ** 2
    emit = np.where(chm.is_uniform[path], chm.log_uni[path], norm)
    lp = chm.log_start[path[0]] + emit.sum() + chm.log_end[path[-1]]
    lp += chm.log_trans[path[:-1], path[1:]].sum()
    return float(lp)


def mod_pattern(path: np.ndarray, chm) -> str:
    """One character a repeat unit of a mod HMM's path, a unit being a run
    of states between the anchors: '1' where its first state is on the
    mod profile, '0' where on the base one."""
    anchor = chm.meta["anchor_states"][path]
    starts = ~anchor & np.concatenate(([True], anchor[:-1]))
    return "".join(np.where(chm.meta["mod_states"][path][starts], "1", "0"))
