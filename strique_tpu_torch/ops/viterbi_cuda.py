"""Max-plus Viterbi, factored and dense: CUDA kernels + plain twins.

Counterpart of ``strique_tpu/ops/viterbi_pallas.py`` on the split path:

  * ``viterbi_forward_factored`` -- ``_fwd_factored_kernel``: the
    forward over (B, SP) rows with transitions applied as lane-rolled
    diagonals plus delete-chain flows ``cummax(inj - ramp) + ramp``,
    Gaussian/uniform emissions, a per-step row-max rescale and its
    running sum ``acc``.  Kernel ``csrc/viterbi_fwd.cu``.
  * ``viterbi_forward_dense`` -- ``_fwd_kernel_multi``: the same forward
    with ``max_u(st[u] + trans[u, v])`` over the full SP x SP matrix,
    for HMMs without a factored form (``hmm/factor.py`` declines) or
    under ``STRIQUE_DENSE_VITERBI=1``.  Kernel ``csrc/viterbi_dense.cu``.
  * ``viterbi_backward_batch`` -- ``_bwd_batch_kernel``: the backward
    walk that recomputes each visited backpointer,
    ``bp[t] = min{u : sc[t-1, u] + trans[u, path[t]] == max}``, frozen
    past each read's length.  Kernel ``csrc/viterbi_bwd.cu``.

Each kernel's plain PyTorch twin (``_fwd_plain``, ``_fwd_dense_plain``,
``_bwd_plain``) runs for CPU tensors only.  Layouts are the reference's:
score rows time-major (T, B, SP), paths (B, T) int32.  Rows and path entries past
a read's length follow the reference where it defines them (the path
repeats the last state); score rows past a read's length are not
written by the kernel and are never read.

Emission: ``lsig - 0.5*z*z`` with ``z = (x - mu) / sigma`` (IEEE
division) and ``lsig = -log(2*pi)/2 - log(sigma)`` computed once on the
host in float64 and rounded to f32, so no decision hinges on a device
``logf``.  The reference computes lsig with XLA's f32 log, which
differs from the rounded float64 value by one ulp on some sigmas; paths
are exact regardless and scores agree to f32 rounding (tests state the
tolerance).

``PaddedHMM`` stages the factored form unless the HMM has none or
``STRIQUE_DENSE_VITERBI=1`` at its construction (as the reference's
does); ``viterbi_batch`` takes the dense forward when it has none.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from .. import _build
from .viterbi import stage_factored

NEG = -1e30
LANE = 128
CHUNK_T = 512
GROUP = 64  # reads per forward/backward call
_LOG2PI = float(np.log(2.0 * np.pi))


def _round_up(x, m):
    return (x + m - 1) // m * m


def lsig_row(sigma: np.ndarray) -> np.ndarray:
    """-log(2*pi)/2 - log(sigma), in float64 rounded to float32."""
    return (-0.5 * _LOG2PI - np.log(np.asarray(sigma, np.float64))).astype(np.float32)


def _encode_spec(spec, sp: int) -> np.ndarray:
    """Factored spec -> flat int32 program for the kernel:
    [n_diag, diag_offs.., n_chain, (n_entry, entry_offs.., n_exit, exit_offs..)*],
    offsets reduced mod SP."""
    diag_offs, chain_spec = spec
    out = [len(diag_offs), *[o % sp for o in diag_offs], len(chain_spec)]
    for entry_offs, exit_offs in chain_spec:
        out += [len(entry_offs), *[o % sp for o in entry_offs]]
        out += [len(exit_offs), *[o % sp for o in exit_offs]]
    return np.asarray(out, np.int32)


class PaddedHMM:
    """Lane-padded tensors of a CompiledHMM (SP a multiple of 128) on one device.

    ``fspec``/``fweights`` hold the factored form, or None: when the HMM
    has none, or when ``STRIQUE_DENSE_VITERBI=1`` at construction (read
    here, as the reference reads it), so decodes take the dense forward.
    """

    def __init__(self, chm, device="cpu"):
        S = chm.n_states
        sp = _round_up(max(S, LANE), LANE)
        trans = np.full((sp, sp), NEG, np.float32)
        trans[:S, :S] = np.maximum(chm.log_trans, NEG).astype(np.float32)
        start = np.full(sp, NEG, np.float32)
        start[:S] = np.maximum(chm.log_start, NEG)
        end = np.full(sp, NEG, np.float32)
        end[:S] = np.maximum(chm.log_end, NEG)
        mu = np.zeros(sp, np.float32)
        mu[:S] = chm.mu
        sigma = np.ones(sp, np.float32)
        sigma[:S] = chm.sigma
        uni = np.zeros(sp, np.int32)
        uni[:S] = chm.is_uniform
        luni = np.zeros(sp, np.float32)
        luni[:S] = chm.log_uni
        fspec = fweights = None
        if (getattr(chm, "factored", None) is not None
                and os.environ.get("STRIQUE_DENSE_VITERBI") != "1"):
            fspec, fweights = stage_factored(chm.factored, sp)
        self._init(S, trans, start, end, mu, sigma, uni, luni, fspec, fweights, device)

    @classmethod
    def from_arrays(cls, n_states, trans, start, end, mu, sigma, uni, luni,
                    fspec, fweights, device="cpu"):
        """Build from already padded host arrays (see convert.py)."""
        ph = cls.__new__(cls)
        ph._init(n_states, trans, start, end, mu, sigma, uni, luni, fspec, fweights, device)
        return ph

    def _init(self, n_states, trans, start, end, mu, sigma, uni, luni, fspec,
              fweights, device):
        dev = torch.device(device)
        trans = np.asarray(trans, np.float32)
        sp = trans.shape[0]
        if sp % LANE:
            raise ValueError(f"padded state count must be a multiple of {LANE}, got {sp}")

        def t(x, dtype=np.float32):
            return torch.from_numpy(np.array(x, dtype).reshape(-1)).to(dev)

        self.sp = sp
        self.n_states = int(n_states)
        self.trans = torch.from_numpy(trans.copy()).to(dev)
        self.transT = torch.from_numpy(np.ascontiguousarray(trans.T)).to(dev)
        self.start = t(start)
        self.end = t(end)
        self.mu = t(mu)
        self.sigma = t(sigma)
        self.uni = t(uni, np.int32)
        self.luni = t(luni)
        self.lsig = t(lsig_row(np.asarray(sigma, np.float32).reshape(-1)))
        self.fspec = fspec
        self.fweights = None
        self.spec_prog = None
        if fspec is not None:
            w = np.stack([np.asarray(x, np.float32).reshape(sp) for x in fweights])
            self.fweights = torch.from_numpy(w).to(dev)
            self.spec_prog = torch.from_numpy(_encode_spec(fspec, sp)).to(dev)


def _transition_plain(spec, weights, st):
    """out[v] = max_u st[u] + log_trans[u, v] under the factored form."""
    diag_offs, chain_spec = spec
    it = iter(weights)
    out = torch.full_like(st, NEG)
    for o in diag_offs:
        out = torch.maximum(out, torch.roll(st + next(it), o, dims=1))
    for entry_offs, exit_offs in chain_spec:
        inj = torch.full_like(st, NEG)
        for o in entry_offs:
            inj = torch.maximum(inj, torch.roll(st + next(it), o, dims=1))
        ramp = next(it)
        h = torch.cummax(inj - ramp, dim=1).values + ramp
        for o in exit_offs:
            out = torch.maximum(out, torch.roll(h + next(it), o, dims=1))
    return out


def _fwd_plain(obs, t_actual, ph):
    B, T = obs.shape
    sp = ph.sp
    dev = obs.device
    tact = t_actual.to(torch.int64).clamp_max(T)
    st = torch.zeros((B, sp), device=dev)
    fin = torch.zeros((B, sp), device=dev)
    acc = torch.zeros((B,), device=dev)
    sc = torch.zeros((T, B, sp), device=dev)
    weights = list(ph.fweights)
    for t in range(int(tact.max())):
        z = (obs[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            val = ph.start + emit
        else:
            val = _transition_plain(ph.fspec, weights, st) + emit
        m = val.max(dim=1, keepdim=True).values
        stn = val - m
        live = t < tact
        st = torch.where(live[:, None], stn, st)
        acc = acc + torch.where(live, m[:, 0], 0.0)
        fin = torch.where((tact - 1 == t)[:, None], stn, fin)
        sc[t] = st
    return sc, fin, acc


def _fwd_cuda(obs, t_actual, ph):
    B, T = obs.shape
    sp = ph.sp
    dev = obs.device
    o = obs.contiguous()
    tact = t_actual.to(torch.int32).contiguous()
    sc = torch.empty((T, B, sp), dtype=torch.float32, device=dev)
    fin = torch.empty((B, sp), dtype=torch.float32, device=dev)
    acc = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        "viterbi_fwd_launch", dev,
        o.data_ptr(), tact.data_ptr(), ph.start.data_ptr(), ph.mu.data_ptr(),
        ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(),
        ph.lsig.data_ptr(), ph.fweights.data_ptr(), ph.spec_prog.data_ptr(),
        sc.data_ptr(), fin.data_ptr(), acc.data_ptr(),
        B, T, sp, ph.fweights.shape[0], ph.spec_prog.shape[0])
    _build.LAUNCHES["viterbi_forward_factored"] += 1
    return sc, fin, acc


def viterbi_forward_factored(obs, t_actual, ph: PaddedHMM):
    """Factored forward of a (B, T) batch.

    Returns (sc (T, B, SP) f32 rescaled score rows, fin (B, SP) the row
    at t_actual-1, acc (B,) the summed rescale shifts).
    """
    if ph.fspec is None:
        raise ValueError("HMM has no factored form: decode it with viterbi_forward_dense")
    _check_obs(obs, t_actual, ph)
    if obs.device.type == "cuda":
        return _fwd_cuda(obs, t_actual, ph)
    return _fwd_plain(obs, t_actual, ph)


def _check_obs(obs, t_actual, ph):
    if obs.dtype != torch.float32 or obs.dim() != 2 or obs.device != ph.trans.device:
        raise ValueError("obs must be a (B, T) float32 tensor on the HMM's device")
    if t_actual.shape != obs.shape[:1] or t_actual.device != obs.device:
        raise ValueError("t_actual must be (B,) on the obs device")
    if obs.device.type not in ("cuda", "cpu"):
        raise ValueError(f"Viterbi runs on cuda or cpu tensors, got {obs.device}")


def _fwd_dense_plain(obs, t_actual, ph):
    """Plain twin of the dense forward: the reference's step, every read
    together.  Rows past a read's length are not frozen (the reference
    does not freeze them either); they are never read."""
    B, T = obs.shape
    sp = ph.sp
    dev = obs.device
    tact = t_actual.to(torch.int64).clamp_max(T)
    st = torch.zeros((B, sp), device=dev)
    fin = torch.zeros((B, sp), device=dev)
    acc = torch.zeros((B,), device=dev)
    sc = torch.zeros((T, B, sp), device=dev)
    for t in range(int(tact.max())):
        z = (obs[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            val = ph.start + emit
        else:
            val = (st[:, :, None] + ph.trans[None]).amax(dim=1) + emit
        m = val.max(dim=1, keepdim=True).values
        st = val - m
        acc = acc + torch.where(t < tact, m[:, 0], 0.0)
        fin = torch.where((tact - 1 == t)[:, None], st, fin)
        sc[t] = st
    return sc, fin, acc


def _fwd_dense_cuda(obs, t_actual, ph):
    B, T = obs.shape
    sp = ph.sp
    dev = obs.device
    o = obs.contiguous()
    tact = t_actual.to(torch.int32).contiguous()
    sc = torch.empty((T, B, sp), dtype=torch.float32, device=dev)
    fin = torch.empty((B, sp), dtype=torch.float32, device=dev)
    acc = torch.empty((B,), dtype=torch.float32, device=dev)
    _build.launch(
        "viterbi_dense_launch", dev,
        o.data_ptr(), tact.data_ptr(), ph.trans.data_ptr(), ph.start.data_ptr(),
        ph.mu.data_ptr(), ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(),
        ph.lsig.data_ptr(), sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, sp)
    _build.LAUNCHES["viterbi_forward_dense"] += 1
    return sc, fin, acc


def viterbi_forward_dense(obs, t_actual, ph: PaddedHMM):
    """Dense forward of a (B, T) batch over the full SP x SP transitions.

    Counterpart of the reference's ``viterbi_forward_pallas_multi``, with
    the rows written time-major so ``viterbi_backward_batch`` reads them
    directly.  Returns (sc (T, B, SP) f32 rescaled score rows, fin (B, SP)
    the row at t_actual-1, acc (B,) the summed rescale shifts).  Rows at
    t >= t_actual are left unwritten on the card; nothing reads them.
    """
    _check_obs(obs, t_actual, ph)
    if obs.device.type == "cuda":
        return _fwd_dense_cuda(obs, t_actual, ph)
    return _fwd_dense_plain(obs, t_actual, ph)


def _bwd_plain(sc, last, t_actual, transT):
    T, B, sp = sc.shape
    dev = sc.device
    tact = t_actual.to(torch.int64).clamp_max(T)
    st = last.to(torch.int64).clone()
    lane = torch.arange(sp, device=dev)
    path = torch.empty((B, T), dtype=torch.int64, device=dev)
    mt = int(tact.max())
    path[:, mt:] = st[:, None]
    for t in range(mt - 1, -1, -1):
        path[:, t] = st
        if t == 0:
            break
        cand = sc[t - 1] + transT[st]
        mx = cand.max(dim=1, keepdim=True).values
        bp = torch.where(cand >= mx, lane, sp).min(dim=1).values
        st = torch.where(t < tact, bp, st)
    return path.to(torch.int32)


def _bwd_cuda(sc, last, t_actual, transT):
    T, B, sp = sc.shape
    dev = sc.device
    s = sc.contiguous()
    tt = transT.contiguous()
    la = last.to(torch.int32).contiguous()
    ta = t_actual.to(torch.int32).contiguous()
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    _build.launch(
        "viterbi_bwd_launch", dev,
        s.data_ptr(), tt.data_ptr(), la.data_ptr(), ta.data_ptr(), path.data_ptr(), B, T, sp)
    _build.LAUNCHES["viterbi_backward_batch"] += 1
    return path


def viterbi_backward_batch(sc, last, t_actual, transT):
    """Paths (B, T) int32 from time-major score rows (T, B, SP).

    path[t] = last for t >= t_actual - 1; below, each step takes the
    first state u maximising sc[t-1, u] + trans[u, path[t]].
    """
    T, B, sp = sc.shape
    if (sc.dtype != torch.float32 or transT.shape != (sp, sp) or last.shape != (B,)
            or t_actual.shape != (B,)):
        raise ValueError("sc (T, B, SP) f32, transT (SP, SP), last and t_actual (B,)")
    if any(x.device != sc.device for x in (transT, last, t_actual)):
        raise ValueError("all backward inputs must share one device")
    if sc.device.type == "cuda":
        return _bwd_cuda(sc, last, t_actual, transT)
    if sc.device.type == "cpu":
        return _bwd_plain(sc, last, t_actual, transT)
    raise ValueError(f"Viterbi runs on cuda or cpu tensors, got {sc.device}")


def _pad_batch(obs, t_actual):
    bpad = (-obs.shape[0]) % 8
    if not bpad:
        return obs, t_actual
    obs = torch.cat([obs, torch.zeros((bpad, obs.shape[1]), dtype=obs.dtype, device=obs.device)])
    t_actual = torch.cat([t_actual, torch.ones(bpad, dtype=t_actual.dtype, device=t_actual.device)])
    return obs, t_actual


def viterbi_batch(obs, t_actual, ph: PaddedHMM):
    """Decode a (B, T) batch: returns (logp (B,) f32, path (B, T) int32).

    Runs in GROUP-read calls; each call pads its rows to a multiple of
    8 with length-1 dummies.  logp = (fin + end)[last] + acc with
    last = argmax(fin + end), first maximum.  The forward is the
    factored one, or the dense one when ``ph`` has no factored form.
    """
    B = obs.shape[0]
    if B > GROUP:
        outs = [viterbi_batch(obs[g : g + GROUP], t_actual[g : g + GROUP], ph)
                for g in range(0, B, GROUP)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    obs_p, tact_p = _pad_batch(obs.to(torch.float32), t_actual.to(torch.int32))
    forward = viterbi_forward_dense if ph.fspec is None else viterbi_forward_factored
    sc, fin, acc = forward(obs_p, tact_p, ph)
    final = fin + ph.end
    last = torch.argmax(final, dim=1)
    logp = final.gather(1, last[:, None])[:, 0] + acc
    path = viterbi_backward_batch(sc, last, tact_p, ph.transT)
    return logp[:B], path[:B]
