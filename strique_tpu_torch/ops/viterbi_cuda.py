"""Max-plus Viterbi, factored and dense: CUDA kernels + plain twins.

Counterpart of ``strique_tpu/ops/viterbi_pallas.py`` on the split path:

  * ``viterbi_forward_factored`` -- ``_fwd_factored_kernel``: the
    forward over (B, SP) rows with transitions applied as lane-rolled
    diagonals plus delete-chain flows ``cummax(inj - ramp) + ramp``,
    Gaussian/uniform emissions, a per-step row-max rescale and its
    running sum ``acc``.  Kernel ``csrc/viterbi_fwd.cu``, fed per-thread
    gather tables (``fwd_gather_tables``) in one of two slot layouts
    (``FWD_LAYOUTS``): CHAINED, at most ``FWD_MAX_DIAG`` diagonals and
    ``FWD_MAX_CHAIN`` chains of ``FWD_MAX_ENTRY`` entries and
    ``FWD_MAX_EXIT`` exits, the shape of every flanked-repeat HMM
    (launch counter ``viterbi_forward_factored``); DIAG_ONLY, at most
    ``FWD_DIAG_ONLY`` diagonals and no chain, the shape of every mod HMM
    (``viterbi_forward_factored_diag``).  Up to ``NARROW_MAX_SP`` padded
    states one CTA a read holds them, on :func:`fwd_warps` warps of
    consecutive states a lane (a rule on SP and layout; a traced launch
    counts ``viterbi.fwd.w<W>``); past it, up to
    ``MAX_SP``, the cluster form spreads a read over a thread-block
    cluster of :func:`fwd_cluster_ctas` CTAs (a rule on SP, the call's
    reads and the clusters the card runs at once), one state a thread
    (launch counters ``viterbi_forward_factored_cluster`` and
    ``viterbi_forward_factored_diag_cluster``).
  * ``viterbi_forward_dense`` -- ``_fwd_kernel_multi``: the same forward
    with ``max_u(st[u] + trans[u, v])`` over the full SP x SP matrix,
    for HMMs without a factored form (``hmm/factor.py`` declines) or
    under ``STRIQUE_DENSE_VITERBI=1``.  Kernel ``csrc/viterbi_dense.cu``
    in one of three modes, picked by :func:`dense_mode` from SP alone,
    each a thread-block cluster of K CTAs a read passing each step's row
    by st.async: RESIDENT (SP <= 512; launch counter
    ``viterbi_forward_dense_resident``), the transitions in registers;
    SLICE (``viterbi_forward_dense_slice``), each CTA's column slice of
    them in shared memory; STREAMED (``viterbi_forward_dense_stream``),
    each CTA reading its slice from L2.
  * ``viterbi_backward_batch`` -- ``_bwd_batch_kernel``: the backward
    walk that recomputes each visited backpointer,
    ``bp[t] = min{u : sc[t-1, u] + trans[u, path[t]] == max}``, frozen
    past each read's length.  Kernel ``csrc/viterbi_bwd.cu``, one warp a
    read with its score rows prefetched into a shared ring up to
    ``NARROW_MAX_SP``; past it, up to ``MAX_SP``, the wide variant walks
    with one CTA a read of ``BWD_WIDE_SPT`` states a thread, the transT
    row reloaded only when the state moves, and a keyed cross-warp
    first-max a step (launch counter ``viterbi_backward_wide``).

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

``PaddedHMM`` stages the factored form unless the HMM has none, its
form fits neither slot layout of the forward kernel (``fwd_spec_fits``), or
``STRIQUE_DENSE_VITERBI=1`` at its construction (as the reference's
does); ``viterbi_batch`` takes the dense forward when it has none.

On the card every Viterbi kernel stops at ``MAX_SP`` padded states
(the dense forward's cap too): ``check_card_sp`` refuses a wider HMM
where it is staged (``PaddedHMM``, and the counter's ``add_target``),
before any launch.  The plain twins on the CPU take any SP, as the
reference does.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple

import numpy as np
import torch

from .. import _build
from ..utils import trace
from .viterbi import stage_factored

NEG = -1e30
LANE = 128
CHUNK_T = 512
GROUP = 64  # reads per forward/backward call
NARROW_MAX_SP = 1024  # the widest SP of the narrow forward and backward kernels
MAX_SP = 8192  # the widest SP of every Viterbi kernel past the narrow ones, the dense forward's too
_LOG2PI = float(np.log(2.0 * np.pi))


def _round_up(x, m):
    return (x + m - 1) // m * m


def padded_sp(n_states: int) -> int:
    """The padded state count (lanes) of an HMM of ``n_states``."""
    return _round_up(max(int(n_states), LANE), LANE)


def check_card_sp(n_states: int, device) -> None:
    """Raise ValueError when an HMM of ``n_states`` is too wide for the
    card's Viterbi kernels (``MAX_SP`` padded states) and ``device`` is
    a card; the CPU's plain twins take any width."""
    sp = padded_sp(n_states)
    if torch.device(device).type == "cuda" and sp > MAX_SP:
        raise ValueError(
            f"an HMM of {n_states} states pads to {sp} lanes, past the {MAX_SP} padded "
            f"states the card's Viterbi kernels take (the reference's chip path stops "
            f"earlier: its backward stages the (SP, SP) transitions in VMEM, "
            f"strique_tpu/ops/viterbi_pallas.py:318); device='cpu' decodes at any width")


def lsig_row(sigma: np.ndarray) -> np.ndarray:
    """-log(2*pi)/2 - log(sigma), in float64 rounded to float32."""
    return (-0.5 * _LOG2PI - np.log(np.asarray(sigma, np.float64))).astype(np.float32)


# slot layouts of the factored forward kernel (csrc/viterbi_fwd.cu): each
# thread holds one source lane and weight per slot in registers, and
# applies every slot at every step; these are the limits of a spec each
# layout takes.  Every flanked-repeat HMM factors into 6 or 7 diagonals
# and 2 chains of 2 entries and 3 and 2 exits (CHAINED); every mod HMM
# into 11 diagonals and no chain (DIAG_ONLY).
FWD_MAX_DIAG = 8
FWD_MAX_CHAIN = 2
FWD_MAX_ENTRY = 2
FWD_MAX_EXIT = 3
FWD_CHAIN_SLOTS = FWD_MAX_ENTRY + FWD_MAX_EXIT
FWD_SLOTS = FWD_MAX_DIAG + FWD_MAX_CHAIN * FWD_CHAIN_SLOTS
FWD_DIAG_ONLY = 12


class FwdLayout(NamedTuple):
    """A slot layout of the factored forward kernel: ``code`` is the
    kernel's template argument, ``name`` its launch counter."""

    code: int
    name: str
    diag: int
    chain: int

    @property
    def slots(self) -> int:
        return self.diag + self.chain * FWD_CHAIN_SLOTS

    @property
    def cluster_name(self) -> str:
        """The launch counter of the layout's cluster form (SP past
        ``NARROW_MAX_SP``)."""
        return self.name + "_cluster"


FWD_LAYOUTS = (FwdLayout(0, "viterbi_forward_factored", FWD_MAX_DIAG, FWD_MAX_CHAIN),
               FwdLayout(1, "viterbi_forward_factored_diag", FWD_DIAG_ONLY, 0))
# the narrow forward (SP up to NARROW_MAX_SP) runs a read on W warps of S
# = SP / (32 W) consecutive states a lane, S a power of two: by layout
# code, S at SP / 128 = 1 ... 8 (csrc/viterbi_fwd.cu FWD_STATES, the same
# table), the fastest W of tools/probe_viterbi_narrow.py's sweep at 64
# reads on an H100.  FWD_MAX_STATES: the most a lane holds without a
# spill (the slot tables take 2 registers a slot and state; S = 8 spilled
# in both layouts)
FWD_STATES = {0: (1, 2, 4, 4, 4, 4, 4, 4), 1: (1, 2, 2, 4, 2, 2, 4, 4)}
FWD_MAX_STATES = 4
BWD_RING = 16  # score rows the backward kernel keeps in flight in shared memory
# the wide backward (SP past NARROW_MAX_SP): states a thread, one CTA of
# SP / BWD_WIDE_SPT threads a read (csrc/viterbi_bwd.cu WIDE_SPT)
BWD_WIDE_SPT = 8
# the dense forward's resident mode (csrc/viterbi_dense.cu): a cluster of
# at most DENSE_MAX_CLUSTER CTAs a read, each warp holding the transitions
# into its 128/16 or 64/16 destination columns in at most DENSE_MAX_REGS
# registers a lane
DENSE_MAX_CLUSTER = 8  # the portable cluster size
DENSE_MAX_REGS = 64
# past it, on DENSE_STREAM_CTAS CTAs (the kernel takes up to
# DENSE_MAX_CLUSTER): SLICE where their column slices fit DENSE_MAX_SHMEM
# bytes a CTA (an H100's 227 KB, less the static mbarriers), else STREAMED
DENSE_STREAM_CTAS = DENSE_MAX_CLUSTER
DENSE_MAX_SHMEM = 232448 - 64
# the factored forward's cluster form past NARROW_MAX_SP: at most
# FWD_MAX_CLUSTER CTAs a read (the portable cluster size)
FWD_MAX_CLUSTER = 8
# clusters of C CTAs (the key) an H100 runs at once with no two CTAs on
# one SM (fwd_cluster_capacity on an H100 80GB HBM3, every SP and layout
# alike): fwd_cluster_ctas's counts where no card is asked
H100_CLUSTERS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15}
_capacity_cache: dict = {}


def fwd_spec_fits(spec) -> FwdLayout | None:
    """The first slot layout of ``FWD_LAYOUTS`` a factored spec fits, or
    None: the forward kernel takes none such."""
    diag_offs, chain_spec = spec
    if not all(len(a) <= FWD_MAX_ENTRY and len(x) <= FWD_MAX_EXIT for a, x in chain_spec):
        return None
    for layout in FWD_LAYOUTS:
        if len(diag_offs) <= layout.diag and len(chain_spec) <= layout.chain:
            return layout
    return None


def fwd_gather_tables(spec, weights, sp: int):
    """Per-thread gather tables of the factored forward kernel.

    Every roll's source lane ``u = (v - o) mod SP`` and weight ``w[u]``
    are the same at every step, so the kernel's thread ``v`` loads them
    once into registers.  Slots of the layout ``fwd_spec_fits`` picks:
    its diagonals, then per chain ``FWD_MAX_ENTRY`` entries and
    ``FWD_MAX_EXIT`` exits; a slot the spec leaves empty gathers lane v
    with weight -inf, the identity of the max, so the kernel applies its
    slots without a branch.  Returns numpy (src (slots, SP) int32, w
    (slots, SP) f32, ramp (chains, SP) f32, counts int32 [n_diag,
    n_chain, (n_entry, n_exit) per chain of FWD_MAX_CHAIN]).  Raises
    ValueError for a spec that fits no layout: the kernel takes none.
    """
    diag_offs, chain_spec = spec
    layout = fwd_spec_fits(spec)
    if layout is None:
        raise ValueError(
            f"factored spec with {len(diag_offs)} diagonals and chains "
            f"{[(len(a), len(x)) for a, x in chain_spec]} exceeds the forward kernel's slots "
            f"({FWD_MAX_DIAG} diagonals, {FWD_MAX_CHAIN} chains of {FWD_MAX_ENTRY} entries "
            f"and {FWD_MAX_EXIT} exits; or {FWD_DIAG_ONLY} diagonals and no chain)")
    lane = np.arange(sp)
    src = np.tile(lane.astype(np.int32), (layout.slots, 1))
    w = np.full((layout.slots, sp), -np.inf, np.float32)
    ramp = np.zeros((layout.chain, sp), np.float32)
    counts = np.zeros(2 + 2 * FWD_MAX_CHAIN, np.int32)
    counts[:2] = len(diag_offs), len(chain_spec)
    it = iter(np.asarray(x, np.float32).reshape(sp) for x in weights)

    def put(slot, o):
        src[slot] = (lane - o) % sp
        w[slot] = next(it)[src[slot]]

    for d, o in enumerate(diag_offs):
        put(d, o)
    for c, (entry_offs, exit_offs) in enumerate(chain_spec):
        base = layout.diag + c * FWD_CHAIN_SLOTS
        for e, o in enumerate(entry_offs):
            put(base + e, o)
        ramp[c] = next(it)
        for e, o in enumerate(exit_offs):
            put(base + FWD_MAX_ENTRY + e, o)
        counts[2 + 2 * c : 4 + 2 * c] = len(entry_offs), len(exit_offs)
    return src, w, ramp, counts


class PaddedHMM:
    """Lane-padded tensors of a CompiledHMM (SP a multiple of 128) on one device.

    ``device`` defaults to the card and raises when there is none, as
    ``RepeatCounter`` does; pass "cpu" for the plain twins.
    ``fspec``/``fweights`` hold the factored form, or None: when the HMM
    has none, when it fits neither of the forward kernel's slot layouts
    (``fwd_spec_fits``; the factorizer takes up to 28 rolls), or when
    ``STRIQUE_DENSE_VITERBI=1`` at construction (read here, as the
    reference reads it), so decodes take the dense forward.
    ``fwd_layout`` is the layout the factored form is staged in (None
    without one).  On the card an HMM past ``MAX_SP`` padded states is
    refused (``check_card_sp``).
    """

    def __init__(self, chm, device="cuda"):
        S = chm.n_states
        check_card_sp(S, device)
        sp = padded_sp(S)
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
                    fspec, fweights, device="cuda"):
        """Build from already padded host arrays (see convert.py)."""
        ph = cls.__new__(cls)
        ph._init(n_states, trans, start, end, mu, sigma, uni, luni, fspec, fweights, device)
        return ph

    def _init(self, n_states, trans, start, end, mu, sigma, uni, luni, fspec,
              fweights, device):
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PaddedHMM(device='cuda') needs a CUDA device; "
                               "pass device='cpu' for the plain PyTorch path")
        trans = np.asarray(trans, np.float32)
        sp = trans.shape[0]
        if sp % LANE:
            raise ValueError(f"padded state count must be a multiple of {LANE}, got {sp}")
        check_card_sp(sp, dev)

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
        self.fwd_layout = None if fspec is None else fwd_spec_fits(fspec)
        if self.fwd_layout is None:
            fspec = None
        self.fspec = fspec
        self.fweights = None
        self._fwd_tables = None
        if fspec is not None:
            w = np.stack([np.asarray(x, np.float32).reshape(sp) for x in fweights])
            self.fweights = torch.from_numpy(w).to(dev)

    def fwd_tables(self):
        """The forward kernel's gather tables on this HMM's device (built
        at first use)."""
        if self._fwd_tables is None:
            src, w, ramp, counts = fwd_gather_tables(self.fspec, self.fweights.cpu().numpy(),
                                                     self.sp)
            dev = self.fweights.device
            self._fwd_tables = (torch.from_numpy(src).to(dev), torch.from_numpy(w).to(dev),
                                torch.from_numpy(ramp).to(dev),
                                (ctypes.c_int * len(counts))(*counts.tolist()))
        return self._fwd_tables


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


def fwd_warps(sp: int, layout: int = 0) -> int:
    """Warps a read of the narrow factored forward at SP padded states (a
    multiple of 128 up to ``NARROW_MAX_SP``) in slot layout code
    ``layout``: SP / (32 S) with S from ``FWD_STATES``, the fastest of
    every W the probe swept at 64 reads (S = 1, W = SP / 32, holds one
    state a lane, as the form it replaced did)."""
    return sp // 32 // FWD_STATES[layout][sp // LANE - 1]


def fwd_cluster_lanes(sp: int, ctas: int) -> int:
    """Lanes (threads) a CTA of the factored forward's cluster form: SP
    over ``ctas`` CTAs in whole warps (csrc/viterbi_fwd.cu
    ``cluster_lanes``)."""
    return _round_up(-(-sp // ctas), 32)


def fwd_cluster_capacity(device, sp: int, layout: int, ctas: int) -> int | None:
    """Clusters of ``ctas`` CTAs a read of the factored forward's cluster
    form at SP (slot layout code ``layout``) the card of ``device`` runs
    at once with no two CTAs on one SM: the SMs of a graphics processing
    cluster hold whole clusters only, so fewer than SMs / ``ctas`` may
    fit.  The kernel library's occupancy query, once a card and shape;
    None for a CPU device."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    key = (dev.index if dev.index is not None else torch.cuda.current_device(), sp, layout, ctas)
    if key not in _capacity_cache:
        with torch.cuda.device(dev):
            _capacity_cache[key] = int(_build.lib().viterbi_fwd_cluster_capacity(sp, layout, ctas))
    return _capacity_cache[key]


def fwd_cluster_ctas(sp: int, rows: int, device=None, layout: int = 0) -> int:
    """CTAs a read of the factored forward's cluster form at SP padded
    states (past ``NARROW_MAX_SP``, slot layout code ``layout``) for a
    call of ``rows`` reads: the most, up to ``FWD_MAX_CLUSTER``, whose
    ``rows`` clusters the card runs at once with no two CTAs on one SM,
    each CTA of at most 1024 lanes with a live one (lanes a CTA by
    ``fwd_cluster_lanes``); where no count fits, the fewest that hold the
    lanes.  A CUDA ``device`` is asked (:func:`fwd_cluster_capacity`);
    else the H100's counts, ``H100_CLUSTERS``.  A step is a latency chain
    that does not slow with fewer lanes a CTA down to 160 at SP 1152; a
    CTA that shares its SM slows its read's step, and a second wave of
    clusters doubles it (tools/probe_viterbi_wide.py on an H100, 8-64
    reads: 8 CTAs at 8 reads, 6 at 16, 4 at 24, 3 at 32, 2 at 48 and
    64)."""
    dev = torch.device(device) if device is not None else torch.device("cpu")
    valid = [c for c in range(1, FWD_MAX_CLUSTER + 1)
             if fwd_cluster_lanes(sp, c) <= 1024 and fwd_cluster_lanes(sp, c) * (c - 1) < sp]
    fit = [c for c in valid
           if rows <= (H100_CLUSTERS[c] if dev.type != "cuda"
                       else fwd_cluster_capacity(dev, sp, layout, c))]
    return max(fit) if fit else min(valid)


def _fwd_cuda(obs, t_actual, ph):
    B, T = obs.shape
    sp = ph.sp
    dev = obs.device
    o = obs.contiguous()
    tact = t_actual.to(torch.int32).contiguous()
    src, w, ramp, counts = ph.fwd_tables()
    sc = torch.empty((T, B, sp), dtype=torch.float32, device=dev)
    fin = torch.empty((B, sp), dtype=torch.float32, device=dev)
    acc = torch.empty((B,), dtype=torch.float32, device=dev)
    args = (o.data_ptr(), tact.data_ptr(), ph.start.data_ptr(), ph.mu.data_ptr(),
            ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(), ph.lsig.data_ptr(),
            src.data_ptr(), w.data_ptr(), ramp.data_ptr(), ctypes.addressof(counts),
            sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, sp, ph.fwd_layout.code)
    if sp > NARROW_MAX_SP:
        _build.launch("viterbi_fwd_cluster_launch", dev, *args,
                      fwd_cluster_ctas(sp, B, dev, ph.fwd_layout.code))
        _build.LAUNCHES[ph.fwd_layout.cluster_name] += 1
    else:
        _build.launch("viterbi_fwd_launch", dev, *args)
        _build.LAUNCHES[ph.fwd_layout.name] += 1
        trace.count(f"viterbi.fwd.w{fwd_warps(sp, ph.fwd_layout.code)}")
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


class DenseMode(NamedTuple):
    """A mode of the dense forward: ``kind`` "resident", "slice" or
    "stream", ``ctas`` the CTAs a read (its cluster size); ``name`` is
    its launch counter."""

    kind: str
    ctas: int

    @property
    def name(self) -> str:
        return "viterbi_forward_dense_" + self.kind


def dense_stream_shmem(sp: int, ctas: int, slice_: bool) -> int:
    """Shared bytes of a CTA of the dense forward's SLICE or STREAMED
    mode (csrc/viterbi_dense.cu ``stream_shmem``): two rows, their warp
    maxima, the thread groups' column maxes and, in SLICE, the CTA's
    SP x VC transitions."""
    vc = sp // ctas
    npp = _round_up(ctas * -(-vc // 32), 4)
    groups = (1024 if vc > 512 else 512) // (vc // 4)
    return 4 * (2 * sp + 2 * npp + groups * vc + (sp * vc if slice_ else 0))


def dense_mode(sp: int) -> DenseMode:
    """The dense forward's mode for SP padded states, a thread-block
    cluster of ``ctas`` CTAs a read in each:

    * RESIDENT up to SP 512: a resident CTA holds VC = SP / K destination
      columns, 16 warps of VC/16 columns whose lanes keep the transitions
      from all SP source rows in SP/32 x VC/16 registers: K is the fewest
      CTAs, at most DENSE_MAX_CLUSTER, with VC 128 (else 64) and at most
      DENSE_MAX_REGS such registers.  1 at SP 128, 2 at 256, 6 at 384, 8
      at 512.
    * SLICE past it, where ``DENSE_STREAM_CTAS`` CTAs' column slices fit
      their shared memory (``dense_stream_shmem``): SP 640 on 8.
    * STREAMED past that, up to ``MAX_SP``: as many CTAs reading their
      slices from L2.

    8 CTAs, portable, were the fastest the probe measured at SP 640 and
    768 and within 7% of a non-portable 16-CTA cluster (the probe's own
    instance) at SP 896 to 1152 for 8 reads, and 1.3-1.8x faster than 16
    for 64 reads at SP 640 and for 8 at SP 8192
    (tools/probe_viterbi_wide.py on an H100)."""
    for vc in (128, 64):
        k = sp // vc
        if sp % vc == 0 and k <= DENSE_MAX_CLUSTER and (sp // 32) * (vc // 16) <= DENSE_MAX_REGS:
            return DenseMode("resident", k)
    k = DENSE_STREAM_CTAS
    if dense_stream_shmem(sp, k, True) <= DENSE_MAX_SHMEM:
        return DenseMode("slice", k)
    return DenseMode("stream", k)


def _fwd_dense_plain(obs, t_actual, ph):
    """Plain twin of the dense forward: the reference's step over the
    reads still within their length (``max_u st[u] + trans[u, v]`` as a
    max over transT's rows).  A finished read's row stays as it was
    (the reference lets it run on); rows past a read's length are never
    read."""
    B, T = obs.shape
    sp = ph.sp
    dev = obs.device
    tact = t_actual.to(torch.int64).clamp_max(T)
    st = torch.zeros((B, sp), device=dev)
    fin = torch.zeros((B, sp), device=dev)
    acc = torch.zeros((B,), device=dev)
    sc = torch.zeros((T, B, sp), device=dev)
    for t in range(int(tact.max())):
        rows = torch.nonzero(t < tact)[:, 0]
        z = (obs[rows, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            val = ph.start + emit
        else:
            val = (st[rows, None, :] + ph.transT[None]).amax(dim=2) + emit
        m = val.max(dim=1, keepdim=True).values
        st[rows] = val - m
        acc[rows] = acc[rows] + m[:, 0]
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
    args = (o.data_ptr(), tact.data_ptr(), ph.trans.data_ptr(), ph.start.data_ptr(),
            ph.mu.data_ptr(), ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(),
            ph.lsig.data_ptr(), sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, sp)
    mode = dense_mode(sp)
    if mode.kind == "resident":
        _build.launch("viterbi_dense_resident_launch", dev, *args, mode.ctas)
    else:
        _build.launch("viterbi_dense_stream_launch", dev, *args, mode.ctas,
                      int(mode.kind == "slice"))
    _build.LAUNCHES[mode.name] += 1
    return sc, fin, acc


def viterbi_forward_dense(obs, t_actual, ph: PaddedHMM):
    """Dense forward of a (B, T) batch over the full SP x SP transitions.

    Counterpart of the reference's ``viterbi_forward_pallas_multi``, with
    the rows written time-major so ``viterbi_backward_batch`` reads them
    directly.  Returns (sc (T, B, SP) f32 rescaled score rows, fin (B, SP)
    the row at t_actual-1, acc (B,) the summed rescale shifts).  Rows at
    t >= t_actual are left unwritten on the card; nothing reads them.
    On the card the kernel runs in :func:`dense_mode`'s mode; every mode
    gives ``_fwd_dense_plain``'s bits.
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
    if sp > MAX_SP:
        raise ValueError(f"the backward kernel takes at most {MAX_SP} padded states, got {sp}")
    wide = sp > NARROW_MAX_SP
    s = sc.contiguous()
    tt = transT.contiguous()
    la = last.to(torch.int32).contiguous()
    ta = t_actual.to(torch.int32).contiguous()
    path = torch.empty((B, T), dtype=torch.int32, device=dev)
    _build.launch(
        "viterbi_bwd_wide_launch" if wide else "viterbi_bwd_launch", dev,
        s.data_ptr(), tt.data_ptr(), la.data_ptr(), ta.data_ptr(), path.data_ptr(), B, T, sp)
    _build.LAUNCHES["viterbi_backward_wide" if wide else "viterbi_backward_batch"] += 1
    return path


def viterbi_backward_batch(sc, last, t_actual, transT):
    """Paths (B, T) int32 from time-major score rows (T, B, SP).

    path[t] = last for t >= t_actual - 1; below, each step takes the
    first state u maximising sc[t-1, u] + trans[u, path[t]].  SP at most
    ``MAX_SP`` on the card.
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


def viterbi_batch(obs, t_actual, ph: PaddedHMM, group: int = GROUP):
    """Decode a (B, T) batch: returns (logp (B,) f32, path (B, T) int32).

    Runs in ``group``-read calls (at most GROUP; the forward's score
    plane is (T, group, SP) f32); each call pads its rows to a multiple
    of 8 with length-1 dummies.  logp = (fin + end)[last] + acc with
    last = argmax(fin + end), first maximum.  The forward is the
    factored one, or the dense one when ``ph`` has no factored form.
    """
    B = obs.shape[0]
    if B > group:
        outs = [viterbi_batch(obs[g : g + group], t_actual[g : g + group], ph, group)
                for g in range(0, B, group)]
        return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])
    obs_p, tact_p = _pad_batch(obs.to(torch.float32), t_actual.to(torch.int32))
    forward = viterbi_forward_dense if ph.fspec is None else viterbi_forward_factored
    sc, fin, acc = forward(obs_p, tact_p, ph)
    final = fin + ph.end
    last = torch.argmax(final, dim=1)
    logp = final.gather(1, last[:, None])[:, 0] + acc
    path = viterbi_backward_batch(sc, last, tact_p, ph.transT)
    return logp[:B], path[:B]
