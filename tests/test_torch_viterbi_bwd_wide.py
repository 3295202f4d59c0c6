"""The wide Viterbi backward's reduction (SP past 1024) in plain ops, on
the CPU, against the plain twin and the JAX package's backward.

On the card the wide backward (``csrc/viterbi_bwd.cu``
``viterbi_bwd_wide_kernel``) walks a read with one CTA of SP /
``BWD_WIDE_SPT`` threads, thread x owning the float4s x + k * threads of
a row, and takes each step's first maximum by keys: the order key of a
candidate with -0.0 folded onto +0.0, the largest key of the thread (a
strict > scan over its ascending states), then of the warp (a redux.sync
max) with the least state holding it (a redux.sync min), then the same
fold over the warps' pairs.  A CUDA kernel cannot run here, so that
reduction is emulated step by step in plain ops (``_emulate``) and held
to ``viterbi_cuda._bwd_plain`` and the reference's ``viterbi_backward_batch``
in Pallas interpret mode:

* on the plain forward's rows of every ``synthetic.VITERBI_WIDE`` case
  (both slot layouts, SP 1152 to 8192, constant observations among
  them) at T 256;
* on ``synthetic.BWD_EDGES``: -0.0 and +0.0 ties (the key's fold decides
  the answer there: without it the walk parts from the twin's), ties at
  NEG held by states across the CTA's warps, random ties; at SP 1152,
  4480 and 8192, at the package's states a thread and at 4 and 16.

Paths exact.  The ``gpu`` tests hold the kernel to ``_bwd_plain`` on the
card at the same inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.ops.viterbi_pallas import viterbi_backward_batch as jax_backward
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (BWD_EDGES, MOD_MODEL_SEED, VITERBI_WIDE,
                                        bwd_edge_case, viterbi_wide_case, write_mod_model,
                                        write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

T = 256
INT_MIN, INT_MAX = -(2 ** 31), 2 ** 31 - 1


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    return (PoreModel(write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED)),
            PoreModel(write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED)))


def _fkey(x, fold=True):
    """csrc/viterbi_bwd.cu ``fkey``: int32 keys in the float order, -0.0
    folded onto +0.0 (x + 0.0) unless ``fold`` is False."""
    i = (x + 0.0 if fold else x).contiguous().view(torch.int32)
    return torch.where(i >= 0, i, i ^ 0x7FFFFFFF)


def _first_max(keys, states):
    """The largest key of each row and the least state holding it (a
    redux.sync max, then a redux.sync min over the holders)."""
    k = keys.max(dim=-1).values
    return k, torch.where(keys == k[..., None], states, INT_MAX).min(dim=-1).values


def _thread_states(sp: int, spt: int):
    """(threads, spt) states of each thread of the launch, ascending
    (thread x owns the float4s x + k * threads, k < spt / 4), -1 past SP."""
    threads = (sp // spt + 31) // 32 * 32  # blockDim.x
    x = torch.arange(threads)[:, None, None]
    q = x + torch.arange(spt // 4)[None, :, None] * threads
    u = 4 * q + torch.arange(4)[None, None, :]
    return torch.where(q < sp // 4, u, -1).reshape(threads, spt)


def _emulate(sc, last, t_actual, transT, spt=TVC.BWD_WIDE_SPT, fold=True):
    """The wide backward's walk, each step's state by the kernel's keyed
    reduction over ``spt`` states a thread.  Returns (path (B, T) int32,
    the steps whose maximum is held by states of two or more warps)."""
    Tn, B, sp = sc.shape
    tact = t_actual.to(torch.int64).clamp_max(Tn)
    st = last.to(torch.int64).clone()
    path = torch.empty((B, Tn), dtype=torch.int64)
    layout = _thread_states(sp, spt)
    live = layout >= 0
    mt = int(tact.max())
    path[:, mt:] = st[:, None]
    split_ties = 0
    for t in range(mt - 1, -1, -1):
        path[:, t] = st
        if t == 0:
            break
        keys = _fkey(sc[t - 1] + transT[st], fold)
        tk = torch.where(live, keys[:, layout.clamp_min(0)], INT_MIN)  # (B, threads, spt)
        bk, bi = _first_max(tk, torch.where(live, layout, INT_MAX).expand_as(tk))
        nb, threads = bk.shape
        wk, wi = _first_max(bk.reshape(nb, threads // 32, 32), bi.reshape(nb, threads // 32, 32))
        gk, bp = _first_max(wk, wi)
        holders = (tk == gk[:, None, None]).reshape(nb, threads // 32, -1).any(dim=2)
        split_ties += int(((holders.sum(dim=1) > 1) & (t < tact)).sum())
        st = torch.where(t < tact, bp.to(torch.int64), st)
    return path.to(torch.int32), split_ties


def _jax_path(sc, last, lens, transT):
    return np.asarray(jax_backward(jnp.asarray(sc.numpy()),
                                   jnp.asarray(last.numpy().astype(np.int32)),
                                   jnp.asarray(lens.numpy()), int(lens.max()),
                                   jnp.asarray(transT.numpy()), time_major=True))


@pytest.mark.parametrize("case", list(VITERBI_WIDE))
def test_wide_backward_reduction_matches_plain_and_jax(models, case):
    """The kernel's reduction, emulated, on the plain forward's rows of
    every wide case: equal to the plain twin and to the reference's
    backward in interpret mode."""
    pm, pm_mod = models
    chm, obs, lens = viterbi_wide_case(pm, pm_mod, case, np.random.default_rng(40 + len(case)))
    ph = TVC.PaddedHMM(chm, "cpu")
    assert ph.sp > TVC.NARROW_MAX_SP
    o = torch.from_numpy(np.ascontiguousarray(obs[:, :T]))
    n = torch.from_numpy(np.minimum(lens, T))
    sc, fin, _acc = TVC.viterbi_forward_factored(o, n, ph)
    last = torch.argmax(fin + ph.end, dim=1)
    want = TVC._bwd_plain(sc, last, n, ph.transT)
    np.testing.assert_array_equal(want.numpy(), _jax_path(sc, last, n, ph.transT))
    assert torch.equal(TVC.viterbi_backward_batch(sc, last, n, ph.transT), want)
    assert torch.equal(_emulate(sc, last, n, ph.transT)[0], want)


# each edge case at the package's states a thread and at 4 and 16, where
# SP / states threads fit a CTA
EDGE_SPT = [(label, spt) for label, sp in BWD_EDGES.items()
            for spt in sorted({4, TVC.BWD_WIDE_SPT, 16}) if sp // spt <= 1024]


@pytest.mark.parametrize("label,spt", EDGE_SPT)
def test_wide_backward_edges_match_plain_and_jax(label, spt):
    """The edge inputs through the reduction at ``spt`` states a thread:
    equal to the plain twin and the reference.  Every case has steps
    whose maximum is held by states of several warps; "signed zeros"
    needs the key's fold (without it the walk parts from the twin's)."""
    sc, transT, last, lens = (torch.from_numpy(x)
                              for x in bwd_edge_case(label, np.random.default_rng(70)))
    want = TVC._bwd_plain(sc, last, lens, transT)
    np.testing.assert_array_equal(want.numpy(), _jax_path(sc, last, lens, transT))
    path, split_ties = _emulate(sc, last, lens, transT, spt)
    assert torch.equal(path, want)
    assert split_ties > 0
    if label == "signed zeros":
        assert not torch.equal(_emulate(sc, last, lens, transT, spt, fold=False)[0], want)


def test_wide_backward_threads_fit_a_cta():
    """Every SP the wide backward takes (past NARROW_MAX_SP up to MAX_SP)
    runs BWD_WIDE_SPT states a thread in one CTA of at most 1024
    threads, each warp with a live state."""
    for sp in range(TVC.NARROW_MAX_SP + TVC.LANE, TVC.MAX_SP + 1, TVC.LANE):
        layout = _thread_states(sp, TVC.BWD_WIDE_SPT)
        assert layout.shape[0] <= 1024
        assert (layout.reshape(-1, 32 * TVC.BWD_WIDE_SPT) >= 0).any(dim=1).all()
        assert torch.equal(layout[layout >= 0].sort().values, torch.arange(sp))
