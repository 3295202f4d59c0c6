"""strique_tpu_torch factored Viterbi vs the JAX reference.

The port's plain factored forward + backward (the CPU twins of
csrc/viterbi_fwd.cu and csrc/viterbi_bwd.cu) against
``viterbi_pallas_batch`` in Pallas interpret mode, on a factoring
flanked-repeat HMM built from a seeded synthetic 6-mer model (B=8,
T=512), both sides fed the same padded HMM arrays through convert.py.

Tolerances: paths exact.  logp within rtol 1e-5: the port's emission
constant lsig = -log(2 pi)/2 - log(sigma) is float64 rounded to f32,
the reference's is XLA's f32 log (different by an ulp on some sigmas),
and logp accumulates one such term per step over T=512 steps of
magnitude ~1, so the f32 sums may part by a few ulp of |logp| ~ 1e3.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.hmm.models import build_flanked_repeat
from strique_tpu.ops import viterbi as JV
from strique_tpu.ops.viterbi_pallas import PaddedHMM as JaxPaddedHMM
from strique_tpu.ops.viterbi_pallas import viterbi_pallas_batch
from strique_tpu.pore_model import PoreModel
from strique_tpu_torch.convert import padded_hmm_from_jax
from strique_tpu_torch.ops import viterbi as TV
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.synthetic import write_pore_model

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)

# short flanks: reads of 1-3 units fit T=512
PREFIX = "CCAGGATGCCGCCTCCTCACTCACC"
SUFFIX = "TAGCGCGACTCCTGAGTTCCAGAGC"


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    return PoreModel(write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=3))


@pytest.fixture(scope="module")
def chm(pm):
    c = build_flanked_repeat("GGCCCC", PREFIX, SUFFIX, pm)
    assert c.factored is not None
    return c


def _batch(pm, counts, T, seed):
    rng = np.random.default_rng(seed)
    obs = np.zeros((len(counts), T), np.float32)
    lens = np.zeros(len(counts), np.int32)
    for i, n in enumerate(counts):
        s = pm.generate_signal(PREFIX + "GGCCCC" * n + SUFFIX, samples=8, noise=True,
                               rng=rng).astype(np.float32)[:T]
        obs[i, : len(s)] = s
        lens[i] = len(s)
    return obs, lens


def test_factored_viterbi_matches_jax_interpret(pm, chm):
    # whole short reads beside ones cut at T
    obs, lens = _batch(pm, [1, 2, 3, 5, 8, 2, 6, 4], 512, seed=5)
    assert lens.min() < 512 and lens.max() == 512
    jph = JaxPaddedHMM(chm)
    jl, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    jl, jp = np.asarray(jl), np.asarray(jp)
    tl, tp = TVC.viterbi_batch(torch.from_numpy(obs), torch.from_numpy(lens),
                               padded_hmm_from_jax(jph, "cpu"))
    np.testing.assert_array_equal(tp.numpy(), jp)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=1e-5)
    for i in range(len(lens)):
        assert (TV.count_repeats(tp.numpy()[i], lens[i], chm)
                == JV.count_repeats(jp[i], lens[i], chm))


def test_padded_hmm_matches_reference_staging(chm):
    """PaddedHMM(chm) stages the same arrays as the reference class."""
    jph = JaxPaddedHMM(chm)
    ph = TVC.PaddedHMM(chm, "cpu")
    assert ph.sp == jph.sp and ph.sp % 128 == 0 and ph.n_states == jph.n_states
    np.testing.assert_array_equal(ph.trans.numpy(), np.asarray(jph.trans))
    np.testing.assert_array_equal(ph.transT.numpy(), np.asarray(jph.transT))
    for name in ("start", "end", "mu", "sigma", "uni", "luni"):
        np.testing.assert_array_equal(getattr(ph, name).numpy(),
                                      np.asarray(getattr(jph, name)).reshape(-1), err_msg=name)
    assert ph.fspec == jph.fspec
    np.testing.assert_array_equal(ph.fweights.numpy(),
                                  np.stack([np.asarray(w).reshape(-1) for w in jph.fweights]))
    np.testing.assert_allclose(ph.lsig.numpy(),
                               -0.5 * np.log(2 * np.pi) - np.log(ph.sigma.numpy()), rtol=1e-6)


def test_forward_rows_and_backward_against_reference_kernels(pm, chm):
    """The forward's rescaled rows, final row and acc against the
    reference Pallas forward; the backward on the reference's rows."""
    from strique_tpu.ops.viterbi_pallas import (viterbi_backward_batch,
                                                viterbi_forward_pallas_factored)

    obs, lens = _batch(pm, [2, 3, 4, 5, 2, 3, 4, 5], 512, seed=9)
    jph = JaxPaddedHMM(chm)
    jsc, jfin, jacc = viterbi_forward_pallas_factored(
        jnp.asarray(obs), jnp.asarray(lens), jph.start, jph.mu, jph.sigma, jph.uni,
        jph.luni, jph.fspec, *jph.fweights)
    jsc, jfin, jacc = np.asarray(jsc), np.asarray(jfin), np.asarray(jacc)[:, 0]
    ph = padded_hmm_from_jax(jph, "cpu")
    sc, fin, acc = TVC.viterbi_forward_factored(torch.from_numpy(obs), torch.from_numpy(lens), ph)
    live = np.arange(obs.shape[1])[:, None] < lens[None, :]
    # rows are rescaled to max 0 each step; an ulp of lsig moves a row
    # entry by at most a few ulp of its magnitude (<= ~1e3 here)
    np.testing.assert_allclose(sc.numpy()[live], jsc[live], rtol=0, atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), jfin, rtol=0, atol=2e-3)
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-5)
    last = np.argmax(jfin + np.asarray(jph.end), axis=1).astype(np.int32)
    jpath = np.asarray(viterbi_backward_batch(jnp.asarray(jsc), jnp.asarray(last),
                                              jnp.asarray(lens), int(lens.max()), jph.transT,
                                              time_major=True))
    path = TVC.viterbi_backward_batch(torch.from_numpy(np.array(jsc)), torch.from_numpy(last),
                                      torch.from_numpy(lens), ph.transT)
    np.testing.assert_array_equal(path.numpy(), jpath)


def test_dense_only_hmm_raises(pm, chm):
    """An HMM staged without a factored form: the factored forward raises
    on it, and viterbi_batch decodes it with the dense forward to the
    reference's (factored) paths."""
    jph = JaxPaddedHMM(chm)
    ph = TVC.PaddedHMM.from_arrays(chm.n_states, np.asarray(jph.trans), np.asarray(jph.start),
                                   np.asarray(jph.end), np.asarray(jph.mu),
                                   np.asarray(jph.sigma), np.asarray(jph.uni),
                                   np.asarray(jph.luni), None, None, device="cpu")
    obs, lens = _batch(pm, [1, 2, 3, 5, 8, 2, 6, 4], 512, seed=5)
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    with pytest.raises(ValueError, match="dense"):
        TVC.viterbi_forward_factored(o, n, ph)
    jl, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    tl, tp = TVC.viterbi_batch(o, n, ph)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
