"""strique_tpu_torch's Viterbi decode past 1024 padded states vs the JAX
reference, on the CPU.

The card's narrow kernels stop at SP 1024; the wide variants of rows
3-4 (``csrc/viterbi_fwd.cu`` ``viterbi_fwd_wide_kernel``,
``csrc/viterbi_bwd.cu`` ``viterbi_bwd_wide_kernel``) take SP up to
``viterbi_cuda.MAX_SP`` = 8192 and give their plain twins' bits (the
``gpu`` tests and ``chip_smoke.py`` hold that on the card).  Here:

* the plain twins at SP 1152 and 2048 (``synthetic.VITERBI_WIDE``'s
  flanked and mod HMMs: both slot layouts) against
  ``strique_tpu.ops.viterbi_pallas`` in Pallas interpret mode, at T 256;
* ``add_target`` refusing an HMM past ``MAX_SP`` on the card before
  any launch (with the card's presence faked, since the CPU tests run
  without one; and the check's function directly), while the CPU
  takes it.

The 150-base-unit target's counts through the port's counter against
the JAX counter are in tests/test_torch_wide_counter.py.

Tolerances, as tests/test_torch_viterbi.py states them (ROADMAP Queue
3): paths exact; acc and log_p 1e-5 relative (the port's emission
constant is float64 rounded to f32, the reference's XLA's f32 log: an
ulp apart on some sigmas); score rows and the final row 2e-3 absolute
plus 1e-6 relative.  That ulp moves a row entry by a few ulp of its
magnitude: up to ~1e3 at the narrow widths, but ~1.3e4 at SP 2048,
where 14 of 1.86M live entries part by up to 4 ulp (0.0039).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.hmm.models import build_flanked_repeat as jax_build_flanked_repeat
from strique_tpu.hmm.models import build_repeat_mod as jax_build_repeat_mod
from strique_tpu.ops.viterbi_pallas import PaddedHMM as JaxPaddedHMM
from strique_tpu.ops.viterbi_pallas import (viterbi_backward_batch, viterbi_forward_pallas_factored,
                                            viterbi_pallas_batch)
from strique_tpu.pore_model import PoreModel as JaxPoreModel
from strique_tpu_torch import _build
from strique_tpu_torch.convert import padded_hmm_from_jax
from strique_tpu_torch.detect import counter as counter_mod
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, REPEAT, SUFFIX, VITERBI_WIDE,
                                        random_unit, viterbi_wide_case, write_mod_model,
                                        write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

T = 256
CASES = {"flanked 150": (1152, "viterbi_forward_factored"),
         "flanked 300": (2048, "viterbi_forward_factored"),
         "mod 260": (1152, "viterbi_forward_factored_diag"),
         "mod 500": (2048, "viterbi_forward_factored_diag")}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    return (write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED),
            write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED))


@pytest.mark.parametrize("case", list(CASES))
def test_wide_twins_match_jax_interpret(models, case):
    """The plain forward's rows, final row and acc, the backward's paths
    on the reference's rows, and viterbi_batch's paths and log_p against
    the reference's Pallas kernels at SP past 1024."""
    base, twin = models
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    chm, obs, lens = viterbi_wide_case(pm, pm_mod, case, np.random.default_rng(30 + len(case)))
    obs, lens = np.ascontiguousarray(obs[:, :T]), np.minimum(lens, T)
    kind, bases, _lens, _constant = VITERBI_WIDE[case]
    jpm = JaxPoreModel(base)
    unit = random_unit(bases, bases)
    jchm = (jax_build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], jpm) if kind == "flanked"
            else jax_build_repeat_mod(unit, jpm, JaxPoreModel(twin)))
    assert jchm.n_states == chm.n_states
    jph = JaxPaddedHMM(jchm)
    ph = padded_hmm_from_jax(jph, "cpu")
    sp, layout = CASES[case]
    assert ph.sp == jph.sp == sp and ph.fwd_layout.name == layout
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)

    jsc, jfin, jacc = viterbi_forward_pallas_factored(
        jnp.asarray(obs), jnp.asarray(lens), jph.start, jph.mu, jph.sigma, jph.uni, jph.luni,
        jph.fspec, *jph.fweights)
    jsc, jfin, jacc = np.asarray(jsc), np.asarray(jfin), np.asarray(jacc)[:, 0]
    sc, fin, acc = TVC.viterbi_forward_factored(o, n, ph)
    live = np.arange(T)[:, None] < lens[None, :]
    np.testing.assert_allclose(sc.numpy()[live], jsc[live], rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), jfin, rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-5)
    last = np.argmax(jfin + np.asarray(jph.end), axis=1).astype(np.int32)
    jpath = np.asarray(viterbi_backward_batch(jnp.asarray(jsc), jnp.asarray(last),
                                              jnp.asarray(lens), int(lens.max()), jph.transT,
                                              time_major=True))
    path = TVC.viterbi_backward_batch(torch.from_numpy(np.array(jsc)), torch.from_numpy(last),
                                      n, ph.transT)
    np.testing.assert_array_equal(path.numpy(), jpath)

    jl, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    tl, tp = TVC.viterbi_batch(o, n, ph)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_check_card_sp_limit():
    """Up to MAX_SP padded states the card takes an HMM; past it only the
    CPU does, and the refusal names the limit and the reference's own
    chip reach (its backward's (SP, SP) block in VMEM)."""
    assert TVC.padded_sp(1) == 128 and TVC.padded_sp(1080) == 1152
    assert TVC.padded_sp(TVC.MAX_SP) == TVC.MAX_SP == 8192
    TVC.check_card_sp(TVC.MAX_SP, "cuda")
    TVC.check_card_sp(TVC.MAX_SP + 1, "cpu")
    with pytest.raises(ValueError, match="8192 padded states.*VMEM.*device='cpu'"):
        TVC.check_card_sp(TVC.MAX_SP + 1, torch.device("cuda"))
    assert TVC.NARROW_MAX_SP == 1024


class _WideHMM:
    """A stand-in for a compiled repeat HMM of ``n_states`` (its dense
    build past 8192 states takes ~25 s and ~5 GB)."""

    def __init__(self, n_states):
        self.n_states = n_states


@pytest.mark.parametrize("device, refused", [("cuda", True), ("cpu", False)])
def test_add_target_refuses_past_max_sp_on_the_card(models, monkeypatch, device, refused):
    """On the card ``add_target`` refuses a repeat HMM past MAX_SP as soon
    as its first strand's HMM is built: no launch, no second build, no
    target.  The CPU counter keeps it."""
    base, _twin = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []

    def build(unit, *a, **k):
        built.append(unit)
        return _WideHMM(TVC.MAX_SP + 1)

    monkeypatch.setattr(counter_mod, "build_flanked_repeat", build)
    c = RepeatCounter(base, device=device)
    before = dict(_build.LAUNCHES)
    if refused:
        with pytest.raises(ValueError, match="8192 padded states"):
            c.add_target("wide", REPEAT, PREFIX, SUFFIX)
        assert built == [REPEAT] and "wide" not in c.targets
    else:
        c.add_target("wide", REPEAT, PREFIX, SUFFIX)
        assert len(built) == 2 and "wide" in c.targets
    assert dict(_build.LAUNCHES) == before
