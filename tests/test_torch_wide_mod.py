"""Mod calling past SP 1024 through the port's counter against the JAX
counter, on the CPU.

chip_smoke.py phase 4f's wide mod target: the ``MOD_MODEL_SEED`` base
and twin models, a 260-base unit (``synthetic.random_unit(260, 260)``)
between ``synthetic.PREFIX`` and ``SUFFIX``: its repeat HMM has 1740
states (SP 1792, the chained layout's cluster forward on the card) and
its mod HMM 1042 (SP 1152, the diagonal-only layout's).  '+'
reads of 3 units, alternately from the base and the twin model
(``make_mod_reads`` from ``default_rng(6)``).  The port's CPU counter
gives the JAX counter's result tuples, mod strings included;
chip_smoke.py holds the card's tuples to this CPU counter's.
Tolerance: as tests/test_torch_wide_counter.py.
"""
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, SUFFIX, WIDE_MOD_UNIT_BASES,
                                        wide_mod_reads, write_mod_model, write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    return (write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED),
            write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED))


def test_wide_mod_target_matches_jax_counter(models):
    base, twin = models
    unit, reads = wide_mod_reads(base, twin, 2)
    assert len(unit) == WIDE_MOD_UNIT_BASES
    ref_counter = JaxRepeatCounter(base, mod_model_file=twin)
    ref_counter.add_target("wide", unit, PREFIX, SUFFIX)
    ref = ref_counter.detect_many("wide", reads, "+")
    port = RepeatCounter(base, mod_model_file=twin, device="cpu")
    port.add_target("wide", unit, PREFIX, SUFFIX)
    tc = port.targets["wide"][0]
    assert TVC.padded_sp(tc.repeat_hmm.n_states) == 1792
    assert TVC.padded_sp(tc.mod_hmm.n_states) == 1152
    got = port.detect_many("wide", reads, "+")
    # the base read calls no unit methylated, the twin read every unit
    assert [set(r[6]) for r in ref] == [{"0"}, {"1"}]
    for r, g in zip(ref, got, strict=True):
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)
