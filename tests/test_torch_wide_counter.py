"""The 150-base-unit VNTR target past SP 1024 through the port's counter
against the JAX counter, on the CPU.

chip_smoke.py phase 4f's wide target: the seed-0 synthetic model, a
150-base unit (``synthetic.random_unit(150, 5)``, ``default_rng(5)``'s
first draw, as phase 4f's 60-base VNTR unit) between ``synthetic.PREFIX``
and ``SUFFIX``, whose repeat HMM has 1080 states (SP 1152: past the
narrow Viterbi kernels' 1024, on the card the cluster forward and the
wide backward), and '+'
reads of 5 units from the same generator.  The port's CPU counter on
the default route (the factored forward) and under
``STRIQUE_DENSE_VITERBI=1`` (the dense forward) gives the JAX counter's
result tuples; chip_smoke.py holds the card's tuples to this CPU
counter's.  Tolerance: counts, scores, offsets and ticks exact, log_p
1e-9 relative (recomputed in float64 on the host from identical paths),
as tests/test_torch_dense.py.
"""
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (PREFIX, SUFFIX, WIDE_UNIT_BASES, make_reads,
                                        random_unit, write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

UNIT_SEED = 5
UNITS = 5


@pytest.fixture(scope="module")
def smoke_model(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=0)


def wide_reads(pm, n_reads):
    """The unit and ``n_reads`` '+' reads of UNITS units: phase 4f's draws."""
    rng = np.random.default_rng(UNIT_SEED)
    unit = "".join(rng.choice(list("ACGT"), WIDE_UNIT_BASES))
    return unit, make_reads(pm, n_reads, UNITS, rng, "+", repeat=unit)


def test_wide_target_counts_match_jax_counter(smoke_model, monkeypatch):
    pm = PoreModel(smoke_model)
    unit, reads = wide_reads(pm, 2)
    assert unit == random_unit(WIDE_UNIT_BASES, UNIT_SEED)
    ref_counter = JaxRepeatCounter(smoke_model)
    ref_counter.add_target("wide", unit, PREFIX, SUFFIX)
    ref = ref_counter.detect_many("wide", reads, "+")
    # the reference counts 4 of the 5 units on these reads
    assert [r[0] for r in ref] == [UNITS - 1] * len(reads)
    calls = []
    dense_fn = TVC.viterbi_forward_dense
    monkeypatch.setattr(TVC, "viterbi_forward_dense", lambda *a: calls.append(1) or dense_fn(*a))
    for route in ("default", "dense"):
        if route == "dense":
            monkeypatch.setenv("STRIQUE_DENSE_VITERBI", "1")
        port = RepeatCounter(smoke_model, device="cpu")
        port.add_target("wide", unit, PREFIX, SUFFIX)
        hmm = port.targets["wide"][0].repeat_hmm
        assert hmm.n_states == 1080 and TVC.padded_sp(hmm.n_states) == 1152
        got = port.detect_many("wide", reads, "+")
        assert bool(calls) == (route == "dense"), route
        for r, g in zip(ref, got, strict=True):
            assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
            assert g[3] == pytest.approx(r[3], rel=1e-9)
