"""FMR1 '+' reads that the count path miscounts on the synthetic model:
the port's count against the JAX package's, read by read, on the CPU.

chip_smoke.py phase 4g's stream (``synthetic.count_workload(pm, 9)`` over
the seed-0 model, the FMR1 target of ``synthetic.LOCI`` at its full
flanks) counts about half of its FMR1 '+' reads off their true units on
the card: most 1-5 under, two 1 over.  Three of them -- both overcounts
and the largest undercount -- go through both packages'
``RepeatCounter.detect`` here.  The port must give the JAX package's
tuple, digit for digit, and the count the card gave.
"""
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import LOCI, count_workload, write_pore_model

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

# read id -> (true units, the count on the card in phase 4g: NVIDIA H100
# 80GB HBM3, 700.00 W)
MISSED = {"fmr1-+-0257": (89, 90), "fmr1-+-0300": (124, 125), "fmr1-+-0312": (146, 141)}


@pytest.fixture(scope="module")
def counters(tmp_path_factory):
    model = write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                             seed=0)
    reads = {r[0]: r for r in count_workload(PoreModel(model), 9) if r[0] in MISSED}
    _chrom, _b, _e, repeat, prefix, suffix = LOCI["fmr1"]
    port = RepeatCounter(model, device="cpu")
    ref = JaxRepeatCounter(model)
    for c in (port, ref):
        c.add_target("fmr1", repeat, prefix, suffix)
    return reads, port, ref


@pytest.mark.parametrize("read_id", sorted(MISSED))
def test_missed_fmr1_read_counts_as_in_jax(counters, read_id):
    reads, port, ref = counters
    _rid, target, strand, units, raw = reads[read_id]
    assert (target, strand, units) == ("fmr1", "+", MISSED[read_id][0])
    mine = port.detect("fmr1", np.asarray(raw), "+")
    theirs = ref.detect("fmr1", np.asarray(raw), "+")
    assert "\t".join(map(str, mine)) == "\t".join(map(str, theirs))
    assert mine[0] == MISSED[read_id][1]
