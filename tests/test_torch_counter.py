"""strique_tpu_torch RepeatCounter (plain CPU path) vs strique_tpu's.

Both counters load the same seeded synthetic 6-mer model from tmp_path
and count the same 8 noisy reads of known repeat count on each strand
through detect_many (the split pipeline on both sides).  Result tuples
must be equal: counts, offsets and ticks exactly, the span-normalised
flank scores exactly (the f32 alignment streams are bit-equal on these
reads), and log_p to 1e-9 relative -- it is recomputed in float64 on
the host from an identical path and identical segment.
"""
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu.pore_model import PoreModel
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, make_reads, write_pore_model

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)

# shortened c9orf72 flanks keep the reference's CPU alignment quick
T_PREFIX = PREFIX[-80:]
T_SUFFIX = SUFFIX[:80]
COUNTS = {"+": [5, 8, 12, 20, 7, 10, 15, 9], "-": [6, 11, 4, 18, 9, 13, 7, 16]}


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


def _reads(pm, strand, seed):
    rng = np.random.default_rng(seed)
    return [make_reads(pm, 1, n, rng, strand=strand, flank_bases=200, prefix=T_PREFIX,
                       suffix=T_SUFFIX)[0] for n in COUNTS[strand]]


@pytest.mark.parametrize("strand", ["+", "-"])
def test_counter_matches_jax_counter(model_file, strand):
    pm = PoreModel(model_file)
    reads = _reads(pm, strand, seed=31 if strand == "+" else 22)
    ref_counter = JaxRepeatCounter(model_file)
    ref_counter.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    port = RepeatCounter(model_file, device="cpu")
    port.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    ref = ref_counter.detect_many("c9orf72", reads, strand)
    got = port.detect_many("c9orf72", reads, strand)
    assert [r[0] for r in ref] == COUNTS[strand]
    assert len(got) == len(ref)
    for r, g in zip(ref, got):
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)


def test_counter_phases_and_prep_tokens(model_file):
    """submit -> middle -> finish in steps (middle idempotent) with shared
    prep tokens gives the same tuples as detect_many."""
    pm = PoreModel(model_file)
    reads = _reads(pm, "+", seed=23)[:3]
    port = RepeatCounter(model_file, device="cpu")
    port.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    tokens = [{} for _ in reads]
    state = port.detect_submit("c9orf72", reads, "+", preps=tokens)
    state = port.detect_middle(port.detect_middle(state))
    first = port.detect_finish(state)
    assert all("prep" in t for t in tokens)
    again = port.detect_finish(port.detect_submit("c9orf72", reads, "+", preps=tokens))
    assert first == again == port.detect_many("c9orf72", reads, "+")


def test_counter_cuda_default_needs_a_card(model_file):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        RepeatCounter(model_file)

