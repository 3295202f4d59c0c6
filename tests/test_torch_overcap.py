"""strique_tpu_torch past one CTA's score table (MP 2176) vs the JAX reference.

A template of more than 1024 lanes, or of more levels than one block's
table holds, runs the wave kernel's TABLE mode on a thread-block cluster
of CTAs a row (``align_cuda.wave_table_ctas``), each CTA scoring from a
table of only its own lanes' levels (the split form of
``template_levels``).  On the CPU the wrappers run the table twin on the
same levels flattened (``flat_levels``), so these tests hold the split
form's indexing at MP 2176 (phase 4e's template width in chip_smoke.py:
flanks 200 bases past the bench's) against the reference:

  * ``align_forward_wave_multi`` in Pallas interpret mode on the decoded
    ``lut[bins]`` (both flanks as per-row templates), against the
    port's morph call in the split form: pointer words a walk can read
    and bottom taps exactly, and the batch step's scores, end columns
    and tracebacks;
  * a flat read (every sample equal: the prep's level table is all NaN)
    through the JAX counter and the port's CPU counter at those flanks:
    the same gated tuple, offset 0 on both.  The card's kernels gave
    offset 449 before their maxes propagated NaN (ROADMAP Queue 3).

Tolerances (ROADMAP Queue 3): the port's pow is correctly rounded and
XLA's f32 ``jnp.power`` differs from it by 1 ulp on ~0.065% of inputs,
so scores compare within 1.2e-4; the bottom taps are exact on these
seeds.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu.ops import align as JA
from strique_tpu.ops import align_pallas as JP
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, quantise, write_pore_model
from tests.test_torch_align import PARAMS, _assert_align_equal, _valid_words

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

B, N = 8, 256
MP = 2176


def _overcap_reads(seed):
    """Morph reads and two samples=6 templates padding to MP 2176 lanes
    (2172 and 2052 samples, ~360 levels: past one CTA's table), a slice
    of the first planted in every read."""
    rng = np.random.default_rng(seed)
    t_pre = np.repeat(rng.uniform(60, 120, 362), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 342), 6).astype(np.float32)
    lo = rng.uniform(40, 60, B)
    hi = rng.uniform(130, 150, B)
    sig = rng.uniform(60, 120, (B, N))
    for i in range(B):
        st = 20 + 10 * i
        sig[i, st : st + 120] = t_pre[600:720] + rng.normal(0, 0.5, 120)
    bins, lut = quantise(sig, rng, lo, hi)
    na = rng.integers(150, N, B).astype(np.int32)
    na[0] = N
    return bins, lut, na, t_pre, t_suf


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


@pytest.mark.parametrize("pi", [0, 1])
def test_split_form_multi_matches_jax_interpret(pi):
    """Both flanks as per-row templates at MP 2176: the split form on 2
    CTAs a row against the reference's wave_multi on lut[bins]."""
    p = PARAMS[pi]
    bins, lut, na, t_pre, t_suf = _overcap_reads(960 + pi)
    rows, ms = TC.pad_template_rows([t_pre, t_suf])
    tmpl = np.repeat(rows, B // 2, axis=0)
    m_rows = np.repeat(ms, B // 2).astype(np.int32)
    assert tmpl.shape[1] == MP and TC.wave_table_ctas(tmpl) == 2
    levels, lidx = TC.template_levels(tmpl, 2)
    assert levels.shape[1] == 2 and TC.wave_score_mode(levels.shape[2], MP, 2) == "table"
    sig = jnp.asarray(np.take_along_axis(lut, bins.astype(np.int64), axis=1))
    jptr, jbot = JP.align_forward_wave_multi(sig, jnp.asarray(na), jnp.asarray(tmpl),
                                             jnp.asarray(m_rows), p)
    b_t, l_t, n_t, lv_t, li_t, m_t = _t(bins, lut, na, levels, lidx, m_rows)
    ptr, bot = TC.align_forward_wave_multi_morph(b_t, l_t, n_t, lv_t, li_t, m_t, p)
    mask = _valid_words(na, m_rows, ptr.shape[0])
    np.testing.assert_array_equal(ptr.numpy()[mask], np.asarray(jptr)[mask])
    np.testing.assert_array_equal(bot.numpy(), np.asarray(jbot))
    m_max = int(m_rows.max())
    ref = JA._align_batch_wave_multi(sig, jnp.asarray(na), jnp.asarray(tmpl),
                                     jnp.asarray(m_rows), p, m_max)
    got = TA._align_batch_wave_multi_morph(b_t, l_t, n_t, lv_t, li_t, m_t, p, m_max)
    _assert_align_equal(ref, got, "split form")


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=3)


def test_flat_read_over_the_cap_matches_jax_counter(model_file, monkeypatch):
    """A flat read against flanks 200 bases longer than the bench's (MP
    2176, the wave route's cluster TABLE form on morph input): the JAX
    counter and the port's CPU counter give the same gated tuple, offset
    0."""
    rng = np.random.default_rng(970)
    prefix = "".join(rng.choice(list("ACGT"), 200)) + PREFIX
    suffix = SUFFIX + "".join(rng.choice(list("ACGT"), 200))
    reads = [np.full(3000, 90.0)]
    split_calls = []
    real = TC.flat_levels
    monkeypatch.setattr(TC, "flat_levels", lambda *a: split_calls.append(1) or real(*a))
    out = []
    for c in (JaxRepeatCounter(model_file), RepeatCounter(model_file, device="cpu")):
        c.add_target("long", REPEAT, prefix, suffix)
        out.append(c.detect_many("long", reads, "+"))
    assert split_calls  # the port's wave calls took the split form
    tc = c.targets["long"][0]
    rows, _ = TC.pad_template_rows([tc.prefix_ext, tc.suffix_ext])
    assert rows.shape[1] == MP and TC.wave_table_ctas(rows) >= 2
    assert out[0] == out[1]
    assert out[1][0][0] == 0 and out[1][0][4] == 0  # (n, scores, log_p, offset, ...)
