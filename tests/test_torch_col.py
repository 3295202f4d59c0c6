"""strique_tpu_torch column-sweep alignment vs the JAX reference.

The port's plain column recurrence (the CPU twin of csrc/col_align.cu)
and its column-layout traceback (``traceback_pointers(packed=True)``,
the twin of csrc/traceback.cu's column mode) against the reference's
``align_forward_pallas`` and ``_align_batch_pallas`` in Pallas
interpret mode, at B=8, N=512, M=40, under the default AlignParams, the
steep affine corner and non-negative horizontal gaps (the row-0 select
branch); the TABLE score mode's twin (``_col_table_plain``, morph-form
reads) against the POW twin on the decoded f32 and against the
reference; then ``align_core`` and the counter under
``STRIQUE_ALIGN_KERNEL=col`` against the reference and the wave route,
on f32 and on morph-form reads, and the TABLE/POW rule
``col_score_mode``.

Tolerances: pointer words a walk can read, bottom taps, end columns
and tracebacks exactly.  Scores within ``SCORE_ATOL`` (1.2e-4, the
pow-rounding bound of ROADMAP Queue 3; see tests/test_torch_align.py);
on these seeds every f32 value is bit-equal, which the exact bottom
check pins.  The counter's tuples as in tests/test_torch_counter.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu.ops import align as JA
from strique_tpu.ops import align_pallas as JP
from strique_tpu.pore_model import PoreModel
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.pore_model import PoreModel as TorchPoreModel
from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, make_reads, quantise,
                                        write_pore_model)
from tests.test_torch_align import FIELDS, PARAMS, _assert_align_equal, _reads
from tests.test_torch_counter import T_PREFIX, T_SUFFIX

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)


def _col_words(na, nwords):
    """(N/8, B) mask of the pointer words a row's walk can read: (j-1)//8 < ceil(n/8)."""
    return np.arange(nwords)[:, None] < ((np.asarray(na, np.int64) + 7) // 8)[None, :]


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_col_forward_matches_jax_interpret(pi):
    p = PARAMS[pi]
    signals, na, template = _reads(100 + pi)
    tp, m = JP.pad_template(template)
    jptr, jbot = JP.align_forward_pallas(jnp.asarray(signals), jnp.asarray(na),
                                         jnp.asarray(tp), p, m)
    ptr, bot = TC.align_forward_col(torch.from_numpy(signals), torch.from_numpy(na),
                                    torch.from_numpy(tp), p, m)
    jptr, jbot = np.asarray(jptr), np.asarray(jbot)
    assert ptr.shape == jptr.shape == (512 // 8, 8, 128) and bot.shape == jbot.shape
    mask = _col_words(na, jptr.shape[0])
    np.testing.assert_array_equal(ptr.numpy()[mask], jptr[mask])
    np.testing.assert_array_equal(bot.numpy(), jbot)


def test_col_traceback_on_jax_plane():
    """The port's column-layout walk over the plane the JAX column kernel
    wrote gives the reference walk's outputs."""
    p = PARAMS[0]
    signals, na, template = _reads(110)
    tp, m = JP.pad_template(template)
    ref = JA._align_batch_pallas(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp), p, m)
    jptr, _ = JP.align_forward_pallas(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp),
                                      p, m)
    tb = TA.traceback_pointers(torch.from_numpy(np.array(jptr)),
                               torch.from_numpy(np.array(ref["j_end"])), m, packed=True)
    for k in ("is_gap", "jpos", "j_begin"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(ref[k]), err_msg=k)
    with pytest.raises(ValueError, match="layout"):
        TA.traceback_pointers(torch.from_numpy(np.array(jptr)),
                              torch.from_numpy(np.array(ref["j_end"])), m, packed=False)


def _morph_reads(seed):
    """``_reads`` quantised to morph form: (bins, lut) numpy, their
    decoded f32 signals, lengths, the template, its lane layout, m and
    ``template_levels``."""
    signals, na, template = _reads(seed)
    bins, lut = quantise(signals, np.random.default_rng(seed + 1))
    decoded = np.take_along_axis(lut, bins.astype(np.int64), axis=1)
    tp, m = TC.pad_template(template)
    levels, lidx = TC.template_levels(tp)
    return bins, lut, decoded, na, template, tp, m, levels, lidx


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_col_table_plain_matches_pow_plain(pi):
    """The TABLE twin on morph-form reads equals the POW twin on the
    decoded f32, bit for bit in every pointer word and bottom tap."""
    bins, lut, decoded, na, _, tp, m, levels, lidx = _morph_reads(130 + pi)
    p = PARAMS[pi]
    ptr_t, bot_t = TC._col_table_plain(torch.from_numpy(bins), torch.from_numpy(lut),
                                       torch.from_numpy(levels), torch.from_numpy(lidx),
                                       torch.from_numpy(na), p, m)
    ptr_p, bot_p = TC._col_plain(torch.from_numpy(decoded), torch.from_numpy(tp),
                                 torch.from_numpy(na), p, m)
    assert torch.equal(ptr_t, ptr_p) and torch.equal(bot_t, bot_p)


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_col_table_forward_matches_jax_interpret(pi):
    """align_forward_col_morph (TABLE mode: its CPU twin) against the
    reference's column kernel on the decoded f32."""
    bins, lut, decoded, na, _, tp, m, levels, lidx = _morph_reads(140 + pi)
    p = PARAMS[pi]
    assert TC.col_score_mode(levels.shape[1], tp.shape[1]) == "table"
    jptr, jbot = JP.align_forward_pallas(jnp.asarray(decoded), jnp.asarray(na),
                                         jnp.asarray(tp), p, m)
    ptr, bot = TC.align_forward_col_morph(torch.from_numpy(bins), torch.from_numpy(lut),
                                          torch.from_numpy(na), torch.from_numpy(levels),
                                          torch.from_numpy(lidx), p, m)
    jptr, jbot = np.asarray(jptr), np.asarray(jbot)
    mask = _col_words(na, jptr.shape[0])
    np.testing.assert_array_equal(ptr.numpy()[mask], jptr[mask])
    np.testing.assert_array_equal(bot.numpy(), jbot)


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_align_core_col_morph_matches_jax(pi, monkeypatch):
    """align_core under STRIQUE_ALIGN_KERNEL=col on morph-form reads keeps
    the bins (one align_forward_col_morph call, TABLE mode) and equals
    the reference's _align_batch_pallas on the decoded f32."""
    bins, lut, decoded, na, template, tp, m, _, _ = _morph_reads(150 + pi)
    p = PARAMS[pi]
    ref = JA._align_batch_pallas(jnp.asarray(decoded), jnp.asarray(na), jnp.asarray(tp), p, m)
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    calls = []
    morph_fn = TA.align_forward_col_morph
    monkeypatch.setattr(TA, "align_forward_col_morph",
                        lambda *a: calls.append(1) or morph_fn(*a))
    monkeypatch.setattr(TA, "align_forward_col", None)  # the f32 entry point must not run
    got = TA.align_core(torch.from_numpy(bins), torch.from_numpy(na), template, p,
                        lut=torch.from_numpy(lut))
    assert calls == [1]
    _assert_align_equal(ref, got, f"col morph params {p}")


def test_col_score_mode_rule(tmp_path):
    """TABLE for the bench's c9orf72 flanks (``samples=6``: 119 and 142
    levels at MP 896 on the seed-0 synthetic model chip_smoke.py runs),
    POW past 1024 lanes (the over-the-cap flanks' MP 2176) and past the
    shared-memory cap of 224 levels."""
    pm = TorchPoreModel(write_pore_model(str(tmp_path / "synthetic_6mer.model"), seed=0))
    gen = lambda seq: pm.generate_signal(seq, samples=6).astype(np.float32)
    for flank, u_want in ((PREFIX, 119), (SUFFIX, 142)):
        levels, lidx = TC.template_levels(TC.pad_template(gen(flank))[0])
        assert (levels.shape[1], lidx.shape[1]) == (u_want, 896)
        assert TC.col_score_mode(*levels.shape[1:], *lidx.shape[1:]) == "table"
    assert TC.col_score_mode(224, 1024) == "table" and TC.col_score_mode(225, 896) == "pow"
    assert TC.col_score_mode(10, 1152) == "pow" and TC.col_score_mode(120, 2176) == "pow"


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_align_core_col_matches_jax_and_wave(pi, monkeypatch):
    """align_core under STRIQUE_ALIGN_KERNEL=col (read per call) equals
    the reference's _align_batch_pallas and the port's wave route."""
    p = PARAMS[pi]
    signals, na, template = _reads(120 + pi)
    tp, m = JP.pad_template(template)
    ref = JA._align_batch_pallas(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp), p, m)
    sig, n = torch.from_numpy(signals), torch.from_numpy(na)
    wave = TA.align_core(sig, n, template, p)
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    stats = TA.kernel_stats()
    got = TA.align_core(sig, n, template, p)
    # one column call: rows x N columns x MP lanes (the wave form issues N + MP steps)
    assert TA.kernel_stats()["calls"] - stats["calls"] == 1
    assert TA.kernel_stats()["cells"] - stats["cells"] == 8 * 512 * 128
    _assert_align_equal(ref, got, f"col params {p}")
    for k in FIELDS:
        assert torch.equal(got[k], wave[k]), k


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


def test_counter_col_matches_jax_counter(model_file, monkeypatch):
    """40 '+' reads (a batch the fusion rule leaves to align_core, so both
    flanks take the column kernel) through the port's counter under
    STRIQUE_ALIGN_KERNEL=col, against the JAX counter: tuples equal."""
    pm = PoreModel(model_file)
    rng = np.random.default_rng(41)
    counts = [int(c) for c in rng.integers(4, 16, 40)]
    reads = [make_reads(pm, 1, c, rng, strand="+", flank_bases=200, prefix=T_PREFIX,
                        suffix=T_SUFFIX)[0] for c in counts]
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    calls = []
    col_fn = TA.align_forward_col_morph  # the counter hands the alignment morph-form reads
    monkeypatch.setattr(TA, "align_forward_col_morph", lambda *a: calls.append(1) or col_fn(*a))
    ref_counter = JaxRepeatCounter(model_file)
    ref_counter.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    port = RepeatCounter(model_file, device="cpu")
    port.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    ref = ref_counter.detect_many("c9orf72", reads, "+")
    got = port.detect_many("c9orf72", reads, "+")
    assert len(calls) == 2  # one 40-row column call per flank
    assert [r[0] for r in ref] == counts
    for r, g in zip(ref, got):
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)
