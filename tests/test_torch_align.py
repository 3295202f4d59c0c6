"""strique_tpu_torch flank alignment vs the JAX reference.

The port's plain PyTorch wave recurrence and traceback (the CPU twins
of csrc/wave_align.cu and csrc/traceback.cu) against the reference's
wave kernel run in Pallas interpret mode on the CPU, on the same NumPy
inputs, at small shapes (B=8, N=512, M~40).

Tolerances: end columns, traceback outputs, pointer words and the
bottom taps (NEG pattern and live values) are compared exactly.  The
reported scores are held to ``SCORE_ATOL``: the port computes |d|^1.2
as (float)pow((double)d, 1.2f), which differs from XLA's f32
``jnp.power`` by one ulp on ~0.065% of inputs; one such cell moves a
path score by at most one ulp of its term (|term| <= 16 here, ulp
1.9e-6), so 1.2e-4 covers 64 such cells.  On these seeds every f32
value is in fact bit-equal, which the exact tap check pins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.ops import align as JA
from strique_tpu.ops import align_pallas as JP
from strique_tpu.ops.reference import AlignParams
from strique_tpu_torch.convert import align_inputs_from_jax
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)

SCORE_ATOL = 1.2e-4
FIELDS = ("score", "j_end", "is_gap", "jpos", "j_begin")
# reference defaults; affine corners with g = max(ge_v, go_v) != go_v;
# non-negative horizontal gaps (the non-neg_h branch of the kernel)
PARAMS = [
    AlignParams(),
    AlignParams(gap_open_h=-3.0, gap_extension_h=-0.5, gap_open_v=-20.0, gap_extension_v=-4.0),
    AlignParams(gap_open_h=1.0, gap_extension_h=0.5),
]


def _reads(seed, B=8, N=512, M=40):
    rng = np.random.default_rng(seed)
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B // 2):
        st = 50 + i * 60
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    na = rng.integers(300, 500, B).astype(np.int32)
    return signals, na, template


def _assert_align_equal(ref, got, tag=""):
    for k in FIELDS:
        a = np.asarray(ref[k])
        b = got[k].numpy()
        if k == "score":
            np.testing.assert_allclose(b, a, rtol=0, atol=SCORE_ATOL, err_msg=f"{tag} {k}")
        else:
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=f"{tag} {k}")


def _valid_words(na, m_rows, nwords):
    """(ND/8, B) mask of the pointer words each row's walk can read."""
    words = (np.asarray(na, np.int64) + np.asarray(m_rows, np.int64) + 7) // 8
    return np.arange(nwords)[:, None] < words[None, :]


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_wave_batch_matches_jax_interpret(pi):
    p = PARAMS[pi]
    signals, na, template = _reads(100 + pi)
    tp, m = JP.pad_template(template)
    ref = JA._align_batch_wave(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp), p, m)
    got = TA._align_batch_wave(torch.from_numpy(signals), torch.from_numpy(na),
                               torch.from_numpy(tp), p, m)
    _assert_align_equal(ref, got, f"params {p}")


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_wave_pointer_plane_and_bottom_match_jax(pi):
    """Raw forward outputs: every pointer word a walk can read, and every
    bottom tap, exactly."""
    p = PARAMS[pi]
    signals, na, template = _reads(200 + pi)
    tp, m = JP.pad_template(template)
    jptr, jbot = JP.align_forward_wave(jnp.asarray(signals), jnp.asarray(na),
                                       jnp.asarray(tp), p, m)
    ptr, bot = TC.align_forward_wave(torch.from_numpy(signals), torch.from_numpy(na),
                                     torch.from_numpy(tp), p, m)
    jptr, jbot = np.asarray(jptr), np.asarray(jbot)
    assert ptr.shape == jptr.shape and bot.shape == jbot.shape
    mask = _valid_words(na, np.full(len(na), m), jptr.shape[0])
    np.testing.assert_array_equal(ptr.numpy()[mask], jptr[mask])
    np.testing.assert_array_equal(bot.numpy(), jbot)


def test_traceback_on_jax_pointer_plane():
    """The port's traceback walks a pointer plane the JAX kernel wrote
    to the same tracebacks as the reference's own walk."""
    p = AlignParams()
    signals, na, template = _reads(300)
    tp, m = JP.pad_template(template)
    ref = JA._align_batch_wave(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp), p, m)
    jptr, _ = JP.align_forward_wave(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp), p, m)
    tb = TA.traceback_pointers(torch.from_numpy(np.array(jptr)),
                               torch.from_numpy(np.array(ref["j_end"])), m)
    for k in ("is_gap", "jpos", "j_begin"):
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("pi", [0, 2])
def test_wave_multi_matches_jax_interpret(pi):
    """Per-row templates of unequal length (flank fusion), through the
    convert.py crossing: the same rows, lengths and params on both sides."""
    p = PARAMS[pi]
    rng = np.random.default_rng(400 + pi)
    B, N = 8, 512
    t_pre = rng.uniform(60, 120, 40).astype(np.float32)
    t_suf = rng.uniform(60, 120, 28).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = 40 + i * 50
        signals[i, st : st + 40] = t_pre + rng.normal(0, 0.5, 40)
        signals[i, st + 60 : st + 88] = t_suf + rng.normal(0, 0.5, 28)
    na = rng.integers(400, 500, B).astype(np.int32)
    rows, ms = JP.pad_template_rows([t_pre, t_suf])
    tmpl_rows = np.concatenate([np.repeat(rows[0:1], B // 2, 0), np.repeat(rows[1:2], B // 2, 0)])
    m_rows = np.concatenate([np.full(B // 2, ms[0]), np.full(B // 2, ms[1])]).astype(np.int32)
    ref = JA._align_batch_wave_multi(jnp.asarray(signals), jnp.asarray(na),
                                     jnp.asarray(tmpl_rows), jnp.asarray(m_rows), p, int(ms.max()))
    t_t, m_t, p_t = align_inputs_from_jax(tmpl_rows, m_rows, p)
    got = TA._align_batch_wave_multi(torch.from_numpy(signals), torch.from_numpy(na),
                                     t_t, m_t, p_t, int(ms.max()))
    _assert_align_equal(ref, got, "multi")


def test_fused_pair_matches_two_core_calls():
    """The fusion rule picks the per-row-template route for a partial
    batch; its outputs equal two single-template align_core calls."""
    rng = np.random.default_rng(17)
    B, N = 8, 512
    p = AlignParams()
    t_pre = rng.uniform(60, 120, 40).astype(np.float32)
    t_suf = rng.uniform(60, 120, 28).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = 40 + i * 50
        signals[i, st : st + 40] = t_pre + rng.normal(0, 0.5, 40)
        signals[i, st + 60 : st + 88] = t_suf + rng.normal(0, 0.5, 28)
    na = torch.from_numpy(rng.integers(400, 500, B).astype(np.int32))
    sig = torch.from_numpy(signals)
    stats0 = TA.kernel_stats()["calls"]
    pre, suf = TA.align_fused_pair(sig, na, t_pre, t_suf, p)
    assert TA.kernel_stats()["calls"] - stats0 == 1  # one fused call for both flanks
    pre2 = TA.align_core(sig, na, t_pre, p)
    suf2 = TA.align_core(sig, na, t_suf, p)
    for a, b in ((pre, pre2), (suf, suf2)):
        for k in FIELDS:
            assert torch.equal(a[k], b[k]), k


def test_kernel_batch_and_budget(monkeypatch):
    """Call widths, and the route past the pointer budget: the two-pass
    calls (one pass 1, one pass 2 per 8-row group), or a ValueError
    where no span bound exists."""
    assert TC.kernel_batch(8, device="cpu") == 8
    assert TC.kernel_batch(200, device="cpu") == TC.BATCH_WAVE
    signals = torch.zeros((8, 512))
    n = torch.full((8,), 500, dtype=torch.int32)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    stats = TA.kernel_stats()
    out = TA.align_core(signals, n, np.ones(40, np.float32), AlignParams())
    assert TA.kernel_stats()["calls"] - stats["calls"] == 2
    assert out["jpos"].shape == (8, 40)
    with pytest.raises(ValueError, match="negative horizontal gap"):
        TA.align_core(signals, n, np.ones(40, np.float32), PARAMS[2])


def test_pad_template_helpers_match_reference():
    rng = np.random.default_rng(3)
    t = rng.uniform(60, 120, 130).astype(np.float32)
    u = rng.uniform(60, 120, 20).astype(np.float32)
    for a, b in zip(TC.pad_template(t), JP.pad_template(t)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(TC.pad_template_rows([t, u]), JP.pad_template_rows([t, u])):
        np.testing.assert_array_equal(a, b)


def _corner_params():
    from tests.test_fuzz_params import _sample_params

    return _sample_params(np.random.default_rng(0), n_random=0)


@pytest.mark.parametrize("ci", range(14))
def test_wave_param_corners_match_jax_scan(ci):
    """The explicit AlignParams corners of the reference's fuzz sweep
    (positive, free and steep gaps, dist_min floors): the port's plain
    path against the reference's XLA scan kernel, itself pinned
    bit-identical to the Pallas wave kernel by tests/test_fuzz_params.py."""
    from tests.test_fuzz_params import _fuzz_reads

    params = _corner_params()
    assert len(params) == 14
    p = params[ci]
    signals, na, template = _fuzz_reads(np.random.default_rng(600 + ci), 8, 256, 20)
    ref = JA.align_batch(signals, na, template, p, impl="xla")
    got = TA.align_core(torch.from_numpy(signals), torch.from_numpy(na), template, p)
    _assert_align_equal(ref, got, f"corner {ci} {p}")
