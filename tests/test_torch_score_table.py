"""strique_tpu_torch morph-form wave alignment (TABLE score mode) vs the JAX reference.

The wave kernel's TABLE score mode reads each cell's score from a
per-row table of U template levels x 258 signal values (the read's 256
morph levels, NEG before the read, 0.0 past the padded end).  Its plain
twin (``_wave_table_plain``, the CPU side of csrc/wave_align.cu's TABLE
mode) reads that table too, so these tests hold the table's indexing
against the reference's wave kernel in Pallas interpret mode: the reads
are made as u8 bins plus a per-read 256-level table, templates as
``np.repeat(levels, 6)`` (how the counter builds them), and the JAX
side gets the decoded ``lut[bins]``.  Also pinned: ``template_levels``,
``score_table`` against an independent NumPy evaluation of every
(level, bin) pair and against the recurrence's own POW-mode scores, the
TABLE/POW rule at the shared-memory cap and past 1024 lanes, and the card's call-width and
fusion rules with an explicit SM count.

Tolerances: pointer words a walk can read, bottom taps, end columns and
tracebacks exactly; scores within ``SCORE_ATOL`` (1.2e-4, the
pow-rounding bound of ROADMAP Queue 3; see tests/test_torch_align.py).
The exact tap check holds on these seeds; on some others (820 and 836
of the per-row reads) two taps differ by one ulp, the measured
difference of XLA's f32 ``jnp.power`` from the correctly rounded pow
that both port modes evaluate (Queue 3).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.ops import align as JA
from strique_tpu.ops import align_pallas as JP
from strique_tpu_torch import _build
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.synthetic import quantise
from tests.test_torch_align import FIELDS, PARAMS, _assert_align_equal, _valid_words

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)

B, N = 8, 512


def _morph_reads(seed, B=B, N=N):
    """u8 bins, (B, 256) level tables, lengths and two samples=6 templates
    (42 and 30 samples) planted in every read.  Row 0 runs to the padded
    end (n = N), so its lanes read the 0.0 past it; every lane reads NEG
    before the read."""
    rng = np.random.default_rng(seed)
    t_pre = np.repeat(rng.uniform(60, 120, 7), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 5), 6).astype(np.float32)
    lo = rng.uniform(40, 60, B)
    hi = rng.uniform(130, 150, B)
    sig = rng.uniform(60, 120, (B, N))
    for i in range(B):
        st = 40 + i * 50
        sig[i, st : st + 42] = t_pre + rng.normal(0, 0.5, 42)
        sig[i, st + 60 : st + 90] = t_suf + rng.normal(0, 0.5, 30)
    bins, lut = quantise(sig, rng, lo, hi)
    na = rng.integers(400, N, B).astype(np.int32)
    na[0] = N
    return bins, lut, na, t_pre, t_suf


def _decoded(bins, lut):
    return np.take_along_axis(lut, bins.astype(np.int64), axis=1)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _shared(t_pre):
    tp, m = TC.pad_template(t_pre)
    levels, lidx = TC.template_levels(tp)
    return tp, m, levels, lidx


def _per_row(t_pre, t_suf):
    rows, ms = TC.pad_template_rows([t_pre, t_suf])
    tmpl = np.repeat(rows, B // 2, axis=0)
    m_rows = np.repeat(ms, B // 2).astype(np.int32)
    levels, lidx = TC.template_levels(tmpl)
    return tmpl, m_rows, levels, lidx


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_morph_wave_planes_match_jax_interpret(pi):
    """Raw forward outputs of the morph form (shared template): every
    pointer word a walk can read, and every bottom tap, exactly."""
    p = PARAMS[pi]
    bins, lut, na, t_pre, _ = _morph_reads(800 + pi)
    tp, m, levels, lidx = _shared(t_pre)
    jptr, jbot = JP.align_forward_wave(jnp.asarray(_decoded(bins, lut)), jnp.asarray(na),
                                       jnp.asarray(tp), p, m)
    ptr, bot = TC.align_forward_wave_morph(*_t(bins, lut, na, levels, lidx), p, m)
    jptr, jbot = np.asarray(jptr), np.asarray(jbot)
    assert ptr.shape == jptr.shape and bot.shape == jbot.shape
    mask = _valid_words(na, np.full(B, m), jptr.shape[0])
    np.testing.assert_array_equal(ptr.numpy()[mask], jptr[mask])
    np.testing.assert_array_equal(bot.numpy(), jbot)


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_morph_wave_batch_matches_jax_interpret(pi):
    """Scores, end columns and tracebacks of the morph form through
    align_core's batch step, against the reference's on lut[bins]."""
    p = PARAMS[pi]
    bins, lut, na, t_pre, _ = _morph_reads(810 + pi)
    tp, m, levels, lidx = _shared(t_pre)
    ref = JA._align_batch_wave(jnp.asarray(_decoded(bins, lut)), jnp.asarray(na),
                               jnp.asarray(tp), p, m)
    b_t, l_t, n_t, lv_t, li_t = _t(bins, lut, na, levels, lidx)
    got = TA._align_batch_wave_morph(b_t, l_t, n_t, lv_t, li_t, p, m)
    _assert_align_equal(ref, got, f"params {p}")


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_morph_wave_multi_matches_jax_interpret(pi):
    """Per-row templates (flank fusion: the two flanks' levels differ):
    pointer plane, bottom taps and the align outputs against the
    reference's wave_multi on lut[bins]."""
    p = PARAMS[pi]
    bins, lut, na, t_pre, t_suf = _morph_reads(823 + pi)
    tmpl, m_rows, levels, lidx = _per_row(t_pre, t_suf)
    assert levels.shape[0] == B and not np.array_equal(levels[0], levels[-1])
    sig = jnp.asarray(_decoded(bins, lut))
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
    _assert_align_equal(ref, got, "multi")


@pytest.mark.parametrize("per_row", [False, True])
def test_table_scores_equal_pow_scores_every_step(per_row):
    """The twin's table lookup gives the recurrence's own POW-mode score
    at every step and lane, sentinel bins (256 before the read, 257 past
    the padded end) included."""
    p = PARAMS[1]
    bins, lut, na, t_pre, t_suf = _morph_reads(830)
    if per_row:
        tmpl, m_rows, levels, lidx = _per_row(t_pre, t_suf)
    else:
        tmpl, m, levels, lidx = _shared(t_pre)
        m_rows = np.full(B, m, np.int32)
    b_t, l_t, lv_t, li_t, tm_t = _t(bins, lut, levels, lidx, tmpl)
    mp = tmpl.shape[1]
    table = TC._table_scores(b_t, l_t, lv_t, li_t, p)
    pow_ = TC._pow_scores(TC._signal_ext(TC.morph_decode(b_t, l_t), mp), tm_t, p)
    t_run = TC._steps_to_run(torch.from_numpy(na), torch.from_numpy(m_rows), N + mp)
    # lanes i > t read before the read (bin 256); row 0 (n = N) runs
    # round_up(N + m, 8) steps, so its lane 0 reads past the padded end
    # (bin 257) from step N on
    assert t_run > N
    for t in range(t_run):
        assert torch.equal(table(t), pow_(t)), t


@pytest.mark.parametrize("mode", ["ckpt", "window"])
def test_two_pass_table_scores_equal_pow_scores_every_step(mode):
    """Rows 5-6's table lookups against the POW scores of the f32 route,
    at every step and lane.  ckpt: ND = NB + MP + 256 steps over the
    bins row, where the f32 row is padded with 0.0 (bin 257 past the
    row).  window: lane i at local step t reads sample t0 + t - i, 0.0 on
    both sides of the read (the f32 window's gather fill), on a cold row
    (t0 = 0), rows near the end and past the row's end."""
    p = PARAMS[1]
    bins, lut, _, t_pre, t_suf = _morph_reads(831)
    tmpl, _, levels, lidx = _per_row(t_pre, t_suf)
    b_t, l_t, lv_t, li_t, tm_t = _t(bins, lut, levels, lidx, tmpl)
    mp = tmpl.shape[1]
    dec = TC.morph_decode(b_t, l_t)
    if mode == "ckpt":
        nd = N + mp + 256
        table = TC._table_scores(b_t, l_t, lv_t, li_t, p, nd)
        pow_ = TC._pow_scores(TC._signal_ext(torch.nn.functional.pad(dec, (0, 256)), mp), tm_t,
                              p)
    else:
        nd = 384
        t0 = torch.tensor([0, 0, 128, 256, 384, 384, 512, 128])
        table = TC._table_scores(b_t, l_t, lv_t, li_t, p, nd, t0)
        sig_win, r_init = TA._gather_windows(dec, t0, nd, mp)
        pow_ = TC._pow_scores(torch.cat([torch.flip(r_init, dims=[1]), sig_win], dim=1), tm_t, p)
    for t in range(nd):
        assert torch.equal(table(t), pow_(t)), t


@pytest.mark.parametrize("per_row", [False, True])
def test_template_levels_reconstruct_every_lane(per_row):
    _, _, _, t_pre, t_suf = _morph_reads(840)
    if per_row:
        tmpl, _, levels, lidx = _per_row(t_pre, t_suf)
    else:
        tmpl, _, levels, lidx = _shared(t_pre)
    assert levels.dtype == np.float32 and lidx.dtype == np.int32
    assert levels.shape[0] == lidx.shape[0] == tmpl.shape[0] and lidx.shape == tmpl.shape
    np.testing.assert_array_equal(np.take_along_axis(levels, lidx.astype(np.int64), 1), tmpl)
    for r in range(tmpl.shape[0]):
        u = np.unique(tmpl[r])
        assert np.float32(1e30) in u  # lane 0 and the pad lanes
        np.testing.assert_array_equal(levels[r, : len(u)], u)
        assert (levels[r, len(u) :] == np.float32(1e30)).all()
    # samples=6 templates: 7 (and 5) levels plus the pad
    assert levels.shape[1] == 8


@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_score_table_matches_numpy_every_pair(pi):
    """Every (level, bin) entry against an independent NumPy evaluation
    of the kernel's expression: f32 |x - level|, pow in f64 with the f32
    exponent 1.2, rounded to f32, then max(off - pw, dmin) in f32."""
    p = PARAMS[pi]
    bins, lut, _, t_pre, t_suf = _morph_reads(850 + pi)
    for levels in (_shared(t_pre)[2], _per_row(t_pre, t_suf)[2]):
        got = TC.score_table(*_t(lut, levels), p).numpy()
        assert got.shape == (B, levels.shape[1], 258)
        x = np.concatenate([lut, np.full((B, 1), -1e30, np.float32),
                            np.zeros((B, 1), np.float32)], axis=1)
        diff = np.abs(x[:, None, :] - levels[:, :, None]).astype(np.float32)
        pw = np.power(diff.astype(np.float64), np.float64(np.float32(1.2))).astype(np.float32)
        want = np.maximum(np.float32(p.dist_offset) - pw, np.float32(p.dist_min))
        np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("mp", [256, 896, 2176])
def test_score_mode_rule_at_the_cap(mp, monkeypatch):
    """TABLE up to the shared-memory cap (the table behind the four
    (MP + 1)-float exchange buffers) at MP <= 1024, POW one level past
    it, and POW at any level count past 1024 lanes; the CPU wrapper runs
    the chosen mode's twin, and both give the table twin's planes."""
    if mp <= TC.TABLE_MAX_MP:
        cap = (TC.SMEM_BYTES // 4 - 4 * (mp + 1)) // TC.SCORE_COLS
        assert cap == {256: 221, 896: 211}[mp]
        assert 4 * (4 * (mp + 1) + cap * 258) <= 232448 < 4 * (4 * (mp + 1) + (cap + 1) * 258)
        cases = ((cap, "table"), (cap + 1, "pow"))
    else:
        cases = ((9, "pow"),)
    for n_lv, mode in cases:
        assert TC.wave_score_mode(n_lv, mp) == mode
    called = []
    real_table, real_pow = TC._wave_table_plain, TC._wave_plain
    monkeypatch.setattr(TC, "_wave_table_plain",
                        lambda *a: called.append("table") or real_table(*a))
    monkeypatch.setattr(TC, "_wave_plain", lambda *a: called.append("pow") or real_pow(*a))
    rng = np.random.default_rng(860)
    bins, lut, na, _, _ = _morph_reads(861)
    na = np.minimum(na, 200).astype(np.int32)
    for n_lv, _ in cases:
        # n_lv - 1 distinct values (the +1e30 pad is a level too), m = MP - 1
        vals = np.linspace(60, 120, n_lv - 1).astype(np.float32)
        tp, m = TC.pad_template(rng.permutation(np.resize(vals, mp - 1)))
        levels, lidx = TC.template_levels(tp)
        assert tp.shape[1] == mp and levels.shape[1] == n_lv
        out = TC.align_forward_wave_morph(*_t(bins, lut, na, levels, lidx), PARAMS[0], m)
        ref = real_table(*_t(bins, lut, levels, lidx, na), torch.full((B,), m), PARAMS[0])
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert called == [mode for _, mode in cases]


def test_kernel_batch_card_rule():
    """A call is as wide as its rows (rounded up to 8), up to the largest
    multiple of 8 within the SM count; the CPU rule keeps 64."""
    assert TC.kernel_batch(200, device="cpu", sms=132) == 128
    assert TC.kernel_batch(128, device="cpu", sms=132) == 128
    assert TC.kernel_batch(48, device="cpu", sms=132) == 48
    assert TC.kernel_batch(3, device="cpu", sms=132) == 8
    assert TC.kernel_batch(130, device="cpu", sms=100) == 96
    assert TC.kernel_batch(None, device="cpu", sms=132) == 128
    assert TC.kernel_batch(200, device="cpu") == TC.BATCH_WAVE == 64
    assert TC.kernel_batch(48, device="cpu") == 48
    # the pointer budget still narrows a call: ND x kb x MP / 2 bytes
    nd, mp = 25472, 896
    assert TC.kernel_batch(128, n_cols=nd, mp=mp, device="cpu", sms=132) == 128
    assert (TC.kernel_batch(128, n_cols=nd * 64, mp=mp, device="cpu", sms=132)
            < 128)


def test_fuse_flanks_rules(monkeypatch):
    """Card rule: fuse whenever the 2B rows fit one call; reference rule
    (CPU, or STRIQUE_ALIGN_KERNEL=col): a partial batch's tail of at most
    half a 64-row call; never past the width-8 pointer budget."""
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    assert TA.fuse_flanks(64, 24576, 896, "cpu", sms=132)
    assert TA.fuse_flanks(24, 24576, 896, "cpu", sms=132)
    assert not TA.fuse_flanks(72, 24576, 896, "cpu", sms=132)
    assert not TA.fuse_flanks(64, 24576, 896, "cpu")
    assert TA.fuse_flanks(24, 24576, 896, "cpu")
    assert not TA.fuse_flanks(48, 24576, 896, "cpu")
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    assert not TA.fuse_flanks(64, 24576, 896, "cpu", sms=132)
    assert TA.fuse_flanks(24, 24576, 896, "cpu", sms=132)
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL")
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    assert not TA.fuse_flanks(24, 24576, 896, "cpu", sms=132)
    assert not TA.fuse_flanks(24, 24576, 896, "cpu")


def _batch_reads(Bn, seed):
    rng = np.random.default_rng(seed)
    t_pre = np.repeat(rng.uniform(60, 120, 5), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 4), 6).astype(np.float32)
    lut = np.sort(rng.uniform(50, 130, (Bn, 256)), axis=1).astype(np.float32)
    bins = rng.integers(0, 256, (Bn, 256)).astype(np.uint8)
    na = rng.integers(150, 257, Bn).astype(np.int32)
    return bins, lut, na, t_pre, t_suf


@pytest.mark.parametrize("card", [False, True])
def test_fused_pair_width_rule_on_a_full_batch(card, monkeypatch):
    """64 reads: on the card's rule (132 SMs) both flanks run as ONE
    128-row call; on the CPU rule as two 64-row align_core calls.  The
    outputs are the same either way, and equal the f32 route's."""
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    if card:
        monkeypatch.setattr(TC, "sm_count", lambda device: 132)
        monkeypatch.setattr(TA, "sm_count", lambda device: 132)
    bins, lut, na, t_pre, t_suf = _batch_reads(64, 870)
    b_t, l_t, n_t = _t(bins, lut, na)
    calls0 = TA.kernel_stats()["calls"]
    cells0 = TA.kernel_stats()["cells"]
    pre, suf = TA.align_fused_pair(b_t, n_t, t_pre, t_suf, PARAMS[0], lut=l_t)
    calls = TA.kernel_stats()["calls"] - calls0
    rows = (TA.kernel_stats()["cells"] - cells0) // ((256 + 128) * 128)
    assert (calls, rows) == ((1, 128) if card else (2, 128))
    pre_f, suf_f = TA.align_fused_pair(TC.morph_decode(b_t, l_t), n_t, t_pre, t_suf, PARAMS[0])
    for a, b in ((pre, pre_f), (suf, suf_f)):
        for k in FIELDS:
            assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("route", ["col", "two_pass"])
def test_morph_core_routes_decode_to_f32(route, monkeypatch):
    """align_core on morph input under STRIQUE_ALIGN_KERNEL=col keeps the
    bins and runs the column kernel's TABLE twin; past the pointer budget
    (two-pass) it keeps them and runs the TABLE twins of rows 5-6 (the
    template fits both score tables).  Neither decodes lut[bins], and
    either gives the wave route's outputs exactly."""
    bins, lut, na, t_pre, _ = _morph_reads(880)
    b_t, l_t, n_t = _t(bins, lut, na)
    wave = TA.align_core(b_t, n_t, t_pre, PARAMS[0], lut=l_t)
    if route == "col":
        monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    else:
        monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    ran = []
    monkeypatch.setattr(TA, "morph_decode", lambda *a: ran.append("decode") or TC.morph_decode(*a))
    for name in ("_ckpt_table_plain", "_window_table_plain", "_col_table_plain"):
        real = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _n=name, _f=real: ran.append(_n) or _f(*a))
    _build.reset_launches()
    got = TA.align_core(b_t, n_t, t_pre, PARAMS[0], lut=l_t)
    assert ran == (["_col_table_plain"] if route == "col"
                   else ["_ckpt_table_plain", "_window_table_plain"])
    for k in FIELDS:
        assert torch.equal(wave[k], got[k]), k
    with pytest.raises(ValueError, match="multiple of 128"):
        TA.align_core(b_t[:, :500], n_t, t_pre, PARAMS[0], lut=l_t)
