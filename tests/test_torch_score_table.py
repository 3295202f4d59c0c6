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
from strique_tpu_torch.ops.reference import AlignParams
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
    """TABLE on one CTA up to the shared-memory cap (the table behind the
    four (MP + 1)-float exchange buffers) at MP <= 1024, POW one level
    past it in the one-CTA form; past 1024 lanes one CTA runs POW at any
    level count, and the template's rule gives 2 CTAs a row: its split
    form runs the TABLE mode on that cluster.  The CPU wrapper runs the
    chosen mode's twin, and each gives the one-CTA table twin's planes."""
    if mp <= TC.TABLE_MAX_MP:
        cap = (TC.SMEM_BYTES // 4 - 4 * (mp + 1)) // TC.SCORE_COLS
        assert cap == {256: 221, 896: 211}[mp]
        assert 4 * (4 * (mp + 1) + cap * 258) <= 232448 < 4 * (4 * (mp + 1) + (cap + 1) * 258)
        cases = ((cap, "table"), (cap + 1, "pow"))
    else:
        assert TC.wave_score_mode(9, mp) == "pow"
        cases = ((9, "cluster"),)
    for n_lv, mode in cases:
        if mode == "cluster":
            assert TC.wave_score_mode(n_lv, mp, 2) == "table"
        else:
            assert TC.wave_score_mode(n_lv, mp) == mode
    called = []
    real_table, real_pow = TC._wave_table_plain, TC._wave_plain
    monkeypatch.setattr(TC, "_wave_table_plain",
                        lambda *a: called.append("table") or real_table(*a))
    monkeypatch.setattr(TC, "_wave_plain", lambda *a: called.append("pow") or real_pow(*a))
    rng = np.random.default_rng(860)
    bins, lut, na, _, _ = _morph_reads(861)
    na = np.minimum(na, 200).astype(np.int32)
    for n_lv, mode in cases:
        # n_lv - 1 distinct values (the +1e30 pad is a level too), m = MP - 1
        vals = np.linspace(60, 120, n_lv - 1).astype(np.float32)
        tp, m = TC.pad_template(rng.permutation(np.resize(vals, mp - 1)))
        levels, lidx = TC.template_levels(tp)
        assert tp.shape[1] == mp and levels.shape[1] == n_lv
        ref = real_table(*_t(bins, lut, levels, lidx, na), torch.full((B,), m), PARAMS[0])
        if mode == "cluster":
            assert TC.wave_table_ctas(tp) == 2
            levels, lidx = TC.template_levels(tp, 2)
            assert levels.shape == (1, 2, n_lv)  # every CTA's lanes hold every value
        out = TC.align_forward_wave_morph(*_t(bins, lut, na, levels, lidx), PARAMS[0], m)
        assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert called == ["table" if mode == "cluster" else mode for _, mode in cases]


def _cycled_template(mp: int, n_vals: int, seed: int):
    """A (1, MP) template filling every lane but lane 0 with ``n_vals``
    values cycled in a shuffled order: every CTA of any split sees all of
    them, so each CTA's level count is n_vals (+1 in CTA 0, the +1e30 of
    lane 0)."""
    vals = np.random.default_rng(seed).permutation(np.linspace(60, 120, n_vals))
    tp, _ = TC.pad_template(np.resize(vals, mp - 1).astype(np.float32))
    assert tp.shape[1] == mp
    return tp


@pytest.mark.parametrize("mp", [1152, 2176, 4096])
def test_cluster_rule_at_each_cap(mp):
    """The CTAs a row of the wave and column kernels' TABLE mode past one
    CTA: the fewest CTAs (of the splits the kernels take: 2 to 8 CTAs of
    at most 2048 lanes, none empty) whose per-CTA tables fit.  Wave: a
    CTA's exchange buffers shrink with its lanes, so each split has a
    larger cap; at each split's cap the rule gives that split, one level
    more the next split, and past the last one (at most 8 CTAs) POW.
    Column: one cap (218 levels a CTA) for every split; a template whose
    every CTA holds more runs POW, and one whose levels spread over its
    lanes takes the fewest CTAs that bring each CTA's share under it."""
    for ctas_of, mode, ring, exch in (
            (TC.wave_table_ctas, TC.wave_score_mode, TC.WAVE_RING_BYTES, None),
            (TC.col_table_ctas, TC.col_score_mode, TC.COL_RING_BYTES, 0)):
        splits = [c for c in range(2, 9) if TC._split_ok(mp, c)]
        assert splits and splits[-1] <= TC.MAX_CTAS
        caps = []
        for c in splits:
            mpc = TC.cta_lanes(mp, c)
            assert mpc % 128 == 0 and mpc <= 2048 and (c - 1) * mpc < mp <= c * mpc
            fixed = 4 * (mpc + 1) if exch is None else exch
            cap = ((TC.SMEM_BYTES - ring) // 4 - fixed) // TC.SCORE_COLS
            assert mode(cap, mp, c) == "table" and mode(cap + 1, mp, c) == "pow"
            caps.append(cap)
        assert mode(caps[0], mp) == "pow"  # one CTA never past 1024 lanes
        if exch is None:
            assert caps == sorted(set(caps))  # fewer lanes a CTA: a larger cap
            for k, (c, cap) in enumerate(zip(splits, caps)):
                # cap levels a CTA: cap - 1 values and lane 0's +1e30
                assert ctas_of(_cycled_template(mp, cap - 1, mp + c)) == c
                nxt = splits[k + 1] if k + 1 < len(splits) else 0
                assert ctas_of(_cycled_template(mp, cap, mp + c)) == nxt
        else:
            assert set(caps) == {218}
            assert ctas_of(_cycled_template(mp, 217, mp)) == 2
            assert ctas_of(_cycled_template(mp, 218, mp)) == 0
            # distinct values in runs of 4 lanes: MPC / 4 levels a CTA (+1)
            for c, cap in zip(splits, caps):
                mpc = TC.cta_lanes(mp, c)
                runs = np.repeat(np.linspace(60, 120, mp // 4), 4)[: mp - 1]
                tp, _ = TC.pad_template(runs.astype(np.float32))
                want = next(k for k in splits if TC.cta_lanes(mp, k) // 4 + 1 <= cap)
                if mpc // 4 + 1 <= cap:
                    assert ctas_of(tp) == want
    # pinned: two CTAs of 1152 lanes at MP 2176 (phase 4e's template)
    assert TC.cta_lanes(2176, 2) == 1152
    assert TC.wave_score_mode(206, 2176, 2) == "table" != TC.wave_score_mode(207, 2176, 2)
    assert TC.col_score_mode(218, 2176, 2) == "table" != TC.col_score_mode(219, 2176, 2)
    assert not TC._split_ok(2176, 7) and not TC._split_ok(8320, 8)


@pytest.mark.parametrize("per_row", [False, True])
@pytest.mark.parametrize("ctas", [2, 3, 4, 5, 8])
def test_template_levels_split_form_rebuilds_every_lane(per_row, ctas):
    """The split form: each CTA's sorted distinct values over its own
    lanes (+1e30 padded to the largest count), each lane's index into its
    CTA's values, and the twins' flattened form, every lane rebuilt."""
    rng = np.random.default_rng(845 + per_row)
    t_pre = np.repeat(rng.uniform(60, 120, 362), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 300), 6).astype(np.float32)
    if per_row:
        rows, _ = TC.pad_template_rows([t_pre, t_suf])
        tmpl = np.repeat(rows, [3, 5], axis=0)
    else:
        tmpl, _ = TC.pad_template(t_pre)
    mp = tmpl.shape[1]
    mpc = TC.cta_lanes(mp, ctas)
    levels, lidx = TC.template_levels(tmpl, ctas)
    assert levels.dtype == np.float32 and lidx.dtype == np.int32
    assert levels.shape[:2] == (tmpl.shape[0], ctas) and lidx.shape == tmpl.shape
    rank = np.arange(mp) // mpc
    rows_i = np.arange(tmpl.shape[0])[:, None]
    np.testing.assert_array_equal(levels[rows_i, rank[None, :], lidx], tmpl)
    for r in range(tmpl.shape[0]):
        for k in range(ctas):
            u = np.unique(tmpl[r, k * mpc : (k + 1) * mpc])
            np.testing.assert_array_equal(levels[r, k, : len(u)], u)
            assert (levels[r, k, len(u) :] == np.float32(1e30)).all()
    assert levels.shape[2] < TC.template_levels(tmpl)[0].shape[1]  # a CTA holds fewer
    flat_lv, flat_li = TC.flat_levels(*_t(levels, lidx))
    assert flat_lv.shape == (tmpl.shape[0], ctas * levels.shape[2])
    np.testing.assert_array_equal(flat_lv.gather(1, flat_li.long()).numpy(), tmpl)


@pytest.mark.parametrize("ctas", [1, 2, 3, 8])
def test_call_widths_count_ctas(ctas):
    """On the card's rule a call's rows times its CTAs a row fit the SM
    count (132 on an H100): 128 rows of one CTA, 64 of two, 40 of three,
    16 of eight; the pointer budget still narrows a call; two-pass groups
    and flank fusion follow the same widths."""
    want = {1: 128, 2: 64, 3: 40, 8: 16}[ctas]
    assert TC.kernel_batch(200, device="cpu", sms=132, ctas=ctas) == want
    assert want * ctas <= 132
    assert TC.kernel_batch(12, device="cpu", sms=132, ctas=ctas) == 16
    assert TC.kernel_batch(200, device="cpu", ctas=ctas) == TC.BATCH_WAVE  # CPU rule
    assert TC.kernel_batch(200, n_cols=2432 * 64, mp=2176, device="cpu", sms=132,
                           ctas=ctas) == min(want, 16)
    w, mp = 6016, 2176
    assert TA.two_pass_group(200, mp, w, "cpu", sms=132, ctas=ctas) == want
    assert TA.two_pass_group(200, mp, w, "cpu", ctas=ctas) == 8  # CPU rule
    rows = np.zeros((2, mp), np.float32)  # flank rows whose tables fit any CTA count
    assert TA.fuse_flanks(want // 2, 4096, rows, "cpu", sms=132, ctas=ctas)
    assert not TA.fuse_flanks(want // 2 + 8, 4096, rows, "cpu", sms=132, ctas=ctas)


def _overcap_batch(seed, mp=1152):
    """Morph reads and a samples=6 template padding to ``mp`` lanes (past
    one CTA), a slice of it planted in every read."""
    rng = np.random.default_rng(seed)
    template = np.repeat(rng.uniform(60, 120, (mp - 2) // 6), 6).astype(np.float32)
    lut = np.sort(rng.uniform(50, 130, (B, 256)), axis=1).astype(np.float32)
    sig = rng.uniform(60, 120, (B, N))
    for i in range(B):
        sig[i, 40 + 20 * i : 160 + 20 * i] = template[300:420] + rng.normal(0, 0.5, 120)
    bins = np.abs(sig[:, :, None] - lut[:, None, :]).argmin(axis=2).astype(np.uint8)
    na = rng.integers(300, N + 1, B).astype(np.int32)
    return bins, lut, na, template


@pytest.mark.parametrize("route", ["wave", "two_pass", "col"])
def test_overcap_morph_core_keeps_bins(route, monkeypatch):
    """align_core on morph input past one CTA's table (MP 1152) keeps its
    bins on every route: the wave and column routes' split-form twins
    (the clusters' TABLE mode) and, past the pointer budget, rows 5-6's;
    nothing decodes lut[bins], and the outputs equal the f32 route's
    (POW) exactly."""
    bins, lut, na, template = _overcap_batch(885)
    tp, _ = TC.pad_template(template)
    assert tp.shape[1] == 1152 and TC.wave_table_ctas(tp) == TC.col_table_ctas(tp) == 2
    b_t, l_t, n_t = _t(bins, lut, na)
    p = AlignParams(gap_open_h=-16.0, gap_extension_h=-16.0, gap_open_v=-0.5,
                    gap_extension_v=-0.5)  # steep h gaps: a short two-pass window
    if route == "col":
        monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    elif route == "two_pass":
        monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    ref = TA.align_core(TC.morph_decode(b_t, l_t), n_t, template, p)
    ran = []
    monkeypatch.setattr(TA, "morph_decode", lambda *a: ran.append("decode") or TC.morph_decode(*a))
    for name in ("_wave_table_plain", "_ckpt_table_plain", "_window_table_plain",
                 "_col_table_plain", "flat_levels"):
        real = getattr(TC, name)
        monkeypatch.setattr(TC, name, lambda *a, _n=name, _f=real: ran.append(_n) or _f(*a))
    got = TA.align_core(b_t, n_t, template, p, lut=l_t)
    assert ran == {"wave": ["flat_levels", "_wave_table_plain"],
                   "col": ["flat_levels", "_col_table_plain"],
                   "two_pass": ["flat_levels", "_ckpt_table_plain", "flat_levels",
                                "_window_table_plain"]}[route]
    for k in FIELDS:
        assert torch.equal(ref[k], got[k]), k


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
    """Card rule: fuse whenever the launch plan takes the 2B rows in one
    call; reference rule (CPU, or STRIQUE_ALIGN_KERNEL=col): a partial
    batch's tail of at most half a 64-row call; never past the width-8
    pointer budget."""
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    rows = np.zeros((2, 896), np.float32)
    assert TA.fuse_flanks(64, 24576, rows, "cpu", sms=132)
    assert TA.fuse_flanks(24, 24576, rows, "cpu", sms=132)
    assert not TA.fuse_flanks(72, 24576, rows, "cpu", sms=132)
    assert not TA.fuse_flanks(64, 24576, rows, "cpu")
    assert TA.fuse_flanks(24, 24576, rows, "cpu")
    assert not TA.fuse_flanks(48, 24576, rows, "cpu")
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    assert not TA.fuse_flanks(64, 24576, rows, "cpu", sms=132)
    assert TA.fuse_flanks(24, 24576, rows, "cpu", sms=132)
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL")
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    assert not TA.fuse_flanks(24, 24576, rows, "cpu", sms=132)
    assert not TA.fuse_flanks(24, 24576, rows, "cpu")


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
