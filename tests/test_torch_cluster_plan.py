"""The wave kernel's launch plan (``align_cuda.wave_launch_plan``) on the CPU.

The plan gives a wave call its CTAs a row C and its rows: of the CTA
counts from ``wave_table_ctas`` up whose split the kernel takes and
whose per-CTA tables fit, the one whose call set (ceil(rows / width)
calls, each costing its longest row at ``wave_step_us``) is the
shortest, the width a multiple of 8 whose rows x C fit the SM count and
whose pointer plane fits the budget.  These tests hold it as a pure
function of (rows, MP, levels, SMs, budget), hold the CPU rule to the
reference's widths, and run the over-the-cap one-pass and two-pass CPU
routes on the card's rule at each C the plan can pick against the JAX
package's wave kernel in Pallas interpret mode (as
``tests/test_torch_overcap.py`` does).  The wrappers run the table twins
on the CPU, so every C must give the same outputs; scores to SCORE_ATOL
(the port's pow against XLA's, ROADMAP Queue 3), the rest exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.ops import align as JA
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.ops.reference import AlignParams
from strique_tpu_torch.synthetic import quantise
from tests.test_torch_align import FIELDS, SCORE_ATOL

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

SMS = 132  # an H100's streaming multiprocessors
GIB = 1 << 30


def _samples6(rng, n_vals, m):
    """A samples=6 template of ``m`` samples over ``n_vals`` values."""
    return np.repeat(np.resize(rng.uniform(60, 120, n_vals), -(-m // 6)), 6)[:m].astype(
        np.float32)


def _flank_rows(mp, seed=0):
    """Both flanks of a target as (2, MP) template rows, ~``mp`` / 6
    levels each (the counter's samples=6 templates)."""
    rng = np.random.default_rng(seed)
    m = (mp - 2) // 6 * 6
    rows, _ = TC.pad_template_rows([_samples6(rng, m // 6, m), _samples6(rng, m // 6, m - 120)])
    assert rows.shape[1] == mp
    return rows


def _ok_ctas(rows):
    """The CTA counts the plan may give these rows: from the rule's up,
    splits the kernel takes whose per-CTA tables fit."""
    mp = rows.shape[1]
    c_min = TC.wave_table_ctas(rows)
    return [c for c in range(c_min, TC.MAX_CTAS + 1)
            if c == c_min or (TC._split_ok(mp, c) and TC.wave_score_mode(
                TC._cta_level_counts(rows, c), mp, c) == "table")]


CASES = [(rows, mp, n_cols, pass1, budget)
         for mp in (896, 1152, 2176, 4096)
         for rows in (8, 16, 24, 40, 64, 72, 128, 144)
         for n_cols, pass1, budget in ((24576 + mp, None, 60), (30264, 32768, 0.1),
                                       (1310720 + mp, None, 8), (30264, 1310720, 2))]


def _width(rows, mp, n_cols, pass1, c):
    if pass1 is not None:
        return TC.two_pass_group(rows, mp, n_cols, "cpu", SMS, c)
    return TC.kernel_batch(rows, n_cols=n_cols, mp=mp, device="cpu", sms=SMS, ctas=c)


def _calls(rows, tmpl, n_cols, pass1):
    """The plan's call sequence over ``rows`` rows, as a route's loop
    asks it: [(C, rows a call)]."""
    out, left = [], rows
    while left > 0:
        c, kb = TC.wave_launch_plan(left, tmpl, n_cols, "cpu", SMS, pass1_steps=pass1)
        out.append((c, kb))
        left -= kb
    return out


@pytest.mark.parametrize("rows,mp,n_cols,pass1,budget", CASES)
def test_plan_is_the_shortest_call_set_within_the_card(rows, mp, n_cols, pass1, budget,
                                                       monkeypatch):
    """Every call of the plan's sequence: C >= wave_table_ctas, a split
    the kernel takes with tables that fit (one CTA for a template that
    fits one while more than 16 rows are left); the width a multiple of
    8, rows x C within the SMs, the pointer plane within the budget (or
    the 8-row floor).  The sequence covers the rows, and no sequence of
    such calls predicts a shorter wall (each call its steps at its C's
    step: PTR, or a two-pass group's pass 1 and pass 2)."""
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(budget))
    tmpl = _flank_rows(mp)
    c_min = TC.wave_table_ctas(tmpl)
    ok = _ok_ctas(tmpl)

    def allowed(r):
        return [c_min] if c_min == 1 and r * TC.MAX_CTAS > SMS else ok

    def step(c):
        if pass1 is None:
            return n_cols * TC.wave_step_us("ptr", mp, c)
        return pass1 * TC.wave_step_us("ckpt", mp, c) + n_cols * TC.wave_step_us("window", mp, c)

    memo = {0: 0.0}

    def least(r):
        if r not in memo:
            memo[r] = min(step(c) + least(max(r - _width(r, mp, n_cols, pass1, c), 0))
                          for c in allowed(r))
        return memo[r]

    seq, left, wall = _calls(rows, tmpl, n_cols, pass1), rows, 0.0
    for c, kb in seq:
        assert c in allowed(left) and c >= c_min
        assert kb % 8 == 0 and 8 <= kb <= max(8, TC._round_up(left, 8))
        assert kb * c <= SMS
        assert kb == 8 or n_cols * kb * mp // 2 <= budget * GIB
        assert kb == _width(left, mp, n_cols, pass1, c)
        wall += step(c)
        left -= kb
    assert left <= 0
    assert wall == pytest.approx(least(rows), rel=1e-12)


# an H100's clusters at once of 2-7 CTAs a row, one CTA an SM
# (tools/probe_wave_cluster.py, NVIDIA H100 80GB HBM3)
H100_CLUSTERS = {2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 16}


def test_plan_on_the_card_at_phase_4e_and_the_split_path(monkeypatch):
    """The plan with the H100's cluster capacities and step table, at the
    shapes chip_smoke.py drives: phase 4e's 72 '+' rows of one MP 2176
    flank (64 rows on 2 CTAs, then 8 on 6), its 48 fused '-' rows (one
    call on 2 CTAs), its 8-row two-pass groups (6 CTAs), the ultra-long
    routes at MP 896 (one-pass 8 rows on 7 CTAs; the two-pass route's 16
    rows on 4, where 7 CTAs would take two calls of 8), and the split
    path's 128-row calls at MP 896 on one CTA."""
    monkeypatch.setattr(TC, "cluster_capacity", lambda device, c, mpc: H100_CLUSTERS[c])
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "60")
    rng = np.random.default_rng(4)
    flank = TC.pad_template(_samples6(rng, 362, 2172))[0]
    rows = _flank_rows(2176)
    assert TC.wave_table_ctas(flank) == TC.wave_table_ctas(rows) == 2
    assert _calls(72, flank, 28672 + 2176, None) == [(2, 64), (6, 8)]
    assert _calls(48, rows, 28672 + 2176, None) == [(2, 48)]
    assert TA.fuse_flanks(24, 28672, rows, "cpu", sms=SMS)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.1")
    assert _calls(144, rows, 86784, 32768) == [(6, 8)] * 18
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "8")
    bench = _flank_rows(896)
    assert TC.wave_table_ctas(bench) == 1
    assert _calls(8, bench[:1], 1106944 + 896, None) == [(7, 8)]
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "2")
    assert _calls(16, bench, 46080, 1114112) == [(4, 16)]
    assert _calls(32, bench, 46080, 1114112) == [(1, 32)]
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "60")
    assert _calls(128, bench, 24576 + 896, None) == [(1, 128)]
    assert _calls(152, bench, 24576 + 896, None) == [(1, 128), (1, 24)]


@pytest.mark.parametrize("mp", [896, 2176])
@pytest.mark.parametrize("pass1", [None, 32768])
def test_plan_cpu_rule_is_the_references(mp, pass1):
    """Without an SM count (a CPU tensor) the plan keeps the rule's CTAs
    and the reference's widths: 64 rows a call (the remaining rows
    rounded up to 8 when fewer), 8-row two-pass groups."""
    tmpl = _flank_rows(mp)
    for rows in (8, 20, 64, 200):
        c, kb = TC.wave_launch_plan(rows, tmpl, 24576 + mp, "cpu", None, pass1_steps=pass1)
        assert c == TC.wave_table_ctas(tmpl)
        assert kb == (8 if pass1 else min(TC.BATCH_WAVE, TC._round_up(rows, 8)))


def test_plan_pow_keeps_one_cta():
    """A template past every cluster's table (0 CTAs: POW on the decoded
    f32) keeps one CTA a row and kernel_batch's width."""
    rng = np.random.default_rng(3)
    tp, _ = TC.pad_template(rng.uniform(60, 120, 2100).astype(np.float32))
    assert TC.wave_table_ctas(tp) == 0
    assert TC.wave_launch_plan(72, tp, 30000, "cpu", SMS) == (0, 72)


def test_plan_skips_a_split_whose_tables_do_not_fit(monkeypatch):
    """A C the step table prefers is skipped when a CTA of it would hold
    more levels than its table takes: 200 values on each side of lane
    1152 fit 2 CTAs (1152 lanes each) but not CTA 1 of 3 (lanes
    768-1535), which holds both sets."""
    mp = 2176
    rng = np.random.default_rng(8)
    t = np.full(mp - 1, 90.0, np.float32)
    t[767:1151] = np.resize(rng.uniform(60, 80, 200), 384)  # lanes 768..1151
    t[1151:1535] = np.resize(rng.uniform(100, 120, 200), 384)  # lanes 1152..1535
    tp, _ = TC.pad_template(t)
    assert TC.wave_table_ctas(tp) == 2
    assert TC.wave_score_mode(TC._cta_level_counts(tp, 3), mp, 3) == "pow"
    monkeypatch.setattr(TC, "wave_step_us", lambda mode, m, c: 0.1 if c == 3 else 0.3)
    c, _ = TC.wave_launch_plan(8, tp, 30000, "cpu", SMS)
    assert c != 3 and c in _ok_ctas(tp)


def test_step_table_reads_between_and_past_its_points(monkeypatch):
    """wave_step_us: a form's points by lanes a CTA (MP on one CTA, the
    CTA's lanes on a cluster), linear between them, the first value
    below the first (or with one point), the last two's slope past the
    last."""
    for mode in ("ptr", "ckpt", "window"):
        assert TC.WAVE_STEP_US[mode]["one"] and TC.WAVE_STEP_US[mode]["cluster"]
    table = {"ptr": {"one": ((256, 0.2), (768, 0.4)), "cluster": ((128, 0.1), (512, 0.3))},
             "ckpt": {"one": ((896, 0.5),), "cluster": ((128, 0.05), (1152, 0.25))},
             "window": {"one": ((896, 0.6),), "cluster": ((128, 0.07), (1152, 0.27))}}
    monkeypatch.setattr(TC, "WAVE_STEP_US", table)
    assert TC.wave_step_us("ptr", 128, 1) == pytest.approx(0.2)
    assert TC.wave_step_us("ptr", 512, 1) == pytest.approx(0.3)
    assert TC.wave_step_us("ptr", 1024, 1) == pytest.approx(0.5)
    assert TC.wave_step_us("ptr", 896, 7) == pytest.approx(0.1)  # 128 lanes a CTA
    assert TC.wave_step_us("ptr", 896, 3) == pytest.approx(0.1 + 0.2 * 256 / 384)  # 384
    assert TC.wave_step_us("ptr", 2176, 3) == pytest.approx(0.3 + 0.2 * 256 / 384)  # 768
    assert TC.wave_step_us("ckpt", 896, 1) == pytest.approx(0.5)  # one point: flat
    assert TC.wave_step_us("window", 2176, 2) == pytest.approx(0.27)  # 1152


# -- the routes at each C the plan can pick, against the JAX package -------

B, N = 4, 256
MP = 2176


@pytest.fixture(scope="module")
def overcap():
    """Morph reads of two samples=6 flanks padding to MP 2176 and the
    reference's wave_multi (Pallas interpret mode) over both flanks'
    rows on the decoded reads."""
    rng = np.random.default_rng(975)
    t_pre = np.repeat(rng.uniform(60, 120, 362), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 342), 6).astype(np.float32)
    sig = rng.uniform(60, 120, (B, N))
    for i in range(B):
        sig[i, 20 + 10 * i : 140 + 10 * i] = t_pre[600:720] + rng.normal(0, 0.5, 120)
    bins, lut = quantise(sig, rng, rng.uniform(40, 60, B), rng.uniform(130, 150, B))
    na = rng.integers(150, N, B).astype(np.int32)
    na[0] = N
    rows, ms = TC.pad_template_rows([t_pre, t_suf])
    assert rows.shape[1] == MP and TC.wave_table_ctas(rows) == 2
    dec = np.take_along_axis(lut, bins.astype(np.int64), axis=1)
    p = AlignParams(gap_open_h=-16.0, gap_extension_h=-16.0, gap_open_v=-0.5,
                       gap_extension_v=-0.5)  # steep h gaps: a short two-pass window
    ref = JA._align_batch_wave_multi(
        jnp.asarray(np.concatenate([dec, dec])), jnp.asarray(np.concatenate([na, na])),
        jnp.asarray(np.repeat(rows, B, axis=0)), jnp.asarray(np.repeat(ms, B)), p,
        int(ms.max()))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return bins, lut, na, t_pre, t_suf, rows, p, ref


@pytest.mark.parametrize("route", ["one_pass", "two_pass"])
@pytest.mark.parametrize("ctas", [2, 3, 4, 5, 6])
def test_overcap_routes_at_each_plan_ctas_match_jax(overcap, route, ctas, monkeypatch):
    """align_fused_pair on morph reads past one CTA's table, on the
    card's rule, with the step table set so the plan picks ``ctas``:
    every wave call takes that split, and both flanks' outputs equal
    the reference's (the two-pass route's too: it equals the one-pass
    plane by construction)."""
    bins, lut, na, t_pre, t_suf, rows, p, ref = overcap
    assert ctas in _ok_ctas(rows)
    monkeypatch.setattr(TA, "sm_count", lambda device: SMS)
    monkeypatch.setattr(TC, "wave_step_us", lambda mode, mp, c: 0.1 if c == ctas else 1.0)
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    if route == "two_pass":
        monkeypatch.setattr(TA, "CKPT_STEPS", 512)
        monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    else:
        monkeypatch.delenv("STRIQUE_PTR_BUDGET_GB", raising=False)
    forms = []
    real = TA.template_levels
    monkeypatch.setattr(TA, "template_levels", lambda t, c=None: forms.append(c) or real(t, c))
    got = TA.align_fused_pair(*(torch.from_numpy(x) for x in (bins, na)), t_pre, t_suf, p,
                              lut=torch.from_numpy(lut))
    assert forms and set(forms) == {ctas}
    for out, rows_, m in ((got[0], slice(0, B), len(t_pre)), (got[1], slice(B, 2 * B),
                                                              len(t_suf))):
        for k in FIELDS:
            want = ref[k][rows_][:, :m] if ref[k].ndim == 2 else ref[k][rows_]
            if k == "score":
                np.testing.assert_allclose(out[k].numpy(), want, rtol=0, atol=SCORE_ATOL)
            else:
                np.testing.assert_array_equal(out[k].numpy().astype(want.dtype), want, k)


# -- the column kernel's launch plan (align_cuda.col_launch_plan) ---------

COL_CASES = [(rows, mp) for mp in (896, 1152, 2176, 4096)
             for rows in (8, 16, 24, 32, 40, 64, 72, 128)]


def _col_ok(tmpl):
    """The CTA counts the column plan may give a template past one CTA:
    from ``col_table_ctas`` up, splits the kernel takes whose per-CTA
    tables fit."""
    mp = tmpl.shape[1]
    c_min = TC.col_table_ctas(tmpl)
    return [c for c in range(c_min, TC.MAX_CTAS + 1)
            if c == c_min or (TC._split_ok(mp, c) and TC.col_score_mode(
                TC._cta_level_counts(tmpl, c), mp, c) == "table")]


def _col_calls(rows, tmpl, n_cols, device="cpu", sms=SMS):
    out, left = [], rows
    while left > 0:
        c, kb = TC.col_launch_plan(left, tmpl, n_cols, device, sms)
        out.append((c, kb))
        left -= kb
    return out


def _col_capacity(monkeypatch):
    """The H100's clusters at once, as the column kernel launches them
    (one CTA an SM, as the wave kernel's)."""
    monkeypatch.setattr(TC, "cluster_capacity",
                        lambda device, c, mpc, kernel="wave": H100_CLUSTERS[c])


@pytest.mark.parametrize("rows,mp", COL_CASES)
def test_col_plan_is_the_shortest_call_set_within_the_card(rows, mp, monkeypatch):
    """Every call of the column plan's sequence over one flank's template:
    one CTA where the template fits one (MP 896), else C >=
    col_table_ctas, a split the kernel takes with tables that fit; the
    width kernel_batch's at C within the card's clusters at once, rows x
    C within the SMs.  The sequence covers the rows, and no sequence of
    such calls predicts a shorter wall (each call n_cols columns at its
    C's col_step_us)."""
    _col_capacity(monkeypatch)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "60")
    tmpl = _flank_rows(mp)[:1]
    n_cols = 24576
    c_min = TC.col_table_ctas(tmpl)
    ok = _col_ok(tmpl)

    def width(r, c):
        kb = TC.kernel_batch(r, n_cols=n_cols, mp=mp, device="cpu", sms=SMS, ctas=max(c, 1))
        return kb if c < 2 else min(kb, H100_CLUSTERS[c] // 8 * 8)

    memo = {0: 0.0}

    def least(r):
        if r not in memo:
            memo[r] = min(n_cols * TC.col_step_us(mp, c) + least(max(r - width(r, c), 0))
                          for c in ok)
        return memo[r]

    seq, left, wall = _col_calls(rows, tmpl, n_cols), rows, 0.0
    for c, kb in seq:
        assert kb % 8 == 0 and 8 <= kb <= max(8, TC._round_up(left, 8))
        assert kb * max(c, 1) <= SMS and kb == width(left, c)
        if c_min < 2:
            assert c == c_min
        else:
            assert c in ok and c >= c_min
            wall += n_cols * TC.col_step_us(mp, c)
        left -= kb
    assert left <= 0
    if c_min >= 2:
        assert wall == pytest.approx(least(rows), rel=1e-12)


@pytest.mark.parametrize("mp", [896, 2176])
def test_col_plan_cpu_rule_is_the_references(mp):
    """Without an SM count the column plan keeps col_table_ctas and the
    reference's widths (64 rows a call, fewer rounded up to 8); a
    template past every split's table keeps POW (0)."""
    tmpl = _flank_rows(mp)[:1]
    for rows in (8, 20, 64, 200):
        assert TC.col_launch_plan(rows, tmpl, 24576, "cpu") == (
            TC.col_table_ctas(tmpl), min(TC.BATCH_WAVE, TC._round_up(rows, 8)))
    rng = np.random.default_rng(3)
    tp, _ = TC.pad_template(rng.uniform(60, 120, 2100).astype(np.float32))
    assert TC.col_table_ctas(tp) == 0
    assert TC.col_launch_plan(72, tp, 30000, "cpu", SMS) == (0, 72)


def test_col_plan_on_the_card_at_phase_4e(monkeypatch):
    """The column plan with the H100's cluster capacities and the shipped
    step table at phase 4e's template width (MP 2176, 2 CTAs by the rule)
    and N 28672: the column route's 64 rows stay one call on 2 CTAs (3
    or more would take two calls), 32 rows take 3 CTAs, 8-16 rows 6 (the
    picks tools/probe_col_cluster.py measured fastest at each)."""
    _col_capacity(monkeypatch)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "60")
    rng = np.random.default_rng(4)
    flank = TC.pad_template(_samples6(rng, 362, 2172))[0]
    assert flank.shape[1] == 2176 and TC.col_table_ctas(flank) == 2
    assert _col_calls(64, flank, 28672) == [(2, 64)]
    assert _col_calls(32, flank, 28672) == [(3, 32)]
    assert _col_calls(16, flank, 28672) == [(6, 16)]
    assert _col_calls(8, flank, 28672) == [(6, 8)]
    assert _col_calls(72, flank, 28672) == [(2, 64), (6, 8)]


def test_col_step_table_reads_between_and_past_its_points(monkeypatch):
    """col_step_us: the CTA's lanes (cta_lanes) on COL_STEP_US, linear
    between points, the first value below the first, the last two's
    slope past the last."""
    assert len(TC.COL_STEP_US) >= 2
    monkeypatch.setattr(TC, "COL_STEP_US", ((256, 0.2), (512, 0.3), (1152, 0.5)))
    assert TC.col_step_us(2176, 8) == pytest.approx(0.2 + 0.1 * 128 / 256)  # 384 lanes
    assert TC.col_step_us(1152, 8) == pytest.approx(0.2)  # 256 lanes: the first point
    assert TC.col_step_us(2176, 2) == pytest.approx(0.5)  # 1152
    assert TC.col_step_us(4096, 2) == pytest.approx(0.5 + 0.2 * 896 / 640)  # 2048: past


B_COL, N_COL = 8, 256


@pytest.fixture(scope="module")
def overcap_col():
    """Morph reads of one samples=6 flank padding to MP 2176 and the
    reference's column route (_align_batch_pallas, Pallas interpret mode)
    on the decoded reads."""
    rng = np.random.default_rng(976)
    t_pre = np.repeat(rng.uniform(60, 120, 362), 6).astype(np.float32)
    sig = rng.uniform(60, 120, (B_COL, N_COL))
    for i in range(B_COL):
        sig[i, 20 + 10 * i : 140 + 10 * i] = t_pre[600:720] + rng.normal(0, 0.5, 120)
    bins, lut = quantise(sig, rng, rng.uniform(40, 60, B_COL), rng.uniform(130, 150, B_COL))
    na = rng.integers(150, N_COL, B_COL).astype(np.int32)
    na[0] = N_COL
    tp, m = TC.pad_template(t_pre)
    assert tp.shape[1] == MP and TC.col_table_ctas(tp) == 2
    dec = np.take_along_axis(lut, bins.astype(np.int64), axis=1)
    p = AlignParams()
    ref = JA._align_batch_pallas(jnp.asarray(dec), jnp.asarray(na), jnp.asarray(tp), p, m)
    return bins, lut, na, t_pre, p, {k: np.asarray(v) for k, v in ref.items()}


@pytest.mark.parametrize("ctas", [2, 3, 4, 5, 6])
def test_col_route_at_each_plan_ctas_matches_jax(overcap_col, ctas, monkeypatch):
    """align_core under STRIQUE_ALIGN_KERNEL=col on morph reads past one
    CTA's table, on the card's rule, with the step table set so the plan
    picks ``ctas``: every column call takes that split, and the outputs
    equal the reference's."""
    bins, lut, na, t_pre, p, ref = overcap_col
    tp, _ = TC.pad_template(t_pre)
    assert ctas in _col_ok(tp)
    _col_capacity(monkeypatch)
    monkeypatch.setattr(TA, "sm_count", lambda device: SMS)
    monkeypatch.setattr(TC, "sm_count", lambda device: SMS)
    monkeypatch.setattr(TC, "col_step_us", lambda mp, c: 0.1 if c == ctas else 1.0)
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    monkeypatch.delenv("STRIQUE_PTR_BUDGET_GB", raising=False)
    forms = []
    real = TA.template_levels
    monkeypatch.setattr(TA, "template_levels", lambda t, c=None: forms.append(c) or real(t, c))
    got = TA.align_core(torch.from_numpy(bins), torch.from_numpy(na), t_pre, p,
                        lut=torch.from_numpy(lut))
    assert forms == [ctas]
    for k in FIELDS:
        if k == "score":
            np.testing.assert_allclose(got[k].numpy(), ref[k], rtol=0, atol=SCORE_ATOL)
        else:
            np.testing.assert_array_equal(got[k].numpy().astype(ref[k].dtype), ref[k], k)
