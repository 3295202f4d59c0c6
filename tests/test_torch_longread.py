"""strique_tpu_torch's ultra-long two-pass alignment vs the JAX reference.

The port's plain twins of kernel rows 5 and 6 (score-only checkpoint
forward, windowed pointer forward resumed from a checkpoint) against
the reference's ``align_forward_ckpt`` / ``align_window_from_state`` in
Pallas interpret mode on the CPU, then the whole route
(``align_batch_longread``, ``align_core``'s routing past the pointer
budget, ``RepeatCounter``) against the reference's outputs.  Inputs are
made from seeds with NumPy and handed to both packages.

Tolerances: none.  Bottom taps, written checkpoint slots, written
pointer words, end columns and tracebacks are compared exactly.  The
port's |d|^1.2 rounds differently from XLA's f32 ``jnp.power`` on
~0.065% of inputs (ROADMAP Queue 3), which on some seeds moves 0.03% of
the checkpoint and bottom values by 1-2 ulp; the pinned seeds (901 and
905) are bit-equal, and Queue 3 records the measured spread.  The counter's log_p is recomputed in float64 on the host
from an identical path and is held to 1e-9 relative, as in
test_torch_counter.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu.ops import align as JA
from strique_tpu.ops import align_pallas as JP
from strique_tpu.ops.reference import AlignParams as JaxAlignParams
from strique_tpu.pore_model import PoreModel
from strique_tpu_torch.convert import align_params_from_jax, longread_state_from_jax
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, make_reads, quantise,
                                        write_pore_model)

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)

FIELDS = ("score", "j_end", "is_gap", "jpos", "j_begin")
# reference defaults (span bound ~1.4k steps at M=40) and the steep-gap
# corner of the reference's fuzz sweep (steep h, shallow v: bound 123)
PARAMS = {
    "default": JaxAlignParams(),
    "steep": JaxAlignParams(gap_open_h=-16.0, gap_extension_h=-16.0,
                            gap_open_v=-0.5, gap_extension_v=-0.5),
}
CKPT_STEPS = 512


def _reads(seed, B=8, N=3968, M=40):
    """Odd rows carry the template near the start (cold pass-2 windows),
    even rows in the second half (warm windows)."""
    rng = np.random.default_rng(seed)
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = int(rng.integers(0, 100)) if i % 2 else int(rng.integers(N // 2, N - 3 * M))
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    na = rng.integers(N - 3 * M, N, B).astype(np.int32)
    return signals, na, template


def _written_slots(na, m, nd, ckpt_steps):
    stop = np.minimum((na.astype(np.int64) + m + 7) // 8 * 8, nd)
    return (np.arange(nd // ckpt_steps)[:, None] + 1) * ckpt_steps <= stop[None, :]


@pytest.fixture(scope="module", params=sorted(PARAMS))
def pass1(request):
    """One pass-1 run per params on both sides (N + MP = 4096 = 8 slots)."""
    p = PARAMS[request.param]
    signals, na, template = _reads({"default": 901, "steep": 905}[request.param])
    tp, m = JP.pad_template(template)
    jbot, jck = JP.align_forward_ckpt(jnp.asarray(signals), jnp.asarray(na), jnp.asarray(tp),
                                      p, m, CKPT_STEPS // JP.CHUNK)
    pp = align_params_from_jax(p)
    st = TA._longread_pass1(torch.from_numpy(signals), torch.from_numpy(na), template, pp,
                            CKPT_STEPS)
    return {"p": p, "pp": pp, "na": na, "m": m, "tp": tp, "st": st,
            "jbot": np.asarray(jbot), "jck": [np.asarray(c) for c in jck]}


def test_ckpt_twin_matches_jax_interpret(pass1):
    """Bottom taps and every checkpoint slot the port writes, bit-equal."""
    st = pass1["st"]
    assert st["N"] + st["mp"] == 4096 and st["ckpt_steps"] == CKPT_STEPS
    np.testing.assert_array_equal(st["bottom_steps"].numpy(), pass1["jbot"])
    slots = _written_slots(pass1["na"], pass1["m"], 4096, CKPT_STEPS)
    assert slots.sum() > 8
    for got, ref in zip(st["ckpts"], pass1["jck"]):
        np.testing.assert_array_equal(got.numpy()[slots], ref[slots])


def test_window_twin_matches_jax_interpret(pass1):
    """One restart state, gathered from the reference's checkpoint planes,
    through both window versions: written pointer words equal, on cold
    and warm rows."""
    st, m = pass1["st"], pass1["m"]
    w = TA.window_inputs(st)
    cold = w["cold"].numpy()
    assert 0 < cold.sum() < len(cold)
    slot = w["t0"].numpy() // CKPT_STEPS - 1
    state = longread_state_from_jax(pass1["jck"], slot, cold)
    jptr = JP.align_window_from_state(
        jnp.asarray(w["sig_win"].numpy()), jnp.asarray(w["r_init"].numpy()),
        tuple(jnp.asarray(x.numpy()) for x in state), jnp.asarray(cold),
        jnp.asarray(w["steps_needed"].numpy()), jnp.asarray(pass1["tp"]), pass1["p"], m)
    ptr = TC.align_window_from_state(w["sig_win"], w["r_init"], state, w["cold"],
                                     w["steps_needed"], torch.from_numpy(pass1["tp"]),
                                     pass1["pp"], m)
    jptr = np.asarray(jptr)
    assert ptr.shape == jptr.shape
    words = (w["steps_needed"].numpy().astype(np.int64) + 7) // 8
    mask = np.arange(jptr.shape[0])[:, None] < words[None, :]
    np.testing.assert_array_equal(ptr.numpy()[mask], jptr[mask])


def _case_13():
    rng = np.random.default_rng(13)
    B, N, M = 8, 4096, 40
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = int(rng.integers(0, N - 3 * M))
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    na = rng.integers(N // 2, N, B).astype(np.int32)
    return signals, na, template, JaxAlignParams(), 512


def _case_23():
    """Degenerate reads: no template match, a read shorter than the
    template, a match at the signal's very end."""
    rng = np.random.default_rng(23)
    B, N, M = 8, 2048, 40
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = np.full((B, N), 200.0, np.float32)
    na = np.full(B, N - 10, np.int32)
    signals[1] = rng.uniform(60, 120, N)
    na[2] = 8
    signals[3, N - 60 : N - 20] = template
    na[3] = N - 10
    return signals, na, template, JaxAlignParams(), 256


def _case_29():
    """ckpt_steps (128) below the template's lane width (256): clamped up."""
    rng = np.random.default_rng(29)
    B, N, M = 8, 2048, 200
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = 450 + 20 * i
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    na = np.full(B, N - 10, np.int32)
    return signals, na, template, JaxAlignParams(gap_open_h=-20.0, gap_extension_h=-20.0), 128


@pytest.mark.parametrize("case", [_case_13, _case_23, _case_29], ids=["13", "23", "29"])
def test_align_batch_longread_matches_jax(case):
    """The reference's two-pass cases (tests/test_pallas.py): the port's
    route equals the reference's outputs exactly."""
    signals, na, template, p, ckpt_steps = case()
    ref = JA.align_batch_longread(signals, na, template, p, ckpt_steps=ckpt_steps)
    got = TA.align_batch_longread(torch.from_numpy(signals), torch.from_numpy(na), template,
                                  align_params_from_jax(p), ckpt_steps=ckpt_steps)
    for k in FIELDS:
        a = np.asarray(ref[k])
        np.testing.assert_array_equal(got[k].numpy().astype(a.dtype), a, err_msg=k)


def test_longread_requires_bounded_horizontal_gaps():
    """No span bound without negative horizontal gaps: the route refuses,
    and the bound equals the reference's wherever it exists."""
    p = JaxAlignParams(gap_open_h=1.0, gap_extension_h=0.5)
    assert TC.wave_span_bound_steps(p, 40) is None
    with pytest.raises(ValueError, match="negative horizontal gap"):
        TA.align_batch_longread(torch.zeros((8, 256)), torch.full((8,), 250, dtype=torch.int32),
                                np.zeros(16, np.float32), align_params_from_jax(p))
    for q in (*PARAMS.values(), p, JaxAlignParams(dist_min=8.0, dist_offset=0.0)):
        for m in (1, 40, 870):
            assert TC.wave_span_bound_steps(q, m) == JP.wave_span_bound_steps(q, m)


def test_align_core_routes_past_the_budget(monkeypatch):
    """Under a tiny pointer budget align_core takes the two-pass route
    (one pass-1 and one pass-2 call per 8-row group) and returns the
    one-pass route's outputs exactly."""
    signals, na, template, p, _ = _case_13()
    sig, n = torch.from_numpy(signals[:, :2048]), torch.from_numpy(np.minimum(na, 2000))
    pp = align_params_from_jax(p)
    one = TA.align_core(sig, n, template, pp)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    calls = TA.kernel_stats()["calls"]
    two = TA.align_core(sig, n, template, pp)
    assert TA.kernel_stats()["calls"] - calls == 2
    for k in FIELDS:
        assert torch.equal(one[k], two[k]), k


T_PREFIX = PREFIX[-60:]
T_SUFFIX = SUFFIX[:60]
COUNTS = {"+": [5, 9, 12, 7], "-": [6, 11, 4, 8]}


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


@pytest.mark.parametrize("strand", ["+", "-"])
def test_counter_two_pass_matches_jax_counter(model_file, strand, monkeypatch):
    """RepeatCounter on the CPU with a budget that sends every bucket down
    the two-pass route, against the reference counter (its one-pass
    route off-TPU; the two routes are bit-identical by construction)."""
    pm = PoreModel(model_file)
    rng = np.random.default_rng(43 if strand == "+" else 42)
    reads = [make_reads(pm, 1, n, rng, strand=strand, flank_bases=100, prefix=T_PREFIX,
                        suffix=T_SUFFIX)[0] for n in COUNTS[strand]]
    ref_counter = JaxRepeatCounter(model_file)
    ref_counter.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    ref = ref_counter.detect_many("c9orf72", reads, strand)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    port = RepeatCounter(model_file, device="cpu")
    port.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    calls = TA.kernel_stats()["calls"]
    got = port.detect_many("c9orf72", reads, strand)
    assert TA.kernel_stats()["calls"] - calls == 4  # two passes for each flank
    assert [r[0] for r in ref] == COUNTS[strand]
    for r, g in zip(ref, got):
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)


# -- the TABLE score mode of rows 5-6: morph-form reads (u8 bins and a
# 256-level table per read) read in place.  The JAX side and the POW
# twins get the decoded lut[bins].  Tolerance: none, everything
# bit-equal.


def _morph(signals, seed):
    """Each read quantised to its own affine 256-level table
    (``synthetic.quantise``): (bins u8, lut (B, 256) f32, lut[bins])."""
    bins, lut = quantise(signals, np.random.default_rng(seed))
    return bins, lut, np.take_along_axis(lut, bins.astype(np.int64), axis=1)


@pytest.fixture(scope="module", params=sorted(PARAMS))
def pass1_morph(request):
    """Pass 1 on one morph-form batch per params: the TABLE route on the
    bins, the POW route and the reference on the decoded f32."""
    p = PARAMS[request.param]
    seed = {"default": 901, "steep": 905}[request.param]
    signals, na, template = _reads(seed)
    # level tables from seed + 1: the reference's f32 pow (ROADMAP Queue 3)
    # moves 6 values of seed 905's own quantisation by one ulp
    bins, lut, dec = _morph(signals, seed + 1)
    tp, m = JP.pad_template(template)
    jbot, jck = JP.align_forward_ckpt(jnp.asarray(dec), jnp.asarray(na), jnp.asarray(tp), p, m,
                                      CKPT_STEPS // JP.CHUNK)
    pp = align_params_from_jax(p)
    n_t = torch.from_numpy(na)
    st_t = TA._longread_pass1(torch.from_numpy(bins), n_t, template, pp, CKPT_STEPS,
                              lut=torch.from_numpy(lut))
    st_p = TA._longread_pass1(torch.from_numpy(dec), n_t, template, pp, CKPT_STEPS)
    return {"p": p, "pp": pp, "na": na, "m": m, "tp": tp, "st_t": st_t, "st_p": st_p,
            "jbot": np.asarray(jbot), "jck": [np.asarray(c) for c in jck]}


def test_ckpt_table_twin_matches_pow_and_jax(pass1_morph):
    """Row 5's TABLE twin reads the bins in place: bottom taps and every
    written checkpoint slot equal the POW twin's on lut[bins] and the
    reference's, bit for bit."""
    st_t, st_p = pass1_morph["st_t"], pass1_morph["st_p"]
    assert st_t["lut"] is not None and st_t["sig"].dtype == torch.uint8
    assert st_t["N"] + st_t["mp"] == 4096 and st_t["ckpt_steps"] == CKPT_STEPS
    np.testing.assert_array_equal(st_t["bottom_steps"].numpy(), pass1_morph["jbot"])
    assert torch.equal(st_t["bottom_steps"], st_p["bottom_steps"])
    slots = _written_slots(pass1_morph["na"], pass1_morph["m"], 4096, CKPT_STEPS)
    assert slots.sum() > 8
    for got, pow_, ref in zip(st_t["ckpts"], st_p["ckpts"], pass1_morph["jck"]):
        np.testing.assert_array_equal(got.numpy()[slots], ref[slots])
        np.testing.assert_array_equal(got.numpy()[slots], pow_.numpy()[slots])


def test_window_table_twin_matches_pow_and_jax(pass1_morph):
    """Row 6's TABLE twin reads each row's bins from its t0 (0.0 on both
    sides of the read, no gathered window): written pointer words equal
    the POW twin's and the reference's on the gathered f32 windows, on
    cold and warm rows."""
    st_t, st_p, m = pass1_morph["st_t"], pass1_morph["st_p"], pass1_morph["m"]
    w = TA.window_inputs(st_t)
    w_p = TA.window_inputs(st_p)
    assert "sig_win" not in w
    for k in ("j_end", "t0", "cold", "steps_needed"):
        assert torch.equal(w[k], w_p[k]), k
    cold = w["cold"].numpy()
    assert 0 < cold.sum() < len(cold)
    state = longread_state_from_jax(pass1_morph["jck"], w["t0"].numpy() // CKPT_STEPS - 1, cold)
    tp = torch.from_numpy(pass1_morph["tp"])
    ptr = TC.align_window_from_state_morph(st_t["sig"], st_t["lut"], w["t0"], state, w["cold"],
                                           w["steps_needed"], st_t["levels"], st_t["lidx"],
                                           pass1_morph["pp"], m, st_t["W"])
    ptr_p = TC.align_window_from_state(w_p["sig_win"], w_p["r_init"], state, w["cold"],
                                       w["steps_needed"], tp, pass1_morph["pp"], m)
    jptr = np.asarray(JP.align_window_from_state(
        jnp.asarray(w_p["sig_win"].numpy()), jnp.asarray(w_p["r_init"].numpy()),
        tuple(jnp.asarray(x.numpy()) for x in state), jnp.asarray(cold),
        jnp.asarray(w["steps_needed"].numpy()), jnp.asarray(pass1_morph["tp"]), pass1_morph["p"],
        m))
    assert ptr.shape == ptr_p.shape == jptr.shape
    words = (w["steps_needed"].numpy().astype(np.int64) + 7) // 8
    mask = np.arange(jptr.shape[0])[:, None] < words[None, :]
    np.testing.assert_array_equal(ptr.numpy()[mask], jptr[mask])
    np.testing.assert_array_equal(ptr.numpy()[mask], ptr_p.numpy()[mask])


def test_ckpt_table_reads_zero_past_a_short_bins_row():
    """A bins row shorter than ND - MP (3840 samples: ND = 4096, where the
    f32 route pads 256 zeros): the TABLE twin's bin 257 past the row
    gives the POW twin's outputs on the zero-padded lut[bins], and the
    whole route's outputs equal the reference's two-pass route."""
    signals, na, template = _reads(907, N=3840)
    na = np.minimum(na, 3840 - 8).astype(np.int32)
    na[0] = 3840  # a row to the end of the bins: its lanes read past it
    bins, lut, dec = _morph(signals, 907)
    pp = align_params_from_jax(PARAMS["default"])
    n_t = torch.from_numpy(na)
    st_t = TA._longread_pass1(torch.from_numpy(bins), n_t, template, pp, CKPT_STEPS,
                              lut=torch.from_numpy(lut))
    st_p = TA._longread_pass1(torch.from_numpy(dec), n_t, template, pp, CKPT_STEPS)
    assert st_t["sig"].shape[1] == 3840 and st_p["sig"].shape[1] == st_t["N"] == 3968
    assert torch.equal(st_t["bottom_steps"], st_p["bottom_steps"])
    slots = _written_slots(na, st_t["m"], 4096, CKPT_STEPS)
    for a, b in zip(st_t["ckpts"], st_p["ckpts"]):
        np.testing.assert_array_equal(a.numpy()[slots], b.numpy()[slots])
    got = TA._longread_pass2(st_t)
    ref = JA.align_batch_longread(dec, na, template, PARAMS["default"], ckpt_steps=CKPT_STEPS)
    for k in FIELDS:
        a = np.asarray(ref[k])
        np.testing.assert_array_equal(got[k].numpy().astype(a.dtype), a, err_msg=k)


def test_align_core_two_pass_on_morph_input(monkeypatch):
    """align_core past the pointer budget on morph input keeps the bins
    (no lut[bins] decode: the TABLE twins run) and returns the one-pass
    route's outputs and the reference's align_batch_longread on the
    decoded f32, exactly."""
    signals, na, template = _reads(901)
    bins, lut, dec = _morph(signals, 901)
    b_t, l_t, n_t = (torch.from_numpy(x) for x in (bins, lut, na))
    pp = align_params_from_jax(PARAMS["default"])
    one = TA.align_core(b_t, n_t, template, pp, lut=l_t)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    decoded = []
    monkeypatch.setattr(TA, "morph_decode", lambda *a: decoded.append(1) or TC.morph_decode(*a))
    two = TA.align_core(b_t, n_t, template, pp, lut=l_t)
    assert not decoded
    ref = JA.align_batch_longread(dec, na, template, PARAMS["default"], ckpt_steps=16384)
    for k in FIELDS:
        assert torch.equal(one[k], two[k]), k
        a = np.asarray(ref[k])
        np.testing.assert_array_equal(two[k].numpy().astype(a.dtype), a, err_msg=k)


def test_two_pass_group_card_rule(monkeypatch):
    """Card rule: a two-pass group is as wide as its rows, up to the
    largest multiple of 8 within the SM count, narrowed (never below 8)
    so pass 2's (W/8, rows, MP) int32 plane fits the budget; the CPU
    keeps the reference's 8 rows."""
    monkeypatch.delenv("STRIQUE_PTR_BUDGET_GB", raising=False)
    w, mp = 46080, 896  # the bench template: ~20.6 MB of pass-2 plane a row
    assert TA.two_pass_group(16, mp, w, "cpu") == 8
    assert TA.two_pass_group(16, mp, w, "cpu", sms=132) == 16
    assert TA.two_pass_group(200, mp, w, "cpu", sms=132) == 128
    assert TA.two_pass_group(3, mp, w, "cpu", sms=132) == 8
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "1")
    assert TA.two_pass_group(128, mp, w, "cpu", sms=132) == 48  # 48 x 20.6 MB <= 1 GiB
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    assert TA.two_pass_group(128, mp, w, "cpu", sms=132) == 8


@pytest.mark.parametrize("morph", [True, False])
def test_fused_pair_two_pass_on_the_card_rule(morph, monkeypatch):
    """Past the pointer budget on the card's rule (132 SMs), both flanks of
    8 reads run the two-pass route as one 16-row group (one pass-1 and
    one pass-2 call, per-row templates); the outputs equal two per-flank
    align_core calls (the CPU rule: two two-pass groups of 8 rows each)."""
    signals, na, t_pre = _reads(903)
    t_suf = np.random.default_rng(904).uniform(60, 120, 30).astype(np.float32)
    signals[:, 2500:2530] = t_suf
    bins, lut, dec = _morph(signals, 903)
    n_t = torch.from_numpy(na)
    sig, l_t = ((torch.from_numpy(bins), torch.from_numpy(lut)) if morph
                else (torch.from_numpy(dec), None))
    pp = align_params_from_jax(PARAMS["steep"])
    # a width-8 one-pass plane (2 MB) exceeds 1 MB; at a 512-step stride
    # 16 rows of the steep corner's 640-step pass-2 window (0.66 MB) fit
    monkeypatch.setattr(TA, "CKPT_STEPS", CKPT_STEPS)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.001")
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    ref = TA.align_fused_pair(sig, n_t, t_pre, t_suf, pp, lut=l_t)
    monkeypatch.setattr(TC, "sm_count", lambda device: 132)
    monkeypatch.setattr(TA, "sm_count", lambda device: 132)
    calls = TA.kernel_stats()["calls"]
    cells = TA.kernel_stats()["cells"]
    got = TA.align_fused_pair(sig, n_t, t_pre, t_suf, pp, lut=l_t)
    assert TA.kernel_stats()["calls"] - calls == 2
    assert TA.kernel_stats()["cells"] - cells == 16 * (4096 + 640) * 128
    for g, r in zip(got, ref):
        for k in FIELDS:
            assert torch.equal(g[k], r[k]), k
