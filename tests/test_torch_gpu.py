"""strique_tpu_torch CUDA kernels vs their plain PyTorch twins, on a card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present (decided inside a fixture, so every worker collects the same
tests).  The file imports no JAX, so a GPU host without JAX can run it
without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Integer outputs (pointer words, tracebacks, paths) and f32 outputs
(bottom taps, score rows, fin, acc) must be exactly equal: kernel and
twin evaluate the same expression trees with the same rounding on the
same card (CUDA's double ``pow`` on both sides; the wave kernel's TABLE
score mode evaluates it once per table entry).
"""
import numpy as np
import pytest
import torch

from strique_tpu_torch import _build
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.hmm.models import build_flanked_repeat, build_repeat_mod
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.ops.reference import AlignParams
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (BWD_EDGES, MOD_MODEL_SEED, PREFIX, REPEAT, SUFFIX,
                                        VITERBI_EDGES, VITERBI_WIDE, bwd_edge_case,
                                        make_mod_reads, make_reads, quantise, random_unit,
                                        traceback_plane, viterbi_edge_case, viterbi_wide_case,
                                        write_mod_model, write_pore_model)

PARAMS = [
    AlignParams(),
    AlignParams(gap_open_h=-3.0, gap_extension_h=-0.5, gap_open_v=-20.0, gap_extension_v=-4.0),
    AlignParams(gap_open_h=1.0, gap_extension_h=0.5),
]
# the steep-gap corner: a short span bound (a small pass-2 window)
STEEP = AlignParams(gap_open_h=-16.0, gap_extension_h=-16.0, gap_open_v=-0.5,
                    gap_extension_v=-0.5)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels build with nvcc on the card)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=3)


def _valid_words(n_act, m_rows, nwords):
    words = (n_act.to(torch.int64) + m_rows.to(torch.int64) + 7) // 8
    return torch.arange(nwords, device=n_act.device)[:, None] < words[None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("pi", range(len(PARAMS)))
@pytest.mark.parametrize("multi", [False, True])
def test_gpu_wave_and_traceback_match_plain(cuda_device, pi, multi):
    p = PARAMS[pi]
    rng = np.random.default_rng(500 + pi)
    B, N = 16, 512
    t_pre = rng.uniform(60, 120, 40).astype(np.float32)
    t_suf = rng.uniform(60, 120, 28).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        t = t_suf if multi and i >= B // 2 else t_pre
        st = 30 + 20 * i
        signals[i, st : st + len(t)] = t + rng.normal(0, 0.5, len(t))
    s = torch.from_numpy(signals).to(cuda_device)
    n = torch.from_numpy(rng.integers(300, 500, B).astype(np.int32)).to(cuda_device)
    if multi:
        rows, ms = TC.pad_template_rows([t_pre, t_suf])
        tmpl = torch.from_numpy(np.repeat(rows, B // 2, axis=0)).to(cuda_device)
        mr = torch.from_numpy(np.repeat(ms, B // 2)).to(cuda_device)
        name = "align_forward_wave_multi"
        before = _build.LAUNCHES[name]
        ptr, bot = TC.align_forward_wave_multi(s, n, tmpl, mr, p)
    else:
        tp, m = TC.pad_template(t_pre)
        tmpl = torch.from_numpy(tp).to(cuda_device)
        mr = torch.full((B,), m, dtype=torch.int32, device=cuda_device)
        name = "align_forward_wave"
        before = _build.LAUNCHES[name]
        ptr, bot = TC.align_forward_wave(s, n, tmpl, p, m)
    assert _build.LAUNCHES[name] == before + 1
    ptr_p, bot_p = TC._wave_plain(s, tmpl, n, mr, p)
    mask = _valid_words(n, mr, ptr.shape[0])
    assert torch.equal(ptr[mask], ptr_p[mask])
    assert torch.equal(bot, bot_p)
    j_end = (torch.argmax(bot, dim=1).to(torch.int32) + 1 - mr).clamp_min(0).to(torch.int32)
    m_out = int(mr.max())
    got = TA.traceback_pointers(ptr, j_end, m_out, m_start=mr)
    ref = TA._traceback_plain(ptr, j_end, mr, m_out)
    for k in ("is_gap", "jpos", "j_begin"):
        assert torch.equal(got[k], ref[k]), k


def _morph_batch(rng, B, N, templates):
    """u8 bins, per-read 256-level tables and lengths; row b carries
    templates[b] (one row runs to the padded end)."""
    lo = rng.uniform(40, 60, B)
    hi = rng.uniform(130, 150, B)
    sig = rng.uniform(60, 120, (B, N))
    for i, t in enumerate(templates):
        st = 30 + (20 * i) % (N // 2)
        sig[i, st : st + len(t)] = t + rng.normal(0, 0.5, len(t))
    bins, lut = quantise(sig, rng, lo, hi)
    na = rng.integers(N // 2, N, B).astype(np.int32)
    na[0] = N
    return bins, lut, na


@pytest.mark.gpu
@pytest.mark.parametrize("pi", range(len(PARAMS)))
@pytest.mark.parametrize("multi", [False, True])
def test_gpu_wave_table_mode_matches_pow_and_plain(cuda_device, pi, multi):
    """Morph-form reads (samples=6 templates): the TABLE-mode kernel, the
    POW-mode kernel on the decoded f32 and the table twin, bit for bit."""
    p = PARAMS[pi]
    rng = np.random.default_rng(540 + pi)
    B, N = 16, 512
    t_pre = np.repeat(rng.uniform(60, 120, 7), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 5), 6).astype(np.float32)
    if multi:
        rows, ms = TC.pad_template_rows([t_pre, t_suf])
        tmpl, mr = np.repeat(rows, B // 2, axis=0), np.repeat(ms, B // 2).astype(np.int32)
        row_t = [t_pre] * (B // 2) + [t_suf] * (B // 2)
    else:
        tmpl, m = TC.pad_template(t_pre)
        mr = np.full(B, m, np.int32)
        row_t = [t_pre] * B
    bins, lut, na = _morph_batch(rng, B, N, row_t)
    levels, lidx = TC.template_levels(tmpl)
    b, lt, n, lv, li, t, m_d = (torch.from_numpy(x).to(cuda_device)
                                for x in (bins, lut, na, levels, lidx, tmpl, mr))
    name = "align_forward_wave_multi" if multi else "align_forward_wave"
    before = dict(_build.LAUNCHES)
    if multi:
        ptr, bot = TC.align_forward_wave_multi_morph(b, lt, n, lv, li, m_d, p)
        ptr_k, bot_k = TC.align_forward_wave_multi(TC.morph_decode(b, lt), n, t, m_d, p)
    else:
        ptr, bot = TC.align_forward_wave_morph(b, lt, n, lv, li, p, int(mr[0]))
        ptr_k, bot_k = TC.align_forward_wave(TC.morph_decode(b, lt), n, t, p, int(mr[0]))
    assert _build.LAUNCHES[name + "_table"] == before[name + "_table"] + 1
    assert _build.LAUNCHES[name] == before[name] + 1
    ptr_p, bot_p = TC._wave_table_plain(b, lt, lv, li, n, m_d, p)
    mask = _valid_words(n, m_d, ptr.shape[0])
    for got_ptr, got_bot in ((ptr, bot), (ptr_k, bot_k)):
        assert torch.equal(got_ptr[mask], ptr_p[mask])
        assert torch.equal(got_bot, bot_p)


@pytest.mark.gpu
@pytest.mark.parametrize("mp", [256, 1152])
def test_gpu_wave_over_the_cap_runs_pow(cuda_device, mp):
    """A template with one level more than the score table holds (222
    levels at MP 256), or with more lanes than TABLE mode runs (MP 1152,
    9 levels), runs the POW mode on the card and equals the table twin."""
    rng = np.random.default_rng(550)
    if mp <= TC.TABLE_MAX_MP:
        n_vals = (TC.SMEM_BYTES // 4 - 4 * (mp + 1)) // TC.SCORE_COLS  # + the pad: cap + 1
    else:
        n_vals = 8
    t = rng.permutation(np.resize(np.linspace(60, 120, n_vals), mp - 1)).astype(np.float32)
    tp, m = TC.pad_template(t)
    levels, lidx = TC.template_levels(tp)
    assert tp.shape[1] == mp and TC.wave_score_mode(levels.shape[1], mp) == "pow"
    bins, lut, na = _morph_batch(rng, 8, 512, [t[:200]] * 8)
    b, lt, n, lv, li = (torch.from_numpy(x).to(cuda_device) for x in (bins, lut, na, levels, lidx))
    before = dict(_build.LAUNCHES)
    ptr, bot = TC.align_forward_wave_morph(b, lt, n, lv, li, AlignParams(), m)
    assert _build.LAUNCHES["align_forward_wave"] == before["align_forward_wave"] + 1
    assert _build.LAUNCHES["align_forward_wave_table"] == before["align_forward_wave_table"]
    m_d = torch.full((8,), m, dtype=torch.int32, device=cuda_device)
    ptr_p, bot_p = TC._wave_table_plain(b, lt, lv, li, n, m_d, AlignParams())
    mask = _valid_words(n, m_d, ptr.shape[0])
    assert torch.equal(ptr[mask], ptr_p[mask]) and torch.equal(bot, bot_p)


@pytest.mark.gpu
def test_gpu_fused_pair_one_128_row_launch(cuda_device, monkeypatch):
    """Both flanks of 64 morph-form reads: one 128-row TABLE launch on a
    card of at least 128 SMs, with the plain CPU path's outputs."""
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    if TC.sm_count(cuda_device) < 128:
        pytest.skip("needs a card of at least 128 SMs")
    rng = np.random.default_rng(560)
    t_pre = np.repeat(rng.uniform(60, 120, 6), 6).astype(np.float32)
    t_suf = np.repeat(rng.uniform(60, 120, 4), 6).astype(np.float32)
    bins, lut, na = _morph_batch(rng, 64, 512, [t_pre] * 64)
    _build.reset_launches()
    calls0 = TA.kernel_stats()["calls"]
    pre, suf = TA.align_fused_pair(torch.from_numpy(bins).to(cuda_device),
                                   torch.from_numpy(na).to(cuda_device), t_pre, t_suf,
                                   AlignParams(), lut=torch.from_numpy(lut).to(cuda_device))
    assert _build.LAUNCHES["align_forward_wave_multi_table"] == 1
    assert TA.kernel_stats()["calls"] - calls0 == 1
    assert sum(_build.LAUNCHES[k] for k in ("align_forward_wave", "align_forward_wave_multi",
                                            "align_forward_wave_table")) == 0
    ref = TA.align_fused_pair(torch.from_numpy(bins), torch.from_numpy(na), t_pre, t_suf,
                              AlignParams(), lut=torch.from_numpy(lut))
    for got, want in zip((pre, suf), ref):
        for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
            assert torch.equal(got[k].cpu(), want[k]), k


# the narrow forward's HMM at each SP (a multiple of 128 up to
# NARROW_MAX_SP) in each slot layout: chained, c9orf72's repeat between
# flanks of 25 to 130 bases, or (past SP 640) a random unit of 90 to 130
# bases between 50-base flanks -> (unit bases, flank); diagonal-only, the
# mod HMM of GGCCCC or of a random unit of 60 to 250 bases -> unit bases
NARROW_REPEAT = {128: (6, 25), 256: (6, 50), 384: (6, 75), 512: (6, 100), 640: (6, 130),
                 768: (90, 50), 896: (110, 50), 1024: (130, 50)}
NARROW_MOD = {128: 6, 256: 60, 384: 90, 512: 120, 640: 150, 768: 180, 896: 210, 1024: 250}


def _narrow_hmm(pm, pm_mod, sp, layout):
    """(CompiledHMM, a read's sequence) of the narrow forward at SP in
    slot layout code ``layout`` (NARROW_REPEAT; NARROW_MOD, the mod HMM
    of ``pm`` and its twin ``pm_mod``)."""
    if layout == 0:
        bases, flank = NARROW_REPEAT[sp]
        unit = REPEAT if bases == 6 else random_unit(bases, bases)
        return (build_flanked_repeat(unit, PREFIX[-flank:], SUFFIX[:flank], pm),
                PREFIX[-flank:] + unit * (4096 // (8 * bases) + 2) + SUFFIX[:flank])
    bases = NARROW_MOD[sp]
    unit = REPEAT if bases == 6 else random_unit(bases, bases)
    return build_repeat_mod(unit, pm, pm_mod), unit * (4096 // (8 * bases) + 2)


def _check_narrow_forward(dev, ph, obs, lens):
    """The narrow forward (its layout's launch counter alone, at the
    rule's W) and the backward against their twins: rows below each
    length, fin and acc bit-equal, paths equal."""
    o = torch.from_numpy(obs).to(dev)
    n = torch.from_numpy(lens).to(dev)
    keys = [lay.name for lay in TVC.FWD_LAYOUTS]
    before = {k: _build.LAUNCHES[k] for k in keys}
    sc, fin, acc = TVC.viterbi_forward_factored(o, n, ph)
    assert {k: _build.LAUNCHES[k] - before[k] for k in keys} == {
        k: int(k == ph.fwd_layout.name) for k in keys}
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    live = torch.arange(obs.shape[1], device=dev)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)
    last = torch.argmax(fin + ph.end, dim=1)
    before = _build.LAUNCHES["viterbi_backward_batch"]
    path = TVC.viterbi_backward_batch(sc, last, n, ph.transT)
    assert _build.LAUNCHES["viterbi_backward_batch"] == before + 1
    assert torch.equal(path, TVC._bwd_plain(sc, last, n, ph.transT))


@pytest.mark.gpu
@pytest.mark.parametrize("sp", list(NARROW_REPEAT))
def test_gpu_factored_viterbi_matches_plain(cuda_device, model_file, sp):
    """The chained layout at every SP / 128 from 1 to 8, on W =
    ``fwd_warps`` warps a read: noisy reads of the repeat HMM, mixed
    lengths in one launch down to 1."""
    pm = PoreModel(model_file)
    chm, seq = _narrow_hmm(pm, None, sp, 0)
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == sp and ph.fwd_layout.code == 0
    rng = np.random.default_rng(11)
    T = 512
    lens = np.array([512, 500, 413, 300, 129, 65, 33, 1], np.int32)
    obs = np.zeros((len(lens), T), np.float32)
    for i, k in enumerate(lens):
        obs[i, :k] = pm.generate_signal(seq, samples=8, noise=True, rng=rng)[:k]
    _check_narrow_forward(cuda_device, ph, obs, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", [0, 1])
@pytest.mark.parametrize("sp", list(NARROW_REPEAT))
def test_gpu_narrow_forward_edges_match_plain(cuda_device, model_file, mod_models, sp, layout):
    """The narrow forward at every SP / 128 in both layouts at its edges:
    T 1000 (not a multiple of the 32-step obs chunk), a read of length 1,
    lengths ending mid-chunk and at T, mixed in one launch, and a read of
    constant obs (ties in every row)."""
    pm = PoreModel(mod_models[0] if layout else model_file)
    pm_mod = PoreModel(mod_models[1])
    chm, seq = _narrow_hmm(pm, pm_mod, sp, layout)
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == sp and ph.fwd_layout.code == layout
    rng = np.random.default_rng(70 + sp + layout)
    T = 1000
    lens = np.array([1000, 999, 517, 100, 64, 33, 31, 1], np.int32)
    obs = np.zeros((len(lens), T), np.float32)
    for i, k in enumerate(lens):
        x = (pm_mod if layout and i % 2 else pm).generate_signal(seq, samples=8, noise=True,
                                                               rng=rng)
        if layout:  # the counter clips a mod decode's samples to the HMM's levels
            x = np.clip(x, chm.meta["model_min"], chm.meta["model_max"])
        obs[i, :k] = x[:k]
    obs[3, :lens[3]] = 100.0
    _check_narrow_forward(cuda_device, ph, obs, lens)


@pytest.mark.gpu
def test_gpu_narrow_forward_traced_counts_its_warps(cuda_device, model_file):
    """A traced narrow launch counts ``viterbi.fwd.w<W>`` once, W the
    rule's (nothing untraced)."""
    from strique_tpu_torch.utils import trace

    pm = PoreModel(model_file)
    chm, seq = _narrow_hmm(pm, None, 256, 0)
    ph = TVC.PaddedHMM(chm, cuda_device)
    x = pm.generate_signal(seq, samples=8, noise=True, rng=np.random.default_rng(5))[:300]
    o = torch.from_numpy(np.stack([x, x]).astype(np.float32)).to(cuda_device)
    n = torch.tensor([300, 200], dtype=torch.int32, device=cuda_device)
    trace.reset()
    TVC.viterbi_forward_factored(o, n, ph)
    assert not trace.counts()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        trace.reset()
        TVC.viterbi_forward_factored(o, n, ph)
        counts = {k: v for k, v in trace.counts().items() if k.startswith("viterbi.fwd.")}
    assert counts == {f"viterbi.fwd.w{TVC.fwd_warps(256, 0)}": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(VITERBI_EDGES))
def test_gpu_viterbi_edges_match_plain(cuda_device, model_file, case):
    """Both Viterbi kernels against their twins at the edge inputs
    chip_smoke.py runs too: lengths below the backward's score-row ring
    and around the forward's obs chunks, constant obs (ties in every
    row), and SP 512."""
    pm = PoreModel(model_file)
    chm, obs, lens = viterbi_edge_case(pm, case, np.random.default_rng(60 + len(case)))
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == (512 if case == "SP 512" else 256)
    T = obs.shape[1]
    o = torch.from_numpy(obs).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    sc, fin, acc = TVC.viterbi_forward_factored(o, n, ph)
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    live = torch.arange(T, device=cuda_device)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)
    last = torch.argmax(fin + ph.end, dim=1)
    before = _build.LAUNCHES["viterbi_backward_batch"]
    path = TVC.viterbi_backward_batch(sc, last, n, ph.transT)
    assert _build.LAUNCHES["viterbi_backward_batch"] == before + 1
    assert torch.equal(path, TVC._bwd_plain(sc, last, n, ph.transT))


@pytest.fixture(scope="module")
def mod_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("mod")
    return (write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED),
            write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED))


@pytest.mark.gpu
@pytest.mark.parametrize("unit_bases,sp", [(b, sp) for sp, b in NARROW_MOD.items()])
def test_gpu_diag_forward_matches_plain(cuda_device, mod_models, unit_bases, sp):
    """The factored forward in its diagonal-only slot layout on a mod
    HMM at every SP / 128 from 1 to 8, on W = ``fwd_warps`` warps a read:
    GGCCCC's (26 states, SP 128), a 60-base unit's (242, SP 256), up to a
    250-base unit's (1002, SP 1024)."""
    pm, pm_mod = (PoreModel(m) for m in mod_models)
    rng = np.random.default_rng(20 + unit_bases)
    unit = REPEAT if unit_bases == 6 else "".join(rng.choice(list("ACGT"), unit_bases))
    chm = build_repeat_mod(unit, pm, pm_mod)
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == sp and ph.fwd_layout.name == "viterbi_forward_factored_diag"
    T = 1024
    lens = np.array([1024, 1000, 513, 100, 65, 33, 17, 2], np.int32)
    obs = np.zeros((len(lens), T), np.float32)
    for i, k in enumerate(lens):
        x = (pm_mod if i % 2 else pm).generate_signal(unit * (T // (6 * len(unit)) + 2),
                                                      samples=8, noise=True, rng=rng)
        obs[i, :k] = np.clip(x, chm.meta["model_min"], chm.meta["model_max"])[:k]
    _check_narrow_forward(cuda_device, ph, obs, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(VITERBI_EDGES))
def test_gpu_diag_forward_edges_match_plain(cuda_device, mod_models, case):
    """The diagonal-only layout at the Viterbi edge inputs (short reads,
    obs-chunk boundaries, constant obs, the longest case) with the
    GGCCCC mod HMM."""
    pm, pm_mod = (PoreModel(m) for m in mod_models)
    _, obs, lens = viterbi_edge_case(pm, case, np.random.default_rng(80 + len(case)))
    ph = TVC.PaddedHMM(build_repeat_mod(REPEAT, pm, pm_mod), cuda_device)
    _check_narrow_forward(cuda_device, ph, obs, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(VITERBI_WIDE))
def test_gpu_wide_viterbi_matches_plain(cuda_device, mod_models, case):
    """Rows 3-4 past SP 1024 (``synthetic.VITERBI_WIDE``: SP 1152, 1792,
    2048, 4096, 4480 and 8192, both slot layouts, constant obs in each):
    the forward's cluster form in the HMM's layout on
    ``fwd_cluster_ctas``' CTAs and the wide backward, their launch
    counters alone (the one-CTA forward's not), against the twins: rows
    below each length, fin and acc bit-equal, paths equal."""
    pm, pm_mod = (PoreModel(m) for m in mod_models)
    chm, obs, lens = viterbi_wide_case(pm, pm_mod, case, np.random.default_rng(90 + len(case)))
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp > TVC.NARROW_MAX_SP
    o = torch.from_numpy(obs).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    layout = ph.fwd_layout
    keys = (layout.name, layout.cluster_name, "viterbi_backward_batch", "viterbi_backward_wide")
    before = {k: _build.LAUNCHES[k] for k in keys}
    sc, fin, acc = TVC.viterbi_forward_factored(o, n, ph)
    last = torch.argmax(fin + ph.end, dim=1)
    path = TVC.viterbi_backward_batch(sc, last, n, ph.transT)
    assert {k: _build.LAUNCHES[k] - before[k] for k in keys} == {
        layout.name: 0, layout.cluster_name: 1, "viterbi_backward_batch": 0,
        "viterbi_backward_wide": 1}
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    live = torch.arange(obs.shape[1], device=cuda_device)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)
    assert torch.equal(path, TVC._bwd_plain(sc, last, n, ph.transT))


@pytest.mark.gpu
@pytest.mark.parametrize("label", list(BWD_EDGES))
def test_gpu_wide_backward_edges_match_plain(cuda_device, label):
    """The wide backward on the edge inputs (``synthetic.BWD_EDGES``: -0.0
    against +0.0 ties, ties at NEG across the CTA's warps, random ties;
    SP 1152, 4480 and 8192), its counter alone, paths equal to the
    twin's."""
    sc, transT, last, lens = (torch.from_numpy(x).to(cuda_device)
                              for x in bwd_edge_case(label, np.random.default_rng(70)))
    before = _build.LAUNCHES["viterbi_backward_wide"]
    path = TVC.viterbi_backward_batch(sc, last, lens, transT)
    assert _build.LAUNCHES["viterbi_backward_wide"] == before + 1
    assert torch.equal(path, TVC._bwd_plain(sc, last, lens, transT))


# the cluster forward's cases by SP, and every CTA count its rule can
# pick there: 2 to 8, each CTA of at most 1024 lanes and none of them
# empty (fwd_cluster_ctas; 7 CTAs of 192 lanes at SP 1152 leave the last
# empty, so neither the rule nor this list takes them)
WIDE_CTAS_CASES = {"flanked 150": 1152, "flanked 260": 1792, "mod 260": 1152, "mod 430": 1792}
WIDE_CTAS = [(case, c) for case, sp in WIDE_CTAS_CASES.items()
             for c in range(2, TVC.FWD_MAX_CLUSTER + 1)
             if TVC.fwd_cluster_lanes(sp, c) <= 1024
             and TVC.fwd_cluster_lanes(sp, c) * (c - 1) < sp]


@pytest.mark.gpu
@pytest.mark.parametrize("case,ctas", WIDE_CTAS)
def test_gpu_wide_forward_every_ctas_matches_plain(cuda_device, mod_models, case, ctas):
    """The cluster form at every CTA count from 2 to 8 a read that its
    rule can pick (beside the rule's: a CTA of 576 to 160 lanes at SP
    1152, of 896 to 224 at SP 1792, the last CTA part dead), both
    layouts, launched directly, bit-equal to the twin."""
    pm, pm_mod = (PoreModel(m) for m in mod_models)
    chm, obs, lens = viterbi_wide_case(pm, pm_mod, case, np.random.default_rng(95 + ctas))
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == WIDE_CTAS_CASES[case]
    o = torch.from_numpy(obs).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    B, T = o.shape
    sc = torch.empty((T, B, ph.sp), device=cuda_device)
    fin = torch.empty((B, ph.sp), device=cuda_device)
    acc = torch.empty((B,), device=cuda_device)
    src, w, ramp, counts = ph.fwd_tables()
    import ctypes

    _build.launch("viterbi_fwd_cluster_launch", cuda_device, o.data_ptr(), n.data_ptr(),
                  ph.start.data_ptr(), ph.mu.data_ptr(), ph.sigma.data_ptr(), ph.uni.data_ptr(),
                  ph.luni.data_ptr(), ph.lsig.data_ptr(), src.data_ptr(), w.data_ptr(),
                  ramp.data_ptr(), ctypes.addressof(counts), sc.data_ptr(), fin.data_ptr(),
                  acc.data_ptr(), B, T, ph.sp, ph.fwd_layout.code, ctas)
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    live = torch.arange(T, device=cuda_device)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)


@pytest.mark.gpu
@pytest.mark.parametrize("sp,layout", [(1152, 0), (1152, 1), (1792, 0), (8192, 1)])
def test_gpu_fwd_cluster_capacity_bounds_the_rule(cuda_device, sp, layout):
    """The card's count of clusters that run at once with one CTA an SM:
    at least one for every CTA count the kernel takes at SP, at most SMs
    / C, none for a count it refuses; and the rule's pick at 8 to 64
    reads is the most whose clusters all fit (or, where none fits, the
    fewest that hold the lanes)."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    caps = {}
    for c in range(1, TVC.FWD_MAX_CLUSTER + 1):
        cap = TVC.fwd_cluster_capacity(cuda_device, sp, layout, c)
        if TVC.fwd_cluster_lanes(sp, c) > 1024:
            assert cap == 0
        else:
            assert 1 <= cap <= sms // c
            caps[c] = cap
    assert TVC.fwd_cluster_capacity(cuda_device, sp, layout, TVC.FWD_MAX_CLUSTER + 1) == 0
    for rows in (8, 16, 24, 32, 48, 64):
        c = TVC.fwd_cluster_ctas(sp, rows, cuda_device, layout)
        fit = [k for k, cap in caps.items()
               if rows <= cap and TVC.fwd_cluster_lanes(sp, k) * (k - 1) < sp]
        assert c == (max(fit) if fit else min(caps)), rows


@pytest.mark.gpu
def test_gpu_card_refuses_past_max_sp(cuda_device, model_file):
    """An HMM past MAX_SP padded states is refused on the card where it is
    staged, before any launch."""
    pm = PoreModel(model_file)
    chm = build_flanked_repeat(REPEAT, PREFIX[-25:], SUFFIX[:25], pm)
    ph = TVC.PaddedHMM(chm, "cpu")
    sp = TVC.MAX_SP + TVC.LANE
    trans = np.full((sp, sp), TVC.NEG, np.float32)
    before = dict(_build.LAUNCHES)
    with pytest.raises(ValueError, match=f"{TVC.MAX_SP} padded states"):
        TVC.PaddedHMM.from_arrays(ph.n_states, trans, *(np.zeros(sp, np.float32),) * 4,
                                  np.zeros(sp, np.int32), np.zeros(sp, np.float32), None, None,
                                  device=cuda_device)
    assert dict(_build.LAUNCHES) == before


@pytest.mark.gpu
def test_gpu_mod_counter_matches_cpu_counter(cuda_device, mod_models):
    """The mod path on the card against the plain CPU path, tuple for
    tuple, on base and twin reads of both strands."""
    base, twin = mod_models
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    prefix, suffix = PREFIX[-80:], SUFFIX[:80]
    for strand in "+-":
        reads = make_mod_reads(pm, pm_mod, 4, 30, np.random.default_rng(13), strand,
                               flank_bases=200, prefix=prefix, suffix=suffix)
        out = []
        for dev in (cuda_device, "cpu"):
            c = RepeatCounter(base, mod_model_file=twin, device=dev)
            c.add_target("c9orf72", REPEAT, prefix, suffix)
            out.append(c.detect_many("c9orf72", reads, strand))
        assert out[0] == out[1]
        assert all(r[6] not in ("", "-") for r in out[0])


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(VITERBI_EDGES))
def test_gpu_dense_viterbi_edges_match_plain(cuda_device, model_file, case):
    """The dense forward (resident mode: SP 256 and 512) against its twin
    at the Viterbi edge inputs: short lengths, lengths around 32-step
    chunks, constant obs (ties in every row) and SP 512."""
    pm = PoreModel(model_file)
    chm, obs, lens = viterbi_edge_case(pm, case, np.random.default_rng(70 + len(case)))
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert TVC.dense_mode(ph.sp).kind == "resident"
    _check_dense(cuda_device, ph, obs, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("sp", [640, 1152])
@pytest.mark.parametrize("case", list(VITERBI_EDGES))
def test_gpu_dense_wide_edges_match_plain(cuda_device, model_file, case, sp):
    """The SLICE (SP 640) and STREAMED (SP 1152) modes at the Viterbi
    edge inputs' lengths and observations (constant obs among them),
    decoded by the repeat HMM of a 60- or 150-base unit."""
    pm = PoreModel(model_file)
    _, obs, lens = viterbi_edge_case(pm, case, np.random.default_rng(75 + len(case)))
    ph = TVC.PaddedHMM(_dense_wide_hmm(pm, sp)[1], cuda_device)
    assert TVC.dense_mode(ph.sp).kind == ("slice" if sp == 640 else "stream")
    _check_dense(cuda_device, ph, obs, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_gpu_col_table_mode_matches_pow_and_plain(cuda_device, pi):
    """Morph-form reads (a samples=6 template): the column kernel's TABLE
    mode, its POW mode on the decoded f32 and the table twin, bit for bit
    in the written pointer words and every bottom tap."""
    p = PARAMS[pi]
    rng = np.random.default_rng(560 + pi)
    B, N = 16, 512
    template = np.repeat(rng.uniform(60, 120, 7), 6).astype(np.float32)
    bins, lut, na = _morph_batch(rng, B, N, [template] * B)
    tp, m = TC.pad_template(template)
    levels, lidx = TC.template_levels(tp)
    b, lt, n, lv, li, t = (torch.from_numpy(x).to(cuda_device)
                           for x in (bins, lut, na, levels, lidx, tp))
    before = dict(_build.LAUNCHES)
    ptr, bot = TC.align_forward_col_morph(b, lt, n, lv, li, p, m)
    assert _build.LAUNCHES["align_forward_col_table"] == before["align_forward_col_table"] + 1
    assert _build.LAUNCHES["align_forward_col"] == before["align_forward_col"]
    ptr_k, bot_k = TC.align_forward_col(TC.morph_decode(b, lt), n, t, p, m)
    ptr_p, bot_p = TC._col_table_plain(b, lt, lv, li, n, p, m)
    mask = _valid_words(n, torch.zeros_like(n), ptr.shape[0])
    for got_ptr, got_bot in ((ptr, bot), (ptr_k, bot_k)):
        assert torch.equal(got_ptr[mask], ptr_p[mask])
        assert torch.equal(got_bot, bot_p)


@pytest.mark.gpu
@pytest.mark.parametrize("pi", range(len(PARAMS)))
def test_gpu_col_and_traceback_match_plain(cuda_device, pi):
    """The column kernel and the column-layout traceback against their
    twins: written pointer words, every bottom tap and the walks equal."""
    p = PARAMS[pi]
    rng = np.random.default_rng(520 + pi)
    B, N = 16, 512
    template = rng.uniform(60, 120, 40).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = 30 + 20 * i
        signals[i, st : st + 40] = template + rng.normal(0, 0.5, 40)
    s = torch.from_numpy(signals).to(cuda_device)
    n = torch.from_numpy(rng.integers(300, 500, B).astype(np.int32)).to(cuda_device)
    tp, m = TC.pad_template(template)
    tmpl = torch.from_numpy(tp).to(cuda_device)
    before = _build.LAUNCHES["align_forward_col"]
    ptr, bot = TC.align_forward_col(s, n, tmpl, p, m)
    assert _build.LAUNCHES["align_forward_col"] == before + 1
    ptr_p, bot_p = TC._col_plain(s, tmpl, n, p, m)
    mask = _valid_words(n, torch.zeros_like(n), ptr.shape[0])  # (j-1)//8 < ceil(n/8)
    assert torch.equal(ptr[mask], ptr_p[mask])
    assert torch.equal(bot, bot_p)
    b0 = torch.full((B, 1), float(TA._b0(p, m)), device=cuda_device)
    j_end = torch.argmax(torch.cat([b0, bot], dim=1), dim=1).to(torch.int32)
    m_start = torch.full((B,), m, dtype=torch.int32, device=cuda_device)
    before = _build.LAUNCHES["traceback_pointers_col"]
    got = TA.traceback_pointers(ptr, j_end, m, packed=True)
    assert _build.LAUNCHES["traceback_pointers_col"] == before + 1
    ref = TA._traceback_plain(ptr, j_end, m_start, m, col=True)
    for k in ("is_gap", "jpos", "j_begin"):
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [1, 8, 48, 128])
@pytest.mark.parametrize("col", [False, True])
def test_gpu_traceback_hard_planes_match_plain(cuda_device, rows, col):
    """Both layouts' walks on the planes a lane window can miss
    (``synthetic.traceback_plane``: V runs past 128 lanes, H runs across
    more than 16 word groups, j_end 0 and below, m_start 0 and MP - 1,
    code 3), bit-equal to the plain walk, one launch each."""
    ptr, j_end, m_start, m_out = traceback_plane(rows, 40 + rows, col)
    ptr, j_end, m_start = (torch.from_numpy(x).to(cuda_device) for x in (ptr, j_end, m_start))
    name = "traceback_pointers_col" if col else "traceback_pointers"
    before = _build.LAUNCHES[name]
    got = TA.traceback_pointers(ptr, j_end, m_out, packed=True if col else "diag",
                                m_start=m_start)
    assert _build.LAUNCHES[name] == before + 1
    ref = TA._traceback_plain(ptr, j_end, m_start, m_out, col=col)
    assert got["is_gap"].dtype == torch.bool
    for k in ("is_gap", "jpos", "j_begin"):
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.gpu
def test_gpu_align_core_col_matches_wave(cuda_device, monkeypatch):
    """align_core under STRIQUE_ALIGN_KERNEL=col runs the column kernel
    alone and gives the wave route's outputs exactly: on f32 signals in
    the POW mode, on their morph form in the TABLE mode."""
    rng = np.random.default_rng(530)
    template = rng.uniform(60, 120, 40).astype(np.float32)
    signals = rng.uniform(60, 120, (16, 512)).astype(np.float32)
    for i in range(16):
        signals[i, 40 + 20 * i : 80 + 20 * i] = template + rng.normal(0, 0.5, 40)
    s = torch.from_numpy(signals).to(cuda_device)
    n = torch.from_numpy(rng.integers(300, 500, 16).astype(np.int32)).to(cuda_device)
    wave = TA.align_core(s, n, template, AlignParams())
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    _build.reset_launches()
    col = TA.align_core(s, n, template, AlignParams())
    assert _build.LAUNCHES["align_forward_col"] == 1 and _build.LAUNCHES["align_forward_wave"] == 0
    assert _build.LAUNCHES["traceback_pointers_col"] == 1
    assert _build.LAUNCHES["traceback_pointers"] == 0
    for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
        assert torch.equal(wave[k], col[k]), k
    bins, lut = quantise(signals, rng)
    b, lt = torch.from_numpy(bins).to(cuda_device), torch.from_numpy(lut).to(cuda_device)
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL")
    wave = TA.align_core(b, n, template, AlignParams(), lut=lt)
    monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
    _build.reset_launches()
    col = TA.align_core(b, n, template, AlignParams(), lut=lt)
    assert _build.LAUNCHES["align_forward_col_table"] == 1
    assert _build.LAUNCHES["align_forward_col"] == 0
    for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
        assert torch.equal(wave[k], col[k]), k


DENSE_KEYS = ("viterbi_forward_dense_resident", "viterbi_forward_dense_slice",
              "viterbi_forward_dense_stream")


def _check_dense(cuda_device, ph, obs, lens):
    """The dense forward of ``ph`` on (obs, lens): the launch counter of
    ``dense_mode``'s mode alone, rows below each length, fin and acc
    bit-equal to the twin; returns the forward's outputs."""
    o = torch.from_numpy(obs).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    name = TVC.dense_mode(ph.sp).name
    before = dict(_build.LAUNCHES)
    sc, fin, acc = TVC.viterbi_forward_dense(o, n, ph)
    assert {k: _build.LAUNCHES[k] - before[k] for k in DENSE_KEYS} == {
        k: int(k == name) for k in DENSE_KEYS}
    sc_p, fin_p, acc_p = TVC._fwd_dense_plain(o, n, ph)
    live = torch.arange(obs.shape[1], device=cuda_device)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)
    return o, n, sc, fin


@pytest.mark.gpu
@pytest.mark.parametrize("flank,sp", [(25, 128), (50, 256), (75, 384), (100, 512), (130, 640)])
def test_gpu_dense_viterbi_matches_plain(cuda_device, model_file, flank, sp):
    """The dense forward against its twin at SP 128, 256, 384 and 512
    (the resident mode, clusters of 1, 2, 6 and 8 CTAs) and 640 (the
    SLICE mode, 8 CTAs): rows below each read's length, fin and acc
    bit-equal; then decoded, its paths equal the factored forward's on
    this factoring HMM.  Reads are cut off at T 1024 up to SP 384; at SP
    512 and 640 they are whole, because on cut-off SP 512 reads the two
    forwards' rows split a 1-ulp tie in the backward, in the JAX package
    as in this one (tests/test_torch_dense.py
    test_dense_and_factored_paths_split_as_in_jax)."""
    pm = PoreModel(model_file)
    chm = build_flanked_repeat(REPEAT, PREFIX[-flank:], SUFFIX[:flank], pm)
    rng = np.random.default_rng(40 + flank)
    T = 1024 if sp <= 384 else 2560  # past SP 384 every read whole
    obs = np.zeros((8, T), np.float32)
    lens = np.zeros(8, np.int32)
    for i, k in enumerate([1, 2, 3, 5, 8, 2, 6, 4]):
        x = pm.generate_signal(PREFIX[-flank:] + REPEAT * k + SUFFIX[:flank], samples=8,
                               noise=True, rng=rng).astype(np.float32)[:T]
        obs[i, : len(x)] = x
        lens[i] = len(x)
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == sp
    assert TVC.dense_mode(sp).kind == ("resident" if sp <= 512 else "slice")
    o, n, sc, fin = _check_dense(cuda_device, ph, obs, lens)
    last = torch.argmax(fin + ph.end, dim=1)
    path = TVC.viterbi_backward_batch(sc, last, n, ph.transT)
    sc_f, fin_f, _ = TVC.viterbi_forward_factored(o, n, ph)
    path_f = TVC.viterbi_backward_batch(sc_f, torch.argmax(fin_f + ph.end, dim=1), n, ph.transT)
    assert torch.equal(path, path_f)


# past SP 512: the repeat HMM of a random unit between 50-base flanks
DENSE_WIDE = {640: 60, 768: 90, 896: 110, 1024: 130, 1152: 150, 8192: 1330}


def _dense_wide_hmm(pm, sp):
    unit = "".join(np.random.default_rng(DENSE_WIDE[sp]).choice(list("ACGT"), DENSE_WIDE[sp]))
    return unit, build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm)


def _dense_wide_case(model_file, sp, T, rng):
    pm = PoreModel(model_file)
    unit, chm = _dense_wide_hmm(pm, sp)
    lens = np.minimum([T, T - 1, T // 2 + 1, 65, 33, 17, 2, 1], T).astype(np.int32)
    obs = np.zeros((8, T), np.float32)
    for i, k in enumerate(lens):
        x = pm.generate_signal(PREFIX[-50:] + unit * 2 + SUFFIX[:50], samples=8, noise=True,
                               rng=rng).astype(np.float32)
        obs[i, :k] = x[:k]
    return chm, obs, lens


@pytest.mark.gpu
@pytest.mark.parametrize("sp", list(DENSE_WIDE))
def test_gpu_dense_wide_matches_plain(cuda_device, model_file, sp):
    """The dense forward past SP 512 at each boundary of ``dense_mode``:
    SLICE at SP 640 (8 CTAs), STREAMED at 768, 896, 1024, 1152 and 8192
    (8 CTAs), its launch counter alone, bit-equal to the twin."""
    T = 64 if sp == 8192 else 512
    chm, obs, lens = _dense_wide_case(model_file, sp, T, np.random.default_rng(sp))
    ph = TVC.PaddedHMM(chm, cuda_device)
    assert ph.sp == sp and TVC.dense_mode(sp).kind == ("slice" if sp == 640 else "stream")
    _check_dense(cuda_device, ph, obs, lens)


@pytest.mark.gpu
@pytest.mark.parametrize("sp,ctas,slice_", [(640, 4, 0), (640, 5, 0), (768, 4, 0),
                                            (768, 6, 0), (1152, 4, 0), (1152, 6, 0)])
def test_gpu_dense_every_ctas_matches_plain(cuda_device, model_file, sp, ctas, slice_):
    """The STREAMED kernel at cluster sizes beside the rule's 8, launched
    directly, bit-equal to the twin."""
    chm, obs, lens = _dense_wide_case(model_file, sp, 256, np.random.default_rng(sp + ctas))
    ph = TVC.PaddedHMM(chm, cuda_device)
    o = torch.from_numpy(obs).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    B, T = o.shape
    sc = torch.empty((T, B, sp), device=cuda_device)
    fin = torch.empty((B, sp), device=cuda_device)
    acc = torch.empty((B,), device=cuda_device)
    _build.launch("viterbi_dense_stream_launch", cuda_device, o.data_ptr(), n.data_ptr(),
                  ph.trans.data_ptr(), ph.start.data_ptr(), ph.mu.data_ptr(),
                  ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(),
                  ph.lsig.data_ptr(), sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, sp,
                  ctas, slice_)
    sc_p, fin_p, acc_p = TVC._fwd_dense_plain(o, n, ph)
    live = torch.arange(T, device=cuda_device)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)


@pytest.mark.gpu
def test_gpu_counter_matches_cpu_counter(cuda_device, model_file):
    """The whole split path on the card against the plain CPU path."""
    pm = PoreModel(model_file)
    rng = np.random.default_rng(12)
    prefix, suffix = PREFIX[-80:], SUFFIX[:80]
    reads = [make_reads(pm, 1, k, rng, strand="+", flank_bases=200, prefix=prefix,
                        suffix=suffix)[0] for k in (5, 9, 14)]
    out = []
    for dev in (cuda_device, "cpu"):
        c = RepeatCounter(model_file, device=dev)
        c.add_target("c9orf72", REPEAT, prefix, suffix)
        out.append(c.detect_many("c9orf72", reads, "+"))
    assert out[0] == out[1]


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["fused", "two-phase"])
def test_gpu_counter_routes_match_cpu_counter(cuda_device, model_file, route):
    """The fused dispatch (row 2 TABLE, no row 1) and the two-phase
    host-bounds path (row 1 TABLE, one call a flank, no row 2) on the card
    against the same route on the plain CPU path; the last read, its
    flanks swapped, is gated."""
    pm = PoreModel(model_file)
    rng = np.random.default_rng(12)
    prefix, suffix = PREFIX[-80:], SUFFIX[:80]
    reads = [make_reads(pm, 1, k, rng, strand="+", flank_bases=200, prefix=prefix,
                        suffix=suffix)[0] for k in (5, 9, 14)]
    reads.append(make_reads(pm, 1, 9, rng, strand="+", flank_bases=200, prefix=suffix,
                            suffix=prefix)[0])
    n = max(len(r) for r in reads)
    reads = [np.pad(r, (0, n - len(r)), mode="edge") for r in reads]
    out = []
    for dev in (cuda_device, "cpu"):
        c = RepeatCounter(model_file, device=dev)
        c.split = False
        c.fused = route == "fused"
        c.add_target("c9orf72", REPEAT, prefix, suffix)
        _build.reset_launches()
        out.append(c.detect_many("c9orf72", reads, "+"))
        if dev == cuda_device:
            lc = dict(_build.LAUNCHES)
    assert out[0] == out[1]
    assert [r[0] for r in out[0]] == [5, 9, 14, 0] and out[0][3][3] == 0.0
    row1, row2 = lc["align_forward_wave_table"], lc["align_forward_wave_multi_table"]
    assert (row1, row2) == ((0, 1) if route == "fused" else (2, 0))
    assert lc["viterbi_forward_factored"] == lc["viterbi_backward_batch"] == 1


@pytest.mark.gpu
@pytest.mark.parametrize("route", ["split", "fused", "two-phase"])
def test_gpu_flat_read_matches_cpu_counter(cuda_device, model_file, route):
    """A flat read (every sample equal: the prep's level table and flt
    channel are all NaN, on the JAX package's prep too) is gated on every
    route; its row must be the CPU path's, offset included.  The card's
    alignment kernels took the max of NaN and a number as the number
    (fmaxf) where the plain twins and the reference propagate the NaN, so
    the card's gated row ended its prefix elsewhere (offset 449 against 0
    on the CPU, NVIDIA H100); their max is now max.NaN.f32."""
    reads = [np.full(3000, 90.0)]
    out = []
    for dev in (cuda_device, "cpu"):
        c = RepeatCounter(model_file, device=dev)
        c.split = route == "split"
        c.fused = route != "two-phase"
        c.add_target("c9orf72", REPEAT, PREFIX[-80:], SUFFIX[:80])
        out.append(c.detect_many("c9orf72", reads, "+"))
    assert out[1] == [(0, 0.0, 0.0, 0.0, 0, 0, "-")]
    assert out[0] == out[1]


@pytest.mark.gpu
@pytest.mark.parametrize("k", [0, 2, 3, 6, 7, 9, 11, 20])
def test_gpu_sweep_corner_matches_cpu(cuda_device, k, monkeypatch):
    """A handful of the AlignParams sweep's corners (``synthetic.sweep_cases``:
    dist_min 8 with and without the curve, dist_min -4, positive h and v
    gaps, free v gaps, steep h gaps, a seeded draw): ``align_core`` on the
    wave and column routes and the two-pass route where a span bound
    exists, in f32 and in morph form, on the card against the same calls
    on the plain CPU path."""
    from strique_tpu_torch.synthetic import sweep_cases

    p, signals, na, template = sweep_cases()[k]
    bins, lut = quantise(signals, np.random.default_rng(k))
    inputs = {"f32": (signals, None), "morph": (bins, lut)}

    def run(dev, form, route):
        sig, lt = inputs[form]
        s_d = torch.from_numpy(sig).to(dev)
        n_d = torch.from_numpy(na).to(dev)
        l_d = None if lt is None else torch.from_numpy(lt).to(dev)
        if route == "two-pass":
            return TA.align_batch_longread(s_d, n_d, template, p, ckpt_steps=128, lut=l_d)
        return TA.align_core(s_d, n_d, template, p, lut=l_d)

    routes = ["wave", "col"]
    if TC.wave_span_bound_steps(p, len(template)) is not None:
        routes.append("two-pass")
    for route in routes:
        if route == "col":
            monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
        else:
            monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
        for form in inputs:
            got, ref = run(cuda_device, form, route), run("cpu", form, route)
            for key in ("score", "j_end", "is_gap", "jpos", "j_begin"):
                assert torch.equal(got[key].cpu(), ref[key]), (k, route, form, key)


def _longread_reads(rng, B=8, N=4096, M=40):
    """Reads whose template sits early (cold pass-2 windows) or late (warm)."""
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B):
        st = int(rng.integers(0, 600)) if i % 2 else int(rng.integers(N // 2, N - 3 * M))
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M)
    na = rng.integers(N - 3 * M, N, B).astype(np.int32)
    return signals, na, template


def _written_slots(n_act, m, nd, ckpt_steps):
    """(n_ck, B) mask of the checkpoint slots a row's pass 1 writes."""
    stop = torch.clamp_max((n_act.to(torch.int64) + m + 7) // 8 * 8, nd)
    g = torch.arange(nd // ckpt_steps, device=n_act.device)[:, None]
    return (g + 1) * ckpt_steps <= stop[None, :]


@pytest.mark.gpu
@pytest.mark.parametrize("pi", [0, 1])
def test_gpu_ckpt_and_window_match_plain(cuda_device, pi):
    """Kernel rows 5 and 6 against their twins: bottom taps and every
    written checkpoint slot bit-equal, then one window state through both
    window versions, written pointer words equal, cold and warm rows."""
    p = PARAMS[pi]
    signals, na, template = _longread_reads(np.random.default_rng(700 + pi))
    s = torch.from_numpy(signals).to(cuda_device)
    n = torch.from_numpy(na).to(cuda_device)
    before = _build.LAUNCHES["align_forward_ckpt"]
    st = TA._longread_pass1(s, n, template, p, ckpt_steps=512)
    assert _build.LAUNCHES["align_forward_ckpt"] == before + 1
    mr = torch.full((8,), st["m"], dtype=torch.int32, device=cuda_device)
    bot_p, ck_p = TC._ckpt_plain(st["sig"], st["tmpl"], n, mr, p, st["ckpt_steps"])
    assert torch.equal(st["bottom_steps"], bot_p)
    mask = _written_slots(n, st["m"], st["N"] + st["mp"], st["ckpt_steps"])
    for a, b in zip(st["ckpts"], ck_p):
        assert torch.equal(a[mask], b[mask])
    w = TA.window_inputs(st)
    assert 0 < int(w["cold"].sum()) < 8  # both kinds of restart
    args = (w["sig_win"], w["r_init"], w["state4"], w["cold"], w["steps_needed"], st["tmpl"], p)
    before = _build.LAUNCHES["align_window_from_state"]
    ptr = TC.align_window_from_state(*args, st["m"])
    assert _build.LAUNCHES["align_window_from_state"] == before + 1
    ptr_p = TC._window_plain(*args)
    words = _valid_words(w["steps_needed"], torch.zeros_like(n), ptr.shape[0])
    assert torch.equal(ptr[words], ptr_p[words])


@pytest.mark.gpu
@pytest.mark.parametrize("pi", [0, 1])
def test_gpu_ckpt_and_window_table_match_plain_and_pow(cuda_device, pi):
    """Rows 5-6 in the TABLE score mode on morph-form reads (a bins row of
    4096 samples under an ND of 4608: 0.0 past the row) against their
    table twins and against the POW kernels on lut[bins], bit for bit:
    bottom taps, written checkpoint slots, written pointer words of cold
    and warm windows."""
    p = PARAMS[pi]
    rng = np.random.default_rng(720 + pi)
    signals, na, template = _longread_reads(rng)
    bins, lut = quantise(signals, rng)
    b, lt, n = (torch.from_numpy(x).to(cuda_device) for x in (bins, lut, na))
    dec = TC.morph_decode(b, lt)
    before = dict(_build.LAUNCHES)
    st = TA._longread_pass1(b, n, template, p, ckpt_steps=512, lut=lt)
    st_k = TA._longread_pass1(dec, n, template, p, ckpt_steps=512)
    assert _build.LAUNCHES["align_forward_ckpt_table"] == before["align_forward_ckpt_table"] + 1
    assert _build.LAUNCHES["align_forward_ckpt"] == before["align_forward_ckpt"] + 1
    nd = st["N"] + st["mp"]
    assert st["sig"].shape[1] == 4096 < st["N"]
    mr = torch.full((8,), st["m"], dtype=torch.int32, device=cuda_device)
    bot_p, ck_p = TC._ckpt_table_plain(b, lt, st["levels"], st["lidx"], n, mr, p,
                                       st["ckpt_steps"], nd)
    mask = _written_slots(n, st["m"], nd, st["ckpt_steps"])
    for other_bot, other_ck in ((bot_p, ck_p), (st_k["bottom_steps"], st_k["ckpts"])):
        assert torch.equal(st["bottom_steps"], other_bot)
        for a, c in zip(st["ckpts"], other_ck):
            assert torch.equal(a[mask], c[mask])
    w = TA.window_inputs(st)
    w_k = TA.window_inputs(st_k)
    assert 0 < int(w["cold"].sum()) < 8  # both kinds of restart
    args = (w["t0"], w["state4"], w["cold"], w["steps_needed"], st["levels"], st["lidx"], p)
    ptr = TC.align_window_from_state_morph(b, lt, *args, st["m"], st["W"])
    assert (_build.LAUNCHES["align_window_from_state_table"]
            == before["align_window_from_state_table"] + 1)
    ptr_p = TC._window_table_plain(b, lt, *args, st["W"])
    ptr_k = TC.align_window_from_state(w_k["sig_win"], w_k["r_init"], w["state4"], w["cold"],
                                       w["steps_needed"], st_k["tmpl"], p, st["m"])
    words = _valid_words(w["steps_needed"], torch.zeros_like(n), ptr.shape[0])
    assert torch.equal(ptr[words], ptr_p[words])
    assert torch.equal(ptr[words], ptr_k[words])


@pytest.mark.gpu
def test_gpu_two_pass_align_core_matches_one_pass(cuda_device, monkeypatch):
    """align_core past a tiny pointer budget takes the two-pass kernels and
    gives the one-pass route's outputs exactly: POW on f32 reads; on
    morph-form reads a fused pair of 8 reads runs TABLE alone, pass 1 of
    both flanks in one 16-row launch."""
    rng = np.random.default_rng(710)
    signals, na, template = _longread_reads(rng)
    s = torch.from_numpy(signals).to(cuda_device)
    n = torch.from_numpy(na).to(cuda_device)
    one = TA.align_core(s, n, template, AlignParams())
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.0001")
    _build.reset_launches()
    two = TA.align_core(s, n, template, AlignParams())
    assert _build.LAUNCHES["align_forward_wave"] == 0
    assert _build.LAUNCHES["align_forward_ckpt"] == 1
    assert _build.LAUNCHES["align_window_from_state"] == 1
    for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
        assert torch.equal(one[k], two[k]), k

    if TC.sm_count(cuda_device) < 16:
        pytest.skip("the fused two-pass group needs a card of at least 16 SMs")
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    t_suf = rng.uniform(60, 120, 30).astype(np.float32)
    signals[:, 2500:2530] = t_suf
    bins, lut = quantise(signals, rng)
    b, lt = (torch.from_numpy(x).to(cuda_device) for x in (bins, lut))
    p = STEEP
    monkeypatch.delenv("STRIQUE_PTR_BUDGET_GB")
    one = TA.align_fused_pair(b, n, template, t_suf, p, lut=lt)
    # a width-8 one-pass plane (2.2 MB) exceeds 1 MB; at a 512-step stride
    # 16 rows of pass 2's window plane (0.7 MB) fit
    monkeypatch.setattr(TA, "CKPT_STEPS", 512)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "0.001")
    _build.reset_launches()
    two = TA.align_fused_pair(b, n, template, t_suf, p, lut=lt)
    assert _build.LAUNCHES["align_forward_ckpt_table"] == 1
    assert _build.LAUNCHES["align_window_from_state_table"] == 1
    assert sum(_build.LAUNCHES[k] for k in (
        "align_forward_ckpt", "align_window_from_state", "align_forward_wave",
        "align_forward_wave_multi", "align_forward_wave_table",
        "align_forward_wave_multi_table")) == 0
    for a, c in zip(one, two):
        for k in ("score", "j_end", "is_gap", "jpos", "j_begin"):
            assert torch.equal(a[k], c[k]), k


@pytest.mark.gpu
def test_gpu_count_cli_matches_cpu(cuda_device, tmp_path):
    """``strique_tpu_torch.cli count`` on the card writes the TSV of
    ``count --device cpu`` on tests/test_torch_cli.py's single-locus run
    (3 '+' reads, two signal buckets, one read QC-gated), byte for byte,
    through the kernels of the split path."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        pytest.skip("h5py is not installed: the run's reads are single-read fast5 files")
    from strique_tpu_torch import cli
    from strique_tpu_torch.synthetic import LOCI, write_count_run

    model = write_pore_model(str(tmp_path / "m.model"), seed=11)
    loci = {name: (c, b, e, r, p[-80:], s[:80]) for name, (c, b, e, r, p, s) in LOCI.items()}
    specs = [("c9orf72", 5, "+", 20), ("c9orf72", 20, "+", 20), ("c9orf72", 8, "+", 20)]
    (tmp_path / "run").mkdir()
    run = write_count_run(tmp_path / "run", PoreModel(model), specs, 5, loci)
    outs = {}
    for device in ("cpu", "cuda"):
        outs[device] = tmp_path / f"{device}.tsv"
        _build.reset_launches()
        assert cli.main(["count", run["fofn"], model, run["repeat"], "--algn", run["sam"],
                         "--out", str(outs[device]), "--batch", "4", "--device", device]) == 0
    assert outs["cuda"].read_bytes() == outs["cpu"].read_bytes()
    for name in ("align_forward_wave_multi_table", "traceback_pointers",
                 "viterbi_forward_factored", "viterbi_backward_batch"):
        assert _build.LAUNCHES[name] > 0, name


# ---------------------------------------------------------------------------
# The TABLE score mode on a thread-block cluster of CTAs a row (past one
# CTA's table), and NaN level tables (a flat read's) in every alignment
# kernel
# ---------------------------------------------------------------------------

# over-the-cap template widths and the CTAs a row the rule gives their
# samples=6 templates
CLUSTER_MPS = {1152: 2, 2176: 2, 4096: 4}
DEFAULT_P = AlignParams()


def _overcap_templates(rng, mp):
    """Two samples=6 templates, the longer one of the longest length that
    pads to ``mp`` lanes, the other 120 samples shorter."""
    m = (mp - 2) // 6 * 6
    return [np.repeat(rng.uniform(60, 120, k // 6), 6).astype(np.float32) for k in (m, m - 120)]


def _wave_rows(templates, B, multi):
    """(tmpl (R, MP), m_rows (B,)) of a shared template or per-row ones."""
    if multi:
        rows, ms = TC.pad_template_rows(templates)
        return np.repeat(rows, B // 2, axis=0), np.repeat(ms, B // 2).astype(np.int32)
    tp, m = TC.pad_template(templates[0])
    return tp, np.full(B, m, np.int32)


def _equal_nan(a, b):
    """Equal NaN masks and equal values elsewhere."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))


def _wave_call(b, lt, n, lv, li, m_d, p, multi):
    if multi:
        return TC.align_forward_wave_multi_morph(b, lt, n, lv, li, m_d, p)
    return TC.align_forward_wave_morph(b, lt, n, lv, li, p, int(m_d[0]))


@pytest.mark.gpu
@pytest.mark.parametrize("mp", list(CLUSTER_MPS))
@pytest.mark.parametrize("multi", [False, True])
def test_gpu_cluster_wave_matches_table_twin_and_pow(cuda_device, mp, multi):
    """Rows 1-2 past one CTA's table: the cluster TABLE mode (the split
    form of template_levels, the rule's CTAs a row) against the table
    twin on the same levels, and the POW kernel on lut[bins] against the
    same twin run: written pointer words and every bottom tap."""
    rng = np.random.default_rng(900 + mp + multi)
    B, N = 8, 512
    templates = _overcap_templates(rng, mp)
    tmpl, mr = _wave_rows(templates, B, multi)
    ctas = TC.wave_table_ctas(tmpl)
    assert tmpl.shape[1] == mp and ctas == CLUSTER_MPS[mp]
    bins, lut, na = _morph_batch(rng, B, N, [templates[0][:300]] * B)
    levels, lidx = TC.template_levels(tmpl, ctas)
    b, lt, n, lv, li, t, m_d = (torch.from_numpy(x).to(cuda_device)
                                for x in (bins, lut, na, levels, lidx, tmpl, mr))
    name = "align_forward_wave_multi" if multi else "align_forward_wave"
    before = dict(_build.LAUNCHES)
    ptr, bot = _wave_call(b, lt, n, lv, li, m_d, DEFAULT_P, multi)
    assert _build.LAUNCHES[name + "_cluster"] == before[name + "_cluster"] + 1
    assert all(_build.LAUNCHES[k] == before[k] for k in (name, name + "_table"))
    s = TC.morph_decode(b, lt)
    if multi:
        ptr_k, bot_k = TC.align_forward_wave_multi(s, n, t, m_d, DEFAULT_P)
    else:
        ptr_k, bot_k = TC.align_forward_wave(s, n, t, DEFAULT_P, int(mr[0]))
    ptr_p, bot_p = TC._wave_table_plain(b, lt, *TC.flat_levels(lv, li), n, m_d, DEFAULT_P)
    mask = _valid_words(n, m_d, ptr.shape[0])
    for got_ptr, got_bot in ((ptr, bot), (ptr_k, bot_k)):
        assert torch.equal(got_ptr[mask], ptr_p[mask])
        assert torch.equal(got_bot, bot_p)


def _two_pass_inputs(rng, mp, B=8, N=1024):
    """Morph reads of both over-the-cap flanks as per-row templates (the
    two-pass route's row stream): (bins, lut, na, tmpl rows, lengths)."""
    templates = _overcap_templates(rng, mp)
    tmpl, mr = _wave_rows(templates, B, True)
    bins, lut, na = _morph_batch(rng, B, N, [templates[i % 2][:200] for i in range(B)])
    return bins, lut, na, tmpl, mr


def _check_two_pass_cluster(dev, bins, lut, na, tmpl, mr, p, ctas, expect_nan=False):
    """Pass 1 and pass 2 in the TABLE mode of ``ctas`` CTAs a row (a
    cluster past one) against their table twins and the POW kernels on
    lut[bins]: bottom taps, written checkpoint slots (equal NaN masks
    where ``expect_nan``), written pointer words of every window."""
    b, lt, n = (torch.from_numpy(x).to(dev) for x in (bins, lut, na))
    form = "_cluster" if ctas > 1 else "_table"
    before = dict(_build.LAUNCHES)
    st = TA._pass1_rows(b, n, tmpl, mr, p, 512, lt, ctas)
    st_k = TA._pass1_rows(TC.morph_decode(b, lt), n, tmpl, mr, p, 512)
    assert (_build.LAUNCHES["align_forward_ckpt" + form]
            == before["align_forward_ckpt" + form] + 1)
    nd = st["N"] + st["mp"]
    m_rows = torch.from_numpy(mr).to(dev)
    flat = (TC.flat_levels(st["levels"], st["lidx"]) if ctas > 1
            else (st["levels"], st["lidx"]))
    bot_p, ck_p = TC._ckpt_table_plain(b, lt, *flat, n, m_rows, p, st["ckpt_steps"], nd)
    stop = torch.clamp_max((n.long() + m_rows.long() + 7) // 8 * 8, nd)
    g = torch.arange(nd // st["ckpt_steps"], device=dev)[:, None]
    mask = (g + 1) * st["ckpt_steps"] <= stop[None, :]
    eq = _equal_nan if expect_nan else torch.equal
    for other_bot, other_ck in ((bot_p, ck_p), (st_k["bottom_steps"], st_k["ckpts"])):
        assert eq(st["bottom_steps"], other_bot)
        for a, c in zip(st["ckpts"], other_ck):
            assert eq(a[mask], c[mask])
    w = TA.window_inputs(st)
    w_k = TA.window_inputs(st_k)
    args = (w["t0"], w["state4"], w["cold"], w["steps_needed"], st["levels"], st["lidx"], p)
    ptr = TC.align_window_from_state_morph(b, lt, *args, st["m"], st["W"])
    assert (_build.LAUNCHES["align_window_from_state" + form]
            == before["align_window_from_state" + form] + 1)
    ptr_p = TC._window_table_plain(b, lt, w["t0"], w["state4"], w["cold"], w["steps_needed"],
                                   *flat, p, st["W"])
    ptr_k = TC.align_window_from_state(w_k["sig_win"], w_k["r_init"], w["state4"], w["cold"],
                                       w["steps_needed"], st_k["tmpl"], p, st["m"])
    words = _valid_words(w["steps_needed"], torch.zeros_like(n), ptr.shape[0])
    assert torch.equal(ptr[words], ptr_p[words])
    assert torch.equal(ptr[words], ptr_k[words])


@pytest.mark.gpu
@pytest.mark.parametrize("mp", list(CLUSTER_MPS))
def test_gpu_cluster_ckpt_and_window_match_table_twin_and_pow(cuda_device, mp):
    """Rows 5-6 past one CTA's table, both flanks as per-row templates:
    the cluster TABLE modes against their table twins and the POW
    kernels, bit for bit."""
    bins, lut, na, tmpl, mr = _two_pass_inputs(np.random.default_rng(910 + mp), mp)
    ctas = TC.wave_table_ctas(tmpl)
    assert ctas == CLUSTER_MPS[mp]
    _check_two_pass_cluster(cuda_device, bins, lut, na, tmpl, mr, STEEP, ctas)


def _col_plan_ctas():
    """(MP, C) of every CTA count the column kernel's launch plan can give
    the over-the-cap template of each MP (col_launch_plan: from
    col_table_ctas up to 8, splits the kernel takes whose per-CTA tables
    fit); the templates are numpy's, so every worker collects the same."""
    out = []
    for mp in CLUSTER_MPS:
        tp, _ = TC.pad_template(_overcap_templates(np.random.default_rng(920 + mp), mp)[0])
        c_min = TC.col_table_ctas(tp)
        out += [(mp, c) for c in range(c_min, TC.MAX_CTAS + 1)
                if c == c_min or (TC._split_ok(mp, c) and TC.col_score_mode(
                    TC._cta_level_counts(tp, c), mp, c) == "table")]
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mp,ctas", _col_plan_ctas())
def test_gpu_cluster_col_matches_table_twin_and_pow(cuda_device, mp, ctas):
    """Row 8 past one CTA's table: the column kernel's cluster TABLE mode
    at every CTA count its launch plan can pick against the table twin,
    and its POW mode on lut[bins] against the same twin run; then again
    with read 0's level table all NaN (equal NaN masks)."""
    rng = np.random.default_rng(920 + mp)
    B, N = 8, 512
    template = _overcap_templates(rng, mp)[0]
    tp, m = TC.pad_template(template)
    assert 2 <= TC.col_table_ctas(tp) <= ctas
    bins, lut, na = _morph_batch(rng, B, N, [template[:300]] * B)
    levels, lidx = TC.template_levels(tp, ctas)
    b, lt, n, lv, li, t = (torch.from_numpy(x).to(cuda_device)
                           for x in (bins, lut, na, levels, lidx, tp))
    before = dict(_build.LAUNCHES)
    ptr, bot = TC.align_forward_col_morph(b, lt, n, lv, li, DEFAULT_P, m)
    assert _build.LAUNCHES["align_forward_col_cluster"] == before["align_forward_col_cluster"] + 1
    ptr_k, bot_k = TC.align_forward_col(TC.morph_decode(b, lt), n, t, DEFAULT_P, m)
    ptr_p, bot_p = TC._col_table_plain(b, lt, *TC.flat_levels(lv, li), n, DEFAULT_P, m)
    mask = _valid_words(n, torch.zeros_like(n), ptr.shape[0])
    for got_ptr, got_bot in ((ptr, bot), (ptr_k, bot_k)):
        assert torch.equal(got_ptr[mask], ptr_p[mask])
        assert torch.equal(got_bot, bot_p)
    # read 0's level table all NaN (a flat read's): the max_nan instance
    lt = torch.from_numpy(_nan_row(lut)).to(cuda_device)
    ptr, bot = TC.align_forward_col_morph(b, lt, n, lv, li, DEFAULT_P, m)
    ptr_k, bot_k = TC.align_forward_col(TC.morph_decode(b, lt), n, t, DEFAULT_P, m)
    ptr_p, bot_p = TC._col_table_plain(b, lt, *TC.flat_levels(lv, li), n, DEFAULT_P, m)
    assert torch.isnan(bot[0]).any()
    for got_ptr, got_bot in ((ptr, bot), (ptr_k, bot_k)):
        assert torch.equal(got_ptr[mask], ptr_p[mask]) and _equal_nan(got_bot, bot_p)


# every CTA count the launch plan can pick at the MPs the port meets
# (align_cuda.wave_launch_plan: from wave_table_ctas to 8, splits the
# kernel takes): one lane a thread up to 1024 lanes a CTA, two up to 1536
# (MP 2176 on 2 CTAs of 1152 lanes), four past it (MP 4096 on 2 CTAs of
# 2048 lanes)
PLAN_CTAS = [(896, 2), (896, 3), (896, 4), (896, 7), (2176, 2), (2176, 3), (2176, 4),
             (2176, 5), (2176, 6), (4096, 2), (4096, 4), (4096, 8)]


def _plan_templates(rng, mp):
    """Two samples=6 templates padding to ``mp`` lanes; at MP 4096 of 150
    values cycled, so that 2 CTAs of 2048 lanes hold their tables."""
    if mp != 4096:
        return _overcap_templates(rng, mp)
    vals = rng.uniform(60, 120, 150)
    m = (mp - 2) // 6 * 6
    return [np.repeat(np.resize(vals, k // 6), 6).astype(np.float32) for k in (m, m - 120)]


@pytest.mark.gpu
@pytest.mark.parametrize("mp,ctas", PLAN_CTAS)
def test_gpu_cluster_every_plan_ctas_matches_twin(cuda_device, mp, ctas):
    """The cluster form at every CTA count the plan can pick, with read
    0's level table all NaN (a flat read's): PTR (both flanks as per-row
    templates) against the table twin, at MP 896 also against the
    one-CTA kernel, then CKPT and WINDOW against their twins and the POW
    kernels; written pointer words equal, bottom taps and checkpoint
    slots equal with equal NaN masks."""
    rng = np.random.default_rng(950 + mp + ctas)
    B, N = 8, 512
    templates = _plan_templates(rng, mp)
    tmpl, mr = _wave_rows(templates, B, True)
    assert tmpl.shape[1] == mp and TC._split_ok(mp, ctas) and ctas >= TC.wave_table_ctas(tmpl)
    bins, lut, na = _morph_batch(rng, B, N, [templates[i % 2][:300] for i in range(B)])
    lut = _nan_row(lut)
    levels, lidx = TC.template_levels(tmpl, ctas)
    assert TC.wave_score_mode(levels.shape[2], mp, ctas) == "table"
    b, lt, n, lv, li, m_d = (torch.from_numpy(x).to(cuda_device)
                             for x in (bins, lut, na, levels, lidx, mr))
    before = dict(_build.LAUNCHES)
    ptr, bot = TC.align_forward_wave_multi_morph(b, lt, n, lv, li, m_d, DEFAULT_P)
    assert (_build.LAUNCHES["align_forward_wave_multi_cluster"]
            == before["align_forward_wave_multi_cluster"] + 1)
    ptr_p, bot_p = TC._wave_table_plain(b, lt, *TC.flat_levels(lv, li), n, m_d, DEFAULT_P)
    mask = _valid_words(n, m_d, ptr.shape[0])
    assert torch.isnan(bot[0]).any()
    assert torch.equal(ptr[mask], ptr_p[mask]) and _equal_nan(bot, bot_p)
    if mp <= 1024:
        lv1, li1 = (torch.from_numpy(x).to(cuda_device) for x in TC.template_levels(tmpl))
        ptr1, bot1 = TC.align_forward_wave_multi_morph(b, lt, n, lv1, li1, m_d, DEFAULT_P)
        assert (_build.LAUNCHES["align_forward_wave_multi_table"]
                == before["align_forward_wave_multi_table"] + 1)
        assert torch.equal(ptr[mask], ptr1[mask]) and _equal_nan(bot, bot1)
    tmpl2, mr2 = _wave_rows(templates, B, True)
    bins2, lut2, na2 = _morph_batch(rng, B, 1024, [templates[i % 2][:200] for i in range(B)])
    _check_two_pass_cluster(cuda_device, bins2, _nan_row(lut2), na2, tmpl2, mr2, STEEP, ctas,
                            expect_nan=True)


@pytest.mark.gpu
def test_gpu_cluster_refused_split_raises(cuda_device):
    """A split the kernel does not take (9 CTAs a row) is refused at the
    launch: the wrapper raises and counts no launch; nothing falls back
    to POW or to one CTA."""
    rng = np.random.default_rng(958)
    B, N = 8, 512
    templates = _overcap_templates(rng, 2176)
    tmpl, mr = _wave_rows(templates, B, True)
    bins, lut, na = _morph_batch(rng, B, N, [templates[0][:300]] * B)
    levels, lidx = TC.template_levels(tmpl, 9)
    b, lt, n, lv, li, m_d = (torch.from_numpy(x).to(cuda_device)
                             for x in (bins, lut, na, levels, lidx, mr))
    before = dict(_build.LAUNCHES)
    with pytest.raises(RuntimeError, match="wave_table_launch"):
        TC._wave_table_cuda(b, lt, lv, li, n, m_d, DEFAULT_P, "align_forward_wave_multi_cluster")
    assert _build.LAUNCHES == before


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 6, 20])
def test_gpu_cluster_sweep_corner_matches_twin(cuda_device, k):
    """Three AlignParams sweep corners (``synthetic.sweep_cases``: the
    curve at dist_min 8, steep h gaps, a seeded draw) at MP 2176: rows 1
    and 8 in the cluster TABLE mode against their table twins, and rows
    5-6 where a span bound exists."""
    from strique_tpu_torch.synthetic import sweep_cases

    p = sweep_cases()[k][0]
    rng = np.random.default_rng(930 + k)
    B, N = 8, 512
    template = _overcap_templates(rng, 2176)[0]
    tp, m = TC.pad_template(template)
    bins, lut, na = _morph_batch(rng, B, N, [template[:300]] * B)
    b, lt, n = (torch.from_numpy(x).to(cuda_device) for x in (bins, lut, na))
    m_d = torch.full((B,), m, dtype=torch.int32, device=cuda_device)
    for ctas_of, run, twin in (
            (TC.wave_table_ctas, lambda lv, li: TC.align_forward_wave_morph(b, lt, n, lv, li, p, m),
             lambda lv, li: TC._wave_table_plain(b, lt, lv, li, n, m_d, p)),
            (TC.col_table_ctas, lambda lv, li: TC.align_forward_col_morph(b, lt, n, lv, li, p, m),
             lambda lv, li: TC._col_table_plain(b, lt, lv, li, n, p, m))):
        ctas = ctas_of(tp)
        assert ctas >= 2
        lv, li = (torch.from_numpy(x).to(cuda_device) for x in TC.template_levels(tp, ctas))
        got, ref = run(lv, li), twin(*TC.flat_levels(lv, li))
        zero = torch.zeros_like(n) if ctas_of is TC.col_table_ctas else m_d
        mask = _valid_words(n, zero, got[0].shape[0])
        assert torch.equal(got[0][mask], ref[0][mask]) and torch.equal(got[1], ref[1])
    if TC.wave_span_bound_steps(p, m) is not None:
        bins2, lut2, na2, tmpl, mr = _two_pass_inputs(rng, 2176)
        _check_two_pass_cluster(cuda_device, bins2, lut2, na2, tmpl, mr, p,
                                TC.wave_table_ctas(tmpl))


def _nan_row(lut):
    """Row 0's level table all NaN, as the prep gives a flat read's."""
    lut = lut.copy()
    lut[0] = np.nan
    return lut


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["table", "pow", "cluster"])
@pytest.mark.parametrize("kernel", ["wave", "wave_multi", "two_pass", "col"])
def test_gpu_nan_lut_row_matches_twin(cuda_device, kernel, mode):
    """A read whose level table is all NaN (a flat read's) in rows 1, 2,
    5-6 and 8, in the TABLE (one CTA, or a cluster) and POW modes: the
    kernel against its twin, equal NaN masks and equal values elsewhere
    in the bottom taps (and written checkpoint slots), equal written
    pointer words.  The reference propagates the NaN through its maxes
    (jnp.maximum); so do the kernels and the twins."""
    rng = np.random.default_rng(940)
    B, N = 8, 512
    if mode == "cluster":
        templates = _overcap_templates(rng, 1152)
    else:
        templates = [np.repeat(rng.uniform(60, 120, k), 6).astype(np.float32) for k in (7, 5)]
    if kernel == "two_pass":
        bins, lut, na, tmpl, mr = _two_pass_inputs(rng, 1152) if mode == "cluster" else (
            *_morph_batch(rng, B, 1024, [templates[i % 2] for i in range(B)]),
            *_wave_rows(templates, B, True))
        lut = _nan_row(lut)
        if mode == "pow":
            s = TC.morph_decode(*(torch.from_numpy(x).to(cuda_device) for x in (bins, lut)))
            n = torch.from_numpy(na).to(cuda_device)
            st = TA._pass1_rows(s, n, tmpl, mr, STEEP, 512)
            m_rows = torch.from_numpy(mr).to(cuda_device)
            bot_p, ck_p = TC._ckpt_plain(st["sig"], st["tmpl"], n, m_rows, STEEP,
                                         st["ckpt_steps"])
            assert _equal_nan(st["bottom_steps"], bot_p)
            assert torch.isnan(st["bottom_steps"][0]).any()
            w = TA.window_inputs(st)
            args = (w["sig_win"], w["r_init"], w["state4"], w["cold"], w["steps_needed"],
                    st["tmpl"], STEEP)
            ptr, ptr_p = TC.align_window_from_state(*args, st["m"]), TC._window_plain(*args)
            words = _valid_words(w["steps_needed"], torch.zeros_like(n), ptr.shape[0])
            assert torch.equal(ptr[words], ptr_p[words])
            return
        _check_two_pass_cluster(cuda_device, bins, lut, na, tmpl, mr, STEEP,
                                TC.wave_table_ctas(tmpl), expect_nan=True)
        return
    multi = kernel == "wave_multi"
    tmpl, mr = _wave_rows(templates, B, multi)
    bins, lut, na = _morph_batch(rng, B, N, [templates[0][:200]] * B)
    lut = _nan_row(lut)
    ctas = (TC.col_table_ctas if kernel == "col" else TC.wave_table_ctas)(tmpl)
    assert ctas == (1 if mode != "cluster" else 2)
    levels, lidx = TC.template_levels(tmpl, ctas if mode == "cluster" else None)
    b, lt, n, lv, li, t, m_d = (torch.from_numpy(x).to(cuda_device)
                                for x in (bins, lut, na, levels, lidx, tmpl, mr))
    flat = TC.flat_levels(lv, li) if mode == "cluster" else (lv, li)
    m = int(mr[0])
    if kernel == "col":
        zero = torch.zeros_like(n)
        if mode == "pow":
            got = TC.align_forward_col(TC.morph_decode(b, lt), n, t, DEFAULT_P, m)
            ref = TC._col_plain(TC.morph_decode(b, lt), t, n, DEFAULT_P, m)
        else:
            got = TC.align_forward_col_morph(b, lt, n, lv, li, DEFAULT_P, m)
            ref = TC._col_table_plain(b, lt, *flat, n, DEFAULT_P, m)
        mask = _valid_words(n, zero, got[0].shape[0])
    else:
        if mode == "pow":
            s = TC.morph_decode(b, lt)
            got = (TC.align_forward_wave_multi(s, n, t, m_d, DEFAULT_P) if multi
                   else TC.align_forward_wave(s, n, t, DEFAULT_P, m))
            ref = TC._wave_plain(s, t, n, m_d, DEFAULT_P)
        else:
            got = _wave_call(b, lt, n, lv, li, m_d, DEFAULT_P, multi)
            ref = TC._wave_table_plain(b, lt, *flat, n, m_d, DEFAULT_P)
        mask = _valid_words(n, m_d, got[0].shape[0])
    assert torch.isnan(got[1][0]).any()
    assert torch.equal(got[0][mask], ref[0][mask])
    assert _equal_nan(got[1], ref[1])
