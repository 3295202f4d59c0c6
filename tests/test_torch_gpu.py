"""strique_tpu_torch CUDA kernels vs their plain PyTorch twins, on a card.

Every test here is marked ``gpu`` and skips where no CUDA device is
present (decided inside a fixture, so every worker collects the same
tests).  The file imports no JAX, so a GPU host without JAX can run it
without the JAX-side conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py

Integer outputs (pointer words, tracebacks, paths) and f32 outputs
(bottom taps, score rows, fin, acc) must be exactly equal: kernel and
twin evaluate the same expression trees with the same rounding on the
same card (CUDA's double ``pow`` on both sides).
"""
import numpy as np
import pytest
import torch

from strique_tpu_torch import _build
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.hmm.models import build_flanked_repeat
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.ops.reference import AlignParams
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, make_reads, write_pore_model

PARAMS = [
    AlignParams(),
    AlignParams(gap_open_h=-3.0, gap_extension_h=-0.5, gap_open_v=-20.0, gap_extension_v=-4.0),
    AlignParams(gap_open_h=1.0, gap_extension_h=0.5),
]


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


@pytest.mark.gpu
def test_gpu_factored_viterbi_matches_plain(cuda_device, model_file):
    pm = PoreModel(model_file)
    chm = build_flanked_repeat(REPEAT, PREFIX[-25:], SUFFIX[:25], pm)
    rng = np.random.default_rng(11)
    T = 512
    obs = np.zeros((8, T), np.float32)
    lens = np.zeros(8, np.int32)
    for i, k in enumerate([1, 2, 3, 5, 8, 2, 6, 4]):
        x = pm.generate_signal(PREFIX[-25:] + REPEAT * k + SUFFIX[:25], samples=8, noise=True,
                               rng=rng).astype(np.float32)[:T]
        obs[i, : len(x)] = x
        lens[i] = len(x)
    ph = TVC.PaddedHMM(chm, cuda_device)
    o = torch.from_numpy(obs).to(cuda_device)
    n = torch.from_numpy(lens).to(cuda_device)
    before = _build.LAUNCHES["viterbi_forward_factored"]
    sc, fin, acc = TVC.viterbi_forward_factored(o, n, ph)
    assert _build.LAUNCHES["viterbi_forward_factored"] == before + 1
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    live = torch.arange(T, device=cuda_device)[:, None] < n[None, :]
    assert torch.equal(sc[live], sc_p[live])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)
    last = torch.argmax(fin + ph.end, dim=1)
    before = _build.LAUNCHES["viterbi_backward_batch"]
    path = TVC.viterbi_backward_batch(sc, last, n, ph.transT)
    assert _build.LAUNCHES["viterbi_backward_batch"] == before + 1
    assert torch.equal(path, TVC._bwd_plain(sc, last, n, ph.transT))


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
def test_gpu_two_pass_align_core_matches_one_pass(cuda_device, monkeypatch):
    """align_core past a tiny pointer budget takes the two-pass kernels and
    gives the one-pass route's outputs exactly."""
    signals, na, template = _longread_reads(np.random.default_rng(710))
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
