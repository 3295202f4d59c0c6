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
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, make_reads, write_pore_model

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
