"""The reference's parameter sweeps (tests/test_fuzz_params.py) on the
port's CPU paths.

The AlignParams sweep (``synthetic.sweep_params``: the reference's 14
explicit corners and 12 seeded draws, pinned here to its
``_sample_params``) reaches the branches the reference's docstring
names: the wave recurrence's folded vertical term, which flips with
g = max(ge_v, go_v); the two-pass span bound, which depends on
max(go_h, ge_h) and does not exist at free or positive horizontal gaps;
the score floor when dist_min > 0, and the score table where dist_min
beats the curve everywhere.  At each corner (B 8, N 256, M 20) the
port's ``align_core`` on f32 signals and in morph form (u8 bins and a
level table; the TABLE score mode's twin), on the wave route and under
``STRIQUE_ALIGN_KERNEL=col``, and its two-pass route where a span bound
exists (f32 and morph, ``ckpt_steps`` 128), must give the JAX package's
``align_batch(impl="xla")`` outputs bit for bit: scores, end and begin
columns, gap flags, positions.  ``takes_two_pass`` never sends a corner
without a span bound there.  Then the port's wave route against the f64
oracle ``semiglobal_align_np`` at the reference's tolerance, and the
port's Viterbi twins (factored and dense) against the dense f64 oracle
``viterbi_np`` over the reference's perturbed HMM configs: log_p to
1e-4 relative, counts exact, paths equal to the JAX scan's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.ops.align import align_batch as jax_align_batch
from strique_tpu.ops.reference import AlignParams as JaxAlignParams
from strique_tpu.ops.reference import semiglobal_align_np, viterbi_np
from strique_tpu_torch.hmm.models import build_flanked_repeat
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.ops.align_cuda import wave_span_bound_steps
from strique_tpu_torch.ops.viterbi import count_repeats
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, SWEEP_SEED, quantise,
                                        sweep_cases, sweep_params, write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

FIELDS = ("score", "j_end", "is_gap", "jpos", "j_begin")
CASES = sweep_cases()


def _jax_params(p):
    return JaxAlignParams(**p.__dict__)


def _xla(signals, na, template, p):
    out = jax_align_batch(signals, na, template, _jax_params(p), impl="xla")
    return {k: np.asarray(out[k]) for k in FIELDS}


def _assert_equal(ref, got, tag):
    for k in FIELDS:
        a, b = ref[k], got[k].numpy()
        if k == "score":
            assert a.tobytes() == b.astype(np.float32).tobytes(), f"{tag} {k}: {a} vs {b}"
        else:
            np.testing.assert_array_equal(b.astype(a.dtype), a, err_msg=f"{tag} {k}")


def test_sweep_params_are_the_references():
    import test_fuzz_params as ref

    rng = np.random.default_rng(SWEEP_SEED)
    assert [p.__dict__ for p in sweep_params(np.random.default_rng(SWEEP_SEED))] == \
        [p.__dict__ for p in ref._sample_params(rng)]
    signals, na, template = ref._fuzz_reads(rng, 8, 256, 20)
    np.testing.assert_array_equal(CASES[0][1], signals)
    np.testing.assert_array_equal(CASES[0][2], na)
    np.testing.assert_array_equal(CASES[0][3], template)
    assert len(CASES) == 26


@pytest.mark.parametrize("k", range(len(CASES)))
def test_align_sweep_bit_equal_to_jax_xla(k, monkeypatch):
    p, signals, na, template = CASES[k]
    bins, lut = quantise(signals, np.random.default_rng(k))
    decoded = np.take_along_axis(lut, bins.astype(np.int64), axis=1)
    ref = _xla(signals, na, template, p)
    ref_morph = _xla(decoded, na, template, p)
    s_t, na_t = torch.from_numpy(signals), torch.from_numpy(na)
    b_t, l_t = torch.from_numpy(bins), torch.from_numpy(lut)
    for route in ("wave", "col"):
        if route == "col":
            monkeypatch.setenv("STRIQUE_ALIGN_KERNEL", "col")
        assert not TA.takes_two_pass(256, 128, "cpu")
        _assert_equal(ref, TA.align_core(s_t, na_t, template, p), f"corner {k} {p} {route}")
        _assert_equal(ref_morph, TA.align_core(b_t, na_t, template, p, lut=l_t),
                      f"corner {k} {p} {route} morph")
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL")
    bound = wave_span_bound_steps(p, len(template))
    assert (bound is None) == (max(p.gap_open_h, p.gap_extension_h) >= 0.0)
    if bound is None:
        # no span bound: the two-pass route refuses, and a bucket past the
        # pointer budget is refused before it runs
        with pytest.raises(ValueError, match="negative horizontal gap"):
            TA.align_batch_longread(s_t, na_t, template, p, ckpt_steps=128)
        monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", "1e-6")
        with pytest.raises(ValueError, match="negative horizontal gap"):
            TA.align_core(s_t, na_t, template, p)
        return
    _assert_equal(ref, TA.align_batch_longread(s_t, na_t, template, p, ckpt_steps=128),
                  f"corner {k} {p} two-pass")
    _assert_equal(ref_morph, TA.align_batch_longread(b_t, na_t, template, p, ckpt_steps=128,
                                                     lut=l_t),
                  f"corner {k} {p} two-pass morph")


ORACLE_CASES = sweep_cases(seed=1013, shape=(8, 192, 16), n_random=8)


@pytest.mark.parametrize("k", range(len(ORACLE_CASES)))
def test_align_sweep_vs_f64_oracle(k):
    """tests/test_fuzz_params.py:116-150 on the port's wave route: end and
    begin columns and the warp path exact, scores to 1e-4 relative."""
    p, signals, na, template = ORACLE_CASES[k]
    got = TA.align_core(torch.from_numpy(signals), torch.from_numpy(na), template, p)
    M = len(template)
    for i in range(signals.shape[0]):
        n = int(na[i])
        s_o, a_idx, b_idx, j_begin_o, j_end_o = semiglobal_align_np(
            signals[i, :n].astype(np.float64), template.astype(np.float64), _jax_params(p),
            full=True)
        assert abs(float(got["score"][i]) - s_o) / max(abs(s_o), 1.0) < 1e-4, (k, i, p)
        assert int(got["j_end"][i]) == j_end_o, (k, i, p)
        assert int(got["j_begin"][i]) == j_begin_o, (k, i, p)
        is_gap = got["is_gap"][i][:M].numpy()
        jpos = got["jpos"][i][:M].numpy()
        a_pos = {int(c): int(j) for j, c in enumerate(a_idx.astype(np.int64))}
        for t in range(M):
            col = int(b_idx[t])
            if col in a_pos:
                assert not is_gap[t] and int(jpos[t]) == a_pos[col], (k, i, t, p)
            else:
                assert is_gap[t], (k, i, t, p)


# the reference's perturbed HMM configs (tests/test_fuzz_params.py:174-194)
_HMM_RNG = np.random.default_rng(1021)
HMM_CONFIGS = [
    {},
    {"seq_std_scale": 0.5, "rep_std_scale": 2.0},
    {"seq_std_offset": 1.0, "rep_std_offset": 2.0},
    {"e1_ratio": 0.5},
    {"e1_ratio": 0.0},
    {"leave_repeat": 0.1},
    {"leave_repeat": 1e-5},
    {"skip": 0.9},
    {"match_loop": 0.5, "match_match": 0.3, "match_insert": 0.15, "match_delete": 0.05},
] + [{
    "seq_std_scale": float(_HMM_RNG.uniform(0.3, 3.0)),
    "rep_std_scale": float(_HMM_RNG.uniform(0.3, 3.0)),
    "seq_std_offset": float(_HMM_RNG.uniform(0.0, 3.0)),
    "e1_ratio": float(_HMM_RNG.uniform(0.0, 1.0)),
    "leave_repeat": float(10 ** _HMM_RNG.uniform(-5, -0.7)),
} for _ in range(4)]


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    return PoreModel(write_pore_model(str(tmp_path_factory.mktemp("m") / "m.model"), seed=11))


@pytest.mark.parametrize("k", range(len(HMM_CONFIGS)))
def test_viterbi_hmm_config_sweep_vs_oracle(pm, k, monkeypatch):
    from strique_tpu.hmm.models import build_flanked_repeat as jax_build
    from strique_tpu.ops.viterbi import viterbi_scan
    from strique_tpu.pore_model import PoreModel as JaxPoreModel

    cfg = HMM_CONFIGS[k]
    prefix, suffix = PREFIX[-30:], SUFFIX[:30]
    chm = build_flanked_repeat(REPEAT, prefix, suffix, pm, config=cfg)
    sig = pm.generate_signal(prefix + REPEAT * 5 + suffix, samples=8, noise=True,
                             rng=np.random.default_rng(40 + k)).astype(np.float32)
    T = len(sig)
    lp_o, path_o = viterbi_np(sig.astype(np.float64), chm.log_start, chm.log_trans,
                              chm.log_end, chm.mu, chm.sigma, chm.is_uniform, chm.log_uni)
    jchm = jax_build(REPEAT, prefix, suffix, JaxPoreModel(pm.model_file), config=cfg)
    dev = tuple(jnp.asarray(getattr(jchm, a)) for a in
                ("log_start", "log_trans", "log_end", "mu", "sigma", "is_uniform", "log_uni"))
    tpad = -(-T // 512) * 512
    obs = np.zeros((1, tpad), np.float32)
    obs[0, :T] = sig
    _, path_s = viterbi_scan(jnp.asarray(obs[0]), jnp.int32(T), *dev)
    n_o = count_repeats(path_o, T, chm)
    for dense in ("0", "1"):
        monkeypatch.setenv("STRIQUE_DENSE_VITERBI", dense)
        ph = TVC.PaddedHMM(chm, "cpu")
        assert (ph.fspec is None) == (dense == "1")
        lp, path = TVC.viterbi_batch(torch.from_numpy(obs), torch.tensor([T]), ph)
        assert abs(float(lp[0]) - lp_o) / max(abs(lp_o), 1.0) < 1e-4, (k, cfg, dense)
        assert count_repeats(path[0].numpy(), T, chm) == n_o, (k, cfg, dense)
        np.testing.assert_array_equal(path[0].numpy()[:T], np.asarray(path_s)[:T],
                                      err_msg=f"config {k} {cfg} dense={dense}")
