"""strique_tpu_torch bounds, meta packing and copied NumPy helpers.

``segment_bounds`` + ``pack_meta`` (torch integer ops) against the JAX
package's on the same tracebacks -- exact, they are integer math plus
the scores passed through.  Then one pin per NumPy helper the port
copies out of JAX-importing reference modules: each copy must equal its
original on the same inputs.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.detect import counter as JC
from strique_tpu.detect.packed import pack_meta as jax_pack_meta
from strique_tpu.hmm.models import build_flanked_repeat, build_repeat_mod
from strique_tpu.ops import align as JA
from strique_tpu.ops import bounds as JB
from strique_tpu.ops import viterbi as JV
from strique_tpu.pore_model import PoreModel
from strique_tpu_torch.detect import counter as TCn
from strique_tpu_torch.detect.packed import pack_meta
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops.align_cuda import morph_decode
from strique_tpu_torch.ops import bounds as TB
from strique_tpu_torch.ops import viterbi as TV
from strique_tpu_torch.synthetic import write_pore_model

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)


def _tracebacks(rng, B, m, n):
    """Monotone warp positions with vertical-gap runs (repeated jpos)."""
    steps = rng.choice([0, 1, 1, 1, 2], size=(B, m))
    jpos = np.cumsum(steps, axis=1) + rng.integers(-3, n // 2, size=(B, 1))
    is_gap = (steps == 0) | (rng.random((B, m)) < 0.05)
    return is_gap, jpos.astype(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_segment_bounds_and_pack_meta_match_jax(seed):
    rng = np.random.default_rng(seed)
    B, mp, ms, n = 16, 60, 45, 400
    gp, jpp = _tracebacks(rng, B, mp, n)
    gs, jps = _tracebacks(rng, B, ms, n)
    n_sigs = rng.integers(n // 2, n, B).astype(np.int32)
    n_sigs[0] = 1  # a padding row
    score_p = rng.normal(5, 10, B).astype(np.float32)
    score_s = rng.normal(5, 10, B).astype(np.float32)
    trim_p, trim_s = 7, 5
    jb = JB.segment_bounds(
        {"score": jnp.asarray(score_p), "is_gap": jnp.asarray(gp), "jpos": jnp.asarray(jpp)},
        {"score": jnp.asarray(score_s), "is_gap": jnp.asarray(gs), "jpos": jnp.asarray(jps)},
        jnp.asarray(n_sigs), trim_prefix=trim_p, trim_suffix=trim_s)
    tb = TB.segment_bounds(
        {"score": torch.from_numpy(score_p), "is_gap": torch.from_numpy(gp),
         "jpos": torch.from_numpy(jpp)},
        {"score": torch.from_numpy(score_s), "is_gap": torch.from_numpy(gs),
         "jpos": torch.from_numpy(jps)},
        torch.from_numpy(n_sigs), trim_prefix=trim_p, trim_suffix=trim_s)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]), err_msg=k)
    assert tb["ok"].any() and not tb["ok"].all()
    np.testing.assert_array_equal(pack_meta(tb).numpy(), np.asarray(jax_pack_meta(jb)))
    # the per-read host mapping (the reference's own oracle) agrees too
    for i in range(B):
        np.testing.assert_array_equal(
            TB.nearest_positions(torch.from_numpy(gp[i : i + 1]), torch.from_numpy(jpp[i : i + 1]),
                                 torch.from_numpy(n_sigs[i : i + 1]))[0].numpy(),
            JA._nearest_positions(gp[i], jpp[i], int(n_sigs[i])))


def test_nearest_positions_copy_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        gp, jpp = _tracebacks(rng, 1, 50, 300)
        n = int(rng.integers(10, 300))
        np.testing.assert_array_equal(TA._nearest_positions(gp[0], jpp[0], n),
                                      JA._nearest_positions(gp[0], jpp[0], n))


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    return (PoreModel(write_pore_model(str(d / "base.model"), seed=5)),
            PoreModel(write_pore_model(str(d / "mod.model"), seed=6)))


def test_stage_factored_copy_matches_reference(models):
    chm = build_flanked_repeat("GGCCCC", "CCAGGATGCCGCCTCCTCACTCACC",
                               "TAGCGCGACTCCTGAGTTCCAGAGC", models[0])
    for sp in (None, 256):
        spec_t, w_t = TV.stage_factored(chm.factored, sp)
        spec_j, w_j = JV.stage_factored(chm.factored, sp)
        assert spec_t == spec_j and len(w_t) == len(w_j)
        for a, b in zip(w_t, w_j):
            np.testing.assert_array_equal(a, b)


def test_path_helpers_copy_match_reference(models):
    pm, pm_mod = models
    rng = np.random.default_rng(8)
    chm = build_flanked_repeat("GGCCCC", "CCAGGATGCCGCCTCCTCACTCACC",
                               "TAGCGCGACTCCTGAGTTCCAGAGC", pm)
    mod = build_repeat_mod("GGCCCC", pm, pm_mod)
    for _ in range(5):
        T = int(rng.integers(50, 300))
        path = rng.integers(0, chm.n_states, T)
        obs = rng.uniform(60, 130, T)
        t_act = int(rng.integers(1, T + 1))
        assert TV.count_repeats(path, t_act, chm) == JV.count_repeats(path, t_act, chm)
        assert TV.path_logp_f64(obs, path, chm) == JV.path_logp_f64(obs, path, chm)
        np.testing.assert_array_equal(TV.repeat_sample_mask(path, t_act, chm),
                                      JV.repeat_sample_mask(path, t_act, chm))
        mpath = rng.integers(0, mod.n_states, T)
        assert TV.mod_pattern(mpath, t_act, mod) == JV.mod_pattern(mpath, t_act, mod)


def test_counter_helpers_copy_match_reference():
    for n in (1, 100, 2048, 2049, 5000, 21885, 24576, 24577, 100000):
        assert TCn.pad_bucket(n) == JC.pad_bucket(n)
        assert TCn.signal_bucket(n) == JC.signal_bucket(n)
        assert TCn._morph_buf_bytes(n) == JC._morph_buf_bytes(n)
    for seq in ("ACGT", "GGCCCCaacg", "TTTTGA"):
        assert TCn.reverse_complement(seq) == JC.reverse_complement(seq)
    assert ([f.name for f in dataclasses.fields(TCn.TargetClassifier)]
            == [f.name for f in dataclasses.fields(JC.TargetClassifier)])
    assert TCn.DEFAULT_ALIGN_CONFIG == JC.DEFAULT_ALIGN_CONFIG


def test_morph_upload_decode_matches_reference():
    """u8 bins + per-read f32 level table -> morph: the upload's split
    into bins and tables, then ``morph_decode``'s gather."""
    rng = np.random.default_rng(9)
    B, npad = 8, 1024
    buf = np.zeros((B, TCn._morph_buf_bytes(npad)), np.uint8)
    for i in range(B):
        buf[i, : 4 * 256].view(np.float32)[:] = rng.uniform(50, 140, 256).astype(np.float32)
        buf[i, 4 * 256 :] = rng.integers(0, 256, npad)
    ref = np.asarray(JC._unpack_morph_upload(jnp.asarray(buf)))
    got = morph_decode(*TCn._split_morph_upload(torch.from_numpy(buf))).numpy()
    np.testing.assert_array_equal(got, ref)
