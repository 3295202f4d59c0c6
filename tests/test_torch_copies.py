"""The port's own copies of the JAX package's jax-free modules, pinned to
their originals on seeded inputs.

strique_tpu_torch imports nothing of strique_tpu (tests/
test_torch_imports.py), so it carries copies of the pore model, the HMM
builders and factorizer, the NumPy signal ops, ``model_const``,
``AlignParams``, the native host prep and the bounds-row decoder.  Each
is held equal to its original here: arrays exactly, the native prep's
outputs byte for byte.
"""
import numpy as np
import pytest

from strique_tpu import native as jax_native
from strique_tpu.detect import packed as JK
from strique_tpu.hmm.models import build_flanked_repeat as jax_build
from strique_tpu.ops import prep as JPR
from strique_tpu.ops import reference as JR
from strique_tpu.ops import signal as JS
from strique_tpu.pore_model import PoreModel as JaxPoreModel
from strique_tpu_torch import native
from strique_tpu_torch.detect import packed as TK
from strique_tpu_torch.hmm.models import build_flanked_repeat
from strique_tpu_torch.ops import prep as TPR
from strique_tpu_torch.ops import reference as TR
from strique_tpu_torch.ops import signal as TS
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, write_pore_model


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    path = write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=5)
    return PoreModel(path), JaxPoreModel(path)


def _raw(seed, n=6000):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.normal(0, 3, n)) + rng.uniform(300, 600) + rng.normal(0, 8, n)


@pytest.mark.parametrize("mode", ["median", "minmax", "entropy"])
def test_pore_model_normalisation_and_synthesis(models, mode):
    pm, jpm = models
    for k in ("model_median", "model_MAD", "model_min", "model_max", "_m5_mod", "_m95_mod"):
        assert getattr(pm, k) == getattr(jpm, k), k
    x = _raw(1)
    a, b = pm.norm_params(x, mode=mode), jpm.norm_params(x, mode=mode)
    assert (a.scale, a.offset, a.lo, a.hi) == (b.scale, b.offset, b.lo, b.hi)
    np.testing.assert_array_equal(pm.normalize2model(x, mode=mode),
                                  jpm.normalize2model(x, mode=mode))
    seq = PREFIX[-40:] + REPEAT * 7 + SUFFIX[:40]
    for samples, noise in ((6, False), (None, False), (8, True)):
        np.testing.assert_array_equal(
            pm.generate_signal(seq, samples=samples, noise=noise, rng=np.random.default_rng(2)),
            jpm.generate_signal(seq, samples=samples, noise=noise, rng=np.random.default_rng(2)))


@pytest.mark.parametrize("config", [None, {"pomegranate_compat": True}])
def test_flanked_repeat_hmm_and_factor_spec(models, config):
    pm, jpm = models
    got = build_flanked_repeat(REPEAT, PREFIX[-30:], SUFFIX[:30], pm, config)
    ref = jax_build(REPEAT, PREFIX[-30:], SUFFIX[:30], jpm, config)
    assert got.names == ref.names
    for k in ("log_start", "log_trans", "log_end", "mu", "sigma", "is_uniform", "log_uni"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert got.meta.keys() == ref.meta.keys()
    for k in ref.meta:
        np.testing.assert_array_equal(got.meta[k], ref.meta[k], err_msg=k)
    f, g = got.factored, ref.factored
    assert f is not None and g is not None and f.stats == g.stats
    assert [o for o, _ in f.diags] == [o for o, _ in g.diags]
    for (_, a), (_, b) in zip(f.diags, g.diags):
        np.testing.assert_array_equal(a, b)
    assert len(f.chains) == len(g.chains)
    for c, d in zip(f.chains, g.chains):
        np.testing.assert_array_equal(c.ramp, d.ramp)
        np.testing.assert_array_equal(c.slots, d.slots)
        for side in ("entries", "exits"):
            assert [o for o, _ in getattr(c, side)] == [o for o, _ in getattr(d, side)]
            for (_, a), (_, b) in zip(getattr(c, side), getattr(d, side)):
                np.testing.assert_array_equal(a, b)


def test_signal_ops(models):
    x = _raw(3, 2000)
    flt = TS.medfilt3(x)
    np.testing.assert_array_equal(flt, JS.medfilt3(x))
    med, mad = float(np.median(flt)), float(np.mean(np.abs(flt - np.median(flt))))
    q = TS.quantize_morph_np(flt, med, mad)
    np.testing.assert_array_equal(q, JS.quantize_morph_np(flt, med, mad))
    for f in ("erode_np", "dilate_np", "open_close_np"):
        np.testing.assert_array_equal(getattr(TS, f)(q), getattr(JS, f)(q), err_msg=f)


def test_model_const_and_align_params(models):
    pm, jpm = models
    assert TPR.model_const(pm) == JPR.model_const(jpm)
    for kw in ({}, {"gap_open_h": -3.0, "dist_min": 2.0}):
        a, b = TR.AlignParams(**kw), JR.AlignParams(**kw)
        assert a.__dataclass_fields__.keys() == b.__dataclass_fields__.keys()
        assert all(getattr(a, k) == getattr(b, k) for k in b.__dataclass_fields__)


@pytest.fixture
def both_native():
    if not (native.available() and jax_native.available()):
        pytest.skip("a C++ compiler is needed to build the native host prep")


@pytest.mark.parametrize("n", [5, 1000, 25000])
def test_native_preprocess_read_lut_byte_equal(models, both_native, n):
    pm, jpm = models
    raw = _raw(10 + n, n)
    outs = []
    for lib, m in ((native, pm), (jax_native, jpm)):
        mc = (TPR if lib is native else JPR).model_const(m)
        flt32, q, lut = np.empty(n, np.float32), np.empty(n, np.uint8), np.empty(256, np.float32)
        flt64 = lib.preprocess_read_lut(raw, mc, flt32, q, lut)
        outs.append((flt64, flt32, q, lut))
    for a, b in zip(*outs):
        assert a.tobytes() == b.tobytes()


def test_unpack_meta_and_path_itemsize():
    rng = np.random.default_rng(4)
    meta = rng.uniform(0, 500, (6, len(TK.META_FIELDS))).astype(np.float32).round()
    meta[:, 1] = [0, 3, 5, 0, 7, 2]
    meta[:, 8] = [1, 0, 1, 1, 0, 1]
    assert TK.META_FIELDS == JK.META_FIELDS
    for a, b in zip(TK.unpack_meta(meta), JK.unpack_meta(meta)):
        assert a.__dict__ == b.__dict__
    for s in (1, 256, 257, 4000):
        assert TK.path_itemsize(s) == JK.path_itemsize(s)
