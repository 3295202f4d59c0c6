"""strique_tpu_torch dense Viterbi forward vs the JAX reference.

The port's plain dense forward (the CPU twin of csrc/viterbi_dense.cu),
decoded by the plain backward, against the reference's
``viterbi_forward_pallas_multi`` and ``viterbi_pallas_batch`` with
``fspec = None``, in Pallas interpret mode:

  * on a graph both packages' ``hmm/factor.py`` decline (the
    chain-to-chain construction of tests/test_factor.py), B=8, T=512;
  * on the flanked-repeat HMM of a seeded synthetic 6-mer model under
    ``STRIQUE_DENSE_VITERBI=1``, read at PaddedHMM construction (B=8,
    T=512, SP 128), where the dense paths must also equal the factored
    ones;
  * end to end, the port's counter against the JAX counter under the
    knob.

Tolerances.  Paths exact everywhere.  On the declined graph every
sigma is 1 and the observations are multiples of 1/8 from integer
means, so lsig is one f32 constant on both sides and (0.5 z) z is
exact: the f32 streams are bit-equal and rows, fin, acc and logp are
compared exactly.  On the flanked-repeat HMM two rounding differences
of ROADMAP Queue 3 apply: the port's lsig is float64 rounded to f32
where the reference's is XLA's f32 log, and XLA:CPU contracts the
reference's lsig - (0.5 z) z into one FMA (the port keeps two
roundings, as the TPU does).  Rows and fin there are held to 2e-3
absolute, acc and logp to rtol 1e-5, as in tests/test_torch_viterbi.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu.hmm.graph import HmmGraph as JaxHmmGraph
from strique_tpu.hmm.models import build_flanked_repeat as jax_build_flanked_repeat
from strique_tpu.ops.viterbi_pallas import PaddedHMM as JaxPaddedHMM
from strique_tpu.ops.viterbi_pallas import viterbi_forward_pallas_multi, viterbi_pallas_batch
from strique_tpu.pore_model import PoreModel as JaxPoreModel
from strique_tpu_torch.convert import padded_hmm_from_jax
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.hmm.graph import HmmGraph
from strique_tpu_torch.hmm.models import build_flanked_repeat
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import REPEAT, write_pore_model
from tests.test_torch_counter import COUNTS, T_PREFIX, T_SUFFIX
from tests.test_torch_counter import _reads as _counter_reads
from tests.test_torch_viterbi import PREFIX, SUFFIX, _batch

# The tier-1 run puts six pytest workers on the machine's cores, and
# torch's intra-op threads then spin against each other (the plain
# twins' small ops ran 100-200x slower): run torch on one thread here.
torch.set_num_threads(1)


def _declined_graph(graph_cls):
    """Two delete chains linked through two free silents (tests/test_factor.py)."""
    g = graph_cls()
    ems = [g.add_normal(f"m{i:02d}", float(i), 1.0) for i in range(12)]
    c1 = [g.add_silent(f"a{i:02d}d") for i in range(5)]
    c2 = [g.add_silent(f"b{i:02d}d") for i in range(5)]
    mid1 = g.add_silent("mid1")
    mid2 = g.add_silent("mid2")
    for i in range(4):
        g.add_edge(c1[i], c1[i + 1], 0.5)
        g.add_edge(c2[i], c2[i + 1], 0.5)
    for i in range(5):
        g.add_edge(ems[i], c1[i], 0.1)
        g.add_edge(c1[i], ems[i + 1], 0.4)
        g.add_edge(ems[6 + i // 2], c2[i], 0.1)
        g.add_edge(c2[i], ems[5 + i // 2], 0.4)
    g.add_edge(c1[4], mid1, 0.1)
    g.add_edge(mid1, mid2, 1.0)
    g.add_edge(mid2, c2[0], 1.0)
    for e in ems:
        g.add_edge(e, e, 0.5)
    g.add_edge(g.start, ems[0], 1.0)
    g.add_edge(ems[-1], g.end, 0.1)
    return g.compile()


def _reference_rows(obs, lens, jph):
    """The reference dense forward, one read per kernel instance as
    viterbi_pallas_batch runs it: rows (B, T, SP), fin (B, SP), acc (B,)."""
    outs = [viterbi_forward_pallas_multi(
        jnp.asarray(obs[b : b + 1]), jnp.asarray(lens[b : b + 1]), jph.trans, jph.transT,
        jph.start_col, jph.mu, jph.sigma, jph.uni, jph.luni, jph.mu_col, jph.sigma_col,
        jph.uni_col, jph.luni_col, R=1) for b in range(len(lens))]
    return (np.stack([np.asarray(o[0])[0] for o in outs]),
            np.stack([np.asarray(o[1])[0] for o in outs]),
            np.array([np.asarray(o[2])[0, 0] for o in outs]))


def test_dense_viterbi_matches_jax_on_declined_graph():
    chm = _declined_graph(HmmGraph)
    jchm = _declined_graph(JaxHmmGraph)
    assert chm.factored is None and jchm.factored is None
    ph = TVC.PaddedHMM(chm, "cpu")
    jph = JaxPaddedHMM(jchm)
    assert ph.fspec is None and jph.fspec is None
    rng = np.random.default_rng(5)
    B, T = 8, 512
    lens = rng.integers(200, T + 1, B).astype(np.int32)
    obs = np.zeros((B, T), np.float32)
    for b in range(B):  # walk the 12 means; noise in steps of 1/8 keeps (0.5 z) z exact
        walk = np.repeat(np.arange(12), lens[b] // 12 + 1)[: lens[b]]
        obs[b, : lens[b]] = walk + rng.integers(-3, 4, lens[b]) / 8
    jsc, jfin, jacc = _reference_rows(obs, lens, jph)
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc, fin, acc = TVC.viterbi_forward_dense(o, n, ph)
    for b in range(B):
        np.testing.assert_array_equal(sc.numpy()[: lens[b], b], jsc[b, : lens[b]])
    np.testing.assert_array_equal(fin.numpy(), jfin)
    np.testing.assert_array_equal(acc.numpy(), jacc)
    jl, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    tl, tp = TVC.viterbi_batch(o, n, ph)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=3)


def test_dense_viterbi_matches_jax_under_knob(model_file, monkeypatch):
    """STRIQUE_DENSE_VITERBI=1 at construction drops the factored form in
    both packages; convert.py carries fspec = None over; rows, paths and
    logp against the reference; the dense paths equal the factored ones."""
    factored = TVC.PaddedHMM(build_flanked_repeat("GGCCCC", PREFIX, SUFFIX,
                                                  PoreModel(model_file)), "cpu")
    monkeypatch.setenv("STRIQUE_DENSE_VITERBI", "1")
    jpm = JaxPoreModel(model_file)
    jchm = jax_build_flanked_repeat("GGCCCC", PREFIX, SUFFIX, jpm)
    jph = JaxPaddedHMM(jchm)
    own = TVC.PaddedHMM(build_flanked_repeat("GGCCCC", PREFIX, SUFFIX, PoreModel(model_file)),
                        "cpu")
    ph = padded_hmm_from_jax(jph, "cpu")
    assert jchm.factored is not None and factored.fspec is not None
    assert jph.fspec is None and own.fspec is None and ph.fspec is None and ph.sp == 128
    obs, lens = _batch(jpm, [1, 2, 3, 5, 8, 2, 6, 4], 512, seed=13)
    jsc, jfin, jacc = _reference_rows(obs, lens, jph)
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc, fin, acc = TVC.viterbi_forward_dense(o, n, ph)
    for b in range(len(lens)):
        np.testing.assert_allclose(sc.numpy()[: lens[b], b], jsc[b, : lens[b]], rtol=0,
                                   atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), jfin, rtol=0, atol=2e-3)
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-5)
    calls = []
    dense_fn = TVC.viterbi_forward_dense
    monkeypatch.setattr(TVC, "viterbi_forward_dense", lambda *a: calls.append(1) or dense_fn(*a))
    jl, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    tl, tp = TVC.viterbi_batch(o, n, ph)
    assert calls == [1]  # the converted fspec-less HMM took the dense forward
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)
    own_l, own_p = TVC.viterbi_batch(o, n, own)
    fl, fp = TVC.viterbi_batch(o, n, factored)
    np.testing.assert_array_equal(own_p.numpy(), tp.numpy())
    np.testing.assert_array_equal(fp.numpy(), tp.numpy())
    np.testing.assert_allclose(fl.numpy(), own_l.numpy(), rtol=1e-5)


@pytest.fixture(scope="module")
def counter_model(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


def test_counter_dense_matches_jax_counter(counter_model, monkeypatch):
    """The port's counter under STRIQUE_DENSE_VITERBI=1 (its cached
    PaddedHMM takes the dense forward) against the JAX counter under the
    same knob: result tuples equal, as in tests/test_torch_counter.py."""
    monkeypatch.setenv("STRIQUE_DENSE_VITERBI", "1")
    calls = []
    dense_fn = TVC.viterbi_forward_dense
    monkeypatch.setattr(TVC, "viterbi_forward_dense", lambda *a: calls.append(1) or dense_fn(*a))
    reads = _counter_reads(PoreModel(counter_model), "-", seed=22)
    ref_counter = JaxRepeatCounter(counter_model)
    ref_counter.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    port = RepeatCounter(counter_model, device="cpu")
    port.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    ref = ref_counter.detect_many("c9orf72", reads, "-")
    got = port.detect_many("c9orf72", reads, "-")
    assert calls == [1]
    assert [r[0] for r in ref] == COUNTS["-"]
    for r, g in zip(ref, got):
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)
