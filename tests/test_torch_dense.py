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
    knob;
  * the dense forward's mode rule (``dense_mode``) and plain emulations
    of its resident and its SLICE/STREAMED cluster steps, bit-equal to
    the twin;
  * on reads cut off at SP 512, the one step where the dense and
    factored decodes split, in both packages alike;
  * chip_smoke.py's VNTR target (SP 640, the SLICE dense mode), the
    port's counter on both routes against the JAX counter.

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
from strique_tpu_torch.synthetic import PREFIX as LONG_PREFIX
from strique_tpu_torch.synthetic import REPEAT, make_reads, random_unit, write_pore_model
from strique_tpu_torch.synthetic import SUFFIX as LONG_SUFFIX
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


def test_dense_mode_rule():
    """Resident mode with its cluster size K at SP 128, 256, 384 and 512
    (K CTAs of SP/K columns, 128 else 64, whose lanes hold SP/32 x
    SP/(16 K) transitions in registers); past it SLICE where 8 CTAs'
    column slices fit their shared memory (SP 640), else STREAMED on 8
    CTAs, up to MAX_SP."""
    assert [TVC.dense_mode(sp) for sp in (128, 256, 384, 512)] == [
        ("resident", 1), ("resident", 2), ("resident", 6), ("resident", 8)]
    assert TVC.dense_mode(640) == ("slice", 8)
    assert [TVC.dense_mode(sp) for sp in (768, 896, 1024, 1152, 4096, 8192)] == [
        ("stream", 8)] * 6
    for sp in (128, 256, 384, 512):
        k = TVC.dense_mode(sp).ctas
        assert (sp // 32) * (sp // k // 16) <= TVC.DENSE_MAX_REGS and k <= TVC.DENSE_MAX_CLUSTER
    for sp in range(640, TVC.MAX_SP + 1, TVC.LANE):
        mode = TVC.dense_mode(sp)
        assert mode.kind in ("slice", "stream") and sp % (4 * mode.ctas) == 0
        assert sp // mode.ctas <= 1024
        assert (TVC.dense_stream_shmem(sp, mode.ctas, True) <= TVC.DENSE_MAX_SHMEM) == (
            mode.kind == "slice")
    assert TVC.dense_mode(640).name == "viterbi_forward_dense_slice"
    assert TVC.dense_stream_shmem(640, 8, True) == 218112


def _fwd_dense_cluster_emulation(obs, t_actual, ph, k):
    """The resident kernel's step in plain ops: K CTAs of VC = SP/K
    columns; in each, lane l takes its column maxes over the source rows
    l + 32 i, and the lanes' maxes are folded; val = best + emit; m is
    the max of the whole val row, and the next step reads st[u] as
    val[u] - m."""
    B, T = obs.shape
    sp = ph.sp
    vc = sp // k
    tact = t_actual.to(torch.int64).clamp_max(T)
    sc = torch.zeros((T, B, sp))
    fin = torch.zeros((B, sp))
    acc = torch.zeros((B,))
    val = m = None
    for t in range(int(tact.max())):
        z = (obs[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            val = ph.start + emit
        else:
            st = val - m[:, None]
            slices = []
            for r in range(k):
                cols = slice(r * vc, (r + 1) * vc)
                cand = st[:, :, None] + ph.trans[None, :, cols]  # (B, SP, VC)
                lanes = cand.reshape(B, sp // 32, 32, vc).amax(dim=1)  # row u = 32 i + l
                slices.append(lanes.amax(dim=1) + emit[:, cols])
            val = torch.cat(slices, dim=1)
        m = val.amax(dim=1)
        sc[t] = val - m[:, None]
        acc = acc + torch.where(t < tact, m, 0.0)
        fin = torch.where((tact - 1 == t)[:, None], val - m[:, None], fin)
    return sc, fin, acc


@pytest.mark.parametrize("flank", [25, 50, 75])
def test_dense_cluster_step_matches_plain(model_file, flank):
    """On the seed-3 synthetic HMM (25-base flanks: 116 states, SP 128, K
    1; 50-base flanks: SP 256, K 2; 75-base flanks: SP 384, K 6), the
    emulated cluster step -- and, at SP 256, the same step cut into 4
    slices of 64 columns -- is bit-equal to
    ``_fwd_dense_plain`` in every row below each read's length, fin and
    acc: the expression tree the resident kernel keeps."""
    pm = PoreModel(model_file)
    prefix, suffix = LONG_PREFIX[-flank:], LONG_SUFFIX[:flank]
    chm = build_flanked_repeat(REPEAT, prefix, suffix, pm)
    ph = TVC.PaddedHMM(chm, "cpu")
    assert (ph.n_states, ph.sp) == {25: (116, 128), 50: (216, 256), 75: (316, 384)}[flank]
    rng = np.random.default_rng(60 + flank)
    B, T = 8, 256
    obs = np.zeros((B, T), np.float32)
    lens = rng.integers(40, T + 1, B).astype(np.int32)
    lens[0] = 1
    for b in range(B):
        x = pm.generate_signal(prefix + REPEAT * 6 + suffix, samples=8,
                               noise=True, rng=rng).astype(np.float32)
        obs[b, : min(len(x), lens[b])] = x[: lens[b]]
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc_p, fin_p, acc_p = TVC._fwd_dense_plain(o, n, ph)
    live = torch.arange(T)[:, None] < n[None, :]
    for k in sorted({TVC.dense_mode(ph.sp).ctas, *((4,) if ph.sp == 256 else ())}):
        sc, fin, acc = _fwd_dense_cluster_emulation(o, n, ph, k)
        assert torch.equal(sc[live], sc_p[live]), k
        assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p), k


def _fwd_dense_stream_emulation(obs, t_actual, ph, k):
    """The SLICE and STREAMED step (csrc/viterbi_dense.cu
    ``viterbi_dense_cluster_kernel``) in plain ops: K CTAs of VC = SP/K
    columns, each of NT threads (1024 past VC 512, else 512) in G =
    NT / (VC/4) groups; group g takes the source rows g, g + G, ... in
    order, its column maxes are folded over the groups; val = best +
    emit; m is the max of the warp maxima of the columns' owners (32
    columns a warp)."""
    B, T = obs.shape
    sp = ph.sp
    vc = sp // k
    groups = (1024 if vc > 512 else 512) // (vc // 4)
    tact = t_actual.to(torch.int64).clamp_max(T)
    sc = torch.zeros((T, B, sp))
    fin = torch.zeros((B, sp))
    acc = torch.zeros((B,))
    val = m = None
    for t in range(int(tact.max())):
        z = (obs[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            val = ph.start + emit
        else:
            st = val - m[:, None]
            slices = []
            for r in range(k):
                cols = slice(r * vc, (r + 1) * vc)
                part = torch.stack([(st[:, g::groups, None] + ph.trans[None, g::groups, cols])
                                    .amax(dim=1) for g in range(min(groups, sp))])
                slices.append(part.amax(dim=0) + emit[:, cols])
            val = torch.cat(slices, dim=1)
        warps = torch.cat([val[:, r * vc : (r + 1) * vc][:, w : w + 32].amax(dim=1, keepdim=True)
                           for r in range(k) for w in range(0, vc, 32)], dim=1)
        m = warps.amax(dim=1)
        sc[t] = val - m[:, None]
        acc = acc + torch.where(t < tact, m, 0.0)
        fin = torch.where((tact - 1 == t)[:, None], val - m[:, None], fin)
    return sc, fin, acc


@pytest.mark.parametrize("unit_bases,sp", [(60, 640), (150, 1152)])
def test_dense_stream_step_matches_plain(model_file, unit_bases, sp):
    """On the repeat HMM of a random unit of 60 (SP 640: the SLICE mode,
    phase 4f's VNTR unit) and 150 bases (SP 1152: STREAMED) between
    50-base flanks, the emulated SLICE/STREAMED step at the rule's K and
    at 4 and 16 CTAs (16: the non-portable cluster that
    tools/probe_viterbi_wide.py times) is bit-equal to
    ``_fwd_dense_plain`` in every row below each read's length, fin and
    acc."""
    pm = PoreModel(model_file)
    unit = random_unit(unit_bases, unit_bases)
    chm = build_flanked_repeat(unit, LONG_PREFIX[-50:], LONG_SUFFIX[:50], pm)
    ph = TVC.PaddedHMM(chm, "cpu")
    assert ph.sp == sp and TVC.dense_mode(sp).kind == ("slice" if sp == 640 else "stream")
    rng = np.random.default_rng(sp)
    B, T = 8, 128
    obs = np.zeros((B, T), np.float32)
    lens = np.array([128, 100, 65, 33, 32, 17, 2, 1], np.int32)
    for b in range(B):
        x = pm.generate_signal(LONG_PREFIX[-50:] + unit + LONG_SUFFIX[:50], samples=8,
                               noise=True, rng=rng).astype(np.float32)
        obs[b, : lens[b]] = x[: lens[b]]
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc_p, fin_p, acc_p = TVC._fwd_dense_plain(o, n, ph)
    live = torch.arange(T)[:, None] < n[None, :]
    for k in sorted({TVC.dense_mode(sp).ctas, 4, 16}):
        sc, fin, acc = _fwd_dense_stream_emulation(o, n, ph, k)
        assert torch.equal(sc[live], sc_p[live]), k
        assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p), k


def test_dense_and_factored_paths_split_as_in_jax(model_file, monkeypatch):
    """On reads cut off at T 1024 (seed-3 model, 100-base flanks, SP 512,
    the reads of tests/test_torch_gpu.py's SP 512 case), the dense and
    factored decodes differ at one step: read 3, step 1003, where the
    backward's candidates into state 347 sit 1 ulp apart in the dense
    rows (336 wins) and tie in the factored ones (320 wins).  The JAX
    package's two decodes split at the same step, and each of the port's
    paths equals the reference's on its route (ROADMAP Queue 3)."""
    flank, T = 100, 1024
    prefix, suffix = LONG_PREFIX[-flank:], LONG_SUFFIX[:flank]
    pm = PoreModel(model_file)
    rng = np.random.default_rng(40 + flank)
    obs = np.zeros((8, T), np.float32)
    lens = np.zeros(8, np.int32)
    for i, k in enumerate([1, 2, 3, 5, 8, 2, 6, 4]):
        x = pm.generate_signal(prefix + REPEAT * k + suffix, samples=8, noise=True,
                               rng=rng).astype(np.float32)[:T]
        obs[i, : len(x)] = x
        lens[i] = len(x)
    assert (lens == T).all()  # every read cut off
    jpm = JaxPoreModel(model_file)
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    paths = {}
    for route in ("factored", "dense"):
        if route == "dense":
            monkeypatch.setenv("STRIQUE_DENSE_VITERBI", "1")
        ph = TVC.PaddedHMM(build_flanked_repeat(REPEAT, prefix, suffix, pm), "cpu")
        jph = JaxPaddedHMM(jax_build_flanked_repeat(REPEAT, prefix, suffix, jpm))
        assert ph.sp == 512 and (ph.fspec is None) == (jph.fspec is None) == (route == "dense")
        _, tp = TVC.viterbi_batch(o, n, ph)
        _, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        paths[route] = tp.numpy()
    split = np.nonzero(paths["dense"] != paths["factored"])
    assert [(int(b), int(t)) for b, t in zip(*split)] == [(3, 1003)]
    assert (paths["dense"][3, 1003], paths["factored"][3, 1003]) == (336, 320)
    assert paths["dense"][3, 1004] == paths["factored"][3, 1004] == 347


@pytest.fixture(scope="module")
def smoke_model(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=0)


def test_vntr_counts_match_jax_counter(smoke_model, monkeypatch):
    """chip_smoke.py phase 4f's VNTR target and reads (seed-0 model, a
    60-base unit from rng 5, 8 '+' reads of 12 units): the JAX counter
    counts 11 in each; the port's counter on the default route (the
    factored forward) and under STRIQUE_DENSE_VITERBI=1 (540 states, SP
    640: the dense forward) gives the reference's result tuples."""
    pm = PoreModel(smoke_model)
    rng = np.random.default_rng(5)
    unit = "".join(rng.choice(list("ACGT"), 60))
    reads = make_reads(pm, 8, 12, rng, "+", repeat=unit)
    ref_counter = JaxRepeatCounter(smoke_model)
    ref_counter.add_target("vntr", unit, LONG_PREFIX, LONG_SUFFIX)
    ref = ref_counter.detect_many("vntr", reads, "+")
    assert [r[0] for r in ref] == [11] * 8
    calls = []
    dense_fn = TVC.viterbi_forward_dense
    monkeypatch.setattr(TVC, "viterbi_forward_dense", lambda *a: calls.append(1) or dense_fn(*a))
    for route in ("default", "dense"):
        if route == "dense":
            monkeypatch.setenv("STRIQUE_DENSE_VITERBI", "1")
        port = RepeatCounter(smoke_model, device="cpu")
        port.add_target("vntr", unit, LONG_PREFIX, LONG_SUFFIX)
        assert port.targets["vntr"][0].repeat_hmm.n_states == 540
        got = port.detect_many("vntr", reads, "+")
        assert bool(calls) == (route == "dense"), route
        for r, g in zip(ref, got, strict=True):
            assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
            assert g[3] == pytest.approx(r[3], rel=1e-9)
