"""strique_tpu_torch mod calling (5mC per repeat unit) against strique_tpu's.

Both packages read the same seeded synthetic pair: the base 6-mer
model at ``synthetic.MOD_MODEL_SEED`` and its twin
(``synthetic.write_mod_model``: every CpG k-mer's level shifted by
``MOD_SHIFT``), and both decode the same reads, half from each model
(``synthetic.make_mod_reads``).  Held here:

  * the port's ``build_repeat_mod`` equals the JAX one: arrays exactly,
    ``meta`` equal, the factored spec equal (11 diagonals, no chain);
  * the mod HMM's ``PaddedHMM`` keeps its factored form in the forward's
    diagonal-only slot layout, the flanked HMM in the chained one; the
    plain factored and dense twins give equal paths on it, and those
    equal ``viterbi_pallas_batch``'s in Pallas interpret mode;
  * ``RepeatCounter(..., mod_model_file=twin, device="cpu")`` returns the
    JAX counter's tuples on both strands: counts, offsets, ticks, scores
    and the mod string exactly, log_p to 1e-9 relative (float64 on the
    host from identical paths and segments); every count exact and the
    twin reads' '1' share above 0.5, the base reads' below;
  * ``count --device cpu --mod_model`` writes the JAX CLI's TSV byte for
    byte; ``warmup --device cpu`` runs one line a shape.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.cli import main as jax_main
from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu.hmm.models import build_repeat_mod as jax_build_repeat_mod
from strique_tpu.ops.viterbi_pallas import PaddedHMM as JaxPaddedHMM
from strique_tpu.ops.viterbi_pallas import viterbi_pallas_batch
from strique_tpu.pore_model import PoreModel as JaxPoreModel
from strique_tpu_torch import cli
from strique_tpu_torch.convert import padded_hmm_from_jax
from strique_tpu_torch.detect.counter import RepeatCounter, reverse_complement
from strique_tpu_torch.hmm.models import build_flanked_repeat, build_repeat_mod
from strique_tpu_torch.io import fast5
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (LOCI, MOD_MODEL_SEED, MOD_SHIFT,
                                        MOD_WORKLOAD_MISCOUNTS, PREFIX, REPEAT, SUFFIX,
                                        make_mod_reads, mod_workload, sam_line,
                                        write_mod_model, write_pore_model, write_repeat_config,
                                        write_single_fast5)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

# 80-base flanks keep the reference's CPU alignment quick
T_PREFIX = PREFIX[-80:]
T_SUFFIX = SUFFIX[:80]
UNITS = 50


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("mod_models")
    base = write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED)
    twin = write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED)
    return base, twin


@pytest.mark.parametrize("config", [None, {"pomegranate_compat": True}])
@pytest.mark.parametrize("repeat", [REPEAT, reverse_complement(REPEAT), "CGG", "CAG"])
def test_build_repeat_mod_matches_jax(models, repeat, config):
    base, twin = models
    got = build_repeat_mod(repeat, PoreModel(base), PoreModel(twin), config)
    ref = jax_build_repeat_mod(repeat, JaxPoreModel(base), JaxPoreModel(twin), config)
    assert got.names == ref.names
    for k in ("log_start", "log_trans", "log_end", "mu", "sigma", "is_uniform", "log_uni"):
        np.testing.assert_array_equal(getattr(got, k), getattr(ref, k), err_msg=k)
    assert got.meta.keys() == ref.meta.keys()
    for k in ref.meta:
        np.testing.assert_array_equal(got.meta[k], ref.meta[k], err_msg=k)
    f, g = got.factored, ref.factored
    assert f is not None and g is not None and f.stats == g.stats
    assert [o for o, _ in f.diags] == [o for o, _ in g.diags] and len(f.diags) == 11
    for (_, a), (_, b) in zip(f.diags, g.diags):
        np.testing.assert_array_equal(a, b)
    assert not f.chains and not g.chains


def test_write_mod_model_is_deterministic_and_shifts_cpg_levels(tmp_path):
    paths = [write_mod_model(str(tmp_path / f"t{i}.model"), seed=MOD_MODEL_SEED)
             for i in range(2)]
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    base = PoreModel(write_pore_model(str(tmp_path / "b.model"), seed=MOD_MODEL_SEED))
    twin = PoreModel(paths[0])
    assert list(twin.model_dict) == list(base.model_dict) and len(twin.model_dict) == 4096
    for km, (mu, sd) in twin.model_dict.items():
        b_mu, b_sd = base.model_dict[km]
        assert sd == b_sd
        assert mu == pytest.approx(b_mu + (MOD_SHIFT if "CG" in km else 0.0), abs=1.5e-4)


def test_mod_hmm_route_and_paths(models):
    """The mod HMM decodes on the diagonal-only layout; its factored and
    dense twins agree, and both agree with the JAX package's decode."""
    base, twin = models
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    chm = build_repeat_mod(REPEAT, pm, pm_mod)
    ph = TVC.PaddedHMM(chm, "cpu")
    assert ph.sp == 128 and ph.fspec is not None
    assert ph.fwd_layout.name == "viterbi_forward_factored_diag"
    assert ph.fwd_layout.diag == TVC.FWD_DIAG_ONLY and ph.fwd_layout.chain == 0
    src, w, ramp, counts = TVC.fwd_gather_tables(ph.fspec, ph.fweights.numpy(), ph.sp)
    assert src.shape == w.shape == (TVC.FWD_DIAG_ONLY, ph.sp) and ramp.shape == (0, ph.sp)
    assert list(counts[:2]) == [11, 0]
    flanked = TVC.PaddedHMM(build_flanked_repeat(REPEAT, T_PREFIX, T_SUFFIX, pm), "cpu")
    assert flanked.fwd_layout.name == "viterbi_forward_factored"

    rng = np.random.default_rng(4)
    T = 512
    lens = np.array([512, 300, 77, 33, 31, 2, 1, 450], np.int32)
    obs = np.zeros((len(lens), T), np.float32)
    lo, hi = chm.meta["model_min"], chm.meta["model_max"]
    for i, n in enumerate(lens):
        x = (pm_mod if i % 2 else pm).generate_signal(REPEAT * 12, samples=8, noise=True,
                                                      rng=rng)
        obs[i, :n] = np.clip(x, lo, hi)[:n]
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc, fin, _ = TVC._fwd_plain(o, n, ph)
    sc_d, fin_d, _ = TVC._fwd_dense_plain(o, n, ph)
    paths = [TVC._bwd_plain(s, torch.argmax(f + ph.end, dim=1), n, ph.transT)
             for s, f in ((sc, fin), (sc_d, fin_d))]
    assert torch.equal(paths[0], paths[1])
    _, tp = TVC.viterbi_batch(o, n, ph)
    assert torch.equal(tp, paths[0])
    jph = JaxPaddedHMM(chm)
    assert jph.fspec is not None
    _, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    _, cp = TVC.viterbi_batch(o, n, padded_hmm_from_jax(jph, "cpu"))
    assert torch.equal(cp, tp)


@pytest.mark.parametrize("strand", ["+", "-"])
def test_mod_counter_matches_jax_counter(models, strand):
    base, twin = models
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    rng = np.random.default_rng(5)
    reads = make_mod_reads(pm, pm_mod, 4, UNITS, rng, strand, flank_bases=200,
                           prefix=T_PREFIX, suffix=T_SUFFIX)
    ref_counter = JaxRepeatCounter(base, mod_model_file=twin)
    ref_counter.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    port = RepeatCounter(base, mod_model_file=twin, device="cpu")
    port.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    ref = ref_counter.detect_many("c9orf72", reads, strand)
    got = port.detect_many("c9orf72", reads, strand)
    assert len(got) == len(ref) == len(reads)
    for i, (r, g) in enumerate(zip(ref, got)):
        assert [type(x) for x in g] == [type(x) for x in r]
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)
        assert g[0] == UNITS
        share = g[6].count("1") / len(g[6])
        assert (share > 0.5) == bool(i % 2), (i, g[6])


def _mod_run(directory, base, twin):
    """A small count run: 2 base and 2 twin c9orf72 '+' reads and one '-'
    read of each kind as single-read fast5 files (int16 of 10x pA), with
    its fofn, SAM and repeat TSV."""
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    loci = {"c9orf72": (*LOCI["c9orf72"][:4], T_PREFIX, T_SUFFIX)}
    chrom, begin = loci["c9orf72"][:2]
    sam = ["@HD\tVN:1.6\n"]
    rng = np.random.default_rng(8)
    for strand, n in (("+", 4), ("-", 2)):
        sigs = make_mod_reads(pm, pm_mod, n, 20, rng, strand, flank_bases=60,
                              prefix=T_PREFIX, suffix=T_SUFFIX)
        for i, sig in enumerate(sigs):
            rid = f"mod-{strand}{i}"
            write_single_fast5(os.path.join(directory, f"{rid}.fast5"), rid,
                               (sig * 10).astype(np.int16))
            sam.append(sam_line(rid, strand, chrom, begin))
    fofn = os.path.join(directory, "reads.fofn")
    with open(fofn, "w") as fp:
        fp.write("\n".join(fast5.index(str(directory))) + "\n")
    algn = os.path.join(directory, "algn.sam")
    with open(algn, "w") as fp:
        fp.write("".join(sam))
    return fofn, algn, write_repeat_config(os.path.join(directory, "repeats.tsv"), loci)


def test_count_mod_tsv_byte_identical_to_jax_cli(models, tmp_path):
    base, twin = models
    fofn, algn, repeats = _mod_run(tmp_path, base, twin)
    ref, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    args = ["count", fofn, base, repeats, "--algn", algn, "--mod_model", twin, "--batch", "4"]
    assert jax_main([*args, "--out", str(ref)]) == 0
    assert cli.main([*args, "--out", str(got), "--device", "cpu"]) == 0
    assert got.read_bytes() == ref.read_bytes()
    rows = [ln.split("\t") for ln in got.read_text().splitlines()[1:]]
    assert len(rows) == 6 and all(r[9] not in ("", "-") for r in rows)
    assert cli.main(["count", fofn, base, repeats, "--algn", algn, "--device", "cpu",
                     "--mod_model", str(tmp_path / "none.model")]) == 1


def test_warmup_runs_each_shape(models, tmp_path, capsys):
    base, twin = models
    loci = {"c9orf72": (*LOCI["c9orf72"][:4], T_PREFIX, T_SUFFIX)}
    repeats = write_repeat_config(str(tmp_path / "repeats.tsv"), loci)
    assert cli.main(["warmup", base, repeats, "--mod_model", twin, "--device", "cpu",
                     "--batch", "1", "--min_len", "2048", "--max_len", "2048"]) == 0
    out = capsys.readouterr().out.splitlines()
    shapes = [ln.split("\t") for ln in out if not ln.startswith("#")]
    assert [s[:3] for s in shapes] == [["c9orf72", "+", "bucket=2048"],
                                       ["c9orf72", "-", "bucket=2048"]]
    assert all(s[3].startswith("cold=") and s[4].startswith("hot=") for s in shapes)
    assert out[-1].startswith("# warmed 2 target/strand/bucket shapes")


def test_mod_workload_miscounts_match_jax(models):
    """The twin '-' reads of chip_smoke.py's mod workload that the JAX
    package counts one unit over (``MOD_WORKLOAD_MISCOUNTS``): the port
    gives the JAX tuple, count and mod string included."""
    base, twin = models
    _, minus = mod_workload(PoreModel(base), PoreModel(twin), 0)
    idx = sorted(i for s, i in MOD_WORKLOAD_MISCOUNTS if s == "-")
    reads = [minus[i] for i in idx]
    ref_counter = JaxRepeatCounter(base, mod_model_file=twin)
    ref_counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    port = RepeatCounter(base, mod_model_file=twin, device="cpu")
    port.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    ref = ref_counter.detect_many("c9orf72", reads, "-")
    got = port.detect_many("c9orf72", reads, "-")
    for i, r, g in zip(idx, ref, got):
        assert r[0] == g[0] == MOD_WORKLOAD_MISCOUNTS[("-", i)]
        assert (g[0], g[1], g[2], g[4], g[5], g[6]) == (r[0], r[1], r[2], r[4], r[5], r[6])
        assert g[3] == pytest.approx(r[3], rel=1e-9)
        assert g[6].count("1") / len(g[6]) > 0.5
