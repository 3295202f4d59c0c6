"""The traffic generator: deterministic from its seed, true to its cell's
parameters, and the same synthesis as the package's ``make_reads``; the
5mC twin and methylated alleles, and the committed cells' pools pinned
to what they were before either existed."""
import hashlib
import itertools

import numpy as np
import pytest

from harness import spec

CELLS = ("c9orf72-cas9-carrier", "fmr1-cas9-carrier", "c9orf72-ultralong")


@pytest.fixture(scope="module")
def pool_mod():
    return spec.module("traffic", "pool")


@pytest.mark.parametrize("name", CELLS)
def test_specs_match_cell(pool_mod, name):
    params = spec.cell(name)["params"]
    sp = pool_mod.specs(params)
    assert len(sp) == params["reads"]
    assert sp == pool_mod.specs(params)
    plus = sum(s == "+" for _u, s, _f in sp)
    assert plus == round(params["plus_share"] * params["reads"])
    lo, hi = params["flank_bases"]
    assert all(lo <= f <= hi for _u, _s, f in sp)
    ranges = [a["units"] for a in params["alleles"]]
    assert all(any(r[0] <= u <= r[1] for r in ranges) for u, _s, _f in sp)
    for a in params["alleles"]:
        n = sum(a["units"][0] <= u <= a["units"][1] for u, _s, _f in sp)
        assert n >= round(a["share"] * params["reads"])


def test_pool_deterministic_from_seed(pool_mod, tmp_path):
    cell = spec.cell("fmr1-cas9-carrier")
    params = dict(cell["params"], reads=4, flank_bases=[50, 80])
    locus = cell["config_spec"]["locus"]
    m1 = pool_mod.write_model(str(tmp_path / "a.txt"), 2**31 + 7)
    m2 = pool_mod.write_model(str(tmp_path / "b.txt"), 2**31 + 7)
    assert open(m1).read() == open(m2).read()
    a = pool_mod.make_pool(m1, locus, params, 2**31 + 7)
    b = pool_mod.make_pool(m2, locus, params, 2**31 + 7)
    c = pool_mod.make_pool(m1, locus, params, 5)
    assert all(x[:2] == y[:2] and np.array_equal(x[2], y[2]) for x, y in zip(a, b))
    assert [x[:2] for x in a] == [x[:2] for x in c]
    assert not all(np.array_equal(x[2], y[2]) for x, y in zip(a, c))
    assert all(x[2].dtype == np.int16 for x in a)


@pytest.mark.parametrize("strand", ["+", "-"])
def test_same_synthesis_as_make_reads(pool_mod, tmp_path, strand):
    from strique_tpu_torch.pore_model import PoreModel
    from strique_tpu_torch.synthetic import make_reads

    cell = spec.cell("c9orf72-cas9-carrier")
    locus = cell["config_spec"]["locus"]
    path = pool_mod.write_model(str(tmp_path / "m.txt"), 11)
    want = make_reads(PoreModel(path), 1, 7, np.random.default_rng(3), strand, flank_bases=40,
                      prefix=locus["prefix"], suffix=locus["suffix"], repeat=locus["repeat"])[0]
    got = pool_mod.read(pool_mod.read_model(path), locus, 7, strand, 40, np.random.default_rng(3))
    assert np.array_equal(got, (want * 10).astype(np.int16))


# sha256 of the base model file and of the first 8 reads' raw bytes of each
# committed cell at two seeds, as the generator made them before it knew a
# twin or methylation: a cell without them must read the same pool
PINNED = [
    ("c9orf72-cas9-carrier", 2**31 + 5,
     "4186eb682488cf8ae037ab3d58d9e6f0ebee0cc4582c880cd469a3f6b76ba0cf",
     "7bed4afa71d1e5fc07fd21b410f9f5eb8976039b0debc64133c72d8b980a24f7"),
    ("c9orf72-cas9-carrier", 7,
     "247078eefc7758a70cfbbb533955202a9e4c937e4e47f3055a5d7c01a48673d3",
     "6167d94fa42d88d415e69fe3026fb6b6390a5442834382cda11a0044ce171ac2"),
    ("fmr1-cas9-carrier", 2**31 + 5,
     "4186eb682488cf8ae037ab3d58d9e6f0ebee0cc4582c880cd469a3f6b76ba0cf",
     "ea1f928b207762b5df423a64a7558b81e10b4d7e0f442bcee1fe37d00d287ee9"),
    ("fmr1-cas9-carrier", 7,
     "247078eefc7758a70cfbbb533955202a9e4c937e4e47f3055a5d7c01a48673d3",
     "5932980bcbc46eb69c1cce2c7ead12e879816f39edef042f9e9fd01265c6e368"),
    ("c9orf72-ultralong", 2**31 + 5,
     "4186eb682488cf8ae037ab3d58d9e6f0ebee0cc4582c880cd469a3f6b76ba0cf",
     "5946b201c11faf1c2fa663794809d92cda55ba9fdae3c9624e3bb47f2cdc53b8"),
    ("c9orf72-ultralong", 7,
     "247078eefc7758a70cfbbb533955202a9e4c937e4e47f3055a5d7c01a48673d3",
     "5e38dbfff772b80ad7bcd026f13a060902767afa475876c3bc1b68c974bc1226"),
]


@pytest.mark.parametrize("name,seed,model_sha,reads_sha", PINNED,
                         ids=[f"{n}-{s}" for n, s, _m, _r in PINNED])
def test_pool_unchanged_without_methylation(pool_mod, tmp_path, name, seed, model_sha,
                                            reads_sha):
    cell = spec.cell(name)
    assert "mod_model" not in cell["config_spec"]
    model = pool_mod.write_model(str(tmp_path / "m.txt"), seed, cell["config_spec"]["model"]["k"])
    assert hashlib.sha256(open(model, "rb").read()).hexdigest() == model_sha
    pool = pool_mod.make_pool(model, cell["config_spec"]["locus"], cell["params"], seed)
    h = hashlib.sha256()
    for _u, _s, raw in pool[:8]:
        h.update(raw.tobytes())
    assert h.hexdigest() == reads_sha


def test_twin_shifts_cg_kmers_only(pool_mod, tmp_path):
    base = pool_mod.read_model(pool_mod.write_model(str(tmp_path / "m.txt"), 2**31 + 3, 6))
    twin = pool_mod.read_model(pool_mod.write_mod_model(str(tmp_path / "t.txt"), 2**31 + 3, 6,
                                                        -4.0))
    cg = np.array(["CG" in "".join(p) for p in itertools.product("ACGT", repeat=6)])
    assert cg.any() and not cg.all()
    np.testing.assert_allclose(twin[0][cg] - base[0][cg], -4.0, atol=1e-9)
    assert np.array_equal(twin[0][~cg], base[0][~cg])
    assert np.array_equal(twin[1], base[1]) and twin[2] == base[2] == 6


def _levels(pool_mod, model, twin, locus, units, strand, flank, seed, k, flags):
    """Replay read k's rng: each k-mer's level as the read's samples carry
    it (the noise taken off), and the base's and the twin's levels."""
    rng = np.random.default_rng([seed, 1, k])
    backbone = "".join(rng.choice(list("ACTG"), 2 * flank))
    seq = (backbone[:flank] + locus["prefix"] + locus["repeat"] * units + locus["suffix"]
           + backbone[-flank:])
    on = np.zeros(len(seq), bool)
    start = flank + len(locus["prefix"])
    on[start : start + units * len(locus["repeat"])] = np.repeat(flags, len(locus["repeat"]))
    if strand == "-":
        seq = seq.translate(str.maketrans("ACGT", "TGCA"))[::-1]
        on = on[::-1]
    code = pool_mod._kmer_codes(seq, 6)
    on = on[: len(code)]
    reps = rng.uniform(6, 10, len(code)).astype(int)
    sd = np.repeat(np.where(on, twin[1][code], model[1][code]), reps)
    z = rng.standard_normal(int(reps.sum()))
    return code, on, reps, sd * z


@pytest.mark.parametrize("strand", ["+", "-"])
def test_methylated_units_take_twin_levels(pool_mod, tmp_path, strand):
    cell = spec.cell("c9orf72-cas9-carrier")
    locus = cell["config_spec"]["locus"]
    params = dict(cell["params"], reads=8, flank_bases=[40, 60],
                  plus_share=1.0 if strand == "+" else 0.0)
    params["alleles"] = [dict(a, units=[6, 12], methylation={"reads": 0.5, "units": 0.5})
                         for a in params["alleles"]]
    seed = 2**31 + 11
    m = pool_mod.write_model(str(tmp_path / "m.txt"), seed, 6)
    t = pool_mod.write_mod_model(str(tmp_path / "t.txt"), seed, 6, -4.0)
    model, twin = pool_mod.read_model(m), pool_mod.read_model(t)
    pool = pool_mod.make_pool(m, locus, params, seed, t)
    flags = pool_mod.methylation(params)
    assert sum(f is not None for f in flags) == 4
    assert any(f is not None and f.any() and not f.all() for f in flags)
    twin_seen = 0
    for k, ((units, s, raw), (_u, _s, flank)) in enumerate(zip(pool, pool_mod.specs(params))):
        assert s == strand
        f = flags[k] if flags[k] is not None else np.zeros(units, bool)
        code, on, reps, noise = _levels(pool_mod, model, twin, locus, units, s, flank, seed, k, f)
        level = (raw.astype(np.float64) / 10 - noise)  # the level, less the int16 cut (< 0.1)
        want = np.repeat(np.where(on, twin[0][code], model[0][code]), reps)
        other = np.repeat(np.where(on, model[0][code], twin[0][code]), reps)
        assert len(raw) == len(want)
        assert np.all(np.abs(level - want) < 0.1 + 1e-9), k
        moved = np.abs(want - other) > 1
        assert np.all(np.abs(level - other)[moved] > 3), k
        twin_seen += int((moved & np.repeat(on, reps)).any())
    assert twin_seen > 0
