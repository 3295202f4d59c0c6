"""The traffic generator: deterministic from its seed, true to its cell's
parameters, and the same synthesis as the package's ``make_reads``."""
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
