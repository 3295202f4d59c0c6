"""The plain reference against the package on its CPU path, on small reads
of both configurations, and the comparison's arithmetic."""
import numpy as np
import pytest

from harness import check, spec
from small import small_cell, small_mod_cell


@pytest.mark.parametrize("name", ["c9orf72-cas9-carrier", "fmr1-cas9-carrier"])
def test_reference_equals_package_on_cpu(name, tmp_path):
    from reference.pipeline import Reference
    from strique_tpu_torch.detect.counter import RepeatCounter

    cell = small_cell(name, reads=4)
    cfg = cell["config_spec"]
    locus = cfg["locus"]
    traffic = spec.module("traffic", cell["generator"])
    model = traffic.write_model(str(tmp_path / "m.txt"), 21)
    pool = traffic.make_pool(model, locus, cell["params"], 21)
    assert {s for _u, s, _r in pool} == {"+", "-"}
    want = Reference(locus, model, cfg["align"], "cpu").rows([p[2] for p in pool],
                                                           [p[1] for p in pool])
    counter = RepeatCounter(model, align_config=cfg["align"], device="cpu")
    counter.add_target(locus["name"], locus["repeat"], locus["prefix"], locus["suffix"])
    for (_units, strand, raw), row in zip(pool, want):
        assert counter.detect_many(locus["name"], [raw], strand)[0] == row


@pytest.mark.parametrize("name", ["c9orf72-cas9-carrier", "fmr1-cas9-carrier"])
def test_reference_mod_equals_package_on_cpu(name, tmp_path):
    """With a 5mC twin both sides call methylation: every row equal, mod
    string included, and every gated-in row carries a '0'/'1' string."""
    from reference.pipeline import Reference
    from strique_tpu_torch.detect.counter import RepeatCounter

    cell = small_mod_cell(name, reads=4)
    cfg = cell["config_spec"]
    locus = cfg["locus"]
    traffic = spec.module("traffic", cell["generator"])
    model = traffic.write_model(str(tmp_path / "m.txt"), 21)
    twin = traffic.write_mod_model(str(tmp_path / "t.txt"), 21, 6,
                                   cfg["mod_model"]["shift_pA"])
    pool = traffic.make_pool(model, locus, cell["params"], 21, twin)
    assert any(f is not None for f in traffic.methylation(cell["params"]))
    want = Reference(locus, model, cfg["align"], "cpu", mod_model_file=twin).rows(
        [p[2] for p in pool], [p[1] for p in pool])
    counter = RepeatCounter(model, mod_model_file=twin, align_config=cfg["align"], device="cpu")
    counter.add_target(locus["name"], locus["repeat"], locus["prefix"], locus["suffix"])
    gated_in = [row for row in want if row[3] != 0.0]
    assert gated_in
    for row in gated_in:
        assert row[6] and set(row[6]) <= {"0", "1"}, row
    for (_units, strand, raw), row in zip(pool, want):
        assert counter.detect_many(locus["name"], [raw], strand)[0] == row


def test_compare_numbers():
    ref = {0: (5, 9.0, 8.0, -100.0, 10, 20, "-"), 1: (7, 9.5, 8.5, -120.0, 11, 21, "-")}
    rows = [(0, ref[0]), (1, ref[1]), (0, ref[0])]
    assert check.compare(rows, [0, 1, 0], ref) == {
        "missing": 0, "replay_mismatch": 0, "int_mismatch": 0, "score_err": 0.0,
        "logp_err": 0.0}
    bad = [(0, ref[0]), (1, (8, 9.5 * (1 + 1e-3), 8.5, -120.0 * (1 + 1e-6), 11, 21, "-")),
           (0, (5, 9.0, 8.0, -100.0, 10, 22, "-"))]
    n = check.compare(bad, [0, 1, 0, 1], ref)
    assert n["missing"] == 1 and n["replay_mismatch"] == 1 and n["int_mismatch"] == 2
    assert n["score_err"] == pytest.approx(1e-3) and n["logp_err"] == pytest.approx(1e-6)


@pytest.mark.parametrize("bad", [float("nan"), float("inf"), -float("inf")])
def test_compare_sees_non_finite(bad):
    ref = {0: (5, 9.0, 8.0, -100.0, 10, 20, "-")}
    n = check.compare([(0, (5, bad, 8.0, bad, 10, 20, "-"))], [0], ref)
    assert n["score_err"] == float("inf") and n["logp_err"] == float("inf")
    assert not check.verdict(n, {k: 1e300 for k in check.NUMBERS})


def test_sample_takes_longest():
    pool = [(0, "+", np.zeros(n)) for n in (5, 50, 7, 9, 11)]
    s = check.sample({0, 1, 2, 3, 4}, pool, 9, 3)
    assert s[0] == 1 and len(s) == 3 and len(set(s)) == 3
    assert s == check.sample({0, 1, 2, 3, 4}, pool, 9, 3)
