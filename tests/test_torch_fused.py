"""The port's fused single dispatch and two-phase host-bounds path against
strique_tpu's, on the CPU.

Both counters load the seeded synthetic 6-mer model and count
tests/test_fused.py's read mix (three noisy reads of 20 units, a read
with no locus, a flat dead read the QC gate drops) with 80-base c9orf72
flanks and 80-base backbones:

  * the fused route (``STRIQUE_SPLIT=0`` at construction, or ``split =
    False``) returns the JAX counter's fused tuples exactly, and so does
    the two-phase route (``fused = False``) the JAX two-phase tuples;
  * the relations of tests/test_fused.py hold between the port's
    routes: split and fused equal, two-phase at the fused counts,
    offsets and ticks, its scores and log_p within 1e-6 relative;
  * the fused route with a mod model and on the NumPy prep returns the
    JAX counter's tuples there, and both routes over two CPU device
    entries their single-device tuples;
  * the fused memory rule (``fused_viterbi_rows``): the Viterbi call
    width shrinks with the budget, and past it the bucket takes the
    split route;
  * ``count --device cpu`` under ``STRIQUE_SPLIT=0`` writes the JAX
    CLI's TSV byte for byte.
"""
import numpy as np
import pytest
import torch

from strique_tpu.cli import main as jax_main
from strique_tpu.detect.counter import RepeatCounter as JaxRepeatCounter
from strique_tpu_torch import cli
from strique_tpu_torch import native as native_lib
from strique_tpu_torch.detect import counter as TC
from strique_tpu_torch.detect.counter import RepeatCounter, fused_viterbi_rows
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (LOCI, MOD_MODEL_SEED, PREFIX, REPEAT, SUFFIX,
                                        make_mod_reads, write_count_run, write_mod_model,
                                        write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

T_PREFIX = PREFIX[-80:]
T_SUFFIX = SUFFIX[:80]
UNITS = 20
BACKBONE = 80  # bases of backbone on each side of the locus


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


def _read_mix(pm):
    """tests/test_fused.py's mix: 3 noisy reads of UNITS units, a read of
    backbone only, a flat dead read; edge-padded to one length."""
    rng = np.random.default_rng(42)
    backbone = "".join(rng.choice(list("ACTG"), 2 * BACKBONE))
    seq = backbone[:BACKBONE] + T_PREFIX + REPEAT * UNITS + T_SUFFIX + backbone[BACKBONE:]
    sigs = [pm.generate_signal(seq, samples=8, noise=True, rng=rng) for _ in range(3)]
    sigs.append(pm.generate_signal("".join(rng.choice(list("ACTG"), 2 * BACKBONE + 300)),
                                   samples=8))
    sigs.append(np.full(2000, 90.0))
    mx = max(len(s) for s in sigs)
    return [np.pad(s, (0, mx - len(s)), mode="edge") for s in sigs]


def _counter(cls, model_file, **kw):
    c = cls(model_file, **kw)
    c.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    return c


def _routes(counter, reads):
    """split, fused and two-phase tuples of one counter, as tests/test_fused.py flips them."""
    out = {"split": counter.detect_many("c9orf72", reads, "+")}
    counter.split = False
    out["fused"] = counter.detect_many("c9orf72", reads, "+")
    counter.fused = False
    out["two_phase"] = counter.detect_many("c9orf72", reads, "+")
    counter.split, counter.fused = True, True
    return out


@pytest.fixture(scope="module")
def reads(model_file):
    return _read_mix(PoreModel(model_file))


@pytest.fixture(scope="module")
def jax_routes(model_file, reads):
    return _routes(_counter(JaxRepeatCounter, model_file), reads)


@pytest.fixture(scope="module")
def port_routes(model_file, reads):
    return _routes(_counter(RepeatCounter, model_file, device="cpu"), reads)


@pytest.mark.parametrize("route", ["split", "fused", "two_phase"])
def test_routes_match_jax_counter(jax_routes, port_routes, route):
    assert port_routes[route] == jax_routes[route]
    counts = [r[0] for r in port_routes[route]]
    assert counts[:3] == [UNITS] * 3 and counts[4] == 0


def test_route_relations(port_routes):
    """tests/test_fused.py:68-76 on the port's routes."""
    split, fused, two = port_routes["split"], port_routes["fused"], port_routes["two_phase"]
    assert split == fused
    for f, t in zip(fused, two):
        assert (f[0], f[4], f[5]) == (t[0], t[4], t[5])
        np.testing.assert_allclose(f[1:4], t[1:4], rtol=1e-6)
    # the dead read is gated: no count, no log_p, no mod string
    assert fused[4][0] == 0 and fused[4][3] == 0.0 and fused[4][6] == "-"


def test_split_env_selects_fused_route(model_file, reads, port_routes, monkeypatch):
    monkeypatch.setenv("STRIQUE_SPLIT", "0")
    c = _counter(RepeatCounter, model_file, device="cpu")
    assert not c.split and c.fused
    state = c.detect_submit("c9orf72", reads, "+")
    assert "fused_parts" in state and c.detect_middle(state) is state
    assert c.detect_finish(state) == port_routes["fused"]


@pytest.mark.parametrize("route", ["fused", "two_phase"])
def test_routes_over_two_cpu_entries(model_file, reads, port_routes, route):
    c = _counter(RepeatCounter, model_file, device=["cpu", "cpu"])
    c.split = False
    c.fused = route == "fused"
    assert c.detect_many("c9orf72", reads, "+") == port_routes[route]


@pytest.mark.parametrize("route", ["fused", "two_phase"])
def test_routes_numpy_prep(model_file, reads, monkeypatch, route):
    """Without the native library (the NumPy prep; the fused route then
    uploads f32 morph and flt channels, the reference's use_buf=False
    pipeline): the JAX counter's tuples on its NumPy prep."""
    from strique_tpu import native as jax_native

    monkeypatch.setattr(native_lib, "available", lambda: False)
    monkeypatch.setattr(jax_native, "available", lambda: False)
    got, ref = (_counter(RepeatCounter, model_file, device="cpu"),
                _counter(JaxRepeatCounter, model_file))
    got.split = ref.split = False
    got.fused = ref.fused = route == "fused"
    assert got.detect_many("c9orf72", reads, "+") == ref.detect_many("c9orf72", reads, "+")


@pytest.fixture(scope="module")
def mod_models(tmp_path_factory):
    d = tmp_path_factory.mktemp("mod_models")
    return (write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED),
            write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED))


def test_fused_route_with_mod_model(mod_models):
    base, twin = mod_models
    pm, pm_twin = PoreModel(base), PoreModel(twin)
    reads = make_mod_reads(pm, pm_twin, 2, 12, np.random.default_rng(3), strand="+",
                           prefix=T_PREFIX, suffix=T_SUFFIX, flank_bases=BACKBONE)
    ref = _counter(JaxRepeatCounter, base, mod_model_file=twin)
    ref.split = False
    port = _counter(RepeatCounter, base, mod_model_file=twin, device="cpu")
    port.split = False
    got = port.detect_many("c9orf72", reads, "+")
    assert got == ref.detect_many("c9orf72", reads, "+")
    assert all(r[0] == 12 and set(r[6]) <= {"0", "1"} and len(r[6]) for r in got)
    port.split = True
    assert port.detect_many("c9orf72", reads, "+") == got


def test_fused_memory_rule(model_file, reads, port_routes, monkeypatch):
    """Reads per fused Viterbi call: the (npad, rows, SP) f32 plane within
    the budget, in multiples of 8 up to GROUP; below 8 rows the split
    route runs.  The tuples stay the fused route's."""
    gib = 1 << 30
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(65536 * 64 * 8192 * 4 / gib))
    assert fused_viterbi_rows(65536, 8192, "cpu") == 64
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(65536 * 20 * 8192 * 4 / gib))
    assert fused_viterbi_rows(65536, 8192, "cpu") == 16
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(65536 * 7 * 8192 * 4 / gib))
    assert fused_viterbi_rows(65536, 8192, "cpu") == 0

    c = _counter(RepeatCounter, model_file, device="cpu")
    c.split = False
    npad = TC.signal_bucket(len(reads[0]))
    per8 = npad * 8 * TVC.padded_sp(c.targets["c9orf72"][0].repeat_hmm.n_states) * 4
    groups = []
    real = TVC.viterbi_batch

    def spy(obs, t_actual, ph, group=TVC.GROUP):
        groups.append(group)
        return real(obs, t_actual, ph, group)

    monkeypatch.setattr(TC, "viterbi_batch", spy)
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(1.5 * per8 / gib))
    state = c.detect_submit("c9orf72", reads, "+")
    assert "fused_parts" in state and groups == [8]
    assert c.detect_finish(state) == port_routes["fused"]
    monkeypatch.setenv("STRIQUE_PTR_BUDGET_GB", str(0.5 * per8 / gib))
    state = c.detect_submit("c9orf72", reads, "+")
    assert "bounds_parts" in state
    assert c.detect_finish(state) == port_routes["fused"]
    # a bucket whose alignment takes the two-pass route runs the split path too
    monkeypatch.delenv("STRIQUE_PTR_BUDGET_GB")
    monkeypatch.setattr(TC, "takes_two_pass", lambda *a: True)
    assert "bounds_parts" in c.detect_submit("c9orf72", reads[:1], "+")


def test_count_cli_fused_tsv_byte_identical(model_file, tmp_path, monkeypatch):
    loci = {name: (c, b, e, r, p[-80:], s[:80]) for name, (c, b, e, r, p, s) in LOCI.items()}
    (tmp_path / "run").mkdir()
    run = write_count_run(tmp_path / "run", PoreModel(model_file),
                          [("c9orf72", 9, "+", 20), ("fmr1", 12, "-", 20)], 7, loci)
    monkeypatch.setenv("STRIQUE_SPLIT", "0")
    ref, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    base = ["count", run["fofn"], model_file, run["repeat"], "--algn", run["sam"], "--batch", "4"]
    assert jax_main([*base, "--out", str(ref)]) == 0
    assert cli.main([*base, "--out", str(got), "--device", "cpu"]) == 0
    assert got.read_bytes() == ref.read_bytes()
    assert [line.split("\t")[3] for line in got.read_text().splitlines()[1:]] == ["9", "12"]
