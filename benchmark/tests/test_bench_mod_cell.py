"""The ``c9orf72-5mC-carrier`` cell: its files, a small CPU run of it
through ``run.run_cell``, and the readers of its two new per-layer
metrics (``mod_host_ms``, ``mod_pad_pct``; the cell reports them as
their ``.card`` twins, as it reports ``card_us_per_read``) on hand-made
records and on the traced CPU run."""
import math

import pytest

import run
from harness import spans, spec
from small import small_cell

CELL = "c9orf72-5mC-carrier"
METRICS = ("mod_host_ms", "mod_pad_pct")
CARD = tuple(m + ".card" for m in METRICS)
PROSE = {"name", "source", "deployment", "guarantees", "assumed"}
MAIN, SUBMIT = 1, 2
MS = 1e6  # ns


def _read(name, ctx):
    return spec.module("metrics", name).read(ctx)


def test_cell_file():
    cell = spec.cell(CELL)
    carrier = spec.cell("c9orf72-cas9-carrier")
    assert (cell["config"], cell["traffic"], cell["generator"]) == (
        "c9orf72-5mC", "cas9_carrier_5mC", "pool")
    assert (cell["batch_size"], cell["check_reads"]) == (64, 16)
    assert cell["check"] == carrier["check"]
    p = cell["params"]
    assert (p["reads"], p["plus_share"], p["flank_bases"]) == (512, 0.5, [1000, 1000])
    normal, expanded = p["alleles"]
    assert normal == {"share": 0.5, "units": [2, 23], "draw": "uniform"}
    assert expanded == {"share": 0.5, "units": [700, 1600], "draw": "uniform",
                        "methylation": {"reads": 0.5, "units": 1.0}}
    # the carrier's traffic but for the methylation
    assert dict(p, alleles=[normal, {k: v for k, v in expanded.items()
                                     if k != "methylation"}]) == carrier["params"]


def test_config_is_c9orf72_with_a_twin():
    cfg = spec.cell(CELL)["config_spec"]
    base = spec.cell("c9orf72-cas9-carrier")["config_spec"]
    assert cfg["mod_model"] == {"shift_pA": -4.0}
    assert set(cfg) == set(base) | {"mod_model"}
    assert {k: v for k, v in cfg.items() if k not in PROSE | {"mod_model"}} == {
        k: v for k, v in base.items() if k not in PROSE}
    assert set(base["assumed"]) < set(cfg["assumed"])
    assert set(base["guarantees"]) < set(cfg["guarantees"])
    entry = next(c for c in spec.benchmark()["configs"] if c["name"] == "c9orf72-5mC")
    assert entry["reduced"] == [] and entry["file"] == "benchmark/configs/c9orf72-5mC.json"


def test_cell_reports_the_card_family():
    """The card's time a row end to end, as FMR1's carrier, and the
    ``.card`` metrics with the two of the mod pass."""
    bench = spec.benchmark()
    names = lambda c, s: {m["name"] for m in spec.cell_metrics(bench, c, s)}  # noqa: E731
    assert names(CELL, "end_to_end") == names("fmr1-cas9-carrier", "end_to_end") == {
        "setup_s", "card_us_per_read"}
    assert names(CELL, "per_layer") == names("fmr1-cas9-carrier", "per_layer") | set(CARD)
    assert not any(CELL in m.get("workloads", ()) for m in bench["per_layer"]
                   if not m["name"].endswith(".card"))


def _records():
    """Two batches (two submits).  Main thread: batch 0's mod phase, 10 ms,
    holds a 2 ms wait for the count paths, a 6 ms prep with a 2 ms launch
    inside, and a 2 ms decode; batch 1's, 3 ms, a 1 ms wait (a nested
    wait inside it), a 1 ms prep and a 1 ms decode."""
    from strique_tpu_torch.utils.trace import Record

    rows = [  # id, name, tid, parent, batch, start ms, end ms
        (0, "stream.submit", SUBMIT, None, 0, 0, 10),
        (1, "stream.submit", SUBMIT, None, 1, 10, 20),
        (2, "stream.mod", MAIN, None, 0, 20, 30),
        (3, "finish.wait", MAIN, 2, 0, 20, 22),
        (4, "mod.prep", MAIN, 2, 0, 22, 28),
        (5, "mod.viterbi", MAIN, 4, 0, 26, 28),
        (6, "finish.decode", MAIN, 2, 0, 28, 30),
        (7, "stream.mod", MAIN, None, 1, 30, 33),
        (8, "finish.wait", MAIN, 7, 1, 30, 31),
        (9, "inner.wait", MAIN, 8, 1, 30.2, 30.5),
        (10, "mod.prep", MAIN, 7, 1, 31, 32),
        (11, "mod.viterbi", MAIN, 10, 1, 31.5, 32),
        (12, "finish.decode", MAIN, 7, 1, 32, 33),
    ]
    return [Record(i, n, tid, parent, batch, s * MS, e * MS, {}, tid == MAIN)
            for i, n, tid, parent, batch, s, e in rows]


def _ctx(recs=None, counts=None):
    return {"program_records": _records() if recs is None else recs,
            "program_counts": ({"mod.steps": 600, "mod.padded": 800, "viterbi.steps": 400,
                                "viterbi.padded": 1000} if counts is None else counts),
            "batch_size": 64}


@pytest.mark.parametrize("name,value", [
    ("mod_host_ms", ((10 - 2) + (3 - 1)) / 2),  # each mod phase less its waits, a batch
    ("mod_pad_pct", 25.0),
])
def test_metric_on_hand_made_records(name, value):
    assert _read(name, _ctx()) == pytest.approx(value)


def test_mod_metrics_read_nothing_without_the_mod_pass():
    no_mod = [r for r in _records() if not r.name.startswith(("stream.mod", "mod."))]
    assert _read("mod_host_ms", _ctx(recs=no_mod)) is None
    assert _read("mod_pad_pct", _ctx(counts={"viterbi.steps": 400, "viterbi.padded": 1000}))\
        is None
    assert _read("mod_pad_pct", _ctx(counts={"mod.steps": 0, "mod.padded": 0})) is None
    for name in METRICS:
        assert _read(name, _ctx(recs=[], counts={})) is None, name


@pytest.mark.parametrize("name", METRICS)
def test_no_tracer_reads_nothing(monkeypatch, name):
    """A program without the tracer: no number, no raise."""
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert _read(name, {"batch_size": 64}) is None


def test_small_cell_on_cpu(tmp_path):
    """The cell cut to a few short reads, traced on the CPU: every check
    number at its limit, every gated-in row's mod string of '0'/'1', and
    both new metrics read."""
    out = run.run_cell(small_cell(CELL, reads=4), spec.benchmark(), 2**31 + 4093, 0.5, True,
                       "cpu", tmp_root=str(tmp_path))
    assert out["correct"], (out["numbers"], out["limits"])
    mods = [r[6] for _k, r in out["rows"] if r[3] != 0.0]
    assert mods and all(m and set(m) <= {"0", "1"} for m in mods), mods
    assert any(n.startswith("mod: '1' on methylated units") for n in out["notes"])
    for name in CARD:
        assert math.isfinite(out["layers"][name]["value"]), name
