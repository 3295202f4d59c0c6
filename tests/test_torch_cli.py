"""strique_tpu_torch's ``count`` CLI against strique_tpu's, on the CPU.

Two synthetic runs, written here (``synthetic.write_count_run``) from
the port's seeded 6-mer model (seed 11, as tests/test_torch_counter.py)
with 80-base flanks of c9orf72 and FMR1: noisy reads as single-read
fast5 files (h5py), a fofn from the port's ``fast5.index``, a SAM file
and a repeat TSV.  The port's
``count --device cpu`` must write the TSV of the JAX package's
``count`` (``JAX_PLATFORMS=cpu``) byte for byte: the same rows, in the
same order, with the same digits.  Both run the stream scheduler at
``--batch 4`` (its tail merge plan is the reference's on the CPU) and
the per-read path at ``--batch 1``.
"""
import os

import numpy as np
import pytest
import torch

from strique_tpu.cli import main as jax_main
from strique_tpu_torch import cli
from strique_tpu_torch.io import fast5
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import LOCI, write_count_run, write_pore_model

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

# the loci with 80-base flanks (the reference's CPU alignment stays quick)
T_LOCI = {name: (c, b, e, r, p[-80:], s[:80]) for name, (c, b, e, r, p, s) in LOCI.items()}
# (target, units, strand, backbone bases on each side); the single-locus
# run's reads fall in two signal buckets (2048 and 2560 samples), so the
# scheduler's close-time merge plan decides; the dual run has both loci
# and both strands, one read each (a read of the CPU path takes ~2.5 s)
RUNS = {
    "single": [("c9orf72", 5, "+", 20), ("c9orf72", 20, "+", 20), ("c9orf72", 8, "+", 20)],
    "dual": [("c9orf72", 7, "+", 20), ("fmr1", 16, "-", 20)],
}
# both packages' QC gate drops this noisy short read (flank scores not
# positive): its row has count 0, scores 0.0 -- the gated row's format
GATED = {"read-2-c9orf72+"}
# the stream scheduler (--batch 4) and the per-read path (--batch 1), on
# the dual run with two IO threads (the scheduler's prefetch window, the
# per-read worker pool)
MODES = {"batch4": ["--batch", "4"], "batch1": ["--batch", "1"],
         "batch4-t2": ["--batch", "4", "--t", "2"], "batch1-t2": ["--batch", "1", "--t", "2"]}
CASES = [("single", "batch4"), ("single", "batch1"), ("dual", "batch4-t2"),
         ("dual", "batch1-t2")]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=11)


@pytest.fixture(scope="module")
def runs(model_file, tmp_path_factory):
    pm = PoreModel(model_file)
    out = {}
    for (name, specs), seed in zip(RUNS.items(), (5, 6)):
        run = write_count_run(tmp_path_factory.mktemp(name), pm, specs, seed, T_LOCI)
        run["expect"] = {rid: (t, s, 0 if rid in GATED else n)
                         for rid, (t, s, n) in run["reads"].items()}
        out[name] = run
    return out


def _count_args(run, model_file, out, extra=()):
    return ["count", run["fofn"], model_file, run["repeat"], "--algn", run["sam"],
            "--out", str(out), *extra]


def _rows(path):
    return [line.split("\t") for line in open(path).read().splitlines()[1:]]


@pytest.mark.parametrize("run_name, mode", CASES)
def test_count_tsv_byte_identical_to_jax_cli(runs, model_file, tmp_path, run_name, mode):
    run = runs[run_name]
    ref, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jax_main(_count_args(run, model_file, ref, MODES[mode])) == 0
    assert cli.main(_count_args(run, model_file, got, [*MODES[mode], "--device", "cpu"])) == 0
    assert got.read_bytes() == ref.read_bytes()
    counted = {r[0]: (r[1], r[2], int(r[3])) for r in _rows(got)}
    assert counted == run["expect"]


def test_count_resume_appends_and_skips(runs, model_file, tmp_path):
    """--resume keeps the rows counted before and adds the others once; a
    second resume has nothing left to count (it runs with --profile, whose
    trace it writes)."""
    run = runs["single"]
    out = tmp_path / "counts.tsv"
    lines = open(run["sam"]).readlines()
    first = tmp_path / "first.sam"
    first.write_text("".join(lines[:2]))  # header + one read
    args = ["--batch", "4", "--device", "cpu"]
    assert cli.main(_count_args(dict(run, sam=str(first)), model_file, out, args)) == 0
    before = out.read_text()
    assert len(before.splitlines()) == 2
    assert cli.main(_count_args(run, model_file, out, [*args, "--resume"])) == 0
    assert out.read_text().startswith(before)
    ids = [r[0] for r in _rows(out)]
    assert sorted(ids) == sorted(run["expect"])
    after = out.read_text()
    prof = tmp_path / "profile"
    assert cli.main(_count_args(run, model_file, out,
                                [*args, "--resume", "--profile", str(prof)])) == 0
    assert out.read_text() == after
    traces = list(prof.iterdir())
    assert len(traces) == 1 and traces[0].stat().st_size > 0


def test_poisoned_read_costs_only_itself(runs, model_file):
    """One read whose signal breaks the batch submit is retried alone and
    dropped; its batchmates keep their counts (the scheduler's per-read
    retry), through the port's detector and dispatcher."""
    from strique_tpu_torch.detect.detector import RepeatDetector
    from strique_tpu_torch.parallel.dispatcher import run_pipeline
    from strique_tpu_torch.utils.config import parse_config

    run = runs["single"]
    config = parse_config(run["repeat"])
    index = fast5.Fast5Index(run["fofn"])
    poisoned = next(iter(run["expect"]))

    class Index:
        def get_raw(self, read_id):
            raw = index.get_raw(read_id)
            return np.array(["not-a-signal"] * len(raw)) if read_id == poisoned else raw

    class Sink:
        rows = []

        def write_line(self, target_counts=()):
            self.rows.extend(target_counts)

    rd = RepeatDetector(config["repeat"], model_file, Index(), device="cpu")
    retried = []
    detect = rd.counter.detect
    rd.counter.detect = lambda *a: retried.append(a[0]) or detect(*a)
    lines = [ln for ln in open(run["sam"]) if not ln.startswith("@")]
    assert run_pipeline(iter(lines), rd, Sink(), batch_size=4) == len(lines)
    got = {r[0]: r[3] for r in Sink.rows}
    assert got == {rid: n for rid, (_t, _s, n) in run["expect"].items() if rid != poisoned}
    # the close-time plan merges the two buckets into one batch: all of
    # it is retried, read by read
    assert len(retried) == len(lines)


def test_count_without_a_card_fails_naming_cuda(runs, model_file, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    run = runs["single"]
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(_count_args(run, model_file, tmp_path / "c.tsv"))


def test_missing_inputs_exit_1(runs, model_file, tmp_path):
    run = runs["single"]
    assert cli.main(["count", str(tmp_path / "nope.fofn"), model_file, run["repeat"],
                     "--device", "cpu"]) == 1
    assert cli.main(["count", run["fofn"], str(tmp_path / "no.model"), run["repeat"],
                     "--device", "cpu"]) == 1


def test_index_subcommand_matches_fast5_index(runs, capsys):
    run = runs["dual"]
    assert cli.main(["index", str(run["dir"])]) == 0
    printed = capsys.readouterr().out.splitlines()
    assert printed == list(fast5.index(str(run["dir"])))
    assert len(printed) == len(run["expect"])
    assert os.path.isfile(run["fofn"])
