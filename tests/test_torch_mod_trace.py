"""The port's tracer on the mod pass: with a 5mC twin the mod decode
counts its own Viterbi work (``mod.reads``, ``mod.steps``,
``mod.padded``) apart from the count pass's (``viterbi.*``), and its
launch is a ``mod.viterbi`` span inside ``mod.prep``.

A traced ``run_pipeline`` pass over a small synthetic c9orf72 stream on a
``device='cpu'`` counter with ``synthetic.write_mod_model``'s twin, as
``tests/test_torch_trace.py``'s ``traced`` fixture runs one without it.
"""
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strique_tpu_torch import synthetic
from strique_tpu_torch.detect.detector import RepeatDetector
from strique_tpu_torch.parallel.dispatcher import run_pipeline
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.utils import trace

UNITS = (4, 5, 9, 6, 4, 7)  # c9orf72 units of the stream's reads
MOD = 9  # the mod string's column in a written row


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Index:
    def __init__(self, pool):
        self.pool = pool

    def get_raw(self, read_id):
        return self.pool[read_id]


class _Sink:
    def __init__(self):
        self.rows = []

    def write_line(self, target_counts=()):
        self.rows.extend(target_counts)


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    seed = synthetic.MOD_MODEL_SEED
    return (synthetic.write_pore_model(str(d / "base.model"), seed=seed),
            synthetic.write_mod_model(str(d / "twin.model"), seed=seed))


def _stream(models, seed):
    """SAM lines and an index of small c9orf72 reads, both strands, odd
    reads from the twin (methylated in every unit)."""
    pm, pm_mod = PoreModel(models[0]), PoreModel(models[1])
    rng = np.random.default_rng(seed)
    pool, lines = {}, []
    chrom, begin = synthetic.LOCI["c9orf72"][:2]
    for k, units in enumerate(UNITS):
        strand = "+-"[k % 2]
        pool[f"r{k}"] = synthetic.make_mod_reads(pm, pm_mod, 2, units, rng, strand=strand,
                                                 flank_bases=60)[(k // 2) % 2]
        lines.append(synthetic.sam_line(f"r{k}", strand, chrom, begin))
    return lines, _Index(pool)


def _run(models, traced: bool):
    """One run_pipeline pass at --batch 2; the rows, and each Viterbi
    submit's HMM and segment lengths."""
    lines, index = _stream(models, seed=5)
    det = RepeatDetector({"c9orf72": synthetic.LOCI["c9orf72"]}, models[0], index,
                         mod_model_file=models[1], device="cpu")
    counter, calls = det.counter, []
    submit = counter._viterbi_submit

    def viterbi_submit(chm, segments):  # the two arguments the benchmark's Probe passes on
        calls.append((chm, [len(s) for s in segments]))
        return submit(chm, segments)

    counter._viterbi_submit = viterbi_submit
    sink = _Sink()
    if traced:
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]):
            run_pipeline(iter(lines), det, sink, io_threads=1, batch_size=2)
    else:
        run_pipeline(iter(lines), det, sink, io_threads=1, batch_size=2)
    mod_hmms = {id(tc.mod_hmm) for tc in counter.targets["c9orf72"]}  # both strands'
    return {"rows": sink.rows, "calls": [(id(chm) in mod_hmms, lens) for chm, lens in calls]}


@pytest.fixture(scope="module")
def traced(models):
    out = _run(models, traced=True)
    out.update(recs=trace.records(), counts=trace.counts(), main=threading.get_native_id())
    return out


def _steps(run, mod: bool) -> list:
    """The segment lengths of the Viterbi submits of the mod HMMs (or of
    the count pass's HMMs)."""
    return [n for is_mod, lens in run["calls"] if is_mod == mod for n in lens]


def test_every_row_calls_methylation(traced):
    rows = traced["rows"]
    assert len(rows) == len(UNITS)
    mods = [r[MOD] for r in rows if r[MOD] != "-"]
    assert mods and all(set(m) <= {"0", "1"} for m in mods), mods


def test_mod_reads_are_the_rows_with_a_mod_string(traced):
    called = sum(r[MOD] != "-" for r in traced["rows"])
    assert traced["counts"]["mod.reads"] == called > 0


def test_mod_steps_are_the_mod_segments(traced):
    c = traced["counts"]
    assert c["mod.steps"] == sum(_steps(traced, mod=True))
    assert c["mod.padded"] >= c["mod.steps"] > 0


def test_viterbi_steps_are_the_count_pass_alone(traced):
    c = traced["counts"]
    count_steps = _steps(traced, mod=False)
    assert count_steps and c["viterbi.steps"] == sum(count_steps)
    assert c["viterbi.padded"] >= c["viterbi.steps"]


def test_mod_viterbi_nests_in_mod_prep_in_stream_mod(traced):
    recs = traced["recs"]
    by_id = {r.id: r for r in recs}
    launches = [r for r in recs if r.name == "mod.viterbi"]
    assert len(launches) == sum(1 for r in recs if r.name == "mod.prep") > 0
    for r in launches:
        prep = by_id[r.parent]
        mod = by_id[prep.parent]
        assert (prep.name, mod.name) == ("mod.prep", "stream.mod")
        assert r.tid == prep.tid == mod.tid == traced["main"]
        assert mod.start <= prep.start <= r.start <= r.end <= prep.end <= mod.end
        assert r.batch == prep.batch == mod.batch


def test_untraced_rows_equal_traced_rows(traced, models):
    plain = _run(models, traced=False)
    assert not trace.enabled()
    assert sorted(plain["rows"]) == sorted(traced["rows"])
    for mod in (True, False):  # the same decodes ran
        assert sorted(_steps(plain, mod)) == sorted(_steps(traced, mod))
