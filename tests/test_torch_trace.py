"""The port's tracer (``strique_tpu_torch.utils.trace``): spans and
counters recorded only while a ``torch.profiler`` session runs, on every
host thread, and put on the profiler trace's clock.

The pipeline cases run ``run_pipeline`` over a ``device='cpu'`` counter
on a small synthetic stream, once under a CPU-only profiler; one case
(marked ``gpu``) runs it on a card and looks at the kernel launches.
"""
import itertools
import json
import os
import threading
import tracemalloc
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strique_tpu_torch import synthetic
from strique_tpu_torch.detect.detector import RepeatDetector
from strique_tpu_torch.parallel.dispatcher import run_pipeline
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.utils import trace

# every span the split route's path takes on the CPU, with its thread
MAIN_SPANS = {"stream.read", "stream.wait", "stream.middle", "stream.mod", "stream.finish",
              "stream.retry", "stream.close", "middle.wait", "middle.viterbi", "finish.wait",
              "finish.decode"}
SUBMIT_SPANS = {"stream.submit", "submit.prep", "submit.upload", "submit.align",
                "submit.bounds"}
FLUSHES = ("stream.flush.full", "stream.flush.cap", "stream.flush.close")
UNITS = (4, 5, 9, 6, 4)  # c9orf72 units of the stream's reads


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _annotations(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as fp:
        doc = json.load(fp)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
            for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]


class _Index:
    def __init__(self, pool):
        self.pool = pool

    def get_raw(self, read_id):
        return self.pool[read_id]


class _Sink:
    def __init__(self):
        self.rows = []

    def write_line(self, target_counts=()):
        self.rows.append(list(target_counts))


def _stream(pm, seed):
    """SAM lines and an in-memory index of small c9orf72 reads."""
    rng = np.random.default_rng(seed)
    pool, lines = {}, []
    chrom, begin = synthetic.LOCI["c9orf72"][:2]
    for k, units in enumerate(UNITS):
        strand = "+-"[k % 2]
        pool[f"r{k}"] = synthetic.make_reads(pm, 1, units, rng, strand=strand,
                                             flank_bases=60)[0]
        lines.append(synthetic.sam_line(f"r{k}", strand, chrom, begin))
    return lines, _Index(pool)


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return synthetic.write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"),
                                      seed=3)


@pytest.fixture(scope="module")
def traced(model_file, tmp_path_factory):
    """One traced run_pipeline pass at --batch 2 (two full batches, the
    close-time remainder); the first batch's finish fails once, so its
    reads take the per-read retry.  Returns the records, counters,
    annotations, rows and the main thread's id."""
    lines, index = _stream(PoreModel(model_file), seed=11)
    det = RepeatDetector({"c9orf72": synthetic.LOCI["c9orf72"]}, model_file, index,
                         device="cpu")
    finish, failed = det.counter.detect_finish, []

    def detect_finish(state):
        if not failed:
            failed.append(state["B"])
            raise RuntimeError("a batch that fails once")
        return finish(state)

    det.counter.detect_finish = detect_finish
    sink = _Sink()
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        trace.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run_pipeline(iter(lines), det, sink, io_threads=1, batch_size=2)
    finally:
        torch.set_num_threads(n)
    ann = _annotations(prof, tmp_path_factory.mktemp("trace"))
    return {"recs": trace.records(), "counts": trace.counts(), "ann": ann,
            "rows": sink.rows, "main": threading.get_native_id(), "retried": failed[0],
            "reads": len(lines)}


def test_off_records_nothing():
    before, counted = trace.records(), trace.counts()
    assert not torch.autograd.profiler._is_profiler_enabled
    with trace.span("stream.submit", 3) as sp:
        assert sp is trace.OFF and not sp
        trace.count("stream.reads", 5)
    assert trace.span("kernel.launch") is trace.OFF
    assert not trace.enabled()
    assert trace.records() == before and trace.counts() == counted


def test_off_span_allocates_nothing():
    def calls(n):
        for _ in itertools.repeat(None, n):
            trace.span("kernel.launch")
            trace.count("viterbi.steps", 7)

    calls(10)
    tracemalloc.start()
    try:
        calls(10)
        base = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        calls(10000)
        current, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    assert current == base and peak <= base + 64, (base, current, peak)


def test_profiler_flag_is_process_wide():
    """The tracer reads the profiler's process-wide flag: the thread-local
    one reads False on the submit thread under a running profiler."""
    seen = {}

    def look():
        seen["global"] = torch.autograd.profiler._is_profiler_enabled
        seen["local"] = torch.autograd._profiler_enabled()
        seen["tracer"] = trace.enabled()

    with ThreadPoolExecutor(1) as pool:
        with profile(activities=[ProfilerActivity.CPU]):
            assert torch.autograd._profiler_enabled() and trace.enabled()
            pool.submit(look).result()
        assert seen == {"global": True, "local": False, "tracer": True}
        pool.submit(look).result()
    assert seen == {"global": False, "local": False, "tracer": False}


def test_pipeline_records_every_span(traced):
    names = {(r.name, r.tid == traced["main"]) for r in traced["recs"]}
    assert {(n, True) for n in MAIN_SPANS} <= names
    assert {(n, False) for n in SUBMIT_SPANS} <= names
    assert len(traced["rows"]) == traced["reads"]


def test_submit_thread_spans_carry_its_id(traced):
    recs = traced["recs"]
    submit_tids = {r.tid for r in recs if r.name == "stream.submit"}
    assert len(submit_tids) == 1 and traced["main"] not in submit_tids
    assert all(not r.annotated for r in recs if r.tid in submit_tids)
    # on the main thread every span but the per-line ones opens an annotation
    plain = {r.name for r in recs if r.tid == traced["main"] and not r.annotated}
    assert plain == {"stream.read"}
    assert {n for _s, _e, n in traced["ann"]} >= MAIN_SPANS - plain
    assert not any(n == "stream.read" for _s, _e, n in traced["ann"])


def test_batches_share_their_id(traced):
    recs = traced["recs"]
    submits = sorted(r.batch for r in recs if r.name == "stream.submit")
    assert submits == list(range(len(submits))) and len(submits) == 3
    for name in ("stream.wait", "stream.middle", "stream.mod"):
        assert sorted(r.batch for r in recs if r.name == name) == submits, name
    for name in ("submit.prep", "submit.align", "middle.viterbi", "finish.decode"):
        assert {r.batch for r in recs if r.name == name} == set(submits), name
    finished = sorted(r.batch for r in recs if r.name in ("stream.finish", "stream.retry"))
    assert finished == sorted(submits + [0])  # batch 0 finished, failed, then retried
    for r in recs:
        if r.name in ("finish.decode", "finish.wait") and r.batch == 0:
            # the retry's own one-read batches run inside the retry span
            assert any(p.name == "stream.retry" for p in _ancestors(recs, r))


def _ancestors(recs, r):
    by_id = {x.id: x for x in recs}
    while r.parent is not None:
        r = by_id[r.parent]
        yield r


def test_parents_nest(traced):
    recs = traced["recs"]
    by_id = {r.id: r for r in recs}
    for r in recs:
        if r.parent is None:
            continue
        p = by_id[r.parent]
        assert p.tid == r.tid and p.start <= r.start <= r.end <= p.end, (p, r)
    roots = {r.name for r in recs if r.parent is None}
    assert roots == {"stream.read", "stream.submit", "stream.close"}
    parent_of = {(by_id[r.parent].name, r.name) for r in recs if r.parent is not None}
    assert {("stream.submit", "submit.prep"), ("stream.middle", "middle.wait"),
            ("stream.finish", "finish.decode")} <= parent_of


def test_counters_add_up(traced):
    c, recs = traced["counts"], traced["recs"]
    flushes = sum(c.get(k, 0) for k in FLUSHES)
    assert flushes == len([r for r in recs if r.name == "stream.submit"]) == 3
    assert c["stream.flush.full"] == 2 and c["stream.flush.close"] == 1
    assert c["stream.reads"] == traced["reads"]
    assert c["stream.retries"] == traced["retried"] == 2
    assert c["submit.padded"] > c["submit.samples"] > 0
    assert c["viterbi.padded"] >= c["viterbi.steps"] > 0


def test_records_reset_at_next_session(traced):
    """A session's owner resets the tracer as it starts one; a session
    that follows the program running untraced (a warm-up pass) starts
    afresh by itself."""
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("stream.close"):
            trace.count("stream.reads", 2)
    assert [r.name for r in trace.records()] == ["stream.close"]
    assert trace.counts() == {"stream.reads": 2}
    trace.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        with trace.span("stream.finish"):
            pass
    assert [r.name for r in trace.records()] == ["stream.finish"] and trace.counts() == {}
    with trace.span("stream.read"):  # the program between sessions, untraced
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        trace.count("stream.reads", 3)
    assert trace.records() == [] and trace.counts() == {"stream.reads": 3}
    assert len(traced["recs"]) > 10  # the fixture's copy is untouched


def test_worker_span_on_trace_clock(tmp_path):
    """A main-thread span and a worker span opened inside it (the main
    thread waits on the worker) land on the exported trace's clock, and
    so do the main thread's spans that open no annotation."""
    def work():
        with trace.span("submit.prep"):
            sum(range(200000))

    trace.reset()
    with ThreadPoolExecutor(1) as pool:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for _ in range(20):  # the pairs the clock's offset is the median of
                with trace.span("stream.middle"):
                    sum(range(1000))
                sum(range(5000))  # ~0.1 ms or more on either side of each launch span
                with trace.span("kernel.launch", annotate=False):
                    sum(range(1000))
                sum(range(5000))
            with trace.span("stream.wait"):
                sum(range(100000))
                pool.submit(work).result()
                sum(range(100000))  # the worker is idle again before the span ends
    ann = _annotations(prof, tmp_path)
    on_clock = trace.to_trace_clock(ann)
    recs = {r.name: r for r in on_clock}
    main, worker = recs["stream.wait"], recs["submit.prep"]
    (a_start, a_end), = [(s, e) for s, e, n in ann if n == "stream.wait"]
    assert not any(n in ("submit.prep", "kernel.launch") for _s, _e, n in ann)
    assert abs(main.start - a_start) < 100 and abs(main.end - a_end) < 100
    # each launch span lies between the annotations of the middles around it
    middles = sorted((s, e) for s, e, n in ann if n == "stream.middle")
    launches = sorted((r.start, r.end) for r in on_clock if r.name == "kernel.launch")
    assert len(middles) == len(launches) == 20
    for k, (s, e) in enumerate(launches):
        assert middles[k][1] < s < e < (middles[k + 1][0] if k < 19 else a_start), k
    assert main.start < worker.start < worker.end < main.end
    assert worker.tid != main.tid and not worker.annotated


def test_pipeline_spans_map_onto_annotations(traced):
    recs = trace.to_trace_clock(traced["ann"], traced["recs"])
    ann = {}
    for s, e, n in traced["ann"]:
        ann.setdefault(n, []).append((s, e))
    mains = sorted((r for r in recs if r.name == "stream.middle"), key=lambda r: r.start)
    for r, (s, e) in zip(mains, sorted(ann["stream.middle"])):
        assert abs(r.start - s) < 100 and abs(r.end - e) < 100
    # a batch's submit span ends before its middle phase's wait ends
    submit = {r.batch: r for r in recs if r.name == "stream.submit"}
    for r in recs:
        if r.name == "stream.wait":
            assert submit[r.batch].end <= r.end + 100


def test_count_profile_writes_every_thread(tmp_path, model_file):
    pytest.importorskip("h5py")
    from strique_tpu_torch import cli

    pm = PoreModel(model_file)
    run = synthetic.write_count_run(tmp_path, pm, [("c9orf72", 4, "+", 60),
                                                   ("c9orf72", 5, "+", 60),
                                                   ("c9orf72", 6, "-", 60)], seed=4)
    out, prof_dir = str(tmp_path / "counts.tsv"), str(tmp_path / "prof")
    assert cli.main(["count", run["fofn"], model_file, run["repeat"], "--algn", run["sam"],
                     "--out", out, "--device", "cpu", "--batch", "2",
                     "--profile", prof_dir]) == 0
    (name,) = os.listdir(prof_dir)
    with open(os.path.join(prof_dir, name)) as fp:
        doc = json.load(fp)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ours = [e for e in events if e.get("cat") == "strique_span"]
    annotated = [e for e in events if e.get("cat") == "user_annotation"]
    assert {e["name"] for e in ours} >= SUBMIT_SPANS | {"stream.read"}
    assert {e["name"] for e in annotated} >= {"stream.middle", "stream.finish"}
    main_tid = annotated[0]["tid"]
    # the per-line spans on the main thread's row, the rest on the submit thread's
    assert {e["tid"] for e in ours if e["name"] == "stream.read"} == {main_tid}
    assert len({e["tid"] for e in ours if e["name"] != "stream.read"} - {main_tid}) == 1
    with open(out) as fp:
        assert len(fp.read().strip().splitlines()) == 4  # header and 3 rows


def test_idle_by_innermost_span():
    """``tools/trace_cell.py`` names the card's idle time by the innermost
    span open on each thread: over idle gaps at 1-4 and 6-9 us, a main
    thread's read holding a wait, and a submit thread's prep."""
    from tools.trace_cell import idle_by_span

    rec = trace.Record
    recs = [rec(0, "stream.read", 1, None, None, 0.0, 8.0, {}, False),
            rec(1, "stream.wait", 1, 0, 0, 2.0, 7.0, {}, True),
            rec(2, "submit.prep", 2, None, 0, 3.0, 5.0, {}, False)]
    got = idle_by_span([(1.0, 4.0), (6.0, 9.0)], recs)
    assert got[1] == pytest.approx({"stream.read": 2e-6, "stream.wait": 3e-6, "none": 1e-6})
    assert got[2] == pytest.approx({"submit.prep": 1e-6, "none": 5e-6})


@pytest.mark.gpu
def test_gpu_kernel_launch_spans(tmp_path, model_file):
    """On a card every C entry point's launch is a ``kernel.launch`` span
    naming the entry point, under the submit's alignment on the submit
    thread and under the middle phase's Viterbi on the main thread."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from strique_tpu_torch import _build

    lines, index = _stream(PoreModel(model_file), seed=12)
    det = RepeatDetector({"c9orf72": synthetic.LOCI["c9orf72"]}, model_file, index)
    run_pipeline(iter(lines), det, _Sink(), io_threads=1, batch_size=2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run_pipeline(iter(lines), det, _Sink(), io_threads=1, batch_size=2)
    recs = trace.records()
    by_id = {r.id: r for r in recs}
    launches = [r for r in recs if r.name == "kernel.launch"]
    assert launches and all(r.attrs["entry"] in _build._SIGNATURES and r.attrs["rows"] > 0
                            for r in launches)
    parents = {(by_id[r.parent].name, r.tid == threading.get_native_id()) for r in launches}
    assert ("submit.align", False) in parents and ("middle.viterbi", True) in parents
    # the alignment's first blocking copy waits for the card: a wait span
    assert any(r.name == "align.h2d.wait" and by_id[r.parent].name == "submit.align"
               for r in recs)
