"""The per-layer metrics that read the program's own spans and counters
(``harness/spans.py``): on hand-made records and a fake timeline, on a
program without a tracer, and on a traced CPU run of a small cell."""
import math

import pytest

import run
from harness import spans, spec
from harness.trace import Timeline
from small import small_cell

NEW = ("feed_host_ms", "cap_flush_pct", "prep_host_ms", "launch_host_ms", "middle_host_ms",
       "finish_host_ms", "viterbi_pad_pct", "idle_main_busy_pct", "align_pad_pct")
MAIN, SUBMIT = 1, 2
OFFSET_US = 5000.0  # the fake trace's clock: the tracer's us + 5000
MS = 1e6  # ns


def _records():
    """Two batches.  Submit thread: batch 0 preps 4 ms, uploads 1, aligns
    4 (a launch inside), bounds 1 with a 0.4 ms wait inside; batch 1
    preps 6.  Main thread: a read of 12 ms in which the submit wait (8)
    and the middle phase (2: a 1 ms wait, then 1 of work) run; a read of
    1 ms; a finish of 3 ms whose 1 ms wait holds a nested wait.  The
    main thread's spans open annotations, but for its per-line reads."""
    from strique_tpu_torch.utils.trace import Record

    rows = [  # id, name, tid, parent, batch, start ms, end ms
        (0, "stream.submit", SUBMIT, None, 0, 0, 10),
        (1, "submit.prep", SUBMIT, 0, 0, 0, 4),
        (2, "submit.upload", SUBMIT, 0, 0, 4, 5),
        (3, "submit.align", SUBMIT, 0, 0, 5, 9),
        (4, "kernel.launch", SUBMIT, 3, 0, 6, 7),
        (5, "submit.bounds", SUBMIT, 0, 0, 9, 10),
        (6, "bounds.wait", SUBMIT, 5, 0, 9.2, 9.6),
        (7, "stream.submit", SUBMIT, None, 1, 10, 20),
        (8, "submit.prep", SUBMIT, 7, 1, 10, 16),
        (9, "stream.read", MAIN, None, None, 0, 12),
        (10, "stream.wait", MAIN, 9, 0, 2, 10),
        (11, "stream.middle", MAIN, 9, 0, 10, 12),
        (12, "middle.wait", MAIN, 11, 0, 10, 11),
        (13, "middle.viterbi", MAIN, 11, 0, 11, 12),
        (14, "stream.read", MAIN, None, None, 12, 13),
        (15, "stream.finish", MAIN, None, 0, 13, 16),
        (16, "finish.wait", MAIN, 15, 0, 13, 14),
        (17, "inner.wait", MAIN, 16, 0, 13.2, 13.5),
    ]
    return [Record(i, n, tid, parent, batch, s * MS, e * MS, {},
                   tid == MAIN and n != "stream.read")
            for i, n, tid, parent, batch, s, e in rows]


def _timeline(recs):
    """Kernels at 0-1, 4-11.5 and 15-17 ms of the tracer's clock, the
    feed's end at 16.5 ms, and the main thread's annotations."""
    us = lambda ms: ms * 1e3 + OFFSET_US  # noqa: E731
    device = [(us(0), us(1), "k0", "kernel"), (us(4), us(11.5), "k1", "kernel"),
              (us(15), us(17), "k2", "kernel")]
    host = [(r.start / 1e3 + OFFSET_US, r.end / 1e3 + OFFSET_US, r.name)
            for r in recs if r.annotated]
    host.append((us(16.5), us(16.5), "feed_end"))
    return Timeline(device, host)


def _ctx(recs=None, counts=None):
    recs = _records() if recs is None else recs
    counts = ({"stream.flush.full": 3, "stream.flush.cap": 1, "viterbi.steps": 400,
               "viterbi.padded": 1000, "submit.samples": 300, "submit.padded": 1200}
              if counts is None else counts)
    return {"timeline": _timeline(recs), "program_records": recs, "program_counts": counts,
            "batch_size": 64}


def _read(name, ctx):
    return spec.module("metrics", name).read(ctx)


@pytest.mark.parametrize("name,value", [
    ("feed_host_ms", (2 + 1) / 2),  # read 1's self time: 12 less 8 + 2 of children
    ("prep_host_ms", (4 + 6) / 2),
    ("launch_host_ms", (1 + 4 + 0.6) / 2),  # the bounds less their wait
    ("middle_host_ms", 1 / 2),
    ("finish_host_ms", 2 / 2),  # nested waits count once
    ("cap_flush_pct", 25.0),
    ("viterbi_pad_pct", 60.0),
    ("align_pad_pct", 75.0),
])
def test_metric_on_hand_made_spans(name, value):
    assert _read(name, _ctx()) == pytest.approx(value)


def test_idle_main_busy_on_the_trace_clock():
    """Steady stretch 0-16.5 ms; the card idles 1-4 and 11.5-15; the main
    thread works (in a span, in no wait) 0-2, 11-13 and 14-16: idle and
    busy overlap 1-2, 11.5-13 and 14-15, 3.5 ms of 16.5."""
    assert _read("idle_main_busy_pct", _ctx()) == pytest.approx(100 * 3.5 / 16.5)


@pytest.mark.parametrize("name", NEW)
def test_no_tracer_reads_nothing(monkeypatch, name):
    """A program without the tracer (the parent checkout): no number, no raise."""
    monkeypatch.setattr(spans, "tracer", lambda: None)
    assert _read(name, {"timeline": _timeline(_records()), "batch_size": 64}) is None


def test_nothing_recorded_reads_nothing():
    for name in NEW:
        assert _read(name, _ctx(recs=[], counts={})) is None, name


def test_traced_cpu_run_reads_every_new_metric(tmp_path):
    out = run.run_cell(small_cell("c9orf72-cas9-carrier"), spec.benchmark(), 2**31 + 91, 0.5,
                       True, "cpu", tmp_root=str(tmp_path))
    layers = out["layers"]
    for name in NEW:
        if name == "idle_main_busy_pct":
            continue
        assert name in layers and math.isfinite(layers[name]["value"]), name
    assert "idle_main_busy_pct" not in layers  # no device events on the CPU
    assert out["correct"]
