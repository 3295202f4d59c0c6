"""Spans and counters inside the program, recorded only while a
``torch.profiler`` session runs.

    with trace.span("submit.align") as sp:
        if sp:                       # attributes only when tracing is on
            sp.attrs["route"] = "split"
        ...
    trace.count("stream.reads", len(items))

On or off is the profiler's process-wide state
(``torch.autograd.profiler._is_profiler_enabled``), read once a call:
``count --profile`` and the benchmark's traced run turn the tracer on,
and nothing else does.  The thread-local ``torch.autograd._profiler_enabled()``
is not used for it: it reads False on every thread but the one that
started the profiler.  Off, :func:`span` returns the shared falsy
:data:`OFF`, which allocates nothing and reads no clock, and
:func:`count` returns at once.

A span records its name, its native thread id, its start and end
(``time.perf_counter_ns``), its parent (the innermost span open on its
own thread), its batch (given to a root span by the stream scheduler,
inherited by child spans) and a few attributes.  Records are kept in
memory only.  The owner of a profiler session calls :func:`reset` as it
starts one (``count --profile`` does); besides, records start empty at
the first call of a session that follows a call with the profiler off,
such as a run's untraced warm-up pass, which is never counted.

One clock with the device trace: the profiler records annotations only
on the thread that started it, so a span on that thread also opens a
``record_function`` of its own name; :func:`to_trace_clock` gives those
spans their annotations' times and shifts every other record, on every
thread, by the median offset between the pairs.  The spans opened once
a SAM line or once a kernel launch pass
``annotate=False``: an annotation costs tens of microseconds, and the
per-batch spans give the clock pairs enough.

Names: a span in which a thread blocks (on the card, or on another
thread) ends in ``.wait``; readers rely on it.  Launch counts stay in
``_build.LAUNCHES``.
"""
from __future__ import annotations

import itertools
import json
import statistics
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler


class Record(NamedTuple):
    id: int
    name: str
    tid: int  # native thread id, as the profiler's trace gives it
    parent: int | None  # the id of the innermost span open on the same thread
    batch: int | None
    start: float  # perf_counter ns; trace-clock us after to_trace_clock
    end: float
    attrs: dict
    annotated: bool  # opened a profiler annotation of its own name


class _Off:
    """What :func:`span` returns with tracing off: a no-op, and falsy."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False

    def __bool__(self):
        return False


OFF = _Off()


class _State:
    def __init__(self):
        self.lock = threading.Lock()
        self.records: list = []
        self.counts: dict = {}
        self.stale = True  # the profiler was seen off: the next session starts afresh
        self.ids = itertools.count()
        self.local = threading.local()


_S = _State()


def _fresh() -> None:
    with _S.lock:
        if _S.stale:
            _S.records, _S.counts, _S.stale = [], {}, False


def _stack() -> list:
    try:
        return _S.local.stack
    except AttributeError:
        _S.local.stack = []
        return _S.local.stack


class _Span:
    __slots__ = ("name", "batch", "attrs", "id", "parent", "tid", "start", "_rf", "_annotate")

    def __init__(self, name: str, batch, annotate: bool):
        self.name = name
        self.batch = batch
        self.attrs = {}
        self._annotate = annotate

    def __enter__(self):
        stack = _stack()
        top = stack[-1] if stack else None
        self.parent = None if top is None else top.id
        if self.batch is None and top is not None:
            self.batch = top.batch
        self.id = next(_S.ids)
        self.tid = threading.get_native_id()
        stack.append(self)
        self._rf = None
        if self._annotate and torch.autograd._profiler_enabled():  # the profiler's thread
            self._rf = _profiler.record_function(self.name)
        # an annotation reads its clock deep inside its enter and exit
        # calls: ours just before the one and just after the other, so
        # that a pair's offset is the clocks' and not the calls' work
        self.start = time.perf_counter_ns()
        if self._rf is not None:
            self._rf.__enter__()
        return self

    def __exit__(self, *exc):
        if self._rf is not None:
            self._rf.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()
        elif self in stack:
            stack.remove(self)
        rec = Record(self.id, self.name, self.tid, self.parent, self.batch, self.start, end,
                     self.attrs, self._rf is not None)
        with _S.lock:
            _S.records.append(rec)
        return False


def enabled() -> bool:
    """Whether a profiler session runs (callers gate costly counts on it)."""
    return _profiler._is_profiler_enabled


def span(name: str, batch: int | None = None, annotate: bool = True):
    """A context manager timing ``name`` (``batch``: a root span's batch
    number; ``annotate``: on the profiler's thread, also open a profiler
    annotation); :data:`OFF` while no profiler runs."""
    if not _profiler._is_profiler_enabled:
        _S.stale = True
        return OFF
    if _S.stale:
        _fresh()
    return _Span(name, batch, annotate)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` (nothing while no profiler runs)."""
    if not _profiler._is_profiler_enabled:
        _S.stale = True
        return
    if _S.stale:
        _fresh()
    with _S.lock:
        _S.counts[name] = _S.counts.get(name, 0) + n


def reset() -> None:
    """Drop the records and counters: a profiler session starts afresh."""
    with _S.lock:
        _S.records, _S.counts, _S.stale = [], {}, False


def records() -> list:
    """The finished spans of the last session, in the order they ended."""
    with _S.lock:
        return list(_S.records)


def counts() -> dict:
    with _S.lock:
        return dict(_S.counts)


def to_trace_clock(annotations, recs=None):
    """The records (default :func:`records`) with start and end in the
    profiler trace's microseconds, or None when none of them pairs with
    an annotation.

    ``annotations``: the trace's ``(start_us, end_us, name)`` host
    annotations.  The k-th annotated record of a name pairs with the
    k-th annotation of that name, by start; names whose counts differ
    are left out of the pairing.  A paired record takes its annotation's
    times; every other record, on every thread, moves by the median of
    the pairs' offsets (a single pair's own offset also holds any wait
    for the interpreter lock between the two clock reads)."""
    recs = records() if recs is None else recs
    mine: dict = {}
    for r in recs:
        if r.annotated:
            mine.setdefault(r.name, []).append(r)
    theirs: dict = {}
    for s, e, n in annotations:
        if n in mine:
            theirs.setdefault(n, []).append((s, e))
    paired, offsets = {}, []
    for n, rs in mine.items():
        ann = sorted(theirs.get(n, ()))
        if len(ann) == len(rs):
            for r, (s, e) in zip(sorted(rs, key=lambda r: r.start), ann):
                paired[r.id] = (s, e)
                offsets.append(s - r.start / 1e3)
    if not offsets:
        return None
    off = statistics.median(offsets)
    return [r._replace(start=paired[r.id][0], end=paired[r.id][1]) if r.id in paired
            else r._replace(start=r.start / 1e3 + off, end=r.end / 1e3 + off) for r in recs]


def add_to_chrome_trace(path: str) -> None:
    """Write the spans that opened no annotation (the trace has the
    others already) into the chrome trace at ``path``, on its clock,
    each on its own thread's row."""
    with open(path) as fp:
        doc = json.load(fp)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ann = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
           for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    recs = to_trace_clock(ann)
    if recs is None:
        return
    pid = next((e["pid"] for e in events if e.get("cat") == "user_annotation"), 0)
    events.extend({"ph": "X", "cat": "strique_span", "name": r.name, "pid": pid, "tid": r.tid,
                   "ts": r.start, "dur": r.end - r.start,
                   "args": {"batch": r.batch, **{k: str(v) for k, v in r.attrs.items()}}}
                  for r in recs if not r.annotated)
    with open(path, "w") as fp:
        json.dump(doc, fp)
