"""The measured window: ``count``'s pipeline fed from the pool until the clock runs out.

The window drives ``run_pipeline`` over the package's ``RepeatDetector``
and ``OutputWriter``, the calls ``count`` makes, with SAM lines made
here: the pool's reads replayed in a seeded order under fresh read
ids, until ``seconds`` have passed.  ``run_pipeline`` then flushes and
drains its scheduler, and the window ends when it returns.

With a ``Probe`` the counter's phase calls of the traced run are
wrapped: each call is a span (kept in memory, and a profiler
annotation so the device trace can name what the host was doing), and
the wrappers count the reads a submit carries, their samples, the
Viterbi segments and the per-read retries of the scheduler (a retry's
own one-read submit counts as a submit).
"""
from __future__ import annotations

import threading
import time

import numpy as np

SPANS = {"detect_submit": "submit", "detect_middle": "middle",
         "detect_mod_submit": "mod", "detect_finish": "finish"}


class MemoryIndex:
    """The fast5 index in memory: read id ``p<k>.<epoch>`` -> pool read k."""

    def __init__(self, pool):
        self.pool = pool

    def get_raw(self, read_id):
        try:
            k = int(read_id[1:].split(".", 1)[0])
            return self.pool[k][2]
        except (ValueError, IndexError):
            raise RuntimeError(f"read {read_id} is not in the index") from None


def sam_line(read_id: str, strand: str, chrom: str, begin: int) -> str:
    """A mapped SAM line whose alignment spans the locus at ``begin``."""
    flag = 16 if strand == "-" else 0
    return f"{read_id}\t{flag}\t{chrom}\t{begin - 20000}\t60\t41000M\t*\t0\t0\t*\t*\n"


class Feed:
    """SAM lines of the pool in a seeded order, epoch after epoch, until the
    deadline (none: one epoch)."""

    def __init__(self, pool, locus: dict, seed: int, deadline: float | None, probe=None):
        self.pool = pool
        self.locus = locus
        self.seed = seed
        self.deadline = deadline
        self.probe = probe
        self.fed = []  # pool index of each line, in order

    def __iter__(self):
        chrom, begin = self.locus["chrom"], self.locus["begin"]
        epoch = 0
        while True:
            order = np.random.default_rng([self.seed, 4, epoch]).permutation(len(self.pool))
            for k in order:
                if self.deadline is not None and time.perf_counter() >= self.deadline:
                    self._stop()
                    return
                self.fed.append(int(k))
                yield sam_line(f"p{k}.{epoch}", self.pool[k][1], chrom, begin)
            epoch += 1
            if self.deadline is None:
                self._stop()
                return

    def _stop(self):
        if self.probe is not None:
            self.probe.mark("feed_end")


class Probe:
    """Spans and counts of the counter's calls in the traced window."""

    def __init__(self, counter, annotate):
        self.counter = counter
        self.annotate = annotate  # a context manager naming a profiler span
        self.lock = threading.Lock()
        self.spans = []  # (name, start, end) perf_counter seconds
        self.submits = []  # a detect_submit call's reads' lengths in samples
        self.segments = []  # (length, states) a decoded repeat segment
        self.retries = 0
        self.on = False
        self._wrap()

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            with self.annotate(name):
                out = fn(*args, **kwargs)
            with self.lock:
                self.spans.append((name, t0, time.perf_counter()))
            return out
        return call

    def _wrap(self):
        c = self.counter
        for method, name in SPANS.items():
            setattr(c, method, self._timed(name, getattr(c, method)))
        submit, viterbi, detect = c.detect_submit, c._viterbi_submit, c.detect
        probe = self

        def detect_submit(target_name, raw_signals, strand, preps=None):
            if probe.on:
                with probe.lock:
                    probe.submits.append([len(r) for r in raw_signals])
            return submit(target_name, raw_signals, strand, preps)

        def viterbi_submit(chm, segments):
            if probe.on:
                with probe.lock:
                    probe.segments.extend((len(s), chm.n_states) for s in segments)
            return viterbi(chm, segments)

        def retry(target_name, raw_signal, strand):
            if probe.on:
                with probe.lock:
                    probe.retries += 1
            return detect(target_name, raw_signal, strand)

        c.detect_submit = detect_submit
        c._viterbi_submit = viterbi_submit
        c.detect = retry

    def mark(self, name: str):
        """A zero-length profiler span: a point on the trace's clock."""
        if self.on:
            with self.annotate(name):
                pass


def run(pipeline, detector, writer, pool, locus, seed, batch_size, seconds=None, probe=None):
    """One pass of the pool (``seconds`` None), or the window: returns
    (Feed, start, end) in perf_counter seconds."""
    start = time.perf_counter()
    feed = Feed(pool, locus, seed, None if seconds is None else start + seconds, probe)
    pipeline(iter(feed), detector, writer, io_threads=1, batch_size=batch_size)
    return feed, start, time.perf_counter()
