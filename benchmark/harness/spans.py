"""The program's own spans and counters of a traced window, as the
per-layer metrics read them.

``strique_tpu_torch.utils.trace`` records them while the window's
profiler runs.  A checkout whose program has no tracer gives no
records: every reader here then returns None (the metric is left out
of the line), and none raises.

Times are the tracer's (``perf_counter`` ns) until :func:`on_trace_clock`
moves them onto the device trace's microseconds.  A span's self time is
its length less what its child spans cover; a span's time "less its
waits" is its length less what the ``*.wait`` spans inside it, on its
own thread, cover.
"""
from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict

from harness.trace import union

SUBMIT = "stream.submit"  # one a batch: the per-batch metrics' divisor
WAIT = ".wait"


def tracer():
    """The program's tracer module, or None where the program has none."""
    try:
        from strique_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace


def _cached(ctx, key, read):
    """``read(tracer)`` once a window, kept in the metrics' ``ctx``; None
    where the program has no tracer."""
    if key not in ctx:
        t = tracer()
        ctx[key] = None if t is None else read(t)
    return ctx[key]


def records(ctx) -> list | None:
    """The tracer's records of the traced window (perf_counter ns)."""
    return _cached(ctx, "program_records", lambda t: t.records())


def counts(ctx) -> dict | None:
    """The tracer's counters of the traced window."""
    return _cached(ctx, "program_counts", lambda t: t.counts())


def on_trace_clock(ctx) -> list | None:
    """The window's records on its timeline's clock (trace us)."""
    recs = records(ctx)
    if not recs:
        return None
    return tracer().to_trace_clock(ctx["timeline"].host, recs)


class Spans:
    """Records of one traced window, linked to their children and waits."""

    def __init__(self, recs):
        self.recs = list(recs)
        self.children = defaultdict(list)
        waits = defaultdict(list)
        for r in self.recs:
            if r.parent is not None:
                self.children[r.parent].append(r)
            if r.name.endswith(WAIT):
                waits[r.tid].append((r.start, r.end))
        self.waits = {tid: _Merged(w) for tid, w in waits.items()}

    @classmethod
    def of(cls, ctx):
        """The window's records, linked (once a window), or None."""
        if "program_spans" not in ctx:
            recs = records(ctx)
            ctx["program_spans"] = cls(recs) if recs else None
        return ctx["program_spans"]

    def named(self, name: str) -> list:
        return [r for r in self.recs if r.name == name]

    def batches(self) -> int:
        return len(self.named(SUBMIT))

    def self_time(self, r) -> float:
        kids = _Merged((c.start, c.end) for c in self.children.get(r.id, ()))
        return (r.end - r.start) - kids.covered(r.start, r.end)

    def less_waits(self, r) -> float:
        """``r``'s length less the waits inside it (``r`` itself may be one)."""
        w = self.waits.get(r.tid)
        return (r.end - r.start) - (w.covered(r.start, r.end) if w else 0.0)

    def per_batch_ms(self, total_ns: float):
        n = self.batches()
        return total_ns / n / 1e6 if n else None


class _Merged:
    """Merged, sorted intervals that answer how much of [lo, hi] they cover."""

    def __init__(self, intervals):
        self.iv = union(intervals)
        self.starts = [s for s, _e in self.iv]

    def covered(self, lo: float, hi: float) -> float:
        i = max(bisect_right(self.starts, lo) - 1, 0)
        total = 0.0
        while i < len(self.iv) and self.iv[i][0] < hi:
            s, e = self.iv[i]
            total += max(0.0, min(e, hi) - max(s, lo))
            i += 1
        return total


def subtract(merged, holes) -> list:
    """Merged, sorted intervals less the merged, sorted ``holes``."""
    out, j = [], 0
    for s, e in merged:
        while j < len(holes) and holes[j][1] <= s:
            j += 1
        cur, k = s, j
        while k < len(holes) and holes[k][0] < e:
            hs, he = holes[k]
            if hs > cur:
                out.append((cur, hs))
            cur = max(cur, he)
            k += 1
        if cur < e:
            out.append((cur, e))
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two merged, sorted interval lists."""
    total, j = 0.0, 0
    for s, e in a:
        while j < len(b) and b[j][1] <= s:
            j += 1
        k = j
        while k < len(b) and b[k][0] < e:
            total += min(e, b[k][1]) - max(s, b[k][0])
            k += 1
    return total


def main_thread(recs):
    """The thread that ran the profiler (its spans opened annotations)."""
    return next((r.tid for r in recs if r.annotated), None)


def idle_main_busy_us(timeline, recs, lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which the card was idle while the
    main thread was inside a span and not inside a ``*.wait`` span."""
    tid = main_thread(recs)
    mine = [r for r in recs if r.tid == tid]
    busy = subtract(union((r.start, r.end) for r in mine),
                    union((r.start, r.end) for r in mine if r.name.endswith(WAIT)))
    return overlap(busy, timeline.idle_gaps(lo, hi))

