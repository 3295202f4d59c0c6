"""cap_flush_pct: the share of the window's batches that the scheduler
flushed early because its queued reads passed the cap
(``stream.flush.cap`` over all ``stream.flush.*`` counts).

Layer: the stream (``detect/stream.py`` ``StreamScheduler``), counted
by the program's tracer.  A cap flush sends a part-full batch: its
fixed host and launch cost spreads over fewer reads.
"""
from harness.spans import counts

LAYER = "stream"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"
CAUSES = ("stream.flush.full", "stream.flush.cap", "stream.flush.close")


def read(ctx):
    c = counts(ctx)
    total = sum(c.get(k, 0) for k in CAUSES) if c else 0
    if not total:
        return None
    return 100.0 * c.get("stream.flush.cap", 0) / total
