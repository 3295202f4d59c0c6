"""prep_host_ms: host prep a batch, in ms, on the submit thread: the
program's ``submit.prep`` spans inside ``stream.submit`` (the reads'
float64 copies, then the native prep of every read into the pinned
upload buffer, the buffer included) over the window's batches.

Layer: the counter's host side (``detect/counter.py``, ``native.py``),
a span of the program's own tracer (``harness/spans.py``).
"""
from harness.spans import SUBMIT, Spans

LAYER = "counter host"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    sp = Spans.of(ctx)
    if sp is None:
        return None
    return sp.per_batch_ms(sum(c.end - c.start for r in sp.named(SUBMIT)
                               for c in sp.children[r.id] if c.name == "submit.prep"))
