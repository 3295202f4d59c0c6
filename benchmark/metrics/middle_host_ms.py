"""middle_host_ms: the main thread's middle phase a batch, in ms: the
program's ``stream.middle`` spans less the ``*.wait`` inside them
(``middle.wait``, the bounds' event), so the segment slicing, the
pinned Viterbi input and its launches, over the window's batches.

Layer: the counter's host side (``detect/counter.py``
``detect_middle``), a span of the program's own tracer
(``harness/spans.py``).
"""
from harness.spans import Spans

LAYER = "counter host"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    sp = Spans.of(ctx)
    if sp is None:
        return None
    return sp.per_batch_ms(sum(sp.less_waits(r) for r in sp.named("stream.middle")))
