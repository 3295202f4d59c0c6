"""finish_host_ms: the main thread's finish phase a batch, in ms: the
program's ``stream.finish`` spans less the ``*.wait`` inside them
(``finish.wait``, the paths' event), so the host decode of counts and
float64 log_p and the hand-off of the rows to the writer, over the
window's batches.

Layer: the counter's host side (``detect/counter.py``
``detect_finish``), a span of the program's own tracer
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
    return sp.per_batch_ms(sum(sp.less_waits(r) for r in sp.named("stream.finish")))
