"""launch_host_ms: the submit thread's upload and launch time a batch,
in ms: the program's spans inside ``stream.submit`` other than the
prep (``submit.upload``, ``submit.align``, ``submit.bounds``: the H2D
enqueue, the alignment's plan and launches, the bounds and their D2H
copy), less any ``*.wait`` inside them (``align.h2d.wait``: a blocking
copy that waits for the card), over the window's batches.

Layer: the counter's host side (``detect/counter.py``, ``ops/align.py``,
``_build.launch``), a span of the program's own tracer
(``harness/spans.py``).
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
    return sp.per_batch_ms(sum(sp.less_waits(c) for r in sp.named(SUBMIT)
                               for c in sp.children[r.id]
                               if c.name.startswith("submit.") and c.name != "submit.prep"))
