"""mod_host_ms: the main thread's mod phase a batch, in ms: the
program's ``stream.mod`` spans less the ``*.wait`` inside them (the
count paths' ``finish.wait``), so the repeat samples' minmax and cut in
the prep pool (``mod.prep``), the mod Viterbi's pinned input and
launches (``mod.viterbi``, inside it), and the count rows' host decode
(``finish.decode``) done there while the card runs the mod decode, over
the window's batches.

Layer: the counter's host side (``detect/counter.py``
``detect_mod_submit``), a span of the program's own tracer
(``harness/spans.py``).  Only a configuration with a 5mC model does
work there; None where the window has no ``stream.mod`` span.
"""
from harness.spans import Spans

LAYER = "counter host"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    sp = Spans.of(ctx)
    mods = sp.named("stream.mod") if sp is not None else None
    if not mods:
        return None
    return sp.per_batch_ms(sum(sp.less_waits(r) for r in mods))
