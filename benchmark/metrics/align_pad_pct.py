"""align_pad_pct: the share of the submitted batches' padded signal
that carries no read sample: 100 x (padded - samples) / padded, where a
batch of B reads pads to Bp rows (a multiple of 8) of its signal bucket
(``submit.padded``), against the reads' own lengths (``submit.samples``).

Layer: the alignment (``detect/counter.py`` ``detect_submit``), counted
by the program's tracer.  The prep and both flanks' wave calls run over
every padded row and column: a part-full batch (a cap flush) or a
bucket much longer than its reads costs alignment time for nothing.
"""
from harness.spans import counts

LAYER = "alignment"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    c = counts(ctx)
    padded = c.get("submit.padded", 0) if c else 0
    if not padded:
        return None
    return 100.0 * (padded - c.get("submit.samples", 0)) / padded
