"""viterbi_pad_pct: the share of the Viterbi calls' padded steps that
carry no segment sample: 100 x (padded - steps) / padded, where a call
of B segments pads to Bp rows (a multiple of 8) of its longest
segment's length in whole chunks (``viterbi.padded``), against the
segments' own lengths (``viterbi.steps``).

Layer: the Viterbi (``detect/counter.py`` ``_viterbi_submit``), counted
by the program's tracer.  A forward and backward step costs the same
on a pad row as on a real one.
"""
from harness.spans import counts

LAYER = "Viterbi"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    c = counts(ctx)
    padded = c.get("viterbi.padded", 0) if c else 0
    if not padded:
        return None
    return 100.0 * (padded - c.get("viterbi.steps", 0)) / padded
