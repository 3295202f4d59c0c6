"""mod_pad_pct: the share of the mod decode's padded Viterbi steps that
carry no repeat sample: 100 x (padded - steps) / padded, where a mod
call of B reads pads to Bp rows (a multiple of 8) of its longest
repeat-sample run in whole chunks (``mod.padded``), against the runs'
own lengths (``mod.steps``).

Layer: the Viterbi (``detect/counter.py`` ``_viterbi_submit`` from
``detect_mod_submit``), counted by the program's tracer apart from the
count pass's ``viterbi.*``.  None where the program counted no mod
decode (no 5mC model, or a program without the counters).
"""
from harness.spans import counts

LAYER = "Viterbi"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    c = counts(ctx)
    padded = c.get("mod.padded", 0) if c else 0
    if not padded:
        return None
    return 100.0 * (padded - c.get("mod.steps", 0)) / padded
