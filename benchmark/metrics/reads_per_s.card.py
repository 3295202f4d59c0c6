"""reads_per_s.card: rows written over the traced window's seconds, in
the cells that report the card's time a row, ``card_us_per_read``, in
place of ``reads_per_s``: there the host paces the closed loop, and its
runs spread too widely for the rate's bound.

Layer: the stream (``parallel/dispatcher.py``, ``detect/stream.py``),
timed by the benchmark's host clock.
"""
LAYER = "stream"
UNIT = "reads/s"
SOURCE = "host_clock"
MOVES = "card_us_per_read"


def read(ctx):
    return ctx.get("reads_per_s")
