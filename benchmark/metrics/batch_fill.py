"""batch_fill: reads a ``detect_submit`` call carries, as a share of the
batch size, averaged over the traced window's calls.

Layer: the stream (``parallel/dispatcher.py``, ``detect/stream.py``),
counted by the benchmark's wrapper around the counter's calls.  A
fuller batch spreads each call's fixed host and launch cost over more
reads.
"""
LAYER = "stream"
UNIT = "%"
SOURCE = "program_counter"
MOVES = "reads_per_s"


def read(ctx):
    subs = ctx["probe"].submits
    if not subs:
        return None
    return 100.0 * sum(map(len, subs)) / (len(subs) * ctx["batch_size"])
