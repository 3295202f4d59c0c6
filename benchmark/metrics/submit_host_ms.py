"""submit_host_ms: mean host milliseconds a ``detect_submit`` call takes
on the submit thread (host prep, upload and kernel launches), over the
traced window's calls.

Layer: the counter's host side (``detect/counter.py``, ``native.py``),
a span from the benchmark's wrapper.  While the card waits on the
host, each millisecond cut here is a millisecond off a batch.
"""
LAYER = "counter host"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    spans = [e - s for n, s, e in ctx["probe"].spans if n == "submit"]
    if not spans:
        return None
    return 1e3 * sum(spans) / len(spans)
