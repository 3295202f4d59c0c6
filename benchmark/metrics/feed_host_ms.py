"""feed_host_ms: the main thread's feed work a batch, in ms: the self
time of the program's ``stream.read`` spans (taking a SAM line, its
decode and fast5 fetch, queueing it; not the batch phases its flush
runs, which are child spans) over the window's batches (its
``stream.submit`` spans).

Layer: the stream (``parallel/dispatcher.py``, ``detect/stream.py``),
a span of the program's own tracer (``harness/spans.py``).  While the
card waits on the host, the feed is main-thread time no batch phase
can use.
"""
from harness.spans import Spans

LAYER = "stream"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    sp = Spans.of(ctx)
    if sp is None:
        return None
    return sp.per_batch_ms(sum(sp.self_time(r) for r in sp.named("stream.read")))
