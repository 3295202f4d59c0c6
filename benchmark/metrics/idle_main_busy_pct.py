"""idle_main_busy_pct: the share of the traced window's steady stretch
(``Timeline.steady()``) in which the card was idle while the main
thread was inside one of the program's spans and not inside a
``*.wait`` span, on the device trace's clock (the program's spans moved
onto it by their annotations, ``harness/spans.py``).

``device_idle_pct`` less this is idle time in which the main thread
waited (or ran outside every span): the submit thread's to explain.
Layer: the stream (``parallel/dispatcher.py``, ``detect/stream.py``).
"""
from harness.spans import idle_main_busy_us, on_trace_clock

LAYER = "stream"
UNIT = "%"
SOURCE = "program_span"
MOVES = "reads_per_s"


def read(ctx):
    tl = ctx["timeline"]
    st = tl.steady()
    if st is None or st[1] <= st[0]:
        return None
    recs = on_trace_clock(ctx)
    if not recs:
        return None
    return 100.0 * idle_main_busy_us(tl, recs, *st) / (st[1] - st[0])
