"""device_idle_pct: the share of the traced window's steady stretch, from
its first device event to the end of the feed, in which no kernel,
copy or memset ran on the card: one minus the union of their intervals
over the stretch, from ``torch.profiler``'s trace.

Layer: the device.  Idle time is time the host keeps the card waiting.
"""
LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "reads_per_s"


def read(ctx):
    tl = ctx["timeline"]
    st = tl.steady()
    if st is None or st[1] <= st[0]:
        return None
    return 100.0 * (1.0 - tl.busy_us(*st) / (st[1] - st[0]))
