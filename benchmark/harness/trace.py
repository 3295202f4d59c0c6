"""The traced window's device timeline, from ``torch.profiler``'s trace.

``Timeline.from_profile`` reads the exported trace once: every kernel,
copy and memset that ran on the card (start, end, name) and every host
annotation the probe opened (its span names, ``feed_end``), on the
profiler's one clock.  Device time is a union of intervals, never a
sum of kernel times, so overlapping streams are counted once.
"""
from __future__ import annotations

import json
import os
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def union(intervals) -> list:
    """Merged, sorted (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def covered(merged, lo: float, hi: float) -> float:
    """Length of [lo, hi] that the merged intervals cover."""
    return sum(max(0.0, min(e, hi) - max(s, lo)) for s, e in merged)


class Timeline:
    def __init__(self, device, host):
        self.device = device  # (start_us, end_us, name, cat)
        self.host = host  # (start_us, end_us, name)

    @classmethod
    def from_profile(cls, prof) -> "Timeline":
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as fp:
                events = json.load(fp)
        finally:
            os.remove(path)
        if isinstance(events, dict):
            events = events.get("traceEvents", [])
        device, host = [], []
        for ev in events:
            if ev.get("ph") != "X" or "ts" not in ev:
                continue
            s = float(ev["ts"])
            e = s + float(ev.get("dur", 0.0))
            cat = ev.get("cat", "")
            if cat in DEVICE_CATS:
                device.append((s, e, ev.get("name", ""), cat))
            elif cat == "user_annotation":
                host.append((s, e, ev.get("name", "")))
        return cls(device, host)

    def kernels(self):
        return [d for d in self.device if d[3] == "kernel"]

    def span(self, name: str):
        """(start, end) of the first host annotation called ``name``."""
        for s, e, n in self.host:
            if n == name:
                return s, e
        return None

    def bounds(self):
        """The first device event's start and the last one's end, in us."""
        if not self.device:
            return None
        return min(d[0] for d in self.device), max(d[1] for d in self.device)

    def steady(self):
        """The steady stretch: from the first device event to the feed's end
        (the pipeline's drain after it empties the card)."""
        b = self.bounds()
        if b is None:
            return None
        feed = self.span("feed_end")
        hi = feed[0] if feed is not None and feed[0] > b[0] else b[1]
        return b[0], hi

    def busy_us(self, lo: float, hi: float) -> float:
        return covered(union((s, e) for s, e, _n, _c in self.device), lo, hi)

    def idle_gaps(self, lo: float, hi: float) -> list:
        """(start, end) of the stretches of [lo, hi] with nothing on the card."""
        gaps, cur = [], lo
        for s, e in union((s, e) for s, e, _n, _c in self.device):
            if e <= lo or s >= hi:
                continue
            if s > cur:
                gaps.append((cur, s))
            cur = max(cur, e)
        if cur < hi:
            gaps.append((cur, hi))
        return gaps

    def host_at(self, t: float) -> str:
        """The probe's spans open at time t, joined (``other`` for none)."""
        names = sorted({n for s, e, n in self.host if s <= t <= e and n != "feed_end"})
        return "+".join(names) if names else "other"

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict = {}
        for s, e, n, _c in self.device:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        st = self.steady()
        gaps = []
        if st is not None:
            gaps = sorted(self.idle_gaps(*st), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in ops],
                "idle_gaps": [[self.host_at((s + e) / 2), (e - s) / 1e6] for s, e in gaps]}
