"""Where a benchmark cell's idle card goes, by the program's own spans.

Runs one traced benchmark window of a cell in this process
(``benchmark/run.py``'s ``main`` with ``--trace 1``), then writes the
program's spans of the window: the card's idle seconds in the steady
stretch by the innermost span open on each thread at the time, every
span name's count, total, self time and time less its waits, the
counters, and where each submit's time goes.

    python tools/trace_cell.py CELL SEED SECONDS OUT.json [ROOT]

ROOT (default: this checkout) is the checkout whose benchmark and
program run; it needs a card, as the benchmark does.
"""
from __future__ import annotations

import json
import os
import sys
from collections import defaultdict


def innermost(recs) -> list:
    """(start, end, name) stretches of one thread's properly nested spans,
    each named by the innermost span open over it; none outside them."""
    out, stack, cur = [], [], None
    for r in sorted(recs, key=lambda r: (r.start, -r.end)):
        while stack and stack[-1].end <= r.start:
            top = stack.pop()
            out.append((cur, top.end, top.name))
            cur = top.end
        if stack:
            out.append((cur, r.start, stack[-1].name))
        stack.append(r)
        cur = r.start
    while stack:
        top = stack.pop()
        out.append((cur, top.end, top.name))
        cur = top.end
    return [x for x in out if x[1] > x[0]]


def idle_by_span(gaps, recs) -> dict:
    """The seconds of the card's idle ``gaps`` (merged, sorted, in the
    records' microseconds) by the innermost span open on each thread
    then: {tid: {name or "none": seconds}}."""
    idle = sum(e - s for s, e in gaps)
    by_tid = defaultdict(list)
    for r in recs:
        by_tid[r.tid].append(r)
    out = {}
    for tid, rs in by_tid.items():
        acc: dict = defaultdict(float)
        named, i = 0.0, 0
        stretches = innermost(rs)
        for gs, ge in gaps:
            while i < len(stretches) and stretches[i][1] <= gs:
                i += 1
            j = i
            while j < len(stretches) and stretches[j][0] < ge:
                s, e, n = stretches[j]
                d = min(e, ge) - max(s, gs)
                if d > 0:
                    acc[n] += d / 1e6
                    named += d
                j += 1
        acc["none"] += (idle - named) / 1e6
        out[tid] = dict(acc)
    return out


def main(argv) -> int:
    cell, seed, seconds = argv[:3]
    out = os.path.abspath(argv[3])
    root = os.path.abspath(argv[4] if len(argv) > 4 else
                           os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.chdir(root)
    sys.path[:0] = [root, os.path.join(root, "benchmark")]
    import run
    from harness import spans
    from harness import trace as htrace

    seen = {}
    from_profile = htrace.Timeline.from_profile.__func__

    def keep(cls, prof):
        seen["timeline"] = from_profile(cls, prof)
        return seen["timeline"]

    htrace.Timeline.from_profile = classmethod(keep)
    rc = run.main(["--workload", cell, "--seed", seed, "--seconds", seconds, "--trace", "1"])
    res = {"rc": rc, "cell": cell, "seed": seed}
    tracer = spans.tracer()
    raw = tracer.records() if tracer is not None else []
    if raw and "timeline" in seen:
        tl = seen["timeline"]
        main_tid = spans.main_thread(raw)
        name = lambda tid: "main" if tid == main_tid else f"t{tid}"  # noqa: E731
        steady = tl.steady()  # None without device events
        if steady:
            lo, hi = steady
            gaps = tl.idle_gaps(lo, hi)
            res["steady_s"] = (hi - lo) / 1e6
            res["idle_s"] = sum(e - s for s, e in gaps) / 1e6
            on_clock = tracer.to_trace_clock(tl.host, raw) or []
            res["idle_by_span"] = {name(t): v for t, v in idle_by_span(gaps, on_clock).items()}
        res["counts"] = tracer.counts()
        sp = spans.Spans(raw)
        res["batches"] = sp.batches()
        agg = defaultdict(lambda: [0, 0.0, 0.0, 0.0])
        for r in raw:
            a = agg[f"{name(r.tid)}:{r.name}"]
            a[0] += 1
            a[1] += (r.end - r.start) / 1e6
            a[2] += sp.self_time(r) / 1e6
            a[3] += sp.less_waits(r) / 1e6
        res["spans_n_total_self_lesswaits_ms"] = dict(sorted(agg.items()))
        subs = sorted((r.end - r.start) / 1e6 for r in sp.named(spans.SUBMIT))
        if subs:
            res["submit_ms_mean_p50_max"] = [sum(subs) / len(subs), subs[len(subs) // 2],
                                             subs[-1]]
        kids = defaultdict(float)
        for r in sp.named(spans.SUBMIT):
            for c in sp.children[r.id]:
                kids[c.name] += (c.end - c.start) / 1e6
        res["submit_children_ms"] = dict(kids)
    with open(out, "w") as fp:
        json.dump(res, fp, indent=1)
    print(json.dumps({k: res.get(k) for k in ("rc", "idle_s", "steady_s", "batches",
                                              "submit_ms_mean_p50_max", "idle_by_span")}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
