#!/usr/bin/env python3
"""Run one cell of the benchmark of ``strique_tpu_torch`` once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the CUDA cards the cell
asks for (no card, or too few: a message and exit code 3, no result).
The cell's file (``benchmark/workloads/<cell>.json``) names its
configuration, its traffic generator and the generator's parameters.

Set-up (counted in ``setup_s``, from the process's start): the seeded
pore model and read pool, the package's kernel library (compiled by
nvcc into the checkout's ``build/`` on its first run there, which the
line's ``build_s`` reports apart), the detector, and one pass of the
whole pool through ``count``'s pipeline, which warms every kernel and
shape the window uses.  The window then feeds the pool's
reads, replayed under fresh ids, until ``--seconds`` have passed, and
ends when the pipeline has drained; ``reads_per_s`` is the rows written
over the window's seconds.  With ``--trace 1`` the window runs under
``torch.profiler`` with the counter's calls wrapped, and the line
carries the cell's per-layer metrics instead.

After the window the program's state is freed and the plain reference
(``benchmark/reference/``) recounts a seeded sample of the pool's reads;
``correct`` is the comparison of ``harness/check.py``, each number
printed beside its limit, last on standard error and last in the line.
The last line of standard output is the result's JSON.

An end-to-end metric whose source is ``device_trace`` (``card_us_per_read``:
the card's busy time over the window, a union of every kernel, copy and
memset, per row written) has the untraced window run under
``torch.profiler`` with the card's activity alone; the profiler starts
after ``setup_s`` is read and before the window opens.

A configuration with ``mod_model`` (``harness/spec.py``) has set-up
write the model's 5mC twin beside it, a stage of its own in the set-up
note; the pool's methylated alleles take their levels from it, and the
detector and the reference both call methylation with it, so the check
holds each sampled row's mod string too.  A note after the check gives
the share of '1' characters on methylated and on unmethylated units of
the sampled rows: whether the seeded twin separates at that seed.

The package's environment knobs (``STRIQUE_*``) are refused: the
benchmark runs its default routes.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
for _p in (ROOT, HERE):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from harness import check, spec, window  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "strique_tpu")
NO_CARD = 3


def process_age() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module's first line where /proc is not there."""
    try:
        with open("/proc/self/stat") as fp:
            start_ticks = float(fp.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fp:
            uptime = float(fp.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_START


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def info(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def cpu_seconds() -> float:
    """This process's CPU seconds so far, every thread's."""
    r = resource.getrusage(resource.RUSAGE_SELF)
    return r.ru_utime + r.ru_stime


def cpu_yardstick() -> float:
    """Seconds this process takes for a fixed single-threaded task (NumPy
    sorts and a Python loop): the host's speed for it, run by run."""
    import numpy as np

    x = np.random.default_rng(0).random(1 << 20)
    t0 = time.perf_counter()
    for _ in range(4):
        np.sort(x)
    sum(i * i for i in range(1 << 20))
    return time.perf_counter() - t0


def gpu_state() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                              "temperature.gpu,clocks_throttle_reasons.active",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "not read"
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _num(x):
    """A number for the JSON line: a non-finite float as its name."""
    return x if isinstance(x, int) or math.isfinite(x) else str(x)


def _profiler(host: bool = True):
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host else [ProfilerActivity.CUDA]
    return profile(activities=activities), record_function


def card_metrics(bench: dict, cell_name: str) -> bool:
    """Whether the cell reports an end-to-end metric read from the device trace."""
    return any(m["source"] == "device_trace"
               for m in spec.cell_metrics(bench, cell_name, "end_to_end"))


def run_cell(cell: dict, bench: dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", tmp_root: str | None = None) -> dict:
    """Set up, run the window and check it; returns the result's parts."""
    import torch

    from reference.pipeline import Reference
    from strique_tpu_torch import _build
    from strique_tpu_torch.detect.detector import RepeatDetector
    from strique_tpu_torch.detect.writer import OutputWriter
    from strique_tpu_torch.parallel.dispatcher import run_pipeline
    from strique_tpu_torch.utils import logging as ulog

    cfg = cell["config_spec"]
    locus = cfg["locus"]
    traffic = spec.module("traffic", cell["generator"])
    tmp = tempfile.mkdtemp(prefix="strique-bench-", dir=tmp_root)
    try:
        stages = [("start", process_age())]
        k = cfg["model"]["k"]
        model_file = traffic.write_model(os.path.join(tmp, "model.txt"), seed, k)
        mod_file = None
        if "mod_model" in cfg:
            mod_file = traffic.write_mod_model(os.path.join(tmp, "mod_model.txt"), seed, k,
                                               float(cfg["mod_model"]["shift_pA"]))
            stages.append(("model and its 5mC twin", process_age()))
        pool = traffic.make_pool(model_file, locus, cell["params"], seed, mod_file)
        stages.append(("model and pool" if mod_file is None else "pool", process_age()))
        ulog.init(log_level="warning")
        on_card = device == "cuda"
        if on_card:
            _build.lib()
            built = bool(_build.BUILD_INFO.get("built"))
            stages.append((f"kernel library ({'built by nvcc' if built else 'found built'})",
                           process_age()))
        repeat = {locus["name"]: (locus["chrom"], locus["begin"], locus["end"], locus["repeat"],
                                  locus["prefix"], locus["suffix"])}
        detector = RepeatDetector(repeat, model_file, window.MemoryIndex(pool),
                                  mod_model_file=mod_file, align_config=cfg["align"],
                                  hmm_config=cfg["hmm"], device=device)
        stages.append(("detector", process_age()))
        batch = int(cell["batch_size"])
        window.run(run_pipeline, detector, OutputWriter(os.path.join(tmp, "warm.tsv")), pool,
                   locus, seed, batch)
        if on_card:
            torch.cuda.synchronize()
        stages.append(("warm-up pass (HMMs, every shape)", process_age()))
        prof = annotate = probe = None
        if trace:
            prof, annotate = _profiler()
            probe = window.Probe(detector.counter, annotate)
        tsv = os.path.join(tmp, "count.tsv")
        writer = OutputWriter(tsv)
        written_at = []
        write_line = writer.write_line

        def timed_write(target_counts=()):
            write_line(target_counts=target_counts)
            written_at.append(time.perf_counter())

        writer.write_line = timed_write
        _build.reset_launches()
        setup_s = process_age()
        card_prof = None
        if not trace and on_card and card_metrics(bench, cell["name"]):
            card_prof = _profiler(host=False)[0]
            card_prof.start()
        cpu0 = cpu_seconds()
        if prof is not None:
            prof.start()
            probe.on = True
        feed, start, end = window.run(run_pipeline, detector, writer, pool, locus, seed, batch,
                                      seconds, probe)
        if on_card:
            torch.cuda.synchronize()
            end = time.perf_counter()
        if prof is not None:
            probe.on = False
            prof.stop()
        if card_prof is not None:
            card_prof.stop()
        window_s = end - start
        cpu1 = cpu_seconds()
        launches = {k: v for k, v in _build.LAUNCHES.items() if v}
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        found = forbidden_modules()
        rows = check.read_rows(tsv)
        build_s = next((t1 - t0 for (_, t0), (n, t1) in zip(stages, stages[1:])
                        if n.endswith("(built by nvcc)")), 0.0)
        out = {"setup_s": setup_s, "build_s": build_s, "window_s": window_s, "rows": rows, "fed": feed.fed,
               "reads_per_s": len(rows) / window_s, "peak": peak, "forbidden": found,
               "launches": launches, "layers": {},
               "notes": ["set-up s: " + ", ".join(f"{n} {t1 - t0:.2f}" for (_, t0), (n, t1)
                                                  in zip(stages, stages[1:]))
                         + f" (process start to first stage {stages[0][1]:.2f})"]}
        step = max(window_s / 10, 1e-9)
        per = [0] * 10
        for t in written_at:
            per[min(int((t - start) / step), 9)] += 1
        out["notes"].append("rows a tenth of the window: " + " ".join(map(str, per)))
        out["notes"].append(f"host: this process used {(cpu1 - cpu0) / window_s:.2f} cores in "
                            f"the window; a fixed single-threaded task after it took "
                            f"{cpu_yardstick():.4f} s")
        if on_card:
            out["notes"].append("card at the window's end (sm clock, max, power, temperature, "
                                "throttle reasons): " + gpu_state())
        if card_prof is not None:
            out.update(_card(card_prof, len(rows)))
        if "card_us_per_read" in out:
            out["notes"].append(f"card busy {out['card_busy_s']} s of the window's {window_s} s, "
                                f"{len(rows)} rows: card_us_per_read {out['card_us_per_read']}")
        if trace:
            traced = _traced(prof, probe, cell, bench, cfg, launches, len(rows) / window_s)
            out["notes"] += traced.pop("notes")
            out.update(traced)
        del detector, probe, prof, card_prof, writer
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        written = {k for k, _r in rows}
        picked = check.sample(written, pool, seed, int(cell["check_reads"]))
        ref = Reference(locus, model_file, cfg["align"], device, hmm_config=cfg["hmm"],
                        mod_model_file=mod_file)
        ref_rows = ref.rows([pool[i][2] for i in picked], [pool[i][1] for i in picked])
        out["numbers"] = check.compare(rows, feed.fed, dict(zip(picked, ref_rows)))
        out["limits"] = {n: cell["check"][n] for n in check.NUMBERS}
        out["correct"] = check.verdict(out["numbers"], out["limits"]) and not found
        out["notes"].append(f"reference: {len(picked)} pool reads, their longest "
                            f"{max((len(pool[i][2]) for i in picked), default=0)} samples, "
                            f"{time.perf_counter() - t_ref:.1f} s")
        if mod_file is not None:
            out["notes"].append(mod_note(traffic.methylation(cell["params"]), pool, picked, rows))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def mod_note(flags, pool, picked, rows) -> str:
    """The share of '1' characters on methylated and on unmethylated units,
    over the sampled reads' first rows.  A row's n characters stand for
    the read's units in its strand's order, character j for unit
    j * units // n (the decode may find a unit more or fewer)."""
    first: dict = {}
    for k, r in rows:
        first.setdefault(k, r)
    ones = {True: 0, False: 0}
    chars = {True: 0, False: 0}
    for i in picked:
        mod = first.get(i, (None,) * 7)[6]
        if not mod or mod == "-":
            continue
        units, strand = pool[i][0], pool[i][1]
        on = flags[i] if flags[i] is not None else [False] * units
        if strand == "-":
            on = on[::-1]
        for j, ch in enumerate(mod):
            m = bool(on[j * units // len(mod)])
            chars[m] += 1
            ones[m] += ch == "1"
    share = {m: f"{ones[m]}/{chars[m]}" + (f" = {ones[m] / chars[m]:.4f}" if chars[m] else "")
             for m in (True, False)}
    return (f"mod: '1' on methylated units {share[True]}, on unmethylated units "
            f"{share[False]} (sampled rows' characters)")


def _card(prof, rows: int) -> dict:
    """The untraced window's card time: the union of every device event's
    interval in the trace, in seconds, and in microseconds a row written
    (absent where the trace holds no device event or no row was written)."""
    from harness.trace import Timeline

    tl = Timeline.from_profile(prof)
    b = tl.bounds()
    if b is None or rows == 0:
        return {}
    busy_us = tl.busy_us(*b)
    return {"card_busy_s": busy_us / 1e6, "card_us_per_read": busy_us / rows}


def _traced(prof, probe, cell, bench, cfg, launches, rate) -> dict:
    """The traced window's per-layer metrics, device times and notes;
    ``rate`` is the window's rows a second."""
    from harness.trace import Timeline

    tl = Timeline.from_profile(prof)
    locus = cfg["locus"]
    k = int(cfg["model"]["k"])
    samples = int(cfg["align"]["samples"])
    # the two flank templates' lengths in samples: samples a k-mer of each flank
    flanks = (len(locus["prefix"]) - k + 1) + (len(locus["suffix"]) - k + 1)
    ctx = {"probe": probe, "timeline": tl, "batch_size": int(cell["batch_size"]),
           "template_samples": flanks * samples, "reads_per_s": rate}
    layers, tables = {}, []
    for m in spec.cell_metrics(bench, cell["name"], "per_layer"):
        mod = spec.module("metrics", m["name"])
        tables.extend(getattr(mod, "KERNELS", ()))
        value = mod.read(ctx)
        if value is not None:
            layers[m["name"]] = {"value": value, "unit": m["unit"]}
    b = tl.bounds()
    busy = tl.busy_us(*b) / 1e6 if b else 0.0
    other: dict = {}
    for s, e, n, _c in tl.kernels():
        if not any(t in n for t in tables):
            other[n] = other.get(n, 0.0) + (e - s) / 1e6
    n_sub = len(probe.submits)
    notes = [
        f"kernels no layer table assigns (device s): "
        + json.dumps({n[:100]: v for n, v in sorted(other.items(), key=lambda kv: -kv[1])[:8]}),
        f"launches per batch ({n_sub} detect_submit calls): "
        + json.dumps({k2: v / max(n_sub, 1) for k2, v in launches.items()}),
        f"per-read retries of the scheduler: {probe.retries}",
    ]
    return {"layers": layers, "busy_s": busy, "breakdown": tl.breakdown(), "notes": notes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    knobs = sorted(k for k in os.environ if k.startswith("STRIQUE_"))
    if knobs:
        info(f"refusing to run: the package's knobs are set ({', '.join(knobs)}); the "
             "benchmark runs its default routes")
        return 2
    bench = spec.benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        info(f"no workload {args.workload!r} in BENCHMARK.json")
        return 2
    cell = spec.cell(args.workload)
    seed = args.seed % (1 << 63)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        info(f"needs {entry['chips']} CUDA card(s); this machine has "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: no result")
        return NO_CARD
    out = run_cell(cell, bench, seed, args.seconds, bool(args.trace))
    found = sorted(set(out["forbidden"]) | set(forbidden_modules()))
    if found:
        info(f"JAX or the JAX package was loaded in this process: {', '.join(found)}")
        return 4
    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": int(entry["chips"]),
              "memory_peak_bytes": int(out["peak"])}
    e2e = {"reads_per_s": (out["reads_per_s"], "reads/s"), "setup_s": (out["setup_s"], "s"),
           "card_us_per_read": (out.get("card_us_per_read"), "us/read")}
    if args.trace:
        metrics = out["layers"]
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
        info(f"traced window: {out['reads_per_s']} reads/s over {out['window_s']} s "
             f"({len(out['rows'])} rows); card: {power_limit()}")
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": e2e[m["name"]][1]}
                   for m in spec.cell_metrics(bench, args.workload, "end_to_end")}
    for note in out["notes"]:
        info(note)
    unread = sorted(n for n, m in metrics.items() if m["value"] is None)
    if unread:
        info(f"no reading of {', '.join(unread)}: no result")
        return 5
    numbers, limits = out["numbers"], out["limits"]
    result = {"correct": bool(out["correct"]), "attempted": len(out["fed"]),
              "failed": int(numbers["missing"]), "metrics": metrics, "device": device}
    if args.trace:
        result["breakdown"] = out["breakdown"]
    result["build_s"] = out["build_s"]  # the nvcc build inside setup_s, 0 once built
    result["check"] = {n: {"value": _num(numbers[n]), "limit": limits[n]} for n in check.NUMBERS}
    for n in check.NUMBERS:
        info(f"check {n}: {numbers[n]} (limit {limits[n]})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
