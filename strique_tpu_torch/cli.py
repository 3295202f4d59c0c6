"""Command-line interface of the port: index / count / plot / extract / warmup.

The counterpart of ``strique_tpu/cli.py`` on PyTorch and one CUDA card:
the same subcommands, arguments and TSV output schema, so existing
STRique workflows can switch directly.  ``count`` runs the counter on
the card (``--device cuda``, the default; without a card it fails with
the counter's RuntimeError, there is no CPU fallback) or on the plain
PyTorch path when asked (``--device cpu``); ``--mod_model`` adds the
per-unit 5mC call (the TSV's ``mod`` column).  ``warmup`` builds the
kernels and runs one batch a target, strand and signal bucket, cold
then hot.

``--devices`` shards each batch's rows over several devices
(``parallel/mesh.py``): every local card ("auto"), at most N of them,
or with ``--device cpu`` N replicas of the CPU.  ``--coordinator``,
``--num_hosts`` and ``--host_id`` run ``count`` as one of several
processes (a gloo rendezvous at the coordinator; one that fails or
waits past ``parallel.mesh.RENDEZVOUS_TIMEOUT_S`` ends the run): each
counts a stride of the SAM stream into ``<out>.partN``, and after a
barrier rank 0 merges the parts into ``--out``.  ``plot`` draws one
figure a counted read (matplotlib) and ``extract`` writes reads out of
an indexed run (h5py); both import their library inside the command, so
``count`` runs on a host that has neither.

Environment knobs the port honours: ``STRIQUE_ALIGN_KERNEL=col`` (the
column-sweep alignment), ``STRIQUE_DENSE_VITERBI=1`` (the dense Viterbi
forward), ``STRIQUE_PTR_BUDGET_GB`` (the wave call's pointer-plane
budget, past which the two-pass route runs), ``STRIQUE_ASYNC_SUBMIT=0``
(inline batch submits) and ``STRIQUE_SPLIT=0`` (the counter's fused
single dispatch).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from .utils import logging as ulog
from .utils.config import parse_config
from .utils.logging import LogLevel, log

# --batch's defaults: the reference's on an accelerator (64) on the card,
# its 8 elsewhere (strique_tpu/cli.py:110-112)
CARD_BATCH = 64
CPU_BATCH = 8


def cmd_index(argv) -> int:
    parser = argparse.ArgumentParser(description="Fast5 raw data archive indexing")
    parser.add_argument("input", help="Input batch or directory of batches")
    parser.add_argument("--recursive", action="store_true", help="Recursively scan input")
    parser.add_argument("--out_prefix", default="", help="Prefix for file paths in output")
    parser.add_argument("--tmp_prefix", default=None, help="Prefix for temporary data")
    args = parser.parse_args(argv)
    from .io import fast5

    for record in fast5.index(args.input, recursive=args.recursive,
                              output_prefix=args.out_prefix, tmp_prefix=args.tmp_prefix):
        print(record)
    return 0


def cmd_count(argv) -> int:
    parser = argparse.ArgumentParser(description="STR detection in raw nanopore data")
    parser.add_argument("f5Index", help="Fast5 index")
    parser.add_argument("model", help="Pore model")
    parser.add_argument("repeat", help="Repeat region config file")
    parser.add_argument("--out", default=None, help="Output file name, if not given print to stdout")
    parser.add_argument("--algn", default=None, help="Alignment in sam format, if not given read from stdin")
    parser.add_argument("--mod_model", default=None, help="Base modification pore model")
    parser.add_argument("--config", help="Config file with HMM transition probabilities")
    parser.add_argument("--t", type=int, default=1, help="Host IO worker threads (fast5 reads; also per-read mode workers)")
    parser.add_argument("--batch", type=int, default=None,
                        help="Reads per batched device invocation (1 disables batching; "
                             f"default: {CARD_BATCH} on the card, {CPU_BATCH} on the CPU)")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Where the counter runs: the CUDA card (default; fails without "
                             "one) or the plain PyTorch path on the CPU")
    parser.add_argument("--devices", default="auto",
                        help="Data-parallel device count: 'auto' shards read batches over "
                             "every local card; an integer caps it; with --device cpu, that "
                             "many CPU replicas ('auto': one)")
    parser.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                        help="Multi-host: rank 0's rendezvous address (with --num_hosts and "
                             "--host_id; or MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE)")
    parser.add_argument("--num_hosts", type=int, default=None,
                        help="Multi-host: total process count")
    parser.add_argument("--host_id", type=int, default=None,
                        help="Multi-host: this process' index (0-based)")
    parser.add_argument("--resume", action="store_true",
                        help="Append to --out, skipping read IDs already counted")
    parser.add_argument("--profile", default=None, metavar="DIR",
                        help="Write a torch.profiler chrome trace of the run to DIR")
    parser.add_argument("--log_level", default="warning",
                        choices=["error", "warning", "info", "debug"], help="Log level")
    args = parser.parse_args(argv)
    ulog.init(log_level=args.log_level)
    config = parse_config(args.repeat, args.config)
    for path, desc in ((args.f5Index, "Fast5 index"), (args.model, "Pore model"),
                       (args.mod_model, "Modification pore model")):
        if path and not os.path.isfile(path):
            log(f"Main: {desc} file does not exist.", LogLevel.Error)
            return 1

    from .detect.detector import RepeatDetector
    from .detect.writer import OutputWriter, merge_shards, processed_ids
    from .parallel.dispatcher import run_pipeline
    from .parallel.mesh import barrier, init_distributed, local_devices, process_count

    # multi-host: each process owns its local devices and a stride of the
    # SAM stream; per-process TSV shards merge into the final output (the
    # reference's unordered-collector semantics, reference
    # scripts/STRique.py:778-802).  A failed rendezvous ends the run.
    try:
        rank = init_distributed(args.coordinator, args.num_hosts, args.host_id)
    except Exception as e:  # noqa: BLE001 - any rendezvous failure ends the run
        log(f"Main: the multi-host rendezvous failed: {type(e).__name__}: {e}", LogLevel.Error)
        return 1
    world = process_count()

    devices = local_devices(args.device, args.devices)
    n_dev = len(devices)
    if n_dev > 1:
        log(f"Main: Sharding read batches over {n_dev} {args.device} devices.", LogLevel.Info)
    batch_size = args.batch
    if batch_size is None:
        batch_size = CARD_BATCH if args.device == "cuda" else CPU_BATCH
    if n_dev > 1 and batch_size > 1:
        batch_size = (batch_size + n_dev - 1) // n_dev * n_dev

    out_path = args.out
    if world > 1 and out_path:
        out_path = f"{out_path}.part{rank}"
        log(f"Main: Process {rank}/{world}; writing shard {out_path}.", LogLevel.Info)

    rd = RepeatDetector(config["repeat"], args.model, args.f5Index,
                        mod_model_file=args.mod_model, align_config=config["align"],
                        hmm_config=config["HMM"], device=devices)
    done = processed_ids(out_path) if args.resume else set()
    if args.resume and world > 1:
        # a prior run may have merged its shards already
        done |= processed_ids(args.out)
    ow = OutputWriter(out_path, append=args.resume)
    if done:
        log(f"Main: Resuming; {len(done)} reads already counted.", LogLevel.Info)

    def sam_lines():
        stream = open(args.algn, "r") if args.algn else sys.stdin
        try:
            for i, line in enumerate(stream):
                if line.startswith("@"):
                    continue
                if world > 1 and i % world != rank:
                    continue
                if done and line.split("\t", 1)[0] in done:
                    continue
                yield line
        finally:
            if args.algn:
                stream.close()

    if args.profile:
        from torch.profiler import ProfilerActivity, profile

        from . import _build
        from .utils import trace

        activities = [ProfilerActivity.CPU]
        if args.device == "cuda":
            activities.append(ProfilerActivity.CUDA)
        trace.reset()
        with profile(activities=activities) as prof:
            n = run_pipeline(sam_lines(), rd, ow, io_threads=args.t, batch_size=batch_size)
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, f"count_{os.getpid()}.json")
        prof.export_chrome_trace(path)
        # the spans that opened no annotation (the submit thread's, the
        # main thread's per-line and per-launch ones), each on its
        # thread's row of the same trace
        trace.add_to_chrome_trace(path)
        log(f"Main: Wrote the profile to {path}.", LogLevel.Info)
        log(f"Main: Counters {json.dumps(trace.counts(), sort_keys=True)}; kernel launches "
            f"{json.dumps({k: v for k, v in _build.LAUNCHES.items() if v})}.", LogLevel.Info)
    else:
        n = run_pipeline(sam_lines(), rd, ow, io_threads=args.t, batch_size=batch_size)
    if world > 1 and args.out:
        # every process barriers (waiting for peers still counting, up to
        # parallel.mesh.BARRIER_TIMEOUT), then rank 0 concatenates the
        # .partN shards into --out (one file, unordered rows); parts on
        # another host's filesystem stay put and a warning names them
        barrier()
        if rank == 0:
            merged = merge_shards(args.out, world)
            if merged < world:
                log(f"Main: merged {merged}/{world} shards into {args.out}; the remaining "
                    "processes' .partN files are not on this filesystem: concatenate them "
                    "by hand.", LogLevel.Warning)
            else:
                log(f"Main: merged {world} shards into {args.out}.", LogLevel.Info)
        barrier()
    log(f"Main: Processed {n} alignments.", LogLevel.Info)
    ulog.close()
    return 0


def cmd_warmup(argv) -> int:
    """Build the kernels and run the counting path once per shape a config
    needs, so the first real ``count`` run starts at full speed.

    The counterpart of ``strique_tpu/cli.py``'s ``warmup``: one batch of
    a synthetic read per target x strand x signal bucket (flank
    alignment, bounds, Viterbi, and the mod pipeline when --mod_model is
    given), cold then hot, one line per shape.  On the card "cold" is
    the first use of a shape (the kernel library builds before the first
    one, and the allocator and host pools fill); the kernel library
    builds first (its line gives the seconds) and persists in the build
    directory the last line prints.
    """
    parser = argparse.ArgumentParser(description="Build the kernels and run each shape once")
    parser.add_argument("model", help="Pore model")
    parser.add_argument("repeat", help="Repeat region config file")
    parser.add_argument("--config", help="Config file with HMM transition probabilities")
    parser.add_argument("--mod_model", default=None, help="Base modification pore model")
    parser.add_argument("--batch", type=int, default=None,
                        help="Reads per device batch (match your count run; default: "
                             f"{CARD_BATCH} on the card, {CPU_BATCH} on the CPU)")
    parser.add_argument("--min_len", type=int, default=4096,
                        help="Shortest read-length bucket to run")
    parser.add_argument("--max_len", type=int, default=65536,
                        help="Longest read-length bucket to run")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                        help="Where the counter runs: the CUDA card (default; fails without "
                             "one) or the plain PyTorch path on the CPU")
    parser.add_argument("--devices", default="1",
                        help="Data-parallel device count to warm ('auto' = every local "
                             "card; with --device cpu, that many CPU replicas)")
    parser.add_argument("--log_level", default="warning",
                        choices=["error", "warning", "info", "debug"])
    args = parser.parse_args(argv)
    ulog.init(log_level=args.log_level)
    config = parse_config(args.repeat, args.config)
    for path, desc in ((args.model, "Pore model"), (args.mod_model, "Modification pore model")):
        if path and not os.path.isfile(path):
            log(f"Main: {desc} file does not exist.", LogLevel.Error)
            return 1

    import time

    import numpy as np

    from . import _build
    from .detect.counter import RepeatCounter, reverse_complement, signal_bucket
    from .parallel.mesh import local_devices

    batch = args.batch or (CARD_BATCH if args.device == "cuda" else CPU_BATCH)
    counter = RepeatCounter(args.model, mod_model_file=args.mod_model,
                            align_config=config["align"], hmm_config=config["HMM"],
                            device=local_devices(args.device, args.devices))
    # repeat config rows are (chr, begin, end, repeat, prefix, suffix)
    loci = {name: {"repeat": t[3], "prefix": t[4], "suffix": t[5]}
            for name, t in config["repeat"].items()}
    for name, t in loci.items():
        counter.add_target(name, t["repeat"], t["prefix"], t["suffix"])

    # the distinct signal buckets in range (the stream scheduler's keys)
    buckets, n = [], args.min_len
    while n <= args.max_len:
        b = signal_bucket(n)
        if not buckets or b != buckets[-1]:
            buckets.append(b)
        n = b + 1
    pm = counter.pm
    rng = np.random.default_rng(0)
    total_t0 = time.perf_counter()
    if args.device == "cuda":
        _build.lib()
        print(f"# kernels built in {time.perf_counter() - total_t0:.1f}s")
    n_cold = 0
    for name, t in loci.items():
        base = t["prefix"] + t["repeat"] * 8 + t["suffix"]
        for strand in ("+", "-"):
            for bucket in buckets:
                # a detectable read whose padded length lands in this
                # bucket: repeat units fill ~half the bucket, backbone the
                # rest, end-sliced to fit
                per_unit = max(len(t["repeat"]) * 9, 1)
                k = max(int(bucket // 2 // per_unit) - len(base) // len(t["repeat"]), 2)
                seq = t["prefix"] + t["repeat"] * k + t["suffix"]
                bb = "".join(rng.choice(list("ACTG"), max(bucket // 9, 64)))
                seq = bb[: len(bb) // 2] + seq + bb[len(bb) // 2 :]
                if strand == "-":
                    seq = reverse_complement(seq)
                sig = pm.generate_signal(seq, samples=8, noise=True, rng=rng)
                sig = sig[:bucket]
                if signal_bucket(len(sig)) != bucket:
                    sig = np.pad(sig, (0, bucket - len(sig)), mode="edge")
                reads = [sig] * batch
                t0 = time.perf_counter()
                counter.detect_many(name, reads, strand)
                cold = time.perf_counter() - t0
                t0 = time.perf_counter()
                counter.detect_many(name, reads, strand)
                hot = time.perf_counter() - t0
                n_cold += 1
                print(f"{name}\t{strand}\tbucket={bucket}\t"
                      f"cold={cold:.2f}s\thot={hot:.2f}s")
    where = (f"the kernel library persists in {_build.build_dir()}" if args.device == "cuda"
             else "the CPU path builds no kernel")
    print(f"# warmed {n_cold} target/strand/bucket shapes in "
          f"{time.perf_counter() - total_t0:.1f}s; {where}")
    ulog.close()
    return 0


def _iter_count_rows(counts_path):
    """Yield parsed rows of a count TSV (path or stdin)."""
    stream = open(counts_path, "r") if counts_path else sys.stdin
    try:
        for line in stream:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 9 or cols[0] == "ID":
                continue
            yield {"id": cols[0], "target": cols[1], "strand": cols[2],
                   "count": cols[3], "score_prefix": float(cols[4]),
                   "score_suffix": float(cols[5]), "offset": int(cols[7]),
                   "ticks": int(cols[8])}
    finally:
        if counts_path:
            stream.close()


def _render_read_figure(plt, signal, row, zoom: int, margin_frac: float):
    """One figure per counted read: an overview with the STR span shaded,
    plus boundary close-ups of the prefix and suffix transitions."""
    import numpy as np

    accent, base, marker = "#b5543c", "#555555", "#2b6a99"
    begin, span = row["offset"], row["ticks"]
    end = begin + span
    margin = int(span * margin_frac)
    view = slice(max(0, begin - margin), min(len(signal), end + margin))

    fig = plt.figure(layout="constrained")
    grid = fig.add_gridspec(2, 2, height_ratios=(3, 2))

    overview = fig.add_subplot(grid[0, :])
    x = np.arange(view.start, view.stop)
    overview.plot(x, signal[view], color=base, linewidth=0.4)
    overview.axvspan(begin, end, color=accent, alpha=0.15, label=f"STR x{row['count']}")
    overview.set_title(f"{row['target']} ({row['strand']}) | read {row['id']} | "
                       f"{row['count']} repeat units over {span} samples")
    overview.set_xlabel("sample")
    overview.set_ylabel("z-score")
    overview.legend(loc="upper right")

    for col, (edge, side, score) in enumerate((
            (begin, "prefix", row["score_prefix"]),
            (end, "suffix", row["score_suffix"]))):
        ax = fig.add_subplot(grid[1, col])
        lo, hi = max(0, edge - zoom), min(len(signal), edge + zoom)
        xs = np.arange(lo, hi)
        inside = (xs >= begin) & (xs < end)
        ax.plot(xs[~inside], signal[lo:hi][~inside], ".", color=base, markersize=1)
        ax.plot(xs[inside], signal[lo:hi][inside], ".", color=marker, markersize=1)
        ax.axvline(edge, color=accent, linewidth=1.0)
        ax.set_title(f"{side} boundary | alignment score {score:.2f}")
        ax.set_xlabel("sample")
    return fig


def cmd_plot(argv) -> int:
    """Per-read signal figures for counted STR expansions (the role of the
    reference's plot subcommand, reference scripts/STRique.py:948-1024;
    rendering is this framework's own design)."""
    parser = argparse.ArgumentParser(description="Signal plots over STR expansions")
    parser.add_argument("f5Index", help="Fast5 index")
    parser.add_argument("--counts", default=None, help="Count TSV from 'count', stdin if not given")
    parser.add_argument("--output", default=None, help="Output directory for plots (else GUI)")
    parser.add_argument("--format", default="png", choices={"png", "pdf", "svg"})
    parser.add_argument("--width", default=16, type=int)
    parser.add_argument("--height", default=9, type=int)
    parser.add_argument("--dpi", default=80, type=int)
    parser.add_argument("--extension", type=float, default=0.1,
                        help="Overview margin as a fraction of the STR span")
    parser.add_argument("--zoom", type=int, default=500, help="Samples around each STR boundary")
    parser.add_argument("--log_level", default="warning",
                        choices=["error", "warning", "info", "debug"])
    args = parser.parse_args(argv)
    ulog.init(log_level=args.log_level)
    import matplotlib

    if args.output:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    from .io.fast5 import Fast5Index
    from .ops.signal import medfilt3

    if not os.path.isfile(args.f5Index):
        log("Main: Fast5 index file does not exist.", LogLevel.Error)
        return 1
    f5 = Fast5Index(args.f5Index)
    if args.output:
        os.makedirs(args.output, exist_ok=True)
    plt.rcParams.update({"figure.figsize": (args.width, args.height),
                         "figure.dpi": args.dpi})

    for row in _iter_count_rows(args.counts):
        try:
            raw = f5.get_raw(row["id"])
        except RuntimeError:
            log(f"Plot: no indexed fast5 for read {row['id']}, skipped", LogLevel.Warning)
            continue
        flt = medfilt3(raw.astype(np.float64))
        flt = (flt - np.median(flt)) / np.std(flt)
        fig = _render_read_figure(plt, flt, row, args.zoom, args.extension)
        if args.output:
            name = f"{row['id']}_{row['target']}_{row['count']}.{args.format}"
            fig.savefig(os.path.join(args.output, name))
            plt.close(fig)
        else:
            plt.show()
    ulog.close()
    return 0


def cmd_extract(argv) -> int:
    parser = argparse.ArgumentParser(description="Fast5 extraction")
    parser.add_argument("batch", help="Input batch (.tar/.fast5/.txt of read IDs)")
    parser.add_argument("output", help="Output directory")
    parser.add_argument("--index", default=None, help="Read index")
    parser.add_argument("--output_format", default="single", choices=["single", "bulk", "lazy"])
    parser.add_argument("--tmp_prefix", default=None, help="Prefix for temporary data")
    args = parser.parse_args(argv)
    from .io.fast5 import Fast5Index

    Fast5Index(args.index, tmp_prefix=args.tmp_prefix).extract(
        args.batch, args.output, format=args.output_format)
    return 0


COMMANDS = {"index": cmd_index, "count": cmd_count, "plot": cmd_plot,
            "extract": cmd_extract, "warmup": cmd_warmup}


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(
        prog="strique",
        description="STRique on PyTorch and CUDA: nanopore raw signal repeat detection",
        usage="strique <command> [<args>]\n\nCommands:\n"
              "   index      Index batch(es) of bulk-fast5 or tar archived single fast5\n"
              "   count      Count single read repeat expansions\n"
              "   plot       Plot repeat signal after counting\n"
              "   extract    Extract single reads from indexed sequencing run\n"
              "   warmup     Build the kernels and run each shape of a config once\n")
    parser.add_argument("command", choices=sorted(COMMANDS))
    args = parser.parse_args(argv[:1])
    return COMMANDS[args.command](argv[1:])


if __name__ == "__main__":
    raise SystemExit(main())
