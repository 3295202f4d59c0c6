#!/usr/bin/env python3
"""Build the PyTorch/CUDA port's kernels and run its counting path on one GPU.

    python3 chip_smoke.py [--seed S] [--out results.json]

Phases, each fatal on failure (non-zero exit, no ``ok`` line):

1. Print the card's name and its ``nvidia-smi`` name and power limit;
   exit non-zero when CUDA is unavailable.
2. Build every kernel of ``strique_tpu_torch/csrc`` (nvcc) and print
   the build seconds.
3. Hold each kernel against its plain PyTorch twin on the card, at a
   small random shape and at the bench shape (64 rows, npad 24576,
   MP 896; Viterbi T 6144, SP 256): integer outputs exactly equal, f32
   outputs bit-equal (max_abs_err 0).  The wave kernel (rows 1-2) runs
   on morph-form reads (u8 bins and a 256-level table per read,
   ``samples=6`` templates; row 2 at the bench shape with 128 rows, both
   flanks of 64 reads): its TABLE score mode against the table twin,
   and its POW mode on the decoded f32 against the same twin run, with
   each mode's ms and us per diagonal step.  The score-mode rule is held
   in every direction (at one CTA's shared-memory cap at MP 256, past
   1024 lanes, the cluster's split form at both, and POW past every
   cluster's table at MP 2176), each call against the table twin; row 1 also runs at the
   ultra-long one-pass shape (8 rows, the bucket's N), TABLE against POW
   on the decoded f32.  The two-pass kernels (rows 5-6) run on morph-form
   reads at N=4096, M=42, ckpt_steps 512 (cold and warm windows) and
   at the bench templates, N=24576, ckpt_steps 16384, each with one
   template over 8 rows and with both flanks as per-row templates over
   16 rows (the row stream of phase 4b's two-pass route): their TABLE
   modes against the table twins, their POW modes on the decoded f32
   against the same twin runs; bottom taps, written checkpoint slots
   and written pointer words equal; ms and us per step of each mode.
   Row 5 also runs at the ultra-long shape (8 and 64 rows, the bucket's
   N), TABLE against POW.  The Viterbi pair
   also runs at the ultra-long segment length (B=8, T 55296).  The
   column-sweep kernel runs on morph-form reads at the small and bench
   shapes (64 rows, N 24576, MP 896): its TABLE score mode against the
   table twin, its POW mode on the decoded f32 against the POW twin, the
   two against each other; the column-layout traceback walks the TABLE
   plane.  The dense Viterbi forward runs in the mode ``dense_mode``
   picks (resident: a cluster of K CTAs a read; streamed past SP 512) at
   the small, bench (B 64, T 6144, SP 256, K 2) and ultra shapes, and at
   the bench's B and T with SP 128 (K 1), SP 384 (K 6) and SP 512 (K 8).  The
   diagonal traceback walks row 2's planes (the bench's at 128 rows), the
   column one row 8's TABLE planes; both walk the hard planes of
   ``synthetic.traceback_plane`` at 1, 8, 48 and 128 rows, and the
   diagonal one the ultra one-pass plane (row 1's, 8 rows) and the bench
   two-pass window plane (16 rows): each against its twin, timed warm
   and with L2 flushed, with us per step over the longest walk, and the
   walks replayed to count their steps (held equal to the count read
   from the outputs) and the distinct words they read (the bound).  Rows 3-4
   and 7 also run at their edges (``check_viterbi_edges``: short reads,
   obs-chunk boundaries, constant obs, SP 512).  Row 3's diagonal-only
   slot layout (the mod HMM's) and row 4 run at a mod decode's shape: 64
   clipped repeat-state segments of T 3072 through the mod HMM of
   GGCCCC (26 states, SP 128) and of a 60-base unit (242 states, SP
   256), against their twins, the dense resident forward's ms on the
   same inputs beside them and its paths equal.  Rows 3-4 past SP 1024
   (``check_viterbi_wide``): the wide forward in both slot layouts and
   the wide backward against their twins at SP 1152, 2048 and 8192
   (``synthetic.VITERBI_WIDE``: flanked-repeat and mod HMMs, 8 reads of
   T 1024, constant obs at SP 1152), then at phase 4f's shapes (the
   150-base unit's repeat HMM, 8 segments of 5 units, T 7168; the
   260-base unit's mod HMM, 8 segments of 3 units, T 6656), each with
   its ms, us a step, bound and twin ms.  Last, the AlignParams sweep
   (``check_sweep``: the reference's tests/test_fuzz_params.py corners, 14
   explicit and 12 seeded draws, at B 8, N 256, M 20): rows 1, 2 and 8
   in the TABLE mode against their table twins and in the POW mode on
   the decoded f32 against their POW twins, rows 5-6 in both modes where
   a span bound exists (``ckpt_steps`` 128), and both tracebacks, every
   output equal.  Print kernel and plain times, and us per step (a
   column for row 8).
4. Count the c9orf72 repeat (100 units) in 128 noisy '+' reads of
   ~22k samples, through detect_submit -> detect_middle ->
   detect_finish in batches of 64, then 24 '-' reads (a partial batch:
   the fused per-row-template wave route), with a seeded synthetic
   6-mer pore model.  Every count must be exact, every kernel of the
   split path must have launched in this phase, every wave launch in
   the TABLE score mode (both flanks of a 64-read batch fuse into one
   128-row call on the card), and the first 8 '+' results must equal
   the port's plain CPU path.  Print reads/s beside the card's power
   limit.
4b. The ultra-long route: 8 noisy '+' reads of ~1.1M samples with 1200
   units through the same counter, once with ``STRIQUE_PTR_BUDGET_GB=2``
   (the bucket's ~4.7 GB width-8 plane does not fit: the two-pass
   kernels run in the TABLE mode alone, pass 1 of both flanks in one
   16-row launch, and the one-pass wave kernel must not) and once with 8
   (the one-pass route at 8 rows a call, one call per flank, TABLE mode).
   Counts 8/8 exact on both routes, and the two routes' result tuples
   equal.  Print each route's seconds.
4e. A target whose flanks are 200 bases longer each (MP 2176: more
   lanes than one CTA runs, and more levels than one CTA's table holds;
   the TABLE mode on a thread-block cluster of 2 CTAs a row, each with a
   table of its own lanes' levels): both wave calls held to the table
   twin in the one-CTA form (POW) and the split form (the cluster), 16
   rows, N 4096; rows 5-6 with both flanks as per-row templates, the
   cluster and POW modes against their twins (16 rows, N 4096); then at
   the shapes the runs launch, the cluster mode against the POW mode on
   the decoded f32, timed in turns (POW, cluster, cluster, POW): row 8
   and row 1 at 64 rows of the '+' reads' bucket and row 2 at 48 rows
   (each also against its table twin), rows 5-6 at 8-row groups.  Then
   72 '+' and 24 '-' reads count exactly through the cluster TABLE mode
   alone (row 1: 64 + 8 rows a flank, as many rows as their CTAs fit
   the SMs; row 2: one fused 48-row call), the 72 '+' reads again under
   ``STRIQUE_PTR_BUDGET_GB=0.1`` (the two-pass route, rows 5-6 on the
   cluster) and the first 64 under ``STRIQUE_ALIGN_KERNEL=col`` (row 8
   on the cluster), each with the one-pass run's tuples and no POW
   launch.  Last, the f32 route (``run_f32_route``): the alignment API
   on f32 reads at the same shapes runs rows 1, 2, 5-6 and 8 in the POW
   mode, each call's outputs equal to its morph form's (the cluster's).
4f. A VNTR target of a 60-base unit, whose repeat HMM (SP 640) is past
   the dense forward's resident rule: the streamed dense kernel against
   its twin (8 reads, T 8192), then 8 '+' reads counted on the default
   route and under ``STRIQUE_DENSE_VITERBI=1`` (the streamed kernel
   alone), equal tuples, each read at the reference's count: 11 of 12
   units, as the JAX package counts these reads on the CPU
   (tests/test_torch_dense.py ``test_vntr_counts_match_jax_counter``).
   Past SP 1024: a 150-base unit's target (SP 1152), 8 '+' reads of 5
   units on the default route (the wide forward and backward) and under
   ``STRIQUE_DENSE_VITERBI=1`` (the streamed dense forward and the wide
   backward), tuples equal to the port's CPU counter's
   (tests/test_torch_wide_counter.py holds it to the JAX counter); a
   260-base unit's target with the mod model (repeat HMM SP 1792, mod
   HMM SP 1152), 4 base and twin reads, tuples equal to the CPU
   counter's (tests/test_torch_wide_mod.py); and a 1345-base unit (SP
   8320) refused by ``add_target`` on the card before any launch.
4c. One more pass of each path under torch.profiler: wall time, device
   time by kernel and the busy share; the walks of each traceback launch
   read from its outputs, and the kernel's us a step on the path.
4d. The knob routes: the '+' and '-' passes of phase 4 once under
   ``STRIQUE_ALIGN_KERNEL=col`` (column kernel and column traceback on
   the '+' batches; the '-' partial batch stays on the fused wave
   kernel, as in the reference) and once under
   ``STRIQUE_DENSE_VITERBI=1`` (dense forward instead of the factored
   one), each with a fresh counter so its HMM cache sees the knob.
   Counts exact, result tuples equal to phase 4's, the knob's kernels
   launched (the column kernel's TABLE mode, the dense forward's
   resident mode) and the ones they replace not; reads/s of each route,
   and one profiled '+' pass of each (as in 4c).
4g. The ``count`` path: a shuffled stream of 384 noisy reads over
   c9orf72 (192 '+', 64 '-') and FMR1 (64 '+', 64 '-'), 20-150 units,
   ~15k-37k samples in six signal buckets (``synthetic.count_workload``),
   through ``run_pipeline`` with the port's RepeatDetector (an in-memory
   index: the card's host may lack h5py), StreamScheduler and
   OutputWriter: a warm-up run, then ``--batch`` 32, 64 and 128, twice
   each, and one profiled run at the CLI's card default
   (``cli.CARD_BATCH``).  Then ``strique_tpu_torch.cli count`` at its
   defaults (``--device cuda``, ``--batch cli.CARD_BATCH``) with
   ``--profile``, its detector's index patched to the in-memory one, and
   where h5py imports on the reads as single-read fast5 files too: each
   TSV equal to the in-memory run's at that ``--batch``.  Every run: one
   row per SAM line, every row the string of ``detect_many``'s tuple for
   its read in a fresh counter (batches of one bucket, no tail merge),
   every c9orf72 count exact, no per-read retry; the split path's
   kernels launched.  FMR1's exact share is printed, not required: about
   half its '+' reads miss by a few units on the synthetic model, and
   tests/test_torch_fmr1.py holds three of them (both overcounts and
   the largest undercount) to the JAX package's count on the CPU.
   Print reads/s per ``--batch``, the launches, and the profiled run's
   busy share.
4h. Mod calling: 96 '+' and 32 '-' c9orf72 reads of 50 units, half
   from a base model (``synthetic.MOD_MODEL_SEED``) and half from its
   twin (CpG levels shifted by ``synthetic.MOD_SHIFT``), through
   ``StreamScheduler`` at ``--batch`` 64 with ``mod_model_file`` (a
   warm-up run, then a timed one), then ``cli.main(["count", ...,
   "--mod_model", twin])`` on an in-memory index.  Every count exact
   but the two twin '-' reads the JAX package counts at 51 on the CPU
   (``synthetic.MOD_WORKLOAD_MISCOUNTS``, held there by
   tests/test_torch_mod.py), which must count 51;
   every twin read's '1' share above 0.5 and every base read's below,
   every row equal to ``detect_many``'s tuple in a fresh counter (mod
   string included), the CLI's rows equal to the stream's; every mod
   forward launch on the diagonal-only layout (one a decode call of up
   to 64 reads), none dense; each captured mod obs batch replayed
   through the plain twins on the card gives the kernels' paths.  Print
   reads/s, the batches and the mod decode's device ms (profiled, and
   one decode by CUDA events).
4i. Several device entries: phase 4g's stream through a detector on
   ``device=[cuda:0, cuda:0]`` (each batch's rows in two shards, each
   on its own CUDA stream) at ``--batch`` 64, its TSV byte-equal to
   phase 4g's; the ultra-long reads on the same entries under phase 4b's
   two-pass budget (``STRIQUE_PTR_BUDGET_GB=2``, where one device runs
   both flanks as one 16-row group: here each entry's shard of 4 reads
   runs its own 8-row group) and under the card's default budget, tuples
   equal to phase 4b's two-pass run's.
4j. ``count`` over phase 4g's stream as two processes on the one card
   (``--coordinator localhost:P --num_hosts 2 --host_id i``, gloo; the
   detector's index reads an .npz of the signals): one merged TSV with
   the single process's rows, parts removed, the reads split between
   the processes.  Print the wall seconds.
4k. The counter's other two routes over phase 4's 128 '+' and 24 '-'
   reads, each in a fresh counter: the fused single dispatch
   (``STRIQUE_SPLIT=0``: row 2 TABLE, the traceback, rows 3-4 over each
   read's shifted flt row, one packed copy back) and the two-phase
   host-bounds path (``fused = False``: row 1 TABLE once a flank, the
   traceback, host bounds, rows 3-4).  Counts exact; fused tuples equal
   to phase 4's; two-phase counts, offsets and ticks equal, scores and
   log_p within 1e-6, its first 8 '+' tuples the CPU two-phase path's;
   each route's kernels launched and the ones it replaces not.  Print
   each route's reads/s beside phase 4's, then six rounds of one '+'
   pass of each of the three routes (their order turning) and one
   profiled '+' pass of each new route, and the fused Viterbi call's
   peak device memory.  Then phase 4h's mod reads (every row phase 4h's
   ``detect_many`` row) and phase 4f's 150-base target (SP 1152; the
   default route's tuples, its Viterbi call's peak memory printed)
   through the fused route.
4l. A NaN level table (a flat read's: all samples equal) in row 0 of 8
   in rows 1, 2, 5-6 and 8, in the TABLE mode on one CTA and on a
   cluster (MP 1152) and in the POW mode, each against its twin: equal
   NaN masks and equal values elsewhere in the bottom taps and written
   checkpoint slots, equal written pointer words.  Then a flat read
   through the split, fused and two-phase routes on the card: each the
   CPU counter's tuple, offset 0.
5. Print the kernel table as one JSON line (per kernel: launches on its
   path, max_abs_err against its twin, ms, plain_ms, the bound of
   ``bound()`` and library_ms; ``--out`` adds rows 1-2's us per step and
   their bound with the pow counted per cell), then the final
   ``{"ok": true, "device": ...}`` line.  Row 1's TABLE launches come
   from phase 4b's one-pass route, rows 5-6's TABLE launches from its
   two-pass route, the cluster launches of rows 1-2, 5-6 and 8 from
   phase 4e's count runs and their POW launches from its f32 route, row
   8's TABLE and row 7's resident launches from phase 4d, row
   7's streamed launches from phase 4f, row 3's diagonal-only layout's
   from phase 4h's timed stream run, the wide variants' from phase 4f's
   wide targets (the default route's, and the mod target's for the
   diagonal-only layout).
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time

REPEATS = 100
BATCH = 64
ULTRA_REPEATS = 1200
ULTRA_T = 55296  # Viterbi segment length of an ultra-long read, padded to 512

# published peaks of one H100 SXM (NVIDIA data sheet; dense, no sparsity)
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # FP32 outside the tensor cores
F64_OPS_PER_S = 34e12  # FP64 outside the tensor cores
# f32 operations per DP cell, counted from wave_align.cu's expression
# tree (pointer modes, POW score; the score-only pass drops the 6 of the
# pointer code); col_align.cu's tree counts the same 23 (its prefix max
# takes the place of the running column max); the f64 |d|^1.2 counts as
# 2 FP64 operations (a log and an exp, a lower bound of pow's cost).  In
# the TABLE score mode a cell looks its score up (dp_cell's 19, and 13
# in the score-only pass), and the score's sub, abs, sub, max and pow
# run once per table entry.
WAVE_F32_PER_CELL = 23
CKPT_F32_PER_CELL = 17
TABLE_F32_PER_CELL = 19
CKPT_TABLE_F32_PER_CELL = 13
SCORE_F32 = 4
POW_F64_PER_CELL = 2

# the split path's kernels on the card: both flanks of a batch fuse into
# one per-row-template wave call in TABLE score mode
SPLIT_KERNELS = ("align_forward_wave_multi_table", "traceback_pointers",
                 "viterbi_forward_factored", "viterbi_backward_batch")
POW_WAVE = ("align_forward_wave", "align_forward_wave_multi")
KERNEL_KEYS = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
               "plain_ms", "bound_ms", "bound_by", "library_ms")
TABLE_WAVE = ("align_forward_wave_table", "align_forward_wave_multi_table")
POW_TWO_PASS = ("align_forward_ckpt", "align_window_from_state")
TABLE_TWO_PASS = ("align_forward_ckpt_table", "align_window_from_state_table")
# the TABLE score mode on a thread-block cluster of CTAs a row (past one
# CTA's table), one launch counter each
CLUSTER_WAVE = ("align_forward_wave_cluster", "align_forward_wave_multi_cluster")
CLUSTER_TWO_PASS = ("align_forward_ckpt_cluster", "align_window_from_state_cluster")
KNOBS = {"col": ("STRIQUE_ALIGN_KERNEL", "col"), "dense": ("STRIQUE_DENSE_VITERBI", "1")}
# the dense forward's two modes (resident: SP <= 512) and the column
# kernel's two score modes, one launch counter each
DENSE = ("viterbi_forward_dense_resident", "viterbi_forward_dense")
COL = ("align_forward_col_table", "align_forward_col", "align_forward_col_cluster")
# phase 4g: the count path over a stream of both loci, at each --batch
# twice (it must launch SPLIT_KERNELS)
COUNT_BATCHES = (32, 64, 128)
COUNT_REPS = 2
# phase 4f's VNTR target: a 60-base unit (as MUC1's VNTR) whose repeat
# HMM (540 states, SP 640) is past the dense forward's resident rule
VNTR_UNIT_BASES = 60
VNTR_UNITS = 12
# phase 3's wide Viterbi cases (synthetic.VITERBI_WIDE: SP 1152, 2048 and
# 8192 in both slot layouts; SP 4480 is the gpu tests' alone)
WIDE_CASES = ("flanked 150", "flanked 150, constant obs", "flanked 300", "flanked 1330",
              "mod 260", "mod 500", "mod 2030")
WIDE_KERNELS = ("viterbi_forward_factored_wide", "viterbi_forward_factored_diag_wide",
                "viterbi_backward_wide")
# phase 4f's wide target: '+' reads of 5 units of a 150-base unit (SP 1152)
WIDE_UNITS = 5
WIDE_READS = 8
WIDE_MOD_READS = 4
# a unit past the card's widest HMM: 1345 bases, 8250 states (SP 8320)
TOO_WIDE_UNIT_BASES = 1345
# phase 4i: the count stream and the ultra two-pass route over two entries
# of the one card; phase 4j: count as two processes over gloo
DEVICE_ENTRIES = 2
HOSTS = 2
# phase 4k: rounds of one '+' pass of each route (split, fused, two-phase)
ROUTE_ROUNDS = 6
HOST_TIMEOUT_S = 300
SOURCES = {
    "align_forward_wave": ("strique_tpu_torch/csrc/wave_align.cu",
                           "strique_tpu/ops/align_pallas.py:639"),
    "align_forward_wave_multi": ("strique_tpu_torch/csrc/wave_align.cu",
                                 "strique_tpu/ops/align_pallas.py:684"),
    "align_forward_wave_table": ("strique_tpu_torch/csrc/wave_align.cu",
                                 "strique_tpu/ops/align_pallas.py:639"),
    "align_forward_wave_multi_table": ("strique_tpu_torch/csrc/wave_align.cu",
                                       "strique_tpu/ops/align_pallas.py:684"),
    "align_forward_ckpt": ("strique_tpu_torch/csrc/wave_align.cu",
                           "strique_tpu/ops/align_pallas.py:788"),
    "align_window_from_state": ("strique_tpu_torch/csrc/wave_align.cu",
                                "strique_tpu/ops/align_pallas.py:834"),
    "align_forward_ckpt_table": ("strique_tpu_torch/csrc/wave_align.cu",
                                 "strique_tpu/ops/align_pallas.py:788"),
    "align_window_from_state_table": ("strique_tpu_torch/csrc/wave_align.cu",
                                      "strique_tpu/ops/align_pallas.py:834"),
    "align_forward_wave_cluster": ("strique_tpu_torch/csrc/wave_align.cu",
                                   "strique_tpu/ops/align_pallas.py:639"),
    "align_forward_wave_multi_cluster": ("strique_tpu_torch/csrc/wave_align.cu",
                                         "strique_tpu/ops/align_pallas.py:684"),
    "align_forward_ckpt_cluster": ("strique_tpu_torch/csrc/wave_align.cu",
                                   "strique_tpu/ops/align_pallas.py:788"),
    "align_window_from_state_cluster": ("strique_tpu_torch/csrc/wave_align.cu",
                                        "strique_tpu/ops/align_pallas.py:834"),
    "traceback_pointers": ("strique_tpu_torch/csrc/traceback.cu",
                           "strique_tpu/ops/align.py:235"),
    "viterbi_forward_factored": ("strique_tpu_torch/csrc/viterbi_fwd.cu",
                                 "strique_tpu/ops/viterbi_pallas.py:470"),
    "viterbi_forward_factored_diag": ("strique_tpu_torch/csrc/viterbi_fwd.cu",
                                      "strique_tpu/ops/viterbi_pallas.py:470"),
    "viterbi_backward_batch": ("strique_tpu_torch/csrc/viterbi_bwd.cu",
                               "strique_tpu/ops/viterbi_pallas.py:308"),
    "viterbi_forward_factored_wide": ("strique_tpu_torch/csrc/viterbi_fwd.cu",
                                      "strique_tpu/ops/viterbi_pallas.py:470"),
    "viterbi_forward_factored_diag_wide": ("strique_tpu_torch/csrc/viterbi_fwd.cu",
                                           "strique_tpu/ops/viterbi_pallas.py:470"),
    "viterbi_backward_wide": ("strique_tpu_torch/csrc/viterbi_bwd.cu",
                              "strique_tpu/ops/viterbi_pallas.py:308"),
    "align_forward_col_table": ("strique_tpu_torch/csrc/col_align.cu",
                                "strique_tpu/ops/align_pallas.py:322"),
    "align_forward_col": ("strique_tpu_torch/csrc/col_align.cu",
                          "strique_tpu/ops/align_pallas.py:322"),
    "align_forward_col_cluster": ("strique_tpu_torch/csrc/col_align.cu",
                                  "strique_tpu/ops/align_pallas.py:322"),
    "traceback_pointers_col": ("strique_tpu_torch/csrc/traceback.cu",
                               "strique_tpu/ops/align.py:235"),
    "viterbi_forward_dense_resident": ("strique_tpu_torch/csrc/viterbi_dense.cu",
                                       "strique_tpu/ops/viterbi_pallas.py:183"),
    "viterbi_forward_dense": ("strique_tpu_torch/csrc/viterbi_dense.cu",
                              "strique_tpu/ops/viterbi_pallas.py:183"),
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def device_ms(fn, reps: int, before=lambda: None) -> list:
    """Device ms of each of ``reps`` calls ``fn(before())``, ``before``
    outside the timed span, all queued behind a sleep so the host's time
    per call stays off the timeline (a short kernel outruns its wrapper)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    spans = []
    for _ in range(reps):
        arg = before()
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn(arg)
        t1.record()
        spans.append((t0, t1))
    torch.cuda.synchronize()
    return [t0.elapsed_time(t1) for t0, t1 in spans]


def once_ms(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def bound(nbytes: float, f32_ops: float = 0.0, f64_ops: float = 0.0) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rates of their types, whichever is larger
    (no PyTorch call computes these functions: library_ms is null)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = f32_ops / F32_OPS_PER_S + f64_ops / F64_OPS_PER_S
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations", "library_ms": None}


def wave_cells(n_act, m_rows) -> float:
    """DP cells the inputs need: sum over rows of n * m."""
    return float((n_act.double() * m_rows.double()).sum())


def valid_ptr_mask(n_act, m_rows, nwords):
    """(ND/8, B) mask of pointer words a row's kernel writes (t < n + m, in 8s)."""
    import torch

    words = (n_act.to(torch.int64) + m_rows.to(torch.int64) + 7) // 8
    q = torch.arange(nwords, device=n_act.device)[:, None]
    return q < words[None, :]


def morph_reads(templates, B, N, rng, n_lo=None):
    """(B, N) u8 morph bins and (B, 256) f32 level tables: per read an
    affine 256-level table (as the counter's prep builds one) and a
    uniform signal with row b's template (``templates[b]``) inserted with
    noise, quantised to its nearest level.  Lengths n in [n_lo, N]."""
    import numpy as np

    from strique_tpu_torch.synthetic import quantise

    lo = rng.uniform(40, 60, B)
    hi = rng.uniform(130, 150, B)
    sig = rng.uniform(60, 120, (B, N))
    for b, t in enumerate(templates):
        st = int(rng.integers(0, max(1, N // 2 - len(t))))
        sig[b, st : st + len(t)] = t + rng.normal(0, 1.0, len(t))
    bins, lut = quantise(sig, rng, lo, hi)
    na = rng.integers(N // 2 if n_lo is None else n_lo, N + 1, B).astype(np.int32)
    return bins, lut, na


def table_entries(levels, rows: int) -> float:
    """Score-table entries the TABLE mode evaluates: U x 258 a row (a CTA
    of the row in the split form), U the distinct values of the
    template's (or the CTA's) lanes, the +1e30 pad among them."""
    import numpy as np

    u = ((levels < np.float32(1e30)).sum(axis=-1) + 1).reshape(levels.shape[0], -1).sum(axis=1)
    return 258.0 * float(u.sum() if levels.shape[0] > 1 else u[0] * rows)


def wave_bound(n_d, m_d, levels, nbytes, table: bool):
    """Rows 1-2's bound over the DP cells the inputs need (sum of n * m).
    POW: 23 f32 and 2 FP64 operations a cell.  TABLE: 19 f32 a cell, and
    the score (4 f32, 2 FP64) once per table entry: U x 258 for every row
    (each read has its own level table), U the row's distinct template
    values, the +1e30 pad among them; the POW count beside it."""
    cells = wave_cells(n_d, m_d)
    old = bound(nbytes, WAVE_F32_PER_CELL * cells, POW_F64_PER_CELL * cells)
    if not table:
        return old
    entries = table_entries(levels, n_d.shape[0])
    new = bound(nbytes, TABLE_F32_PER_CELL * cells + SCORE_F32 * entries,
                POW_F64_PER_CELL * entries)
    return {**new, "bound_ms_pow_per_cell": old["bound_ms"]}


def wave_inputs(templates, multi, B, N, rng, n_lo=None, ctas=None):
    """Morph-form wave inputs on the card: one shared template
    (``templates[0]``) or, with ``multi``, the two templates over the two
    halves of the rows; with ``ctas`` the levels in the split form of a
    cluster of that many CTAs a row.  Returns (numpy (levels, lidx,
    tmpl, bins, lut), device (bins, lut, n, m_rows, levels, lidx,
    tmpl))."""
    import numpy as np
    import torch

    from strique_tpu_torch.ops import align_cuda as AC

    if multi:
        rows, ms = AC.pad_template_rows(list(templates))
        tmpl = np.repeat(rows, [B // 2, B - B // 2], axis=0)
        mr = np.repeat(ms.astype(np.int32), [B // 2, B - B // 2])
        row_t = [templates[0]] * (B // 2) + [templates[1]] * (B - B // 2)
    else:
        tmpl, m = AC.pad_template(templates[0])
        mr = np.full(B, m, np.int32)
        row_t = [templates[0]] * B
    bins, lut, na = morph_reads(row_t, B, N, rng, n_lo)
    levels, lidx = AC.template_levels(tmpl, ctas)
    dev = torch.device("cuda")
    return ((levels, lidx, tmpl, bins, lut),
            tuple(torch.from_numpy(x).to(dev) for x in (bins, lut, na, mr, levels, lidx, tmpl)))


def morph_call(multi, b_d, l_d, n_d, m_d, lv_d, li_d, params):
    """The morph-form wave entry point of row 2 (``multi``) or row 1."""
    from strique_tpu_torch.ops import align_cuda as AC

    if multi:
        return AC.align_forward_wave_multi_morph(b_d, l_d, n_d, lv_d, li_d, m_d, params)
    return AC.align_forward_wave_morph(b_d, l_d, n_d, lv_d, li_d, params, int(m_d[0]))


def pow_call(multi, s_d, n_d, m_d, t_d, params):
    """The f32 wave entry point (POW mode) of row 2 (``multi``) or row 1."""
    from strique_tpu_torch.ops import align_cuda as AC

    if multi:
        return AC.align_forward_wave_multi(s_d, n_d, t_d, m_d, params)
    return AC.align_forward_wave(s_d, n_d, t_d, params, int(m_d[0]))


def check_wave(templates, shape_name, B, N, params, multi, rng, results):
    """Rows 1-2 on morph-form reads: the TABLE-mode kernel against the
    table twin (one plain run) and the POW-mode kernel on the decoded f32
    against the same run; pointer words and bottom taps equal."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align_cuda as AC

    (levels, lidx, tmpl, bins, lut), dev_in = wave_inputs(templates, multi, B, N, rng)
    b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
    s_d = AC.morph_decode(b_d, l_d)
    name = "align_forward_wave_multi" if multi else "align_forward_wave"
    if AC.wave_score_mode(levels.shape[1], tmpl.shape[1]) != "table":
        fail(f"the {shape_name} templates ({levels.shape[1]} levels) do not fit the score table")
    run_t = lambda: morph_call(multi, b_d, l_d, n_d, m_d, lv_d, li_d, params)
    run_k = lambda: pow_call(multi, s_d, n_d, m_d, t_d, params)
    before = dict(_build.LAUNCHES)
    (ptr_t, bot_t), _ = once_ms(run_t)
    if (_build.LAUNCHES[name + "_table"] != before[name + "_table"] + 1
            or _build.LAUNCHES[name] != before[name]):
        fail(f"the morph-form {name} call did not launch the TABLE mode alone")
    (ptr_k, bot_k), _ = once_ms(run_k)
    (ptr_p, bot_p), plain_ms = once_ms(
        lambda: AC._wave_table_plain(b_d, l_d, lv_d, li_d, n_d, m_d, params))
    mask = valid_ptr_mask(n_d, m_d, ptr_t.shape[0])
    nd = N + tmpl.shape[1]
    errs = {}
    for mode, (ptr, bot), (ptr_r, bot_r) in (("table", (ptr_t, bot_t), (ptr_p, bot_p)),
                                             ("pow", (ptr_k, bot_k), (ptr_p, bot_p)),
                                             ("table-pow", (ptr_t, bot_t), (ptr_k, bot_k))):
        errs[mode] = (bool(torch.equal(ptr[mask], ptr_r[mask])),
                      float((bot.double() - bot_r.double()).abs().max()))
    del ptr_k, ptr_p, bot_p
    ms_t = cuda_ms(run_t, 3)
    ms_k = cuda_ms(run_k, 3)
    _build.LAUNCHES[name] = 0
    _build.LAUNCHES[name + "_table"] = 0
    print(f"  {name} [{shape_name} B={B} N={N} MP={tmpl.shape[1]} U={levels.shape[1]}]: "
          f"TABLE vs twin: pointers {'equal' if errs['table'][0] else 'DIFFER'}, bottom "
          f"max_abs_err {errs['table'][1]}; POW on the decoded f32 vs twin: pointers "
          f"{'equal' if errs['pow'][0] else 'DIFFER'}, bottom max_abs_err {errs['pow'][1]}; "
          f"TABLE vs POW: pointers {'equal' if errs['table-pow'][0] else 'DIFFER'}, bottom "
          f"max_abs_err {errs['table-pow'][1]}; "
          f"TABLE {ms_t:.3f} ms ({ms_t * 1e3 / nd:.4f} us/step), POW {ms_k:.3f} ms "
          f"({ms_k * 1e3 / nd:.4f} us/step), plain {plain_ms:.1f} ms", flush=True)
    if not all(eq and err == 0.0 for eq, err in errs.values()):
        fail(f"{name}: the TABLE mode, the POW mode and the plain twin disagree at the "
             f"{shape_name} shape")
    words = 4 * int(mask.sum()) * tmpl.shape[1] + 4 * bot_t.numel() + 8 * B
    table_bytes = bins.size + lut.size * 4 + levels.size * 4 + lidx.size * 4 + words
    pow_bytes = 4 * (bins.size + tmpl.size) + words
    results[name + "_table"] = {"max_abs_err": errs["table"][1], "ms": ms_t,
                                "plain_ms": plain_ms, "us_per_step": ms_t * 1e3 / nd,
                                **wave_bound(n_d, m_d, levels, table_bytes, True)}
    results[name] = {"max_abs_err": errs["pow"][1], "ms": ms_k, "plain_ms": plain_ms,
                     "us_per_step": ms_k * 1e3 / nd,
                     **wave_bound(n_d, m_d, levels, pow_bytes, False)}
    return ptr_t, bot_t, n_d, m_d


def hold_morph(templates, multi, B, N, params, rng, mode, label) -> None:
    """One morph-form wave call on the card: it must launch the ``mode``
    score mode alone ("table": one CTA a row, in the one-CTA form of the
    levels; "pow": that form past one CTA's table; "cluster": the split
    form on the CTAs its rule gives) and equal the table twin (written
    pointer words and bottom taps).  The launch does not count toward
    any path's launches."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align_cuda as AC

    rows = AC.pad_template_rows(list(templates))[0] if multi else AC.pad_template(templates[0])[0]
    ctas = AC.wave_table_ctas(rows) if mode == "cluster" else None
    (levels, _, tmpl, _, _), dev_in = wave_inputs(templates, multi, B, N, rng, ctas=ctas)
    b_d, l_d, n_d, m_d, lv_d, li_d, _ = dev_in
    name = "align_forward_wave_multi" if multi else "align_forward_wave"
    counters = {"pow": name, "table": name + "_table", "cluster": name + "_cluster"}
    before = dict(_build.LAUNCHES)
    ptr, bot = morph_call(multi, b_d, l_d, n_d, m_d, lv_d, li_d, params)
    ran = {k: _build.LAUNCHES[k] - before[k] for k in counters.values()}
    want = {k: int(k == counters[mode]) for k in counters.values()}
    flat = AC.flat_levels(lv_d, li_d) if lv_d.dim() == 3 else (lv_d, li_d)
    ptr_p, bot_p = AC._wave_table_plain(b_d, l_d, *flat, n_d, m_d, params)
    mask = valid_ptr_mask(n_d, m_d, ptr.shape[0])
    ok = bool(torch.equal(ptr[mask], ptr_p[mask]) and torch.equal(bot, bot_p))
    form = (f"{levels.shape[1]} CTAs of up to {levels.shape[2]} levels" if levels.ndim == 3
            else f"{levels.shape[1]} levels")
    print(f"  {label} [{name}, B={B} N={N} MP={tmpl.shape[1]}, {form}]: "
          f"launches {ran}, {'equal to' if ok else 'DIFFERS from'} the table twin", flush=True)
    if ran != want or not ok:
        fail(f"{label}: the morph call did not run {mode} mode alone, or disagrees with the "
             "table twin")
    for k in counters.values():
        _build.LAUNCHES[k] = before[k]


def check_mode_rule(params, rng) -> None:
    """The score-mode rule in every direction, each call against the
    table twin.  At MP 256 a template at one CTA's shared-memory cap runs
    TABLE on one CTA, and one with a level more runs POW (on the decoded
    f32) in the one-CTA form, and TABLE on the 2 CTAs its rule gives in
    the split form; at MP 1152 (more lanes than one CTA runs) a template
    of 9 levels runs POW in the one-CTA form and TABLE on 2 CTAs in the
    split form; at MP 2176 a template whose every CTA of every split
    holds more levels than its table (219 values cycled over the lanes)
    gets no CTAs from the rule: POW."""
    import numpy as np

    from strique_tpu_torch.ops import align_cuda as AC

    mp = 256
    cap = next(u for u in range(1, 1024) if AC.wave_score_mode(u + 1, mp) == "pow")
    for n_lv, mode in ((cap, "table"), (cap + 1, "pow"), (cap + 1, "cluster")):
        # n_lv - 1 distinct values (the +1e30 pad is a level too)
        t = rng.permutation(np.linspace(60, 120, n_lv - 1)).astype(np.float32)
        hold_morph((t,), False, 8, 512, params, rng, mode, f"score mode rule (cap {cap})")
    t = np.resize(np.linspace(60, 120, 8), 1100).astype(np.float32)
    for mode in ("pow", "cluster"):
        hold_morph((t,), False, 8, 2048, params, rng, mode, "score mode rule (lanes)")
    t = np.resize(rng.permutation(np.linspace(60, 120, 219)), 2175).astype(np.float32)
    if AC.wave_table_ctas(AC.pad_template(t)[0]) != 0:
        fail("a template past every cluster's table got CTAs from the rule")
    hold_morph((t,), False, 8, 2560, params, rng, "pow", "score mode rule (past every cluster)")


def check_wave_ultra(template, B, N, params, rng, results) -> None:
    """Row 1 at the ultra-long one-pass route's shape (8 rows of the
    bucket's N, one flank): the TABLE-mode kernel against the POW-mode
    kernel on the decoded f32, written pointer words equal and bottom
    max_abs_err 0.  (The twin would take minutes here; POW is held to it
    at the small and bench shapes.)"""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align_cuda as AC

    (levels, _, tmpl, _, _), dev_in = wave_inputs((template,), False, B, N, rng,
                                                  n_lo=N - N // 8)
    b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
    if AC.wave_score_mode(levels.shape[1], tmpl.shape[1]) != "table":
        fail("the ultra-long shape's template does not fit the score table")
    before = dict(_build.LAUNCHES)
    (ptr_t, bot_t), ms_t = once_ms(lambda: morph_call(False, b_d, l_d, n_d, m_d, lv_d, li_d,
                                                      params))
    if (_build.LAUNCHES["align_forward_wave_table"] != before["align_forward_wave_table"] + 1
            or _build.LAUNCHES["align_forward_wave"] != before["align_forward_wave"]):
        fail("the ultra-long morph call did not launch the TABLE mode alone")
    s_d = AC.morph_decode(b_d, l_d)
    (ptr_k, bot_k), ms_k = once_ms(lambda: pow_call(False, s_d, n_d, m_d, t_d, params))
    mask = valid_ptr_mask(n_d, m_d, ptr_t.shape[0])
    eq = not bool(((ptr_t != ptr_k) & mask[:, :, None]).any())
    err = float((bot_t.double() - bot_k.double()).abs().max())
    del ptr_k
    # the traceback's coldest walk: the one-pass route's plane
    j_end = (torch.argmax(bot_t, dim=1).to(torch.int32) + 1 - m_d).clamp_min(0).to(torch.int32)
    check_traceback(ptr_t, j_end, m_d, "ultra one-pass plane", results, key="ultra_one_pass")
    del ptr_t
    for k in ("align_forward_wave", "align_forward_wave_table"):
        _build.LAUNCHES[k] = before[k]
    nd = N + tmpl.shape[1]
    print(f"  align_forward_wave [ultra B={B} N={N} MP={tmpl.shape[1]} U={levels.shape[1]}]: "
          f"TABLE vs POW: pointers {'equal' if eq else 'DIFFER'}, bottom max_abs_err {err}; "
          f"TABLE {ms_t:.3f} ms ({ms_t * 1e3 / nd:.4f} us/step), POW {ms_k:.3f} ms "
          f"({ms_k * 1e3 / nd:.4f} us/step), one call each", flush=True)
    if not (eq and err == 0.0):
        fail("align_forward_wave: the TABLE and POW modes disagree at the ultra-long shape")
    results["align_forward_wave_table"].update(ultra_ms=ms_t, ultra_pow_ms=ms_k)


def walk_steps(out, j_end, m_start):
    """Per row, the steps of a walk, read from its outputs: an H move
    lowers j, a V move i, an M move (or a code-3 step, which leaves its
    entry at the initial 0) both; below m_start the entries that are not
    gaps count the M moves."""
    import torch

    below = torch.arange(out["is_gap"].shape[1], device=j_end.device)[None, :] < m_start[:, None]
    diag = ((~out["is_gap"]) & below).sum(dim=1)
    return m_start.long() + (j_end.long() - out["j_begin"].long()) - diag


def walk_words(ptr, j_end, m_start, col=False):
    """Per row, the steps of the walk back from (m_start, j_end) and the
    distinct pointer words it reads, by replaying the walk's rule
    (``_traceback_plain``'s) on the plane.  It reads the cells it visits
    with i > 0 and j > 0 (row 0's code is never used, column 0's is
    fixed), and never comes back to a word it has left (its lane and word
    group only fall), so a word is new where it differs from the last."""
    import torch

    B, MP = j_end.shape[0], ptr.shape[2]
    rows = torch.arange(B, device=ptr.device)
    i, j = m_start.long().clone(), j_end.long().clone()
    steps = torch.zeros(B, dtype=torch.int64, device=ptr.device)
    words = torch.zeros_like(steps)
    last = torch.full_like(steps, -1)

    def read(ic, jc, live):
        nonlocal words, last
        t = (jc - 1 if col else ic + jc - 1).clamp_min(0)
        lane = (ic - 1 if col else ic).clamp(0, MP - 1)
        on = live & (ic > 0) & (jc > 0)
        key = (t >> 3) * MP + lane
        words = words + (on & (key != last)).long()
        last = torch.where(on, key, last)
        nib = (ptr[t >> 3, rows, lane] >> (4 * (t & 7)).to(torch.int32)) & 15
        return torch.where(jc > 0, nib.long(), torch.full_like(jc, 2 | 8))

    byte = read(i, j, i > 0)
    cur = byte & 3
    while bool((i > 0).any()):
        active = i > 0
        is_m, is_h, is_v = cur == 0, cur == 1, cur == 2
        ni, nj = torch.where(is_h, i, i - 1), torch.where(is_v, j, j - 1)
        nbyte = read(ni, nj, active)
        ext = torch.where(is_h, (byte >> 2) & 1, ((byte if col else nbyte) >> 3) & 1)
        ncur = torch.where(~is_m & (ext == 1), cur, nbyte & 3)
        steps += active.long()
        i, j = torch.where(active, ni, i), torch.where(active, nj, j)
        cur, byte = torch.where(active, ncur, cur), torch.where(active, nbyte, byte)
    return steps, words


def check_traceback(ptr, j_end, m_d, shape_name, results, col=False, m_out=None, key=None):
    """The traceback of a diagonal (wave) or, with ``col``, a column plane
    against its twin, walking back from ``j_end`` at rows ``m_d`` (output
    width ``m_out``, default their largest).  Its times enter the kernel
    line (``results[name]``) or, with ``key``, ``results[name][key]``:
    device ms warm (the plane's walked words left in L2 by the run
    before) and cold (L2 flushed before each launch), us a step over the
    longest row's walk, and the bound, from the distinct pointer words
    the walks read."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL

    B = j_end.shape[0]
    m_out = int(m_d.max()) if m_out is None else m_out
    name = "traceback_pointers_col" if col else "traceback_pointers"
    run_k = lambda: AL.traceback_pointers(ptr, j_end, m_out, packed=True if col else "diag",
                                          m_start=m_d)
    run_p = lambda: AL._traceback_plain(ptr, j_end, m_d, m_out, col=col)
    got, _ = once_ms(run_k)
    ref, plain_ms = once_ms(run_p)
    err = 0
    for k in ("is_gap", "jpos", "j_begin"):
        err = max(err, int((got[k].to(torch.int64) - ref[k].to(torch.int64)).abs().max()))
    ms = sum(device_ms(lambda _: run_k(), 5)) / 5
    flush = torch.empty(64 << 20, dtype=torch.int32, device=ptr.device)  # 256 MB > the 50 MB L2
    cold = sum(device_ms(lambda _: run_k(), 3, flush.zero_)) / 3
    del flush
    _build.LAUNCHES[name] = 0
    row_steps, row_words = walk_words(ptr, j_end, m_d, col)
    longest = max(int(row_steps.max()), 1)
    words = int(row_words.sum())
    print(f"  {name} [{shape_name} B={B} MP={ptr.shape[2]}]: max_abs_err {err}; kernel "
          f"{ms:.3f} ms ({ms * 1e3 / longest:.4f} us/step over the longest walk, {longest} "
          f"steps), cold L2 {cold:.3f} ms ({cold * 1e3 / longest:.4f} us/step), plain "
          f"{plain_ms:.1f} ms, 1 launch; the walks: {int(row_steps.sum())} steps reading "
          f"{words} distinct words", flush=True)
    if err != 0:
        fail(f"{name} kernel disagrees with its plain twin at the {shape_name} shape")
    if not torch.equal(walk_steps(got, j_end, m_d), row_steps):
        fail(f"{name}: the walks' lengths read from the outputs differ from the replay's at "
             f"the {shape_name} shape")
    # the bound: each distinct pointer word read once, the outputs written
    # once, j_end and m_start read; ~10 integer operations a step
    nbytes = 4 * words + B * m_out * 5 + 4 * B + 8 * B
    entry = {"max_abs_err": float(err), "ms": ms, "plain_ms": plain_ms, "cold_ms": cold,
             "us_per_step": ms * 1e3 / longest, "cold_us_per_step": cold * 1e3 / longest,
             "longest_walk": longest, "steps": int(row_steps.sum()), "words": words, "rows": B,
             **bound(nbytes, 10 * float(row_steps.sum()))}
    if key is None:
        results.setdefault(name, {}).update(entry)
    else:
        results.setdefault(name, {})[key] = entry


def check_traceback_planes(seed: int, results) -> None:
    """Both traceback layouts on the planes a lane window can miss
    (``synthetic.traceback_plane``: V runs past 128 lanes, H runs across
    more than 16 word groups, j_end 0 and below, m_start 0 and MP - 1,
    code 3) at 1, 8, 48 and 128 rows, each against its twin."""
    import torch

    from strique_tpu_torch.synthetic import traceback_plane

    for col in (False, True):
        for rows in (1, 8, 48, 128):
            ptr, j_end, m_start, m_out = traceback_plane(rows, seed + rows, col)
            ptr, j_end, m_start = (torch.from_numpy(x).cuda() for x in (ptr, j_end, m_start))
            check_traceback(ptr, j_end, m_start, f"hard plane, {rows} rows", results, col=col,
                            m_out=m_out, key=f"hard_{rows}")


def check_col(template, shape_name, B, N, params, rng, results):
    """The column kernel (row 8) on morph-form reads: its TABLE mode
    against the table twin, its POW mode on the decoded f32 against the
    POW twin, and the two modes against each other (written pointer words
    and every bottom tap equal); then the column-layout traceback on the
    TABLE plane."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC

    (levels, _, tmpl, bins, _), dev_in = wave_inputs((template,), False, B, N, rng)
    b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
    m = int(m_d[0])
    s_d = AC.morph_decode(b_d, l_d)
    if AC.col_score_mode(levels.shape[1], tmpl.shape[1]) != "table":
        fail(f"the {shape_name} template ({levels.shape[1]} levels) does not fit the column "
             "kernel's score table")
    run_t = lambda: AC.align_forward_col_morph(b_d, l_d, n_d, lv_d, li_d, params, m)
    run_k = lambda: AC.align_forward_col(s_d, n_d, t_d, params, m)
    before = dict(_build.LAUNCHES)
    (ptr_t, bot_t), _ = once_ms(run_t)
    if (_build.LAUNCHES["align_forward_col_table"] != before["align_forward_col_table"] + 1
            or _build.LAUNCHES["align_forward_col"] != before["align_forward_col"]):
        fail("the morph-form column call did not launch the TABLE mode alone")
    (ptr_k, bot_k), _ = once_ms(run_k)
    mask = valid_ptr_mask(n_d, torch.zeros_like(n_d), ptr_t.shape[0])  # (j-1)//8 < ceil(n/8)
    errs = {}
    (ptr_p, bot_p), plain_t = once_ms(lambda: AC._col_table_plain(b_d, l_d, lv_d, li_d, n_d,
                                                                  params, m))
    errs["table"] = (bool(torch.equal(ptr_t[mask], ptr_p[mask])),
                     float((bot_t.double() - bot_p.double()).abs().max()))
    del ptr_p, bot_p
    (ptr_p, bot_p), plain_k = once_ms(lambda: AC._col_plain(s_d, t_d, n_d, params, m))
    errs["pow"] = (bool(torch.equal(ptr_k[mask], ptr_p[mask])),
                   float((bot_k.double() - bot_p.double()).abs().max()))
    del ptr_p, bot_p
    errs["table-pow"] = (bool(torch.equal(ptr_t[mask], ptr_k[mask])),
                         float((bot_t.double() - bot_k.double()).abs().max()))
    del ptr_k
    ms_t = cuda_ms(run_t, 3)
    ms_k = cuda_ms(run_k, 3)
    _build.LAUNCHES["align_forward_col"] = 0
    _build.LAUNCHES["align_forward_col_table"] = 0
    cols = AC._cols_to_run(n_d, N)
    print(f"  align_forward_col [{shape_name} B={B} N={N} MP={tmpl.shape[1]} "
          f"U={levels.shape[1]}]: TABLE vs table twin: pointers "
          f"{'equal' if errs['table'][0] else 'DIFFER'}, bottom max_abs_err {errs['table'][1]}; "
          f"POW on the decoded f32 vs POW twin: pointers "
          f"{'equal' if errs['pow'][0] else 'DIFFER'}, bottom max_abs_err {errs['pow'][1]}; "
          f"TABLE vs POW: pointers {'equal' if errs['table-pow'][0] else 'DIFFER'}, bottom "
          f"max_abs_err {errs['table-pow'][1]}; TABLE {ms_t:.3f} ms ({ms_t * 1e3 / cols:.4f} "
          f"us/column), POW {ms_k:.3f} ms ({ms_k * 1e3 / cols:.4f} us/column), plain "
          f"{plain_t:.1f} / {plain_k:.1f} ms", flush=True)
    if not all(eq and err == 0.0 for eq, err in errs.values()):
        fail(f"align_forward_col: the TABLE mode, the POW mode and their twins disagree at the "
             f"{shape_name} shape")
    words = 4 * int(mask.sum()) * tmpl.shape[1] + 4 * bot_t.numel() + 4 * B
    table_bytes = bins.size + 4 * (B * 256 + levels.size + tmpl.size) + words
    pow_bytes = 4 * (bins.size + tmpl.size) + words
    results["align_forward_col_table"] = {"max_abs_err": errs["table"][1], "ms": ms_t,
                                          "plain_ms": plain_t, "us_per_column": ms_t * 1e3 / cols,
                                          **wave_bound(n_d, m_d, levels, table_bytes, True)}
    results["align_forward_col"] = {"max_abs_err": errs["pow"][1], "ms": ms_k,
                                    "plain_ms": plain_k, "us_per_column": ms_k * 1e3 / cols,
                                    **wave_bound(n_d, m_d, levels, pow_bytes, False)}
    b0 = torch.full((B, 1), float(AL._b0(params, m)), device=b_d.device)
    j_end = torch.argmax(torch.cat([b0, bot_t], dim=1), dim=1).to(torch.int32)
    check_traceback(ptr_t, j_end, m_d, shape_name, results, col=True)


def turns_ms(run_a, run_b, reps: int = 3):
    """Mean ms of ``run_a`` and ``run_b`` by CUDA events, timed in turns
    (a, b, b, a): ((a1, a2), (b1, b2))."""
    a1 = cuda_ms(run_a, reps)
    b1 = cuda_ms(run_b, reps)
    b2 = cuda_ms(run_b, reps)
    a2 = cuda_ms(run_a, reps)
    return (a1, a2), (b1, b2)


def check_col_pow(template, shape_name, B, N, params, rng, results) -> None:
    """Past one CTA's column table (more than 1024 lanes): the
    morph-form entry point in the one-CTA form of the levels runs the
    POW mode on the decoded f32 alone, and in the split form the TABLE
    mode on the cluster ``col_table_ctas`` gives alone; both against one
    POW twin run (written pointer words and every bottom tap equal), then
    timed in turns (POW, cluster, cluster, POW).  The kernel line's POW
    entry (timed on the f32 entry point) and cluster entry."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align_cuda as AC

    (levels, _, tmpl, bins, _), dev_in = wave_inputs((template,), False, B, N, rng)
    b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
    m = int(m_d[0])
    ctas = AC.col_table_ctas(tmpl)
    if AC.col_score_mode(levels.shape[1], tmpl.shape[1]) != "pow" or ctas < 2:
        fail(f"the {shape_name} template should be past one CTA's column table and fit a "
             "cluster's")
    lv_c, li_c = (torch.from_numpy(x).to(b_d.device) for x in AC.template_levels(tmpl, ctas))
    before = dict(_build.LAUNCHES)
    ptr_k, bot_k = AC.align_forward_col_morph(b_d, l_d, n_d, lv_d, li_d, params, m)
    ran_k = {k: _build.LAUNCHES[k] - before[k] for k in COL}
    ptr_c, bot_c = AC.align_forward_col_morph(b_d, l_d, n_d, lv_c, li_c, params, m)
    ran_c = {k: _build.LAUNCHES[k] - before[k] - ran_k[k] for k in COL}
    if (ran_k != {k: int(k == "align_forward_col") for k in COL}
            or ran_c != {k: int(k == "align_forward_col_cluster") for k in COL}):
        fail("the morph-form column calls past one CTA's table did not launch the POW mode "
             "(one-CTA form) and the cluster TABLE mode (split form) alone")
    s_d = AC.morph_decode(b_d, l_d)
    (ptr_p, bot_p), plain_ms = once_ms(lambda: AC._col_plain(s_d, t_d, n_d, params, m))
    mask = valid_ptr_mask(n_d, torch.zeros_like(n_d), ptr_k.shape[0])
    errs = {mode: (bool(torch.equal(ptr[mask], ptr_p[mask])),
                   float((bot.double() - bot_p.double()).abs().max()))
            for mode, ptr, bot in (("pow", ptr_k, bot_k), ("cluster", ptr_c, bot_c))}
    del ptr_p, bot_p, ptr_k, ptr_c
    run_k = lambda: AC.align_forward_col(s_d, n_d, t_d, params, m)
    run_c = lambda: AC.align_forward_col_morph(b_d, l_d, n_d, lv_c, li_c, params, m)
    (k1, k2), (c1, c2) = turns_ms(run_k, run_c)
    ms, ms_c = (k1 + k2) / 2, (c1 + c2) / 2
    for k in COL:
        _build.LAUNCHES[k] = before[k]
    cols = AC._cols_to_run(n_d, N)
    print(f"  align_forward_col [{shape_name} B={B} N={N} MP={tmpl.shape[1]} "
          f"U={levels.shape[1]}; {ctas} CTAs of up to {lv_c.shape[2]} levels]: vs POW twin: "
          + "; ".join(f"{mode.upper()} pointers {'equal' if eq else 'DIFFER'}, bottom "
                      f"max_abs_err {err}" for mode, (eq, err) in errs.items())
          + f"; POW {k1:.3f} / {k2:.3f} ms ({ms * 1e3 / cols:.4f} us/column), cluster TABLE "
          f"{c1:.3f} / {c2:.3f} ms ({ms_c * 1e3 / cols:.4f} us/column), in turns; plain "
          f"{plain_ms:.1f} ms", flush=True)
    if not all(eq and err == 0.0 for eq, err in errs.values()):
        fail(f"align_forward_col disagrees with its POW twin at the {shape_name} shape")
    words = 4 * int(mask.sum()) * tmpl.shape[1] + 4 * bot_k.numel() + 4 * B
    results["align_forward_col"] = {"max_abs_err": errs["pow"][1], "ms": ms, "plain_ms": plain_ms,
                                    "us_per_column": ms * 1e3 / cols,
                                    **wave_bound(n_d, m_d, levels,
                                                 4 * (bins.size + tmpl.size) + words, False)}
    lv_np = lv_c.cpu().numpy()
    table_bytes = bins.size + 4 * (B * 256 + lv_np.size + tmpl.size) + words
    results["align_forward_col_cluster"] = {
        "max_abs_err": errs["cluster"][1], "ms": ms_c, "plain_ms": plain_ms, "pow_ms": ms,
        "us_per_column": ms_c * 1e3 / cols, **wave_bound(n_d, m_d, lv_np, table_bytes, True)}


def check_wave_over_cap(templates, multi, B, N, params, rng, results) -> None:
    """Row 1 (``multi`` False: one flank's template) or row 2 (both
    flanks as per-row templates) past one CTA's table, at the shape
    phase 4e launches it: the cluster TABLE mode (the split form on the
    CTAs ``wave_table_ctas`` gives) and the POW mode on the decoded f32,
    each against one table-twin run (written pointer words and every
    bottom tap), then timed in turns (POW, cluster, cluster, POW).  The
    kernel line's cluster entry, the POW ms at this shape beside it."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align_cuda as AC

    rows = AC.pad_template_rows(list(templates))[0] if multi else AC.pad_template(templates[0])[0]
    ctas = AC.wave_table_ctas(rows)
    if ctas < 2:
        fail("the over-the-cap templates should take a cluster of CTAs a row")
    (levels, _, tmpl, bins, lut), dev_in = wave_inputs(templates, multi, B, N, rng, ctas=ctas)
    b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
    s_d = AC.morph_decode(b_d, l_d)
    name = "align_forward_wave_multi" if multi else "align_forward_wave"
    names = (name, name + "_table", name + "_cluster")
    run_c = lambda: morph_call(multi, b_d, l_d, n_d, m_d, lv_d, li_d, params)
    run_k = lambda: pow_call(multi, s_d, n_d, m_d, t_d, params)
    before = dict(_build.LAUNCHES)
    ptr_c, bot_c = run_c()
    if {k: _build.LAUNCHES[k] - before[k] for k in names} != {k: int(k == names[2])
                                                             for k in names}:
        fail(f"the split-form {name} call did not launch the cluster TABLE mode alone")
    ptr_k, bot_k = run_k()
    (ptr_p, bot_p), plain_ms = once_ms(lambda: AC._wave_table_plain(
        b_d, l_d, *AC.flat_levels(lv_d, li_d), n_d, m_d, params))
    mask = valid_ptr_mask(n_d, m_d, ptr_c.shape[0])
    errs = {mode: (bool(torch.equal(ptr[mask], ptr_p[mask])),
                   float((bot.double() - bot_p.double()).abs().max()))
            for mode, ptr, bot in (("cluster", ptr_c, bot_c), ("pow", ptr_k, bot_k))}
    del ptr_p, bot_p, ptr_k, ptr_c
    (k1, k2), (c1, c2) = turns_ms(run_k, run_c)
    ms_k, ms_c = (k1 + k2) / 2, (c1 + c2) / 2
    for k in names:
        _build.LAUNCHES[k] = before[k]
    nd = N + tmpl.shape[1]
    print(f"  {name} [over the cap B={B} N={N} MP={tmpl.shape[1]}, {ctas} CTAs of up to "
          f"{levels.shape[2]} levels]: vs table twin: "
          + "; ".join(f"{mode.upper()} pointers {'equal' if eq else 'DIFFER'}, bottom "
                      f"max_abs_err {err}" for mode, (eq, err) in errs.items())
          + f"; POW {k1:.3f} / {k2:.3f} ms ({ms_k * 1e3 / nd:.4f} us/step), cluster TABLE "
          f"{c1:.3f} / {c2:.3f} ms ({ms_c * 1e3 / nd:.4f} us/step), in turns; plain "
          f"{plain_ms:.1f} ms", flush=True)
    if not all(eq and err == 0.0 for eq, err in errs.values()):
        fail(f"{name}: the cluster TABLE mode, the POW mode and the table twin disagree over "
             "the cap")
    words = 4 * int(mask.sum()) * tmpl.shape[1] + 4 * bot_c.numel() + 8 * B
    table_bytes = bins.size + lut.size * 4 + levels.size * 4 + tmpl.size * 4 + words
    results[name + "_cluster"] = {"max_abs_err": errs["cluster"][1], "ms": ms_c,
                                  "plain_ms": plain_ms, "pow_ms": ms_k,
                                  "us_per_step": ms_c * 1e3 / nd,
                                  **wave_bound(n_d, m_d, levels, table_bytes, True)}
    results[name].update(over_cap_ms=ms_k, over_cap_shape=[B, N, tmpl.shape[1]])


def viterbi_inputs(pm, B, T, rng, repeats, flank=50, unit=None):
    """(B, T) noisy segments of repeats/2..repeats units (c9orf72's, or
    ``unit``) between ``flank`` bases of the c9orf72 flanks, and their
    lengths."""
    import numpy as np
    import torch

    from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX

    obs = np.zeros((B, T), np.float32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(max(1, repeats // 2), repeats + 1))
        s = pm.generate_signal(PREFIX[-flank:] + (unit or REPEAT) * n + SUFFIX[:flank],
                               samples=8, noise=True, rng=rng).astype(np.float32)[:T]
        obs[b, : len(s)] = s
        lens[b] = len(s)
    dev = torch.device("cuda")
    return torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev)


def check_dense(pm, chm, shape_name, B, T, rng, results, repeats=REPEATS, flank=50,
                unit=None):
    """The dense Viterbi forward (row 7) against its twin: rows below each
    read's length, fin and acc bit-equal.  The wrapper must launch the
    mode ``dense_mode`` gives this SP (resident: a cluster of K CTAs a
    read; streamed past SP 512) and no other.  ``results``: where given,
    the kernel line's entry of that mode."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import viterbi_cuda as VC

    ph = VC.PaddedHMM(chm, torch.device("cuda"))
    k = VC.dense_mode(ph.sp)
    name = "viterbi_forward_dense_resident" if k else "viterbi_forward_dense"
    o_d, l_d = viterbi_inputs(pm, B, T, rng, repeats, flank, unit)
    run_k = lambda: VC.viterbi_forward_dense(o_d, l_d, ph)
    before = dict(_build.LAUNCHES)
    (sc_k, fin_k, acc_k), _ = once_ms(run_k)
    if {n: _build.LAUNCHES[n] - before[n] for n in DENSE} != {n: int(n == name) for n in DENSE}:
        fail(f"the dense forward at SP {ph.sp} did not launch the {name} mode alone")
    (sc_p, fin_p, acc_p), plain_ms = once_ms(lambda: VC._fwd_dense_plain(o_d, l_d, ph))
    live = torch.arange(T, device=o_d.device)[:, None] < l_d[None, :]
    err = max(float((sc_k[live] - sc_p[live]).abs().max()),
              float((fin_k - fin_p).abs().max()), float((acc_k - acc_p).abs().max()))
    del sc_p
    ms = cuda_ms(run_k, 3)
    for n in DENSE:
        _build.LAUNCHES[n] = before[n]
    steps = int(l_d.max())
    mode = f"resident, K={k}" if k else "streamed"
    print(f"  viterbi_forward_dense [{shape_name} B={B} T={T} SP={ph.sp}, {mode}]: max_abs_err "
          f"{err}; kernel {ms:.3f} ms ({ms * 1e3 / steps:.4f} us/step), plain {plain_ms:.1f} ms",
          flush=True)
    if err != 0.0:
        fail(f"dense forward kernel disagrees with its plain twin at the {shape_name} shape")
    if results is None:
        return
    sp = ph.sp
    steps_all = float(l_d.double().sum())
    # per step and state pair an add and a max; per state 8 for the
    # emission and the row-max rescale
    f32 = steps_all * (2 * sp * sp + 8 * sp)
    nbytes = 4 * (B * T + sp * sp + 6 * sp + steps_all * sp + B * sp + 2 * B)
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "us_per_step": ms * 1e3 / steps, **bound(nbytes, f32)}


def check_viterbi(pm, chm, shape_name, B, T, rng, results, repeats=REPEATS):
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import viterbi_cuda as VC

    dev = torch.device("cuda")
    ph = VC.PaddedHMM(chm, dev)
    o_d, l_d = viterbi_inputs(pm, B, T, rng, repeats)
    (sc_k, fin_k, acc_k), _ = once_ms(lambda: VC.viterbi_forward_factored(o_d, l_d, ph))
    (sc_p, fin_p, acc_p), plain_ms = once_ms(lambda: VC._fwd_plain(o_d, l_d, ph))
    live = torch.arange(T, device=dev)[:, None] < l_d[None, :]
    err = max(float((sc_k[live] - sc_p[live]).abs().max()),
              float((fin_k - fin_p).abs().max()), float((acc_k - acc_p).abs().max()))
    ms = cuda_ms(lambda: VC.viterbi_forward_factored(o_d, l_d, ph), 3)
    _build.LAUNCHES["viterbi_forward_factored"] = 0
    steps = int(l_d.max())  # the chain: one step a sample of the longest read
    print(f"  viterbi_forward_factored [{shape_name} B={B} T={T} SP={ph.sp}]: "
          f"max_abs_err {err}; kernel {ms:.3f} ms ({ms * 1e3 / steps:.4f} us/step), "
          f"plain {plain_ms:.1f} ms", flush=True)
    if err != 0.0:
        fail(f"factored forward kernel disagrees with its plain twin at the {shape_name} shape")
    sp = ph.sp
    live_cells = float(l_d.double().sum()) * sp
    diag_offs, chain_spec = ph.fspec
    n_rolls = len(diag_offs) + sum(len(a) + len(b) for a, b in chain_spec)
    # per (step, state): an add and a max per roll, 3 per chain (ramp in,
    # cummax, ramp out), 8 for the emission and the row-max rescale
    f32 = live_cells * (2 * n_rolls + 3 * len(chain_spec) + 8)
    nbytes = 4 * (B * T + live_cells + B * sp + B) + 4 * (n_rolls + len(chain_spec) + 5) * sp
    results["viterbi_forward_factored"] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                           "us_per_step": ms * 1e3 / steps, **bound(nbytes, f32)}

    last = torch.argmax(fin_k + ph.end, dim=1)
    run_k = lambda: VC.viterbi_backward_batch(sc_k, last, l_d, ph.transT)
    path_k, _ = once_ms(run_k)
    path_p, plain_ms = once_ms(lambda: VC._bwd_plain(sc_k, last, l_d, ph.transT))
    perr = int((path_k.to(torch.int64) - path_p.to(torch.int64)).abs().max())
    ms = cuda_ms(run_k, 3)
    _build.LAUNCHES["viterbi_backward_batch"] = 0
    print(f"  viterbi_backward_batch [{shape_name} B={B} T={T}]: max_abs_err {perr}; "
          f"kernel {ms:.3f} ms ({ms * 1e3 / steps:.4f} us/step), plain {plain_ms:.1f} ms",
          flush=True)
    if perr != 0:
        fail(f"backward kernel disagrees with its plain twin at the {shape_name} shape")
    # one score row and one transition row per visited step; 3 f32 ops a state
    nbytes = 4 * (live_cells + sp * sp + B * T + 2 * B)
    results["viterbi_backward_batch"] = {"max_abs_err": float(perr), "ms": ms,
                                         "plain_ms": plain_ms, "us_per_step": ms * 1e3 / steps,
                                         **bound(nbytes, 3 * live_cells)}


def check_viterbi_edges(pm, rng) -> None:
    """Rows 3-4 and 7 against their twins at their edge inputs
    (``synthetic.VITERBI_EDGES``, shared with the ``gpu`` tests):
    lengths below the backward's 16-row score ring and around the
    forward's 32-step obs chunks, constant obs (ties in every row), and
    an HMM of SP 512 (the dense forward's 8-CTA clusters).  Forward rows
    below each length, fin and acc bit-equal, paths equal.  These
    launches count toward no path."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import viterbi_cuda as VC
    from strique_tpu_torch.synthetic import VITERBI_EDGE_T, VITERBI_EDGES, viterbi_edge_case

    dev = torch.device("cuda")
    before = dict(_build.LAUNCHES)
    for label in VITERBI_EDGES:
        hmm, obs, lens = viterbi_edge_case(pm, label, rng)
        ph = VC.PaddedHMM(hmm, dev)
        o_d = torch.from_numpy(obs).to(dev)
        l_d = torch.from_numpy(lens).to(dev)
        sc, fin, acc = VC.viterbi_forward_factored(o_d, l_d, ph)
        sc_p, fin_p, acc_p = VC._fwd_plain(o_d, l_d, ph)
        live = torch.arange(VITERBI_EDGE_T, device=dev)[:, None] < l_d[None, :]
        fwd_ok = bool(torch.equal(sc[live], sc_p[live]) and torch.equal(fin, fin_p)
                      and torch.equal(acc, acc_p))
        last = torch.argmax(fin + ph.end, dim=1)
        path = VC.viterbi_backward_batch(sc, last, l_d, ph.transT)
        bwd_ok = bool(torch.equal(path, VC._bwd_plain(sc, last, l_d, ph.transT)))
        sc, fin, acc = VC.viterbi_forward_dense(o_d, l_d, ph)
        sc_p, fin_p, acc_p = VC._fwd_dense_plain(o_d, l_d, ph)
        dense_ok = bool(torch.equal(sc[live], sc_p[live]) and torch.equal(fin, fin_p)
                        and torch.equal(acc, acc_p))
        print(f"  viterbi edges [{label}: SP {ph.sp}, {hmm.n_states} states, lengths "
              f"{lens.tolist()}]: forward {'equal' if fwd_ok else 'DIFFERS'}, paths "
              f"{'equal' if bwd_ok else 'DIFFER'}, dense forward (K={VC.dense_mode(ph.sp)}) "
              f"{'equal' if dense_ok else 'DIFFERS'}", flush=True)
        if not (fwd_ok and bwd_ok and dense_ok):
            fail(f"a Viterbi kernel disagrees with its plain twin at the edge case {label!r}")
    if _build.LAUNCHES["viterbi_forward_dense_resident"] != before[
            "viterbi_forward_dense_resident"] + len(VITERBI_EDGES):
        fail("the edge cases' dense forwards did not run the resident mode")
    for k in ("viterbi_forward_factored", "viterbi_backward_batch", *DENSE):
        _build.LAUNCHES[k] = before[k]


def mod_inputs(pm, pm_mod, unit, B, T, rng):
    """(B, T) noisy repeat-state segments of a mod decode: 25-60 units of
    ``unit``, odd reads from the twin ``pm_mod``, clipped to the mod HMM's
    level range as the counter clips them; and their lengths."""
    import numpy as np
    import torch

    lo, hi = min(pm.model_min, pm_mod.model_min), max(pm.model_max, pm_mod.model_max)
    obs = np.zeros((B, T), np.float32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(25, 61))
        s = (pm_mod if b % 2 else pm).generate_signal(unit * n, samples=8, noise=True, rng=rng)
        s = np.clip(s, lo, hi).astype(np.float32)[:T]
        obs[b, : len(s)] = s
        lens[b] = len(s)
    dev = torch.device("cuda")
    return torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev)


def check_viterbi_mod(pm, pm_mod, unit, shape_name, B, T, rng, results):
    """The factored forward in its diagonal-only slot layout (the mod
    HMM's) and the backward, each against its twin at a mod decode's
    shape: rows below each length, fin and acc bit-equal, paths equal.
    The wrapper must launch the diagonal-only layout alone; the dense
    forward's ms on the same inputs stands beside it.  ``results``: where
    given, the kernel line's entry of the layout."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.hmm.models import build_repeat_mod
    from strique_tpu_torch.ops import viterbi_cuda as VC

    dev = torch.device("cuda")
    chm = build_repeat_mod(unit, pm, pm_mod)
    ph = VC.PaddedHMM(chm, dev)
    name = "viterbi_forward_factored_diag"
    if ph.fwd_layout is None or ph.fwd_layout.name != name:
        fail(f"the mod HMM of a {len(unit)}-base unit is not staged in the diagonal-only layout")
    o_d, l_d = mod_inputs(pm, pm_mod, unit, B, T, rng)
    fwd = ("viterbi_forward_factored", name, *DENSE)
    before = dict(_build.LAUNCHES)
    run_k = lambda: VC.viterbi_forward_factored(o_d, l_d, ph)
    (sc_k, fin_k, acc_k), _ = once_ms(run_k)
    if {n: _build.LAUNCHES[n] - before[n] for n in fwd} != {n: int(n == name) for n in fwd}:
        fail(f"the mod HMM's forward at SP {ph.sp} did not launch the diagonal-only layout alone")
    (sc_p, fin_p, acc_p), plain_ms = once_ms(lambda: VC._fwd_plain(o_d, l_d, ph))
    live = torch.arange(T, device=dev)[:, None] < l_d[None, :]
    err = max(float((sc_k[live] - sc_p[live]).abs().max()),
              float((fin_k - fin_p).abs().max()), float((acc_k - acc_p).abs().max()))
    del sc_p
    ms = cuda_ms(run_k, 3)
    dense_ms = cuda_ms(lambda: VC.viterbi_forward_dense(o_d, l_d, ph), 3)
    last = torch.argmax(fin_k + ph.end, dim=1)
    run_b = lambda: VC.viterbi_backward_batch(sc_k, last, l_d, ph.transT)
    path_k, _ = once_ms(run_b)
    path_p, bwd_plain_ms = once_ms(lambda: VC._bwd_plain(sc_k, last, l_d, ph.transT))
    perr = int((path_k.to(torch.int64) - path_p.to(torch.int64)).abs().max())
    bwd_ms = cuda_ms(run_b, 3)
    sc_d, fin_d, _ = VC.viterbi_forward_dense(o_d, l_d, ph)
    path_d = VC.viterbi_backward_batch(sc_d, torch.argmax(fin_d + ph.end, dim=1), l_d, ph.transT)
    same = bool(torch.equal(path_d, path_k))
    for n in (*fwd, "viterbi_backward_batch"):
        _build.LAUNCHES[n] = before[n]
    steps = int(l_d.max())
    print(f"  {name} [{shape_name} B={B} T={T} SP={ph.sp}, {chm.n_states} states, "
          f"{len(ph.fspec[0])} diagonals]: max_abs_err {err}; kernel {ms:.3f} ms "
          f"({ms * 1e3 / steps:.4f} us/step), dense resident forward on the same inputs "
          f"{dense_ms:.3f} ms (K={VC.dense_mode(ph.sp)}), plain {plain_ms:.1f} ms", flush=True)
    print(f"  viterbi_backward_batch [{shape_name} mod HMM B={B} T={T} SP={ph.sp}]: max_abs_err "
          f"{perr}; kernel {bwd_ms:.3f} ms, plain {bwd_plain_ms:.1f} ms; the dense forward's "
          f"paths {'equal' if same else 'DIFFER'}", flush=True)
    if err != 0.0:
        fail(f"the diagonal-only forward disagrees with its plain twin at the {shape_name} shape")
    if perr != 0:
        fail(f"the backward kernel disagrees with its plain twin on the {shape_name} mod HMM")
    if not same:
        fail(f"the dense and factored forwards' paths differ on the {shape_name} mod HMM")
    if results is None:
        return
    sp = ph.sp
    live_cells = float(l_d.double().sum()) * sp
    n_rolls = len(ph.fspec[0])
    # per (step, state): an add and a max per roll, 8 for the emission and
    # the row-max rescale
    f32 = live_cells * (2 * n_rolls + 8)
    nbytes = 4 * (B * T + live_cells + B * sp + B) + 4 * (n_rolls + 5) * sp
    results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "us_per_step": ms * 1e3 / steps, "dense_ms": dense_ms,
                     "backward_ms": bwd_ms, "shape": f"B={B} T={T} SP={sp}",
                     **bound(nbytes, f32)}


def factored_bound(ph, l_d, B: int, T: int) -> dict:
    """``bound()`` of the factored forward on these inputs: per (step,
    state) an add and a max per roll, 3 per chain (ramp in, cummax, ramp
    out), 8 for the emission and the row-max rescale; the obs, the live
    rows, fin and acc, and the step-invariant tables."""
    sp = ph.sp
    live_cells = float(l_d.double().sum()) * sp
    diag_offs, chain_spec = ph.fspec
    n_rolls = len(diag_offs) + sum(len(a) + len(b) for a, b in chain_spec)
    f32 = live_cells * (2 * n_rolls + 3 * len(chain_spec) + 8)
    nbytes = 4 * (B * T + live_cells + B * sp + B) + 4 * (n_rolls + len(chain_spec) + 5) * sp
    return bound(nbytes, f32)


def backward_bound(sp: int, l_d, B: int, T: int) -> dict:
    """``bound()`` of the backward: one score row and one transition row
    per visited step, 3 f32 operations a state."""
    live_cells = float(l_d.double().sum()) * sp
    return bound(4 * (live_cells + sp * sp + B * T + 2 * B), 3 * live_cells)


def check_wide(label: str, chm, o_d, l_d, results=None) -> None:
    """Rows 3-4's wide variants (SP past 1024) against their twins: the
    forward in the HMM's slot layout (rows below each length, fin and acc
    bit-equal) and the backward (paths equal), each wrapper launching its
    wide counter alone; ms and us a step of each, the bound and the twin's
    ms.  ``results``: where given, the kernel line's entries of the
    layout's wide forward and of the wide backward."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import viterbi_cuda as VC

    ph = VC.PaddedHMM(chm, o_d.device)
    layout = ph.fwd_layout
    B, T = o_d.shape
    keys = (layout.name, layout.wide_name, "viterbi_backward_batch", "viterbi_backward_wide",
            *DENSE)
    before = dict(_build.LAUNCHES)
    run_f = lambda: VC.viterbi_forward_factored(o_d, l_d, ph)
    (sc_k, fin_k, acc_k), _ = once_ms(run_f)
    last = torch.argmax(fin_k + ph.end, dim=1)
    run_b = lambda: VC.viterbi_backward_batch(sc_k, last, l_d, ph.transT)
    path_k, _ = once_ms(run_b)
    want = {k: int(k in (layout.wide_name, "viterbi_backward_wide")) for k in keys}
    if {k: _build.LAUNCHES[k] - before[k] for k in keys} != want:
        fail(f"the Viterbi pair at SP {ph.sp} ({label}) did not launch the wide variants alone")
    (sc_p, fin_p, acc_p), plain_ms = once_ms(lambda: VC._fwd_plain(o_d, l_d, ph))
    live = torch.arange(T, device=o_d.device)[:, None] < l_d[None, :]
    err = max(float((sc_k[live] - sc_p[live]).abs().max()),
              float((fin_k - fin_p).abs().max()), float((acc_k - acc_p).abs().max()))
    del sc_p
    path_p, bwd_plain_ms = once_ms(lambda: VC._bwd_plain(sc_k, last, l_d, ph.transT))
    perr = int((path_k.to(torch.int64) - path_p.to(torch.int64)).abs().max())
    ms = cuda_ms(run_f, 3)
    bwd_ms = cuda_ms(run_b, 3)
    for k in keys:
        _build.LAUNCHES[k] = before[k]
    steps = int(l_d.max())
    fb, bb = factored_bound(ph, l_d, B, T), backward_bound(ph.sp, l_d, B, T)
    print(f"  {layout.wide_name} [{label}: B={B} T={T} SP={ph.sp}, {chm.n_states} states]: "
          f"max_abs_err {err}; kernel {ms:.3f} ms ({ms * 1e3 / steps:.4f} us/step), bound "
          f"{fb['bound_ms']:.4f} ms ({fb['bound_by']}), plain {plain_ms:.1f} ms", flush=True)
    print(f"  viterbi_backward_wide [{label}: B={B} T={T} SP={ph.sp}]: max_abs_err {perr}; "
          f"kernel {bwd_ms:.3f} ms ({bwd_ms * 1e3 / steps:.4f} us/step), bound "
          f"{bb['bound_ms']:.4f} ms ({bb['bound_by']}), plain {bwd_plain_ms:.1f} ms", flush=True)
    if err != 0.0:
        fail(f"the wide forward disagrees with its plain twin ({label})")
    if perr != 0:
        fail(f"the wide backward disagrees with its plain twin ({label})")
    if results is None:
        return
    shape = f"B={B} T={T} SP={ph.sp}"
    results[layout.wide_name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                 "us_per_step": ms * 1e3 / steps, "shape": shape, **fb}
    if layout.chain:
        results["viterbi_backward_wide"] = {"max_abs_err": float(perr), "ms": bwd_ms,
                                            "plain_ms": bwd_plain_ms,
                                            "us_per_step": bwd_ms * 1e3 / steps,
                                            "shape": shape, **bb}


def wide_path_inputs(pm, pm_mod, unit: str, units: int, B: int, T: int, rng, mod: bool):
    """(B, T) noisy segments of the wide path: ``units`` units of ``unit``
    between the 50-base flanks of the repeat HMM, or (``mod``) the units
    alone, odd reads from the twin ``pm_mod``, clipped to the level range
    as the counter clips them; and their lengths."""
    import numpy as np
    import torch

    from strique_tpu_torch.synthetic import PREFIX, SUFFIX

    lo, hi = min(pm.model_min, pm_mod.model_min), max(pm.model_max, pm_mod.model_max)
    obs = np.zeros((B, T), np.float32)
    lens = np.zeros(B, np.int32)
    for b in range(B):
        seq = unit * units if mod else PREFIX[-50:] + unit * units + SUFFIX[:50]
        s = (pm_mod if mod and b % 2 else pm).generate_signal(seq, samples=8, noise=True,
                                                              rng=rng)
        s = (np.clip(s, lo, hi) if mod else s).astype(np.float32)[:T]
        obs[b, : len(s)] = s
        lens[b] = len(s)
    dev = torch.device("cuda")
    return torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev)


def check_viterbi_wide(pm, pm_mod, seed: int, results) -> None:
    """Phase 3's wide Viterbi checks: the cases of ``WIDE_CASES`` (B 8, T
    1024), then the kernel line's shapes: the 150-base unit's repeat HMM
    (SP 1152) on 8 segments of phase 4f's reads' length, and the 260-base
    unit's mod HMM (SP 1152) on 8 repeat-state segments of 3 units."""
    import numpy as np
    import torch

    from strique_tpu_torch.hmm.models import build_flanked_repeat, build_repeat_mod
    from strique_tpu_torch.synthetic import (PREFIX, SUFFIX, WIDE_MOD_UNIT_BASES,
                                             WIDE_MOD_UNITS, WIDE_UNIT_BASES, random_unit,
                                             viterbi_wide_case)

    dev = torch.device("cuda")
    rng = np.random.default_rng(seed + 110)
    for label in WIDE_CASES:
        chm, obs, lens = viterbi_wide_case(pm, pm_mod, label, rng)
        check_wide(label, chm, torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev))
        torch.cuda.empty_cache()
    unit = random_unit(WIDE_UNIT_BASES, 5)
    chm = build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm)
    o_d, l_d = wide_path_inputs(pm, pm_mod, unit, WIDE_UNITS, WIDE_READS, 7168, rng, False)
    check_wide("phase 4f's shape", chm, o_d, l_d, results)
    unit = random_unit(WIDE_MOD_UNIT_BASES, WIDE_MOD_UNIT_BASES)
    o_d, l_d = wide_path_inputs(pm, pm_mod, unit, WIDE_MOD_UNITS, 8, 6656, rng, True)
    check_wide("phase 4f's mod shape", build_repeat_mod(unit, pm, pm_mod), o_d, l_d, results)


def written_slots(n_act, m, nd: int, ckpt_steps: int):
    """(n_ck, B) mask of the checkpoint slots a row's pass 1 writes (it
    stops at round_up(n + m, 8)); ``m`` an int or the (B,) lengths."""
    import torch

    stop = torch.clamp_max((n_act.to(torch.int64) + m + 7) // 8 * 8, nd)
    g = torch.arange(nd // ckpt_steps, device=n_act.device)[:, None]
    return (g + 1) * ckpt_steps <= stop[None, :]


def check_longread(templates, shape_name, B, N, params, ckpt_steps, cold_odd, rng,
                   results=None, twin=True):
    """Kernel rows 5 and 6 on morph-form reads, in the row layout the
    two-pass route launches them with: one shared template
    (``templates`` of one), or ``templates[0]`` on the first half of the
    rows and ``templates[1]`` on the second, each row with its own
    levels, level indices and length (the per-row POW template stride),
    as ``_two_pass_rows`` runs both flanks of a batch.

    Where the templates fit the score table (one CTA a row, or the
    cluster ``wave_table_ctas`` gives): the TABLE-mode kernels against
    their table twins (one plain run each), and the POW-mode kernels on
    the decoded f32 against the same runs.  Past every table (the POW
    mode alone): the POW-mode kernels against their own twins
    (``_ckpt_plain``, ``_window_plain``).  Bottom taps, written
    checkpoint slots and written pointer words equal.

    With ``cold_odd`` the odd rows carry their template near the
    signal's start (their pass-2 window starts cold when the span bound
    allows it), the others in its second half.  ``results``: where
    given, the times and bounds enter the kernel line.  Without
    ``twin`` (a shape where the twins would take minutes) the TABLE
    modes are held to the POW kernels alone, and plain_ms is None.
    """
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC
    from strique_tpu_torch.synthetic import quantise

    dev = torch.device("cuda")
    if len(templates) > 1:
        rows, ms_t = AC.pad_template_rows(list(templates))
        split = [B // 2, B - B // 2]
        tmpl_np, ms = np.repeat(rows, split, axis=0), np.repeat(ms_t, split)
        row_t = [templates[0]] * split[0] + [templates[1]] * split[1]
    else:
        tmpl_np, m1 = AC.pad_template(templates[0])
        ms, row_t = np.array([m1]), [templates[0]] * B
    ctas = AC.wave_table_ctas(tmpl_np)
    table = ctas > 0
    form = "_cluster" if ctas > 1 else "_table"  # the TABLE launches' counters
    sig = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for b, t in enumerate(row_t):
        m = len(t)
        lo, hi = (0, min(600, N - m)) if cold_odd and b % 2 else (min(N // 2, N - m), N - m)
        st = int(rng.integers(lo, max(lo + 1, hi)))
        sig[b, st : st + m] = t + rng.normal(0, 1.0, m).astype(np.float32)
    bins, lut = quantise(sig, rng)
    b_d, l_d = torch.from_numpy(bins).to(dev), torch.from_numpy(lut).to(dev)
    n_d = torch.from_numpy(rng.integers(N - N // 8, N + 1, B).astype(np.int32)).to(dev)
    entry = dict(_build.LAUNCHES)
    st_k = AL._pass1_rows(AC.morph_decode(b_d, l_d), n_d, tmpl_np, ms, params, ckpt_steps)
    st = (AL._pass1_rows(b_d, n_d, tmpl_np, ms, params, ckpt_steps, lut=l_d, ctas=ctas)
          if table else st_k)
    if (_build.LAUNCHES["align_forward_ckpt" + form] != entry["align_forward_ckpt" + form] + table
            or _build.LAUNCHES["align_forward_ckpt"] != entry["align_forward_ckpt"] + 1):
        fail("pass 1 on morph input did not launch the TABLE mode, or on f32 the POW mode")
    cks, mp, nd, m_rows = st_k["ckpt_steps"], st_k["mp"], st_k["N"] + st_k["mp"], st_k["m_rows"]
    m_arg = m_rows if len(templates) > 1 else int(ms[0])
    chunks = cks // AC.CHUNK
    runs = {"pow": lambda: AC.align_forward_ckpt(st_k["sig"], n_d, st_k["tmpl"], params, m_arg,
                                                 chunks)}
    if table:
        runs["table"] = lambda: AC.align_forward_ckpt_morph(b_d, l_d, n_d, st["levels"],
                                                            st["lidx"], params, m_arg, chunks, nd)
        levels, lidx = st["levels"].cpu().numpy(), st["lidx"].cpu().numpy()
        flat = (AC.flat_levels(st["levels"], st["lidx"]) if ctas > 1
                else (st["levels"], st["lidx"]))
    if not twin:
        (bot_p, ck_p), plain_ms = (st_k["bottom_steps"], st_k["ckpts"]), None
    elif table:
        (bot_p, ck_p), plain_ms = once_ms(lambda: AC._ckpt_table_plain(
            b_d, l_d, *flat, n_d, m_rows, params, cks, nd))
    else:
        levels, lidx = AC.template_levels(tmpl_np)
        (bot_p, ck_p), plain_ms = once_ms(lambda: AC._ckpt_plain(
            st_k["sig"], st_k["tmpl"], n_d, m_rows, params, cks))
    slots = written_slots(n_d, m_rows, nd, cks)
    errs = {mode: (all(torch.equal(a[slots], c[slots]) for a, c in zip(s_["ckpts"], ck_p)),
                   float((s_["bottom_steps"].double() - bot_p.double()).abs().max()))
            for mode, s_ in (("table", st), ("pow", st_k))[not table:]}
    if table:
        errs["table-pow"] = (all(torch.equal(a[slots], c[slots])
                                 for a, c in zip(st["ckpts"], st_k["ckpts"])),
                             float((st["bottom_steps"].double()
                                    - st_k["bottom_steps"].double()).abs().max()))
    ms_ = {mode: cuda_ms(run, 3) for mode, run in runs.items()}
    ref = ("the POW kernel" if not twin else "table twin" if table else "_ckpt_plain")
    plain = "" if plain_ms is None else f", plain {plain_ms:.1f} ms"
    lv_form = (f"{ctas} CTAs of up to {levels.shape[2]} levels" if ctas > 1
               else f"U={levels.shape[1]}")
    print(f"  align_forward_ckpt [{shape_name} B={B} N={N} (ND {nd}) MP={mp} {lv_form} "
          f"ckpt_steps={cks}, {'per-row' if len(templates) > 1 else 'one'} template]: "
          f"{int(slots.sum())} written slots; vs {ref}: "
          + "; ".join(f"{mode}: slots {'equal' if eq else 'DIFFER'}, bottom max_abs_err {err}"
                      for mode, (eq, err) in errs.items())
          + "".join(f"; {mode.upper()} {t:.3f} ms ({t * 1e3 / nd:.4f} us/step)"
                    for mode, t in ms_.items())
          + plain, flush=True)
    if not all(eq and err == 0.0 for eq, err in errs.values()):
        fail(f"align_forward_ckpt: the kernels and the plain twin disagree at the {shape_name} "
             f"shape")
    cells = wave_cells(n_d, m_rows)
    ck_bytes = 4 * (bot_p.numel() + 4 * int(slots.sum()) * mp) + 8 * B
    entries = table_entries(levels, B)
    ckpt_res = {"pow": {"max_abs_err": errs["pow"][1], "ms": ms_["pow"], "plain_ms": plain_ms,
                        "us_per_step": ms_["pow"] * 1e3 / nd,
                        **bound(4 * (st_k["sig"].numel() + st_k["tmpl"].numel()) + ck_bytes,
                                CKPT_F32_PER_CELL * cells, POW_F64_PER_CELL * cells)}}
    if table:
        ckpt_res["table"] = {
            "max_abs_err": errs["table"][1], "ms": ms_["table"], "plain_ms": plain_ms,
            "us_per_step": ms_["table"] * 1e3 / nd,
            **bound(bins.size + 1024 * B + 4 * (levels.size + lidx.size) + ck_bytes,
                    CKPT_TABLE_F32_PER_CELL * cells + SCORE_F32 * entries,
                    POW_F64_PER_CELL * entries)}
    del ck_p, bot_p

    w_k = AL.window_inputs(st_k)
    w = AL.window_inputs(st) if table else w_k
    W, m_max = st_k["W"], st_k["m"]
    n_cold = int(w_k["cold"].sum())
    args = (w["t0"], w["state4"], w["cold"], w["steps_needed"], st["levels"], st["lidx"],
            params) if table else None
    pow_args = (w_k["sig_win"], w_k["r_init"], w_k["state4"], w_k["cold"], w_k["steps_needed"],
                st_k["tmpl"], params)
    runs = {"pow": lambda: AC.align_window_from_state(*pow_args, m_max)}
    if table:
        runs["table"] = lambda: AC.align_window_from_state_morph(b_d, l_d, *args, m_max, W)
    before = dict(_build.LAUNCHES)
    ptrs = {mode: run() for mode, run in runs.items()}
    if (_build.LAUNCHES["align_window_from_state"] != before["align_window_from_state"] + 1
            or _build.LAUNCHES["align_window_from_state" + form]
            != before["align_window_from_state" + form] + table):
        fail("the window calls did not launch one POW (and where the table fits one TABLE) "
             "window kernel")
    if not twin:
        ptr_p, plain_ms = ptrs["pow"], None
    elif table:
        ptr_p, plain_ms = once_ms(lambda: AC._window_table_plain(b_d, l_d, *args[:4], *flat,
                                                                 params, W))
    else:
        ptr_p, plain_ms = once_ms(lambda: AC._window_plain(*pow_args))
    words = valid_ptr_mask(w_k["steps_needed"], torch.zeros_like(n_d), ptr_p.shape[0])
    eq = {mode: bool(torch.equal(ptr[words], ptr_p[words])) for mode, ptr in ptrs.items()}
    if results is not None:  # the traceback on the window plane, in window steps
        check_traceback(ptrs["table" if table else "pow"], (w["j_end"] - w["t0"]).to(torch.int32),
                        m_rows.to(torch.int32), f"{shape_name} two-pass window plane", results,
                        m_out=m_max, key="two_pass_window")
    del ptrs, ptr_p
    ms_ = {mode: cuda_ms(run, 3) for mode, run in runs.items()}
    steps = _round_up8(int(w_k["steps_needed"].max()))
    for k in TABLE_TWO_PASS + POW_TWO_PASS + CLUSTER_TWO_PASS:
        _build.LAUNCHES[k] = entry[k]
    ref = ("the POW kernel" if not twin else "_window_table_plain" if table
           else "_window_plain")
    plain = "" if plain_ms is None else f", plain {plain_ms:.1f} ms"
    print(f"  align_window_from_state [{shape_name} B={B} W={W} MP={mp}, {n_cold} cold / "
          f"{B - n_cold} warm rows, {steps} steps run]: vs {ref}: "
          + "; ".join(f"{mode.upper()} pointers {'equal' if e else 'DIFFER'}"
                      for mode, e in eq.items())
          + "".join(f"; {mode.upper()} {t:.3f} ms ({t * 1e3 / steps:.4f} us/step)"
                    for mode, t in ms_.items())
          + plain, flush=True)
    if not all(eq.values()):
        fail(f"align_window_from_state: the kernels and the plain twin disagree at the "
             f"{shape_name} shape")
    if cold_odd and not 0 < n_cold < B:
        fail(f"the {shape_name} shape was meant to cover cold and warm windows, got {n_cold} cold")
    if results is None:
        return
    cells = wave_cells(w_k["steps_needed"], m_rows)
    # pointer words written, the restart state read, t0 / steps / cold
    win_bytes = 4 * int(words.sum()) * mp + 16 * B * mp + 12 * B
    samples = float(torch.clamp_max(w_k["steps_needed"].double() + mp, N).sum())
    sig_bytes = 4 * (w_k["sig_win"].numel() + w_k["r_init"].numel() + st_k["tmpl"].numel())
    results["align_forward_ckpt"] = ckpt_res["pow"]
    results["align_window_from_state"] = {
        "max_abs_err": 0.0 if eq["pow"] else float("inf"), "ms": ms_["pow"],
        "plain_ms": plain_ms, "us_per_step": ms_["pow"] * 1e3 / steps,
        **bound(sig_bytes + win_bytes, WAVE_F32_PER_CELL * cells, POW_F64_PER_CELL * cells)}
    if table:
        results["align_forward_ckpt" + form] = ckpt_res["table"]
        results["align_window_from_state" + form] = {
            "max_abs_err": 0.0 if eq["table"] else float("inf"), "ms": ms_["table"],
            "plain_ms": plain_ms, "us_per_step": ms_["table"] * 1e3 / steps,
            **bound(samples + 1024 * B + 4 * (levels.size + lidx.size) + win_bytes,
                    TABLE_F32_PER_CELL * cells + SCORE_F32 * entries, POW_F64_PER_CELL * entries)}


def check_sweep(seed: int, device="cuda") -> dict:
    """The AlignParams sweep (``synthetic.sweep_cases``: the reference's
    tests/test_fuzz_params.py corners, B 8, N 256, M 20), each corner's
    reads in morph form: rows 1 and 2 (one template; the template and its
    reverse over the two halves of the rows) and row 8, each in the TABLE
    mode against its table twin and in the POW mode on the decoded f32
    against its POW twin, TABLE and POW against each other; the diagonal
    traceback on rows 1-2's planes and the column one on row 8's; where
    ``wave_span_bound_steps`` gives a bound, rows 5-6 in both modes
    (``ckpt_steps`` 128) against their twins and the diagonal traceback
    on the window plane.  Written pointer words, checkpoint slots and
    traceback outputs equal, f32 bit-equal.  The launches are put back
    as they were.  Returns the counts of corners and checks."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC
    from strique_tpu_torch.synthetic import quantise, sweep_cases

    dev = torch.device(device)
    entry = dict(_build.LAUNCHES)
    t_start = time.perf_counter()
    n_checks = n_two_pass = 0
    cases = sweep_cases()

    def tb_equal(ptr, j_end, m_d, col=False):
        m_out = int(m_d.max())
        got = AL.traceback_pointers(ptr, j_end, m_out, packed=True if col else "diag",
                                    m_start=m_d)
        ref = AL._traceback_plain(ptr, j_end, m_d, m_out, col=col)
        return all(torch.equal(got[k], ref[k]) for k in ("is_gap", "jpos", "j_begin"))

    for k, (p, sig, na, template) in enumerate(cases):
        B, N = sig.shape
        bins, lut = quantise(sig, np.random.default_rng(seed + 900 + k))
        b_d, l_d = torch.from_numpy(bins).to(dev), torch.from_numpy(lut).to(dev)
        n_d = torch.from_numpy(na).to(dev)
        s_d = AC.morph_decode(b_d, l_d)
        tmpl1, m = AC.pad_template(template)
        rows, ms = AC.pad_template_rows([template, template[::-1].copy()])
        halves = [B // 2, B - B // 2]
        ok = {}
        for row, tmpl_np, m_np in (
                (1, tmpl1, np.full(B, m, np.int32)),
                (2, np.repeat(rows, halves, axis=0), np.repeat(ms, halves).astype(np.int32))):
            levels, lidx = AC.template_levels(tmpl_np)
            if AC.wave_score_mode(levels.shape[1], tmpl_np.shape[1]) != "table":
                fail(f"sweep corner {k}: the template does not fit the wave's score table")
            lv, li, t_d, m_d = (torch.from_numpy(x).to(dev) for x in (levels, lidx, tmpl_np,
                                                                        m_np))
            if row == 1:
                ptr_t, bot_t = AC.align_forward_wave_morph(b_d, l_d, n_d, lv, li, p, m)
                ptr_k, bot_k = AC.align_forward_wave(s_d, n_d, t_d, p, m)
            else:
                ptr_t, bot_t = AC.align_forward_wave_multi_morph(b_d, l_d, n_d, lv, li, m_d, p)
                ptr_k, bot_k = AC.align_forward_wave_multi(s_d, n_d, t_d, m_d, p)
            ptr_pt, bot_pt = AC._wave_table_plain(b_d, l_d, lv, li, n_d, m_d, p)
            ptr_pk, bot_pk = AC._wave_plain(s_d, t_d, n_d, m_d, p)
            mask = valid_ptr_mask(n_d, m_d, ptr_t.shape[0])
            for mode, (a, ab), (r, rb) in (("TABLE", (ptr_t, bot_t), (ptr_pt, bot_pt)),
                                           ("POW", (ptr_k, bot_k), (ptr_pk, bot_pk)),
                                           ("TABLE-POW", (ptr_t, bot_t), (ptr_k, bot_k))):
                ok[f"row {row} {mode}"] = (torch.equal(a[mask], r[mask])
                                           and torch.equal(ab, rb))
            j_end, _ = AL._end_columns(bot_t, m_d, p)
            ok[f"row {row} traceback"] = tb_equal(ptr_t, j_end, m_d)
        levels, lidx = AC.template_levels(tmpl1)
        if AC.col_score_mode(levels.shape[1], tmpl1.shape[1]) != "table":
            fail(f"sweep corner {k}: the template does not fit the column score table")
        lv, li, t_d = (torch.from_numpy(x).to(dev) for x in (levels, lidx, tmpl1))
        ptr_t, bot_t = AC.align_forward_col_morph(b_d, l_d, n_d, lv, li, p, m)
        ptr_k, bot_k = AC.align_forward_col(s_d, n_d, t_d, p, m)
        ptr_pt, bot_pt = AC._col_table_plain(b_d, l_d, lv, li, n_d, p, m)
        ptr_pk, bot_pk = AC._col_plain(s_d, t_d, n_d, p, m)
        mask = valid_ptr_mask(n_d, torch.zeros_like(n_d), ptr_t.shape[0])
        for mode, (a, ab), (r, rb) in (("TABLE", (ptr_t, bot_t), (ptr_pt, bot_pt)),
                                       ("POW", (ptr_k, bot_k), (ptr_pk, bot_pk)),
                                       ("TABLE-POW", (ptr_t, bot_t), (ptr_k, bot_k))):
            ok[f"row 8 {mode}"] = torch.equal(a[mask], r[mask]) and torch.equal(ab, rb)
        b0 = torch.full((B, 1), float(AL._b0(p, m)), device=dev)
        j_end = torch.argmax(torch.cat([b0, bot_t], dim=1), dim=1).to(torch.int32)
        m_d = torch.full((B,), m, dtype=torch.int32, device=dev)
        ok["row 8 traceback"] = tb_equal(ptr_t, j_end, m_d, col=True)
        if AC.wave_span_bound_steps(p, m) is not None:
            n_two_pass += 1
            ms1 = np.array([m])
            st_t = AL._pass1_rows(b_d, n_d, tmpl1, ms1, p, 128, lut=l_d)
            st_k = AL._pass1_rows(s_d, n_d, tmpl1, ms1, p, 128)
            cks, nd = st_k["ckpt_steps"], st_k["N"] + st_k["mp"]
            bot_pt, ck_pt = AC._ckpt_table_plain(b_d, l_d, st_t["levels"], st_t["lidx"], n_d,
                                                 st_t["m_rows"], p, cks, nd)
            bot_pk, ck_pk = AC._ckpt_plain(st_k["sig"], st_k["tmpl"], n_d, st_k["m_rows"], p,
                                           cks)
            slots = written_slots(n_d, st_k["m_rows"], nd, cks)
            for mode, st, bot_p, ck_p in (("TABLE", st_t, bot_pt, ck_pt),
                                          ("POW", st_k, bot_pk, ck_pk)):
                ok[f"row 5 {mode}"] = (torch.equal(st["bottom_steps"], bot_p) and all(
                    torch.equal(a[slots], c[slots]) for a, c in zip(st["ckpts"], ck_p)))
            w_t, w_k = AL.window_inputs(st_t), AL.window_inputs(st_k)
            W, mx = st_k["W"], st_k["m"]
            wt = (w_t["t0"], w_t["state4"], w_t["cold"], w_t["steps_needed"], st_t["levels"],
                  st_t["lidx"], p)
            wk = (w_k["sig_win"], w_k["r_init"], w_k["state4"], w_k["cold"],
                  w_k["steps_needed"], st_k["tmpl"], p)
            ptr_t = AC.align_window_from_state_morph(b_d, l_d, *wt, mx, W)
            ptr_k = AC.align_window_from_state(*wk, mx)
            words = valid_ptr_mask(w_k["steps_needed"], torch.zeros_like(n_d), ptr_k.shape[0])
            ok["row 6 TABLE"] = torch.equal(
                ptr_t[words], AC._window_table_plain(b_d, l_d, *wt, W)[words])
            ok["row 6 POW"] = torch.equal(ptr_k[words], AC._window_plain(*wk)[words])
            ok["row 6 TABLE-POW"] = torch.equal(ptr_t[words], ptr_k[words])
            ok["row 6 traceback"] = tb_equal(ptr_t, (w_t["j_end"] - w_t["t0"]).to(torch.int32),
                                             st_t["m_rows"].to(torch.int32))
        n_checks += len(ok)
        bad = [name for name, good in ok.items() if not good]
        if bad:
            fail(f"sweep corner {k} ({p}): {', '.join(bad)} disagree with the plain twins")
    for name in entry:
        _build.LAUNCHES[name] = entry[name]
    dt = time.perf_counter() - t_start
    print(f"  AlignParams sweep: {len(cases)} corners (B 8, N 256, M 20; {n_two_pass} with a "
          f"span bound, rows 5-6 at ckpt_steps 128), {n_checks} kernel-vs-twin checks, all "
          f"equal (integer outputs equal, f32 bit-equal); {dt:.1f} s", flush=True)
    return {"corners": len(cases), "two_pass": n_two_pass, "checks": n_checks, "s": dt}


def _round_up8(x: int) -> int:
    return (x + 7) // 8 * 8


def check_ckpt_ultra(template, N, params, rng, results) -> None:
    """Row 5 at the ultra-long shape (N of the bucket, ckpt_steps 16384),
    8 and 64 rows: the TABLE-mode kernel against the POW-mode kernel on
    the decoded f32 (zero-padded to ND - MP), bottom taps and written
    checkpoint slots bit-equal.  (The twin would take minutes here; both
    modes are held to it at the small and bench shapes.)"""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC

    out = {}
    for B in (8, 64):
        (levels, _, tmpl, _, _), dev_in = wave_inputs((template,), False, B, N, rng,
                                                      n_lo=N - N // 8)
        b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
        m, mp = int(m_d[0]), tmpl.shape[1]
        chunks, cks, nd = AL._ckpt_geometry(N, mp, AL.CKPT_STEPS)
        before = dict(_build.LAUNCHES)
        (bot_t, ck_t), ms_t = once_ms(lambda: AC.align_forward_ckpt_morph(
            b_d, l_d, n_d, lv_d, li_d, params, m, chunks, nd))
        s_d = torch.nn.functional.pad(AC.morph_decode(b_d, l_d), (0, nd - mp - N))
        (bot_k, ck_k), ms_k = once_ms(lambda: AC.align_forward_ckpt(s_d, n_d, t_d, params, m,
                                                                      chunks))
        if any(_build.LAUNCHES[k] != before[k] + 1 for k in ("align_forward_ckpt",
                                                             "align_forward_ckpt_table")):
            fail("the ultra-long pass-1 calls did not launch one TABLE and one POW kernel")
        for k in POW_TWO_PASS + TABLE_TWO_PASS:
            _build.LAUNCHES[k] = before[k]
        slots = written_slots(n_d, m, nd, cks)
        eq = all(torch.equal(a[slots], c[slots]) for a, c in zip(ck_t, ck_k))
        err = float((bot_t.double() - bot_k.double()).abs().max())
        del bot_t, ck_t, bot_k, ck_k, s_d
        torch.cuda.empty_cache()
        print(f"  align_forward_ckpt [ultra B={B} N={N} (ND {nd}) MP={mp} U={levels.shape[1]}]: "
              f"TABLE vs POW: {int(slots.sum())} written slots {'equal' if eq else 'DIFFER'}, "
              f"bottom max_abs_err {err}; TABLE {ms_t:.3f} ms ({ms_t * 1e3 / nd:.4f} us/step), "
              f"POW {ms_k:.3f} ms ({ms_k * 1e3 / nd:.4f} us/step), one call each", flush=True)
        if not (eq and err == 0.0):
            fail("align_forward_ckpt: the TABLE and POW modes disagree at the ultra-long shape")
        out.update({f"ultra_ms_{B}": ms_t, f"ultra_pow_ms_{B}": ms_k})
    results["align_forward_ckpt_table"].update(out)


def run_over_cap(pm, model: str, seed: int, card: str, results: dict) -> dict:
    """Phase 4e: a target whose flanks carry 200 more backbone bases each
    (MP 2176, ~300 distinct template levels: past one CTA's table; the
    TABLE mode on the 2 CTAs a row ``wave_table_ctas`` gives) counts 72
    '+' reads in one batch (144 rows, each flank its own calls of row 1:
    64 + 8 rows, as many rows as their CTAs fit the SMs) and 24 '-' reads
    (one fused 48-row call, row 2), all in the cluster TABLE mode; then
    the 72 '+' reads again past a pointer budget that sends them down the
    two-pass route (rows 5-6, both flanks a row stream in 8-row groups),
    and the first 64 under ``STRIQUE_ALIGN_KERNEL=col`` (row 8): each
    with the one-pass run's tuples, the cluster modes alone, no POW
    launch.  Before the runs every kernel holds its cluster and POW
    modes to the twins: the one-CTA form's POW dispatch and the split
    form's cluster against the table twin (16 rows, N 4096), rows 5-6
    both ways against their twins (16 rows, N 4096), and at the shapes
    the runs launch (row 1 at 64 rows, row 2 at 48, rows 5-6 at 8-row
    groups, row 8 at 64 rows, the reads' bucket) the cluster mode
    against the POW mode on the decoded f32 (and the twin for rows 1, 2
    and 8), the two timed in turns.  Last the f32 route
    (:func:`run_f32_route`).  Returns the cluster launches of rows 1-2,
    5-6 and 8 of the count runs and the POW launches of the f32
    route."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.detect.counter import RepeatCounter, signal_bucket
    from strique_tpu_torch.ops import align_cuda as AC
    from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, make_reads

    rng = np.random.default_rng(seed + 3)
    prefix = "".join(rng.choice(list("ACGT"), 200)) + PREFIX
    suffix = SUFFIX + "".join(rng.choice(list("ACGT"), 200))
    c = RepeatCounter(model, device="cuda")
    c.add_target("long", REPEAT, prefix, suffix)
    tc = c.targets["long"][0]
    flanks = (tc.prefix_ext, tc.suffix_ext)
    rows = AC.pad_template_rows(list(flanks))[0]
    levels, _ = AC.template_levels(rows)
    mp, ctas = rows.shape[1], AC.wave_table_ctas(rows)
    # the one-CTA form's POW dispatch and the split form's cluster at this
    # MP, each held to the table twin
    for multi in (False, True):
        for mode in ("pow", "cluster"):
            hold_morph(flanks, multi, 16, 4096, c.align_params, rng, mode, "over the cap")
    # rows 5-6 with both flanks as per-row templates (the two-pass run
    # below launches them so): the cluster modes and the POW modes
    # against their twins
    small = {}
    check_longread(flanks, "over the cap", 16, 4096, c.align_params, 512, False, rng, small)
    plus = make_reads(pm, 72, REPEATS, rng, "+", prefix=prefix, suffix=suffix)
    minus = make_reads(pm, 24, REPEATS, rng, "-", prefix=prefix, suffix=suffix)
    # each kernel at the shape the runs below launch it: the cluster mode
    # against POW in turns (the kernel line's cluster entries)
    n_plus, n_minus = signal_bucket(len(plus[0])), signal_bucket(len(minus[0]))
    check_col_pow(tc.prefix_ext, "over the cap", BATCH, n_plus, c.align_params, rng, results)
    check_wave_over_cap(flanks[:1], False, BATCH, n_plus, c.align_params, rng, results)
    check_wave_over_cap(flanks, True, 2 * len(minus), n_minus, c.align_params, rng, results)
    groups = {}
    check_longread(flanks, "over the cap, the two-pass run's groups", 8, n_plus, c.align_params,
                   16384, False, rng, groups, twin=False)
    for name in CLUSTER_TWO_PASS:
        pow_name = name.replace("_cluster", "")
        results[name] = {**groups[name], "plain_ms": small[name]["plain_ms"],
                         "pow_ms": groups[pow_name]["ms"]}
        results[pow_name].update(over_cap_ms=groups[pow_name]["ms"])
    runs = {}
    try:
        c.detect_many("long", plus[:8], "+")  # first use
        for run, env, reads in (("one-pass", {}, None),
                                ("two-pass", {"STRIQUE_PTR_BUDGET_GB": "0.1"}, plus),
                                ("col", {"STRIQUE_ALIGN_KERNEL": "col"}, plus[:BATCH])):
            # 0.1 GiB: the '+' batch's width-8 plane (~0.23 GB) does not
            # fit, the two-pass route; col: a full batch, no fusion
            os.environ.update(env)
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = (c.detect_many("long", plus, "+") + c.detect_many("long", minus, "-")
                   if reads is None else c.detect_many("long", reads, "+"))
            torch.cuda.synchronize()
            runs[run] = (res, time.perf_counter() - t0, dict(_build.LAUNCHES))
            for k in env:
                os.environ.pop(k)
    except Exception as e:  # noqa: BLE001
        fail(f"the over-the-cap target raised {type(e).__name__}: {e}")
    finally:
        os.environ.pop("STRIQUE_PTR_BUDGET_GB", None)
        os.environ.pop("STRIQUE_ALIGN_KERNEL", None)
    pow_all = POW_WAVE + POW_TWO_PASS + ("align_forward_col",)
    table_all = TABLE_WAVE + TABLE_TWO_PASS + ("align_forward_col_table",)
    want = {"one-pass": {"align_forward_wave_cluster": 2 * -(-len(plus) // BATCH),
                         "align_forward_wave_multi_cluster": 1},
            "two-pass": {k: None for k in CLUSTER_TWO_PASS},
            "col": {"align_forward_col_cluster": None}}
    res_one = runs["one-pass"][0]
    for run, (res, dt, lc) in runs.items():
        ok = sum(int(r[0] == REPEATS) for r in res)
        shown = {k: lc[k] for k in pow_all + table_all + CLUSTER_WAVE + CLUSTER_TWO_PASS
                 + ("align_forward_col_cluster",) if lc[k]}
        print(f"over the cap, {run}: prefix_ext {len(tc.prefix_ext)} samples, "
              f"{levels.shape[1]} levels at MP {mp} ({ctas} CTAs a row); {ok}/{len(res)} exact "
              f"in {dt:.3f} s; card: {card}; launches {json.dumps(shown)}", flush=True)
        if ok != len(res) or not all(np.isfinite(r[1]) and np.isfinite(r[3]) for r in res):
            fail(f"inexact or non-finite results for the over-the-cap target ({run})")
        if [tuple(r) for r in res] != [tuple(r) for r in res_one[: len(res)]]:
            fail(f"the over-the-cap {run} run's tuples differ from the one-pass run's")
        cluster = {k: lc[k] for k in want[run]}
        if (any(v <= 0 or (want[run][k] is not None and v != want[run][k])
                for k, v in cluster.items())
                or any(lc[k] for k in pow_all + table_all)):
            fail(f"the over-the-cap {run} run did not go through the cluster TABLE mode alone "
                 f"({json.dumps(cluster)} against {json.dumps(want[run])}, no POW launch)")
    results["over_cap_s"] = {run: v[1] for run, v in runs.items()}
    f32 = run_f32_route(flanks, c.align_params, rng, len(plus), n_plus, len(minus), n_minus,
                        card)
    return {**{k: runs[run][2][k] for run in runs for k in want[run]}, **f32}


def run_f32_route(flanks, params, rng, n_plus: int, N_plus: int, n_minus: int, N_minus: int,
                  card: str) -> dict:
    """Phase 4e's f32 route: the alignment API (``align_fused_pair``,
    ``align_core``) on f32 reads, as the fused dispatch's NumPy prep
    passes them (``lut`` None: the POW score mode at any MP), over the
    over-the-cap flanks at the count runs' shapes: ``n_plus`` '+' rows
    (each flank its own row-1 call), ``n_minus`` '-' rows (one fused
    row-2 call), the '+' rows past the 0.1 GiB pointer budget (rows
    5-6) and 64 of them under ``STRIQUE_ALIGN_KERNEL=col`` (row 8).  The
    launch counts are zeroed before each call and read after it; each
    call's outputs must equal the same call's on the reads' morph form
    (u8 bins and level tables: the cluster TABLE mode).  Returns the POW
    launches."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC

    dev = torch.device("cuda")
    pow_all = POW_WAVE + POW_TWO_PASS + ("align_forward_col",)
    cluster_all = CLUSTER_WAVE + CLUSTER_TWO_PASS + ("align_forward_col_cluster",)
    out, shown = {}, {}
    for run, env, B, N, want in (
            ("'+'", {}, n_plus, N_plus, ("align_forward_wave",)),
            ("'-'", {}, n_minus, N_minus, ("align_forward_wave_multi",)),
            ("two-pass", {"STRIQUE_PTR_BUDGET_GB": "0.1"}, n_plus, N_plus, POW_TWO_PASS),
            ("col", {"STRIQUE_ALIGN_KERNEL": "col"}, BATCH, N_plus, ("align_forward_col",))):
        bins, lut, na = morph_reads([flanks[b % 2][:600] for b in range(B)], B, N, rng)
        b_d, l_d, n_d = (torch.from_numpy(x).to(dev) for x in (bins, lut, na))
        s_d = AC.morph_decode(b_d, l_d)
        os.environ.update(env)
        try:
            def call(sig, lut_=None):
                if run == "col":
                    return (AL.align_core(sig, n_d, flanks[0], params, lut=lut_),)
                return AL.align_fused_pair(sig, n_d, *flanks, params, lut=lut_)

            torch.cuda.synchronize()
            _build.reset_launches()
            got = call(s_d)
            torch.cuda.synchronize()
            lc = dict(_build.LAUNCHES)
            ref = call(b_d, l_d)
            lc_ref = {k: _build.LAUNCHES[k] - lc[k] for k in cluster_all}
        finally:
            for k in env:
                os.environ.pop(k)
        same = all(torch.equal(g[k], r[k]) for g, r in zip(got, ref) for k in g)
        shown[run] = {k: lc[k] for k in pow_all if lc[k]}
        print(f"  f32 route, {run} ({B} reads, N {N}): POW launches {json.dumps(shown[run])}, "
              f"the morph form's {json.dumps({k: v for k, v in lc_ref.items() if v})}; "
              f"outputs {'equal' if same else 'DIFFER'}", flush=True)
        if not same or any(lc[k] <= 0 for k in want) or any(
                lc[k] for k in pow_all + cluster_all if k not in want):
            fail(f"the f32 route ({run}) did not launch {want} alone, or its outputs differ "
                 "from the cluster TABLE mode's")
        for k in want:
            out[k] = out.get(k, 0) + lc[k]
    print(f"over the cap, f32 route: POW launches {json.dumps(out)}; card: {card}", flush=True)
    return out


def check_nan(model: str, params, rng, card: str) -> None:
    """Phase 4l: a read whose level table is all NaN (a flat read's: the
    prep's MAD is 0, on the JAX package's prep too) beside 7 finite rows,
    in rows 1, 2, 5-6 and 8 in the TABLE mode (one CTA a row, and a
    cluster: MP 1152 templates) and the POW mode, each against its twin:
    equal NaN masks and equal values elsewhere in the bottom taps and
    written checkpoint slots, equal written pointer words.  Then a flat
    read through the split, fused and two-phase routes on the card: each
    row the CPU counter's, offset 0.  (With fmaxf, which drops a NaN,
    the card's row had offset 449.)"""
    import numpy as np
    import torch

    from strique_tpu_torch.detect.counter import RepeatCounter
    from strique_tpu_torch.ops import align as AL
    from strique_tpu_torch.ops import align_cuda as AC
    from strique_tpu_torch.ops.reference import AlignParams
    from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX

    def equal_nan(a, b):
        nan = torch.isnan(a)
        return bool(torch.equal(nan, torch.isnan(b)) and torch.equal(a[~nan], b[~nan]))

    steep = AlignParams(gap_open_h=-16.0, gap_extension_h=-16.0, gap_open_v=-0.5,
                        gap_extension_v=-0.5)  # a short pass-2 window
    B, N = 8, 512
    small = [np.repeat(rng.uniform(60, 120, k), 6).astype(np.float32) for k in (7, 5)]
    m = (1152 - 2) // 6 * 6
    big = [np.repeat(rng.uniform(60, 120, k // 6), 6).astype(np.float32) for k in (m, m - 120)]
    held = []
    for mode, tmpls, n_sig in (("table", small, N), ("pow", small, N), ("cluster", big, 4 * N)):
        for kind in ("row 1", "row 2", "rows 5-6", "row 8"):
            multi = kind in ("row 2", "rows 5-6")
            rows = AC.pad_template_rows(tmpls)[0] if multi else AC.pad_template(tmpls[0])[0]
            rule = AC.col_table_ctas if kind == "row 8" else AC.wave_table_ctas
            ctas = rule(rows)
            if ctas != (2 if mode == "cluster" else 1):
                fail(f"the {mode} templates of the NaN phase got {ctas} CTAs a row")
            (_, _, tmpl, _, _), dev_in = wave_inputs(
                tmpls, multi, B, 2 * n_sig if kind == "rows 5-6" else n_sig, rng,
                ctas=ctas if mode == "cluster" else None)
            b_d, l_d, n_d, m_d, lv_d, li_d, t_d = dev_in
            l_d[0] = float("nan")
            s_d = AC.morph_decode(b_d, l_d)
            flat = AC.flat_levels(lv_d, li_d) if mode == "cluster" else (lv_d, li_d)
            ok = True
            if kind == "rows 5-6":
                ms = m_d.cpu().numpy()
                if mode == "pow":
                    st = AL._pass1_rows(s_d, n_d, tmpl, ms, steep, 512)
                    bot_p, ck_p = AC._ckpt_plain(st["sig"], st["tmpl"], n_d, m_d, steep,
                                                 st["ckpt_steps"])
                else:
                    st = AL._pass1_rows(b_d, n_d, tmpl, ms, steep, 512, lut=l_d, ctas=ctas)
                    bot_p, ck_p = AC._ckpt_table_plain(b_d, l_d, *flat, n_d, m_d, steep,
                                                       st["ckpt_steps"], st["N"] + st["mp"])
                slots = written_slots(n_d, m_d, st["N"] + st["mp"], st["ckpt_steps"])
                ok = (equal_nan(st["bottom_steps"], bot_p) and bool(torch.isnan(bot_p[0]).any())
                      and all(equal_nan(a[slots], c[slots]) for a, c in zip(st["ckpts"], ck_p)))
                w = AL.window_inputs(st)
                if mode == "pow":
                    args = (w["sig_win"], w["r_init"], w["state4"], w["cold"],
                            w["steps_needed"], st["tmpl"], steep)
                    ptr, ptr_p = AC.align_window_from_state(*args, st["m"]), \
                        AC._window_plain(*args)
                else:
                    args = (w["t0"], w["state4"], w["cold"], w["steps_needed"])
                    ptr = AC.align_window_from_state_morph(b_d, l_d, *args, st["levels"],
                                                           st["lidx"], steep, st["m"], st["W"])
                    ptr_p = AC._window_table_plain(b_d, l_d, *args, *flat, steep, st["W"])
                words = valid_ptr_mask(w["steps_needed"], torch.zeros_like(n_d), ptr.shape[0])
            else:
                m0 = int(m_d[0])
                if kind == "row 8":
                    ptr, bot = (AC.align_forward_col(s_d, n_d, t_d, params, m0) if mode == "pow"
                                else AC.align_forward_col_morph(b_d, l_d, n_d, lv_d, li_d,
                                                                params, m0))
                    ptr_p, bot_p = (AC._col_plain(s_d, t_d, n_d, params, m0) if mode == "pow"
                                    else AC._col_table_plain(b_d, l_d, *flat, n_d, params, m0))
                    words = valid_ptr_mask(n_d, torch.zeros_like(n_d), ptr.shape[0])
                else:
                    ptr, bot = (pow_call(multi, s_d, n_d, m_d, t_d, params) if mode == "pow"
                                else morph_call(multi, b_d, l_d, n_d, m_d, lv_d, li_d, params))
                    ptr_p, bot_p = (AC._wave_plain(s_d, t_d, n_d, m_d, params) if mode == "pow"
                                    else AC._wave_table_plain(b_d, l_d, *flat, n_d, m_d, params))
                    words = valid_ptr_mask(n_d, m_d, ptr.shape[0])
                ok = equal_nan(bot, bot_p) and bool(torch.isnan(bot[0]).any())
            ok = ok and bool(torch.equal(ptr[words], ptr_p[words]))
            held.append(f"{kind} {mode} {'equal' if ok else 'DIFFERS'}")
            if not ok:
                fail(f"a NaN level table: {kind} in the {mode} mode disagrees with its twin")
    print(f"  NaN level table (row 0 of {B}) against the twins: {'; '.join(held)}", flush=True)
    reads = [np.full(3000, 90.0)]
    out = {}
    for route in ("cpu", "split", "fused", "two-phase"):
        fc = RepeatCounter(model, device="cpu" if route == "cpu" else "cuda")
        fc.split = route in ("cpu", "split")
        fc.fused = route != "two-phase"
        fc.add_target("c9orf72", REPEAT, PREFIX[-80:], SUFFIX[:80])
        out[route] = fc.detect_many("c9orf72", reads, "+")
    print(f"  a flat read (3000 samples of 90.0, 80-base flanks): "
          + "; ".join(f"{route} {out[route][0]}" for route in out) + f"; card: {card}",
          flush=True)
    if out["cpu"][0][4] != 0 or any(out[r] != out["cpu"] for r in out):
        fail("a flat read's row on the card differs from the CPU counter's")


def run_vntr(pm, model: str, seed: int, card: str, results: dict) -> dict:
    """Phase 4f: a VNTR target of a 60-base unit (as MUC1's), whose repeat
    HMM has 540 states (SP 640, past the dense forward's resident rule):
    the streamed dense kernel against its twin at the route's shape (8
    reads, T 8192), then 8 '+' reads of 12 units counted on the default
    route (the factored forward) and under ``STRIQUE_DENSE_VITERBI=1``
    (the streamed dense forward), with equal result tuples.  Both count
    11, as the JAX package does on the CPU with these reads (its prefix
    profile takes one unit this long): tests/test_torch_dense.py
    ``test_vntr_counts_match_jax_counter`` holds the port's two routes
    to the JAX counter there.  Returns the streamed
    kernel's launches on the knob route."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.detect.counter import RepeatCounter
    from strique_tpu_torch.synthetic import PREFIX, SUFFIX, make_reads

    rng = np.random.default_rng(5)
    unit = "".join(rng.choice(list("ACGT"), VNTR_UNIT_BASES))
    reads = make_reads(pm, 8, VNTR_UNITS, rng, "+", repeat=unit)
    res = {}
    for route in ("default", "dense"):
        if route == "dense":
            os.environ["STRIQUE_DENSE_VITERBI"] = "1"
        try:
            c = RepeatCounter(model, device="cuda")  # a fresh HMM cache sees the knob
            c.add_target("vntr", unit, PREFIX, SUFFIX)
            if route == "default":
                check_dense(pm, c.targets["vntr"][0].repeat_hmm, "VNTR route", 8, 8192, rng,
                            results, repeats=VNTR_UNITS, unit=unit)
            c.detect_many("vntr", reads[:1], "+")  # first use
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = c.detect_many("vntr", reads, "+")
            torch.cuda.synchronize()
            res[route] = (out, time.perf_counter() - t0, dict(_build.LAUNCHES))
        except SystemExit:
            raise
        except Exception as e:  # noqa: BLE001
            fail(f"the VNTR target's {route} route raised {type(e).__name__}: {e}")
        finally:
            os.environ.pop("STRIQUE_DENSE_VITERBI", None)
    for route, (out, dt, lc) in res.items():
        vit = {k: lc[k] for k in ("viterbi_forward_factored", *DENSE)}
        print(f"VNTR ({VNTR_UNIT_BASES}-base unit, {VNTR_UNITS} units), {route} route: counts "
              f"{[r[0] for r in out]} in {dt:.3f} s; card: {card}; launches {json.dumps(vit)}",
              flush=True)
        if any(r[0] != VNTR_UNITS - 1 for r in out) or not all(np.isfinite(r[3]) for r in out):
            fail(f"the VNTR target's {route} route did not count {VNTR_UNITS - 1} units")
    dense_lc = res["dense"][2]
    if (dense_lc["viterbi_forward_dense"] <= 0 or dense_lc["viterbi_forward_dense_resident"]
            or dense_lc["viterbi_forward_factored"] or res["default"][2]["viterbi_forward_dense"]):
        fail("the VNTR target's dense route did not decode with the streamed dense forward alone")
    if [tuple(r) for r in res["dense"][0]] != [tuple(r) for r in res["default"][0]]:
        fail("the VNTR target's dense route's tuples differ from the default route's")
    return {"viterbi_forward_dense": dense_lc["viterbi_forward_dense"]}


def run_wide(model: str, seed: int, card: str, tmp: str) -> dict:
    """Phase 4f's targets past SP 1024: the 150-base unit's (repeat HMM
    of 1080 states, SP 1152) 8 '+' reads of 5 units on the default route
    (the wide factored forward and the wide backward) and under
    ``STRIQUE_DENSE_VITERBI=1`` (the streamed dense forward, then the wide
    backward), tuples equal to each other and to the port's CPU counter
    (tests/test_torch_wide_counter.py holds that counter to the JAX one);
    the 260-base unit with the mod model (repeat HMM SP 1792, mod HMM SP
    1152: both wide layouts), 4 '+' base and twin reads, tuples equal to
    the CPU counter's (tests/test_torch_wide_mod.py); then a 1345-base
    unit (8250 states, SP 8320), refused by ``add_target`` on the card
    before any launch.  Returns the wide kernels' launches on these
    paths."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.detect.counter import RepeatCounter
    from strique_tpu_torch.ops import viterbi_cuda as VC
    from strique_tpu_torch.pore_model import PoreModel
    from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, SUFFIX, WIDE_UNIT_BASES,
                                             make_reads, random_unit, wide_mod_reads,
                                             write_mod_model, write_pore_model)

    pm = PoreModel(model)
    rng = np.random.default_rng(5)
    unit = "".join(rng.choice(list("ACGT"), WIDE_UNIT_BASES))
    reads = make_reads(pm, WIDE_READS, WIDE_UNITS, rng, "+", repeat=unit)
    t0 = time.perf_counter()
    ref_counter = RepeatCounter(model, device="cpu")
    ref_counter.add_target("wide", unit, PREFIX, SUFFIX)
    ref = ref_counter.detect_many("wide", reads, "+")
    cpu_s = time.perf_counter() - t0
    res = {}
    for route in ("default", "dense"):
        if route == "dense":
            os.environ["STRIQUE_DENSE_VITERBI"] = "1"
        try:
            c = RepeatCounter(model, device="cuda")  # a fresh HMM cache sees the knob
            c.add_target("wide", unit, PREFIX, SUFFIX)
            c.detect_many("wide", reads[:1], "+")  # first use
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            out = c.detect_many("wide", reads, "+")
            torch.cuda.synchronize()
            res[route] = (out, time.perf_counter() - t0, dict(_build.LAUNCHES))
        except SystemExit:
            raise
        except Exception as e:  # noqa: BLE001
            fail(f"the wide target's {route} route raised {type(e).__name__}: {e}")
        finally:
            os.environ.pop("STRIQUE_DENSE_VITERBI", None)
    vit = ("viterbi_forward_factored", *WIDE_KERNELS, "viterbi_backward_batch", *DENSE)
    for route, (out, dt, lc) in res.items():
        print(f"wide target ({WIDE_UNIT_BASES}-base unit, {WIDE_UNITS} units, SP 1152), {route} "
              f"route: counts {[r[0] for r in out]} in {dt:.3f} s; card: {card}; launches "
              f"{json.dumps({k: lc[k] for k in vit})}", flush=True)
        if [tuple(r) for r in out] != [tuple(r) for r in ref]:
            fail(f"the wide target's {route} route's tuples differ from the CPU counter's")
        if not all(np.isfinite(r[3]) for r in out):
            fail(f"non-finite log_p on the wide target's {route} route")
    lc, dense_lc = res["default"][2], res["dense"][2]
    if (lc["viterbi_forward_factored_wide"] <= 0 or lc["viterbi_backward_wide"] <= 0
            or lc["viterbi_forward_factored"] or lc["viterbi_backward_batch"]
            or any(lc[k] for k in DENSE)):
        fail("the wide target's default route did not decode with the wide variants alone")
    if (dense_lc["viterbi_forward_dense"] <= 0 or dense_lc["viterbi_backward_wide"] <= 0
            or dense_lc["viterbi_forward_factored_wide"]):
        fail("the wide target's dense route did not decode with the streamed dense forward "
             "and the wide backward")
    print(f"wide target: both routes' tuples equal the CPU counter's (its run {cpu_s:.1f} s)",
          flush=True)

    base = write_pore_model(os.path.join(tmp, "wide_base.model"), seed=MOD_MODEL_SEED)
    twin = write_mod_model(os.path.join(tmp, "wide_twin.model"), seed=MOD_MODEL_SEED)
    munit, mreads = wide_mod_reads(base, twin, WIDE_MOD_READS)
    mod = {}
    for dev in ("cpu", "cuda"):
        c = RepeatCounter(base, mod_model_file=twin, device=dev)
        c.add_target("wide", munit, PREFIX, SUFFIX)
        if dev == "cuda":
            c.detect_many("wide", mreads[:1], "+")  # first use
            torch.cuda.synchronize()
            _build.reset_launches()
        t0 = time.perf_counter()
        mod[dev] = c.detect_many("wide", mreads, "+")
        if dev == "cuda":
            torch.cuda.synchronize()
            mod_lc = dict(_build.LAUNCHES)
        mod[dev + "_s"] = time.perf_counter() - t0
    tc = c.targets["wide"][0]
    print(f"wide mod target ({len(munit)}-base unit, SP {VC.padded_sp(tc.repeat_hmm.n_states)} "
          f"repeat HMM, SP {VC.padded_sp(tc.mod_hmm.n_states)} mod HMM): counts and mod "
          f"strings {[(r[0], r[6]) for r in mod['cuda']]} in {mod['cuda_s']:.3f} s (CPU "
          f"{mod['cpu_s']:.1f} s); card: {card}; launches "
          f"{json.dumps({k: mod_lc[k] for k in vit})}", flush=True)
    if [tuple(r) for r in mod["cuda"]] != [tuple(r) for r in mod["cpu"]]:
        fail("the wide mod target's tuples differ from the CPU counter's")
    if (mod_lc["viterbi_forward_factored_diag_wide"] <= 0
            or mod_lc["viterbi_forward_factored_wide"] <= 0
            or mod_lc["viterbi_forward_factored_diag"] or mod_lc["viterbi_backward_batch"]):
        fail("the wide mod target did not decode with both wide layouts alone")

    too_wide = random_unit(TOO_WIDE_UNIT_BASES, TOO_WIDE_UNIT_BASES)
    c = RepeatCounter(model, device="cuda")
    before = dict(_build.LAUNCHES)
    t0 = time.perf_counter()
    try:
        c.add_target("too wide", too_wide, PREFIX, SUFFIX)
    except ValueError as e:
        msg = str(e)
    else:
        fail(f"add_target took a {TOO_WIDE_UNIT_BASES}-base unit past SP {VC.MAX_SP} on the card")
    if f"{VC.MAX_SP} padded states" not in msg or "too wide" in c.targets:
        fail(f"add_target's refusal past SP {VC.MAX_SP} is not the limit's: {msg}")
    if dict(_build.LAUNCHES) != before:
        fail("a kernel launched before add_target refused the too-wide HMM")
    print(f"a {TOO_WIDE_UNIT_BASES}-base unit's HMM refused by add_target on the card in "
          f"{time.perf_counter() - t0:.1f} s, before any launch: {msg}", flush=True)
    return {"viterbi_forward_factored_wide": lc["viterbi_forward_factored_wide"],
            "viterbi_backward_wide": lc["viterbi_backward_wide"],
            "viterbi_forward_factored_diag_wide": mod_lc["viterbi_forward_factored_diag_wide"]}


def run_devices(model: str, pm, seed: int, card: str, tmp: str, ultra, two_pass) -> None:
    """Phase 4i: phase 4g's stream through ``RepeatCounter(device=[cuda:0]
    * DEVICE_ENTRIES)`` (each batch's rows in contiguous shards, each on
    its own CUDA stream) at ``--batch`` 64, its TSV byte-equal to phase
    4g's single-device run's; then the ultra-long reads under phase 4b's
    two-pass budget (each entry's row shard running its own pass-1
    group) and under the card's default budget, tuples equal to phase
    4b's two-pass run's (``two_pass``)."""
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.detect.counter import RepeatCounter
    from strique_tpu_torch.detect.detector import RepeatDetector
    from strique_tpu_torch.detect.writer import OutputWriter
    from strique_tpu_torch.parallel.dispatcher import run_pipeline as run_count
    from strique_tpu_torch.synthetic import (LOCI, PREFIX, REPEAT, SUFFIX, count_workload,
                                             sam_line)
    from strique_tpu_torch.utils.config import parse_config

    devices = [torch.device("cuda", 0)] * DEVICE_ENTRIES
    reads = count_workload(pm, seed + 9)
    lines = [sam_line(rid, strand, LOCI[t][0], LOCI[t][1]) for rid, t, strand, _u, _s in reads]
    rd = RepeatDetector(parse_config(os.path.join(tmp, "repeats.tsv"))["repeat"], model,
                        MemoryIndex(reads), device=devices)
    with open(os.path.join(tmp, f"count_b{BATCH}_0.tsv"), "rb") as fp:
        expect = fp.read()
    rps = []
    for rep in range(2):  # a first use, then a timed run
        out = os.path.join(tmp, f"count_devices_{rep}.tsv")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        run_count(iter(lines), rd, OutputWriter(out), batch_size=BATCH)
        torch.cuda.synchronize()
        rps.append(len(reads) / (time.perf_counter() - t0))
        with open(out, "rb") as fp:
            if fp.read() != expect:
                fail(f"the count stream over {DEVICE_ENTRIES} device entries wrote another TSV "
                     f"than one device's (run {rep + 1})")
    lc = dict(_build.LAUNCHES)
    print(f"count stream over {DEVICE_ENTRIES} entries of cuda:0 (--batch {BATCH}): TSV equal "
          f"to one device's byte for byte; {', '.join(f'{x:.2f}' for x in rps)} reads/s; "
          f"card: {card}; launches {json.dumps({k: v for k, v in lc.items() if v})}",
          flush=True)
    for name in SPLIT_KERNELS:
        if lc[name] <= 0:
            fail(f"kernel {name} was not launched on the multi-device count path")

    counter = RepeatCounter(model, device=devices)
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    for budget in ("2", None):
        if budget is not None:
            os.environ["STRIQUE_PTR_BUDGET_GB"] = budget
        try:
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = counter.detect_many("c9orf72", ultra, "+")
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        finally:
            os.environ.pop("STRIQUE_PTR_BUDGET_GB", None)
        lc = dict(_build.LAUNCHES)
        label = f"STRIQUE_PTR_BUDGET_GB={budget}" if budget else "the default budget"
        print(f"ultra-long reads over {DEVICE_ENTRIES} entries of cuda:0 ({label}): {len(res)} "
              f"reads in {dt:.3f} s; card: {card}; "
              f"launches {json.dumps({k: v for k, v in lc.items() if v})}", flush=True)
        if [tuple(r) for r in res] != [tuple(r) for r in two_pass]:
            fail(f"the ultra-long reads over two device entries ({label}) gave other tuples "
                 "than one device's")
        if budget is not None and lc["align_forward_ckpt_table"] != DEVICE_ENTRIES:
            fail(f"the ultra-long two-pass route ran {lc['align_forward_ckpt_table']} pass-1 "
                 "groups, not one an entry")


def count_process() -> int:
    """One process of phase 4j (``python3 -c`` runs it with ``sys.argv``
    = [the .npz of signals, "count", ...]): ``cli.main`` on the count
    arguments, the detector's index reading the reads' signals from the
    .npz (the card's host may lack h5py)."""
    import numpy as np

    from strique_tpu_torch import cli
    from strique_tpu_torch.detect import detector

    with np.load(sys.argv[1]) as npz:
        signals = {k: npz[k] for k in npz.files}

    class Index:
        def get_raw(self, read_id):
            if read_id not in signals:
                raise RuntimeError(f"read {read_id} is not in the index")
            return signals[read_id]

    detector.Fast5Index = lambda _path: Index()
    return cli.main(sys.argv[2:])


def run_hosts(model: str, pm, seed: int, card: str, tmp: str) -> float:
    """Phase 4j: ``count`` over phase 4g's stream as HOSTS processes on the
    one card (``--coordinator localhost:P --num_hosts 2 --host_id i``,
    gloo): one merged TSV, the parts removed, its rows those of phase
    4g's single-process run at ``--batch`` 64, each read once, the SAM
    stride splitting the reads.  Returns the wall seconds."""
    import socket

    import numpy as np

    from strique_tpu_torch.synthetic import count_workload

    reads = count_workload(pm, seed + 9)
    npz = os.path.join(tmp, "hosts_reads.npz")
    np.savez(npz, **{rid: sig for rid, _t, _s, _u, sig in reads})
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    out = os.path.join(tmp, "hosts.tsv")
    root = os.path.dirname(os.path.abspath(__file__))
    code = ("import sys; sys.path.insert(0, sys.argv.pop(1)); import chip_smoke; "
            "sys.exit(chip_smoke.count_process())")
    argv = ["count", os.path.join(tmp, "memory.fofn"), model, os.path.join(tmp, "repeats.tsv"),
            "--algn", os.path.join(tmp, "algn.sam"), "--out", out, "--coordinator",
            f"localhost:{port}", "--num_hosts", str(HOSTS), "--log_level", "info"]
    # each process logs to a file: a full pipe would stall it at the barrier
    errs = [os.path.join(tmp, f"hosts_{i}.err") for i in range(HOSTS)]
    t0 = time.perf_counter()
    procs = []
    try:
        for i in range(HOSTS):
            with open(errs[i], "w") as err:
                procs.append(subprocess.Popen(
                    [sys.executable, "-c", code, root, npz, *argv, "--host_id", str(i)],
                    cwd=root, stdout=subprocess.DEVNULL, stderr=err))
        rcs = [p.wait(timeout=max(HOST_TIMEOUT_S - (time.perf_counter() - t0), 1))
               for p in procs]
    except subprocess.TimeoutExpired:
        fail(f"a count process of phase 4j ran past {HOST_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    logs = []
    for i, rc in enumerate(rcs):
        with open(errs[i]) as fp:
            logs.append((rc, fp.read()))
        if rc != 0:
            fail(f"count process {i} of {HOSTS} exited {rc}: {logs[-1][1][-1500:]}")
    if not os.path.exists(out) or any(os.path.exists(f"{out}.part{i}") for i in range(HOSTS)):
        fail("the count processes left no merged TSV, or left their parts")
    with open(out) as fp:
        got = fp.read().splitlines()
    with open(os.path.join(tmp, f"count_b{BATCH}_0.tsv")) as fp:
        want = fp.read().splitlines()
    if got[:1] != want[:1] or sorted(got[1:]) != sorted(want[1:]):
        fail("the merged TSV's rows differ from the single-process run's")
    done = [int(err.split("Main: Processed ")[-1].split()[0]) for _rc, err in logs]
    if sum(done) != len(reads) or min(done) <= 0:
        fail(f"the SAM stride did not split the reads between the processes: {done}")
    print(f"count over {HOSTS} processes (gloo, one card): merged TSV's rows equal the single "
          f"process's, {done} reads a process, {wall:.1f} s wall (process start and kernel "
          f"library load included); card: {card}", flush=True)
    return wall


def profile_pass(label: str, fn, card: str):
    """Run ``fn`` once under torch.profiler; print wall time, device time
    by kernel and the device's busy share (kernel time over wall); return
    the (kernel, device ms, launches) rows and the wall ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if e.self_device_time_total > 0 and str(e.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    total = sum(r[1] for r in rows)
    print(f"profile [{label}]: wall {wall_ms:.2f} ms, device kernels {total:.2f} ms, busy share "
          f"{total / wall_ms:.3f}; card: {card}", flush=True)
    for key, ms, n in rows[:8]:
        print(f"  {ms:10.3f} ms  {n:4d} x  {key[:90]}", flush=True)
    return rows, wall_ms


def profile_walks(label: str, fn, card: str, results) -> None:
    """``profile_pass`` with the length of every traceback launch's walks
    read from its outputs (``walk_steps``; the tensors are kept and read
    after the pass, so it adds no sync): per layout, the longest walk of
    each launch, and the profile's device time of the kernel over their
    sum, the us a step on this path."""
    from strique_tpu_torch.ops import align as AL

    log = []
    inner = AL._traceback_cuda

    def recorded(ptr, j_end, m_start, m_out, col):
        out = inner(ptr, j_end, m_start, m_out, col)
        log.append((col, j_end, m_start, out))
        return out

    AL._traceback_cuda = recorded
    try:
        rows, _ = profile_pass(label, fn, card)
    finally:
        AL._traceback_cuda = inner
    for col in (False, True):
        walks = [int(walk_steps(out, je, ms).max()) for c, je, ms, out in log if c == col]
        if not walks:
            continue
        name = "traceback_pointers_col" if col else "traceback_pointers"
        kern = f"traceback_kernel<{'true' if col else 'false'}>"
        ms = sum(t for key, t, _ in rows if kern in key)
        n = sum(c for key, _, c in rows if kern in key)
        print(f"  {name} on this pass: {len(walks)} launches ({n} profiled), longest walk a "
              f"launch {walks} steps; {ms:.3f} ms of device time, {ms * 1e3 / sum(walks):.4f} "
              f"us/step over the longest walks", flush=True)
        results.setdefault(name, {}).setdefault("passes", {})[label] = {
            "launches": len(walks), "longest_walks": walks, "device_ms": ms,
            "us_per_step": ms * 1e3 / sum(walks)}


class MemoryIndex:
    """A fast5 index held in memory (read id -> signal): the detector's
    ``get_raw`` on a host without h5py."""

    def __init__(self, reads):
        self.raw = {rid: sig for rid, _t, _s, _u, sig in reads}

    def get_raw(self, read_id):
        if read_id not in self.raw:
            raise RuntimeError(f"read {read_id} is not in the index")
        return self.raw[read_id]


def run_count_stream(model: str, pm, seed: int, card: str, tmp: str) -> dict:
    """Phase 4g: the count path (``run_pipeline`` through the port's
    RepeatDetector, StreamScheduler and OutputWriter) over a shuffled
    stream of both loci; see the module docstring.  Returns its
    measurements."""
    import torch

    from strique_tpu_torch import _build, cli
    from strique_tpu_torch.detect.counter import RepeatCounter, signal_bucket
    from strique_tpu_torch.detect.detector import RepeatDetector
    from strique_tpu_torch.detect.writer import HEADER, OutputWriter
    from strique_tpu_torch.parallel.dispatcher import run_pipeline as run_count
    from strique_tpu_torch.synthetic import (COUNT_GROUPS, LOCI, count_workload, sam_line,
                                             write_repeat_config)
    from strique_tpu_torch.utils.config import parse_config

    reads = count_workload(pm, seed + 9)
    units = {r[0]: r[3] for r in reads}
    buckets: dict = {}
    for r in reads:
        nb = signal_bucket(len(r[4]))
        buckets[nb] = buckets.get(nb, 0) + 1
    mix = ", ".join(f"{n} {t} '{s}'" for t, s, n in COUNT_GROUPS)
    print(f"count stream: {len(reads)} reads ({mix}), {min(len(r[4]) for r in reads)}-"
          f"{max(len(r[4]) for r in reads)} samples, signal buckets "
          f"{json.dumps(dict(sorted(buckets.items())))}", flush=True)
    repeat_tsv = write_repeat_config(os.path.join(tmp, "repeats.tsv"), LOCI)
    lines = [sam_line(rid, strand, LOCI[t][0], LOCI[t][1]) for rid, t, strand, _u, _s in reads]
    rd = RepeatDetector(parse_config(repeat_tsv)["repeat"], model, MemoryIndex(reads),
                        device="cuda")
    # the scheduler calls detect only to retry a failed batch read by read
    retried = []
    inner = RepeatCounter.detect

    def counted(self, target_name, raw, strand):
        retried.append(target_name)
        return inner(self, target_name, raw, strand)

    def check_tsv(path, label):
        rows = open(path).read().splitlines()
        if not rows or rows[0] != "\t".join(HEADER):
            fail(f"{label}: no TSV header")
        body = rows[1:]
        if len(body) != len(reads):
            fail(f"{label}: {len(body)} rows for {len(reads)} SAM lines")
        ids = [ln.split("\t", 1)[0] for ln in body]
        bad = [(ln, expect.get(i)) for i, ln in zip(ids, body) if expect.get(i) != ln]
        if bad or len(set(ids)) != len(reads):
            fail(f"{label}: rows differ from detect_many's tuples in a fresh counter, e.g. "
                 f"{bad[:2]} (row, detect_many's)")
        miss = [ln.split("\t")[:4] for ln in body
                if int(ln.split("\t")[3]) != units[ln.split("\t", 1)[0]]]
        c9_miss = [m for m in miss if m[1] == "c9orf72"]
        if c9_miss:
            fail(f"{label}: {len(c9_miss)} inexact c9orf72 counts, e.g. {c9_miss[:4]} against "
                 f"{[units[m[0]] for m in c9_miss[:4]]}")
        return miss

    RepeatCounter.detect = counted
    try:
        # every row's tuple: detect_many in a fresh counter, by (target,
        # strand, bucket) in batches of at most 64 (no tail merge)
        fresh = RepeatCounter(model, device="cuda")
        for name, (_c, _b, _e, repeat, prefix, suffix) in LOCI.items():
            fresh.add_target(name, repeat, prefix, suffix)
        groups: dict = {}
        for r in reads:
            groups.setdefault((r[1], r[2], signal_bucket(len(r[4]))), []).append(r)
        expect = {}
        for (t, strand, _nb), rs in groups.items():
            for i in range(0, len(rs), BATCH):
                chunk = rs[i : i + BATCH]
                for r, out in zip(chunk, fresh.detect_many(t, [r[4] for r in chunk], strand)):
                    expect[r[0]] = "\t".join(str(x) for x in (r[0], t, strand, *out))
        warm = os.path.join(tmp, "count_warm.tsv")
        run_count(iter(lines), rd, OutputWriter(warm), batch_size=BATCH)  # first use
        fmr1_miss = check_tsv(warm, "warm-up run")
        torch.cuda.synchronize()
        del retried[:]
        _build.reset_launches()
        rps = {b: [] for b in COUNT_BATCHES}
        by_batch = {}
        for rep in range(COUNT_REPS):
            for b in COUNT_BATCHES:
                out = os.path.join(tmp, f"count_b{b}_{rep}.tsv")
                before = dict(_build.LAUNCHES)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                n = run_count(iter(lines), rd, OutputWriter(out), batch_size=b)
                torch.cuda.synchronize()
                rps[b].append(len(reads) / (time.perf_counter() - t0))
                if n != len(lines):
                    fail(f"run_pipeline processed {n} of {len(lines)} SAM lines")
                check_tsv(out, f"--batch {b} run {rep + 1}")
                by_batch[b] = {k: v - before[k] for k, v in _build.LAUNCHES.items()
                               if v - before[k]}
        launches = dict(_build.LAUNCHES)
        retries_timed = len(retried)
        rows, wall = profile_pass(
            f"count stream, --batch {cli.CARD_BATCH} (the CLI's card default), {len(reads)} "
            f"reads", lambda: run_count(iter(lines), rd,
                                        OutputWriter(os.path.join(tmp, "count_prof.tsv")),
                                        batch_size=cli.CARD_BATCH), card)
        kernel_ms = sum(r[1] for r in rows)
        check_tsv(os.path.join(tmp, "count_prof.tsv"), "profiled run")
        cli_routes = run_count_cli(reads, lines, model, repeat_tsv, tmp)
        for route in cli_routes:
            check_tsv(os.path.join(tmp, f"count_cli_{route}.tsv"), f"count CLI run ({route})")
    finally:
        RepeatCounter.detect = inner
    print(f"count stream: {len(reads)} rows a run, every tuple equal to detect_many's in a "
          f"fresh counter, every c9orf72 count exact; {retries_timed} per-read retries in the "
          f"timed runs, {len(retried)} in the phase", flush=True)
    for strand in "+-":
        n = sum(1 for r in reads if r[1] == "fmr1" and r[2] == strand)
        ms = [(units[m[0]], int(m[3])) for m in fmr1_miss if m[2] == strand]
        print(f"  fmr1 '{strand}': {n - len(ms)}/{n} counts exact; misses (units, count) "
              f"{ms}", flush=True)
    for b in COUNT_BATCHES:
        print(f"  --batch {b:3d}: {', '.join(f'{x:.2f}' for x in rps[b])} reads/s; launches a "
              f"run {json.dumps(by_batch[b])}; card: {card}", flush=True)
    print(f"count stream: busy share of the profiled --batch {cli.CARD_BATCH} run "
          f"{kernel_ms / wall:.3f} ({kernel_ms:.2f} of {wall:.2f} ms); card: {card}", flush=True)
    print(f"count stream launches ({len(COUNT_BATCHES) * COUNT_REPS} timed runs): "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    print(f"phase 4g ran run_pipeline on an in-memory index and the count CLI at its card "
          f"defaults on the {' and the '.join(cli_routes)} index: TSVs equal to run_pipeline's",
          flush=True)
    if retried:
        fail(f"{len(retried)} per-read retries were taken in phase 4g")
    for name in SPLIT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched on the count path")
    return {"reads_per_sec": {str(b): v for b, v in rps.items()},
            "busy": kernel_ms / wall, "wall_ms": wall, "kernel_ms": kernel_ms,
            "launches": launches, "launches_by_batch": {str(b): v for b, v in by_batch.items()},
            "cli_routes": cli_routes, "buckets": buckets}


def run_count_cli(reads, lines, model: str, repeat_tsv: str, tmp: str) -> list:
    """``strique_tpu_torch.cli count`` at its card defaults (``--device
    cuda``, ``--batch cli.CARD_BATCH``) with ``--profile``, on a SAM file
    of ``lines``: first with the detector's ``Fast5Index`` patched to the
    in-memory index (the fofn then only has to exist), then, where h5py
    imports, on the reads as single-read fast5 files and their fofn.
    Each TSV must equal the in-memory run_pipeline's at that --batch, and
    each profile must write a trace.  Returns the routes that ran."""
    from strique_tpu_torch import cli
    from strique_tpu_torch.detect import detector

    if cli.CARD_BATCH not in COUNT_BATCHES:
        fail(f"the CLI's card --batch {cli.CARD_BATCH} is not among {COUNT_BATCHES}")
    sam = os.path.join(tmp, "algn.sam")
    with open(sam, "w") as fp:
        fp.write("@HD\tVN:1.6\n" + "".join(lines))
    fofn = os.path.join(tmp, "memory.fofn")
    with open(fofn, "w") as fp:
        fp.write("")
    routes = {"memory": fofn}
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:
        from strique_tpu_torch.io import fast5
        from strique_tpu_torch.synthetic import write_single_fast5

        fdir = os.path.join(tmp, "fast5")
        os.makedirs(fdir)
        for rid, _t, _s, _u, sig in reads:
            write_single_fast5(os.path.join(fdir, f"{rid}.fast5"), rid, sig)
        routes["fast5"] = os.path.join(fdir, "reads.fofn")
        with open(routes["fast5"], "w") as fp:
            fp.write("\n".join(fast5.index(fdir)) + "\n")
    with open(os.path.join(tmp, f"count_b{cli.CARD_BATCH}_0.tsv"), "rb") as fp:
        expect = fp.read()
    for route, index in routes.items():
        out = os.path.join(tmp, f"count_cli_{route}.tsv")
        prof_dir = os.path.join(tmp, f"count_profile_{route}")
        argv = ["count", index, model, repeat_tsv, "--algn", sam, "--out", out,
                "--profile", prof_dir]
        inner = detector.Fast5Index
        if route == "memory":
            detector.Fast5Index = lambda _path: MemoryIndex(reads)
        try:
            rc = cli.main(argv)
        finally:
            detector.Fast5Index = inner
        if rc != 0:
            fail(f"the count CLI ({route} index) exited {rc}")
        with open(out, "rb") as fp:
            if fp.read() != expect:
                fail(f"the count CLI's TSV ({route} index) differs from the in-memory "
                     f"run_pipeline's at --batch {cli.CARD_BATCH}")
        if not any(os.path.getsize(os.path.join(prof_dir, f)) for f in os.listdir(prof_dir)):
            fail(f"the count CLI's --profile ({route} index) wrote no trace")
    return list(routes)


def plain_decode(obs, lens, ph):
    """``viterbi_batch``'s paths through the plain twins of the factored
    forward and the backward (on the tensors' device)."""
    import torch

    from strique_tpu_torch.ops import viterbi_cuda as VC

    paths = []
    for g in range(0, obs.shape[0], VC.GROUP):
        o, n = VC._pad_batch(obs[g : g + VC.GROUP], lens[g : g + VC.GROUP])
        sc, fin, _ = VC._fwd_plain(o, n, ph)
        last = torch.argmax(fin + ph.end, dim=1)
        paths.append(VC._bwd_plain(sc, last, n, ph.transT)[: min(VC.GROUP, obs.shape[0] - g)])
    return torch.cat(paths)


def run_mod(seed: int, card: str, tmp: str) -> dict:
    """Phase 4h: mod calling (5mC per repeat unit) through the stream
    scheduler and the count CLI; see the module docstring.  Returns its
    measurements and the diagonal-only forward's launches."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build, cli
    from strique_tpu_torch.detect import detector
    from strique_tpu_torch.detect.counter import RepeatCounter
    from strique_tpu_torch.detect.stream import StreamScheduler
    from strique_tpu_torch.detect.writer import HEADER
    from strique_tpu_torch.ops import viterbi_cuda as VC
    from strique_tpu_torch.pore_model import PoreModel
    from strique_tpu_torch.synthetic import (LOCI, MOD_MODEL_SEED, MOD_REPEATS, MOD_SHIFT,
                                             MOD_WORKLOAD_MISCOUNTS, PREFIX, REPEAT, SUFFIX,
                                             mod_workload, sam_line, write_mod_model,
                                             write_pore_model, write_repeat_config)

    diag = "viterbi_forward_factored_diag"
    base = write_pore_model(os.path.join(tmp, "mod_base.model"), seed=MOD_MODEL_SEED)
    twin = write_mod_model(os.path.join(tmp, "mod_twin.model"), seed=MOD_MODEL_SEED)
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    plus, minus = mod_workload(pm, pm_mod, seed)
    # (read id, target, strand, 1 for a twin read, signal)
    reads = [(f"mod{strand}{i:03d}", "c9orf72", strand, i % 2, sig)
             for strand, sigs in (("+", plus), ("-", minus)) for i, sig in enumerate(sigs)]
    # each read's count: MOD_REPEATS, but the JAX package's own count on the
    # reads of the default seed that it counts off (tests/test_torch_mod.py)
    expect = {f"mod{s}{i:03d}": MOD_REPEATS if seed else MOD_WORKLOAD_MISCOUNTS.get(
        (s, i), MOD_REPEATS) for s, sigs in (("+", plus), ("-", minus)) for i in range(len(sigs))}
    print(f"mod workload: {len(plus)} '+' and {len(minus)} '-' c9orf72 reads of "
          f"{len(plus[0])} and {len(minus[0])} samples, {MOD_REPEATS} units, half from the "
          f"base model (seed {MOD_MODEL_SEED}) and half from its twin (CpG levels "
          f"{MOD_SHIFT:+} pA)", flush=True)
    counter = RepeatCounter(base, mod_model_file=twin, device="cuda")
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    mod_hmms = {id(tc.mod_hmm) for tc in counter.targets["c9orf72"]}
    captured, batches = [], []
    submit, vit_submit = counter.detect_submit, counter._viterbi_submit

    def counted_submit(*a, **k):
        batches.append(len(a[1]))
        return submit(*a, **k)

    def captured_submit(chm, segments):
        h = vit_submit(chm, segments)
        if id(chm) in mod_hmms:
            captured.append((chm, h))
        return h

    counter.detect_submit, counter._viterbi_submit = counted_submit, captured_submit

    def stream():
        out = {}
        sched = StreamScheduler(counter, lambda ctx, res: out.__setitem__(ctx, res),
                                batch_size=BATCH)
        for rid, t, strand, _k, sig in reads:
            sched.add(rid, t, strand, sig)
        sched.close()
        return out

    stream()  # first use
    torch.cuda.synchronize()
    del captured[:], batches[:]
    _build.reset_launches()
    t0 = time.perf_counter()
    out = stream()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    n_batches = list(batches)
    if sorted(out) != sorted(r[0] for r in reads):
        fail(f"the mod stream returned {len(out)} of {len(reads)} reads")
    inexact = [(rid, out[rid][0]) for rid, *_ in reads if out[rid][0] != expect[rid]]
    off = {rid: n for rid, n in expect.items() if n != MOD_REPEATS}
    shares = {}
    for rid, _t, strand, kind, _s in reads:
        mod = out[rid][6]
        share = mod.count("1") / len(mod) if mod not in ("", "-") else None
        shares[rid] = (strand, kind, share)
    bad = [rid for rid, (_s, kind, share) in shares.items()
           if share is None or (share > 0.5) != bool(kind)]
    for strand in "+-":
        for kind, label in ((0, "base"), (1, "twin")):
            sh = [v[2] for v in shares.values() if v[0] == strand and v[1] == kind]
            ok = sum(1 for x in sh if x is not None and (x > 0.5) == bool(kind))
            print(f"  mod '{strand}' {label} reads: {ok}/{len(sh)} separated; '1' share "
                  f"{min(x or 0.0 for x in sh):.3f}-{max(x or 0.0 for x in sh):.3f}", flush=True)
    print(f"mod stream: {len(reads) / dt:.2f} reads/s ({len(reads)} reads in {dt:.3f} s, "
          f"{len(n_batches)} batches of {n_batches} reads); counts "
          f"{len(reads) - len(inexact)}/{len(reads)} as expected ({MOD_REPEATS} units; "
          f"{json.dumps(off)} as the JAX package counts them); card: {card}; launches "
          f"{json.dumps({k: v for k, v in launches.items() if v})}", flush=True)
    if inexact:
        fail(f"counts off the expected in the mod stream: {inexact[:8]}")
    if bad:
        fail(f"{len(bad)} reads not separated (twin '1' share > 0.5, base < 0.5): "
             f"{[(r, shares[r]) for r in bad[:6]]}")

    # every mod forward launch on the diagonal-only layout, none dense
    groups = sum(-(-h["obs"].shape[0] // VC.GROUP) for _c, h in captured)
    if (launches[diag] != groups or groups == 0 or any(launches[k] for k in DENSE)
            or launches["viterbi_forward_factored"] <= 0):
        fail(f"the mod decodes did not run the diagonal-only forward alone ({groups} mod "
             f"decode calls, launches {json.dumps({k: launches[k] for k in (diag, *DENSE)})})")
    # the captured mod obs batches through the plain twins on the card
    for chm, h in captured:
        ph = counter._padded_hmm(chm)
        o = h["obs"].to("cuda")
        n = torch.from_numpy(h["lens"]).to("cuda")
        want = plain_decode(o, n, ph)[: h["B"]].cpu().to(torch.int64)
        if not torch.equal(h["paths"][: h["B"]].to(torch.int64), want):
            fail("a mod decode's paths differ from the plain twins' on its captured obs batch")
    print(f"mod decodes: {len(captured)} batches of {[h['B'] for _c, h in captured]} reads "
          f"({groups} forward launches, layout {diag}); each batch's paths equal the plain "
          f"twins' on its captured obs", flush=True)

    # every row: detect_many's tuple in a fresh counter
    fresh = RepeatCounter(base, mod_model_file=twin, device="cuda")
    fresh.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    many = {}
    for strand in "+-":
        rs = [r for r in reads if r[2] == strand]
        for i in range(0, len(rs), BATCH):
            chunk = rs[i : i + BATCH]
            for r, res in zip(chunk, fresh.detect_many("c9orf72", [r[4] for r in chunk],
                                                       strand)):
                many[r[0]] = list(res)
                if tuple(res) != tuple(out[r[0]]):
                    fail(f"the stream's row for {r[0]} differs from detect_many's in a fresh "
                         f"counter: {out[r[0]]} against {res}")
    print("mod stream: every row equal to detect_many's tuple in a fresh counter, mod string "
          "included", flush=True)

    # where the device time goes in one more stream run; the mod decode of
    # the largest captured batch by CUDA events
    rows, wall = profile_pass(f"mod stream, {len(reads)} reads", stream, card)
    fwd_ms = sum(t for key, t, _ in rows if "Layout<12, 0>" in key)
    kernel_ms = sum(r[1] for r in rows)
    chm, h = max(captured, key=lambda c: c[1]["B"])
    ph = counter._padded_hmm(chm)
    o = h["obs"].to("cuda")
    n = torch.from_numpy(h["lens"]).to("cuda")
    before = dict(_build.LAUNCHES)
    decode_ms = cuda_ms(lambda: VC.viterbi_batch(o, n, ph), 3)
    _build.LAUNCHES.update(before)
    print(f"mod stream: the diagonal-only forward's device time {fwd_ms:.3f} ms of "
          f"{kernel_ms:.3f} ms kernels in a {wall:.2f} ms run; one mod decode of {h['B']} reads "
          f"(T {o.shape[1]}, SP {ph.sp}) {decode_ms:.3f} ms by CUDA events; card: {card}",
          flush=True)

    # the count CLI with --mod_model, on the in-memory index
    repeat_tsv = write_repeat_config(os.path.join(tmp, "mod_repeats.tsv"),
                                     {"c9orf72": LOCI["c9orf72"]})
    chrom, begin = LOCI["c9orf72"][:2]
    sam = os.path.join(tmp, "mod_algn.sam")
    with open(sam, "w") as fp:
        fp.write("@HD\tVN:1.6\n" + "".join(sam_line(r[0], r[2], chrom, begin) for r in reads))
    fofn = os.path.join(tmp, "mod_memory.fofn")
    open(fofn, "w").close()
    tsv = os.path.join(tmp, "mod_counts.tsv")
    inner = detector.Fast5Index
    detector.Fast5Index = lambda _path: MemoryIndex(reads)
    _build.reset_launches()
    try:
        rc = cli.main(["count", fofn, base, repeat_tsv, "--algn", sam, "--out", tsv,
                       "--mod_model", twin])
    finally:
        detector.Fast5Index = inner
    cli_launches = dict(_build.LAUNCHES)
    if rc != 0:
        fail(f"count --mod_model exited {rc}")
    lines = open(tsv).read().splitlines()
    want = sorted("\t".join(str(x) for x in (r[0], r[1], r[2], *out[r[0]])) for r in reads)
    if not lines or lines[0] != "\t".join(HEADER) or sorted(lines[1:]) != want:
        fail("count --mod_model's rows differ from the mod stream's")
    if cli_launches[diag] <= 0 or any(cli_launches[k] for k in DENSE):
        fail("count --mod_model did not decode the mod HMM on the diagonal-only forward alone")
    print(f"count --mod_model (cli.main at its card defaults, in-memory index): "
          f"{len(lines) - 1} rows equal to the mod stream's; {diag} launches "
          f"{cli_launches[diag]}", flush=True)
    return {"reads_per_sec": len(reads) / dt, "seconds": dt, "batches": n_batches,
            "launches": launches, "mod_decode_calls": len(captured),
            "diag_forward_device_ms": fwd_ms, "kernel_ms": kernel_ms, "wall_ms": wall,
            "decode_ms": decode_ms, "decode_reads": h["B"], "cli_launches": cli_launches,
            "detect_many": many}


def viterbi_peaks(peaks: list):
    """A stand-in for the counter's ``viterbi_batch`` that appends each
    call's peak device memory past what was allocated before it, the
    obs shape and the rows a call (synchronising around the call)."""
    import torch

    from strique_tpu_torch.ops import viterbi_cuda as VC

    def measured(obs, t_actual, ph, group=VC.GROUP):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = VC.viterbi_batch(obs, t_actual, ph, group)
        torch.cuda.synchronize()
        peaks.append((torch.cuda.max_memory_allocated() - base, tuple(obs.shape), group, ph.sp))
        return out

    return measured


def run_routes(model: str, seed: int, card: str, tmp: str, warm, plus, minus, split,
               split_rps: float, mod_rows: dict, split_counter) -> dict:
    """Phase 4k: the counter's other two routes over phase 4's reads, each
    in a fresh counter after a warm-up pass: the fused single dispatch
    (``STRIQUE_SPLIT=0``) and the two-phase host-bounds path (``fused =
    False``).  Every count exact; the fused tuples equal phase 4's split
    tuples; the two-phase counts, offsets and ticks equal them, its
    scores and log_p within 1e-6 relative, and its first 8 '+' tuples
    equal the port's CPU two-phase path's.  The fused route must launch
    row 2's TABLE mode, the traceback and rows 3-4 and not row 1; the
    two-phase route row 1's TABLE mode twice a batch (one call a flank),
    the traceback and rows 3-4, and not row 2; neither a POW, two-pass or
    column kernel.  Then the peak device memory of the fused Viterbi
    calls of one batch; ROUTE_ROUNDS rounds of one '+' pass of each route
    (phase 4's split counter among them), the routes' order turning each
    round, and one profiled '+' pass of each new route; phase 4h's mod
    reads through the fused route (every row equal to phase 4h's
    ``detect_many`` row, mod string included) and phase 4f's 150-base
    target (SP 1152) through it (tuples equal to the default route's, and
    its Viterbi call's peak memory).  Returns the rates, launches, peaks
    and profiles."""
    import numpy as np
    import torch

    from strique_tpu_torch import _build
    from strique_tpu_torch.detect import counter as CT
    from strique_tpu_torch.detect.counter import RepeatCounter, fused_viterbi_rows
    from strique_tpu_torch.pore_model import PoreModel
    from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, WIDE_UNIT_BASES,
                                             make_reads, mod_workload)

    def fresh(route, *args, **kw):
        if route == "fused":
            os.environ["STRIQUE_SPLIT"] = "0"
        try:
            c = RepeatCounter(*args, device="cuda", **kw)
        finally:
            os.environ.pop("STRIQUE_SPLIT", None)
        c.fused = route != "two-phase"
        return c

    out = {"split_reads_per_sec": split_rps}
    runs = {}
    for route in ("fused", "two-phase"):
        c = fresh(route, model)
        c.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
        run_pipeline(c, warm, "+")
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res_p = run_pipeline(c, plus, "+")
        dt = time.perf_counter() - t0
        res_m = run_pipeline(c, minus, "-")
        runs[route] = (c, res_p + res_m, dict(_build.LAUNCHES))
        out[route] = {"reads_per_sec": len(plus) / dt, "plus_s": dt,
                      "launches": {k: v for k, v in runs[route][2].items() if v}}
        ok = sum(int(r[0] == REPEATS) for r in res_p + res_m)
        print(f"{route} route: {ok}/{len(plus) + len(minus)} exact; {len(plus) / dt:.2f} "
              f"reads/s on the '+' pass ({dt:.3f} s) beside the split route's {split_rps:.2f} "
              f"(phase 4); card: {card}; launches {json.dumps(out[route]['launches'])}",
              flush=True)
        if ok != len(plus) + len(minus):
            fail(f"inexact repeat counts on the {route} route")
    split = [tuple(r) for r in split]
    fused, two = ([tuple(r) for r in runs[k][1]] for k in ("fused", "two-phase"))
    if fused != split:
        fail("the fused route's tuples differ from the split route's")
    for f, t in zip(fused, two):
        if (f[0], f[4], f[5], f[6]) != (t[0], t[4], t[5], t[6]) or not np.allclose(
                f[1:4], t[1:4], rtol=1e-6, atol=0):
            fail(f"the two-phase route's tuple {t} is not the fused route's {f} within 1e-6")
    cpu = RepeatCounter(model, device="cpu")
    cpu.fused = False
    cpu.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    if [tuple(r) for r in cpu.detect_many("c9orf72", plus[:8], "+")] != two[:8]:
        fail("the first 8 '+' two-phase tuples differ from the port's CPU two-phase path's")
    print("fused tuples equal the split route's; two-phase counts, offsets and ticks equal, "
          "scores and log_p within 1e-6, its first 8 '+' tuples the CPU two-phase path's",
          flush=True)
    batches = -(-len(plus) // BATCH) + -(-len(minus) // BATCH)
    rules = {"fused": ({"align_forward_wave_multi_table": batches, "traceback_pointers": batches},
                       ("align_forward_wave_table",)),
             "two-phase": ({"align_forward_wave_table": 2 * batches,
                            "traceback_pointers": 2 * batches},
                           ("align_forward_wave_multi_table",))}
    banned = POW_WAVE + POW_TWO_PASS + TABLE_TWO_PASS + COL + ("traceback_pointers_col",)
    for route, (want, replaced) in rules.items():
        lc = runs[route][2]
        if ({k: lc[k] for k in want} != want
                or lc["viterbi_forward_factored"] < batches
                or lc["viterbi_backward_batch"] < batches
                or any(lc[k] for k in replaced + banned)):
            fail(f"the {route} route did not launch {want} and rows 3-4 alone")

    counters = {"split": split_counter, "fused": runs["fused"][0],
                "two-phase": runs["two-phase"][0]}
    order = list(counters)
    rates = {k: [] for k in order}
    for r in range(ROUTE_ROUNDS):
        for route in order[r % 3:] + order[: r % 3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_pipeline(counters[route], plus, "+")
            rates[route].append(len(plus) / (time.perf_counter() - t0))
    out["rounds"] = rates
    print(f"'+' pass, {ROUTE_ROUNDS} rounds, the routes' order turning: "
          + "; ".join(f"{k} {np.median(v):.2f} reads/s (median; {min(v):.2f}-{max(v):.2f})"
                      for k, v in rates.items()) + f"; card: {card}", flush=True)
    for route in ("fused", "two-phase"):
        rows, wall = profile_pass(f"{route} route, {len(plus)} '+' reads",
                                  lambda: run_pipeline(counters[route], plus, "+"), card)
        kernel = sum(r[1] for r in rows)
        out[route]["profile"] = {"wall_ms": wall, "kernel_ms": kernel, "busy": kernel / wall,
                                 "kernels": rows[:6]}

    fc = runs["fused"][0]
    peaks: list = []
    real = CT.viterbi_batch
    CT.viterbi_batch = viterbi_peaks(peaks)
    try:
        if [tuple(r) for r in fc.detect_many("c9orf72", plus[:BATCH], "+")] != split[:BATCH]:
            fail("the fused route's measured batch differs from the split route's")
    finally:
        CT.viterbi_batch = real
    npad = CT.signal_bucket(len(plus[0]))
    out["fused_viterbi"] = [{"peak_bytes": b, "obs": o, "rows": g, "sp": sp}
                            for b, o, g, sp in peaks]
    print(f"fused Viterbi of a {BATCH}-read batch: {len(peaks)} call(s), obs {peaks[0][1]}, "
          f"{peaks[0][2]} rows a call (fused_viterbi_rows: "
          f"{fused_viterbi_rows(npad, fc.targets['c9orf72'][0].repeat_hmm.n_states, 'cuda')}), "
          f"SP {peaks[0][3]}: peak {peaks[0][0] / 2**30:.3f} GiB past the batch's tensors "
          f"(the score plane {npad * peaks[0][2] * peaks[0][3] * 4 / 2**30:.3f} GiB)", flush=True)

    # phase 4h's mod reads (its model files are in tmp) through the fused route
    base, twin = (os.path.join(tmp, f) for f in ("mod_base.model", "mod_twin.model"))
    mplus, mminus = mod_workload(PoreModel(base), PoreModel(twin), seed)
    mc = fresh("fused", base, mod_model_file=twin)
    mc.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    _build.reset_launches()
    n_mod = 0
    for strand, sigs in (("+", mplus), ("-", mminus)):
        for i in range(0, len(sigs), BATCH):
            for j, r in enumerate(mc.detect_many("c9orf72", sigs[i : i + BATCH], strand)):
                rid = f"mod{strand}{i + j:03d}"
                if list(r) != mod_rows[rid]:
                    fail(f"the fused route's mod row for {rid} differs from phase 4h's: {r} "
                         f"against {mod_rows[rid]}")
                n_mod += 1
    lc = dict(_build.LAUNCHES)
    if (lc["align_forward_wave_multi_table"] <= 0 or lc["viterbi_forward_factored_diag"] <= 0
            or lc["align_forward_wave_table"]):
        fail("the fused mod run did not go through row 2 and the diagonal-only forward")
    print(f"fused route with the mod model: {n_mod} rows equal phase 4h's detect_many rows, "
          f"mod strings included", flush=True)

    # phase 4f's 150-base target (SP 1152), default route then fused
    pm = PoreModel(model)
    rng = np.random.default_rng(5)
    unit = "".join(rng.choice(list("ACGT"), WIDE_UNIT_BASES))
    reads = make_reads(pm, WIDE_READS, WIDE_UNITS, rng, "+", repeat=unit)
    wc = RepeatCounter(model, device="cuda")
    wc.add_target("wide", unit, PREFIX, SUFFIX)
    ref = wc.detect_many("wide", reads, "+")
    wc.split = False
    wide_peaks: list = []
    _build.reset_launches()
    CT.viterbi_batch = viterbi_peaks(wide_peaks)
    try:
        got = wc.detect_many("wide", reads, "+")
    finally:
        CT.viterbi_batch = real
    lc = dict(_build.LAUNCHES)
    if [tuple(r) for r in got] != [tuple(r) for r in ref]:
        fail("the wide target's fused tuples differ from its default route's")
    if (lc["align_forward_wave_multi_table"] <= 0 or lc["viterbi_forward_factored_wide"] <= 0
            or lc["viterbi_backward_wide"] <= 0):
        fail("the wide target's fused run did not decode with the wide variants")
    b, o, g, sp = wide_peaks[0]
    out["wide_fused_viterbi"] = {"peak_bytes": b, "obs": o, "rows": g, "sp": sp}
    print(f"wide target through the fused route: counts {[r[0] for r in got]}, tuples equal "
          f"the default route's; its Viterbi call: obs {o}, {g} rows a call, SP {sp}, peak "
          f"{b / 2**30:.3f} GiB past the batch's tensors (the score plane "
          f"{o[1] * o[0] * sp * 4 / 2**30:.3f} GiB); card: {card}", flush=True)
    return out


def run_pipeline(counter, sigs, strand):
    """bench.py's three-stage loop: batch k's Viterbi overlaps batch k+1's align."""
    out = []
    pending = []
    for b0 in range(0, len(sigs), BATCH):
        pending.append(counter.detect_submit("c9orf72", sigs[b0 : b0 + BATCH], strand))
        if len(pending) >= 2:
            pending[-2] = counter.detect_middle(pending[-2])
        if len(pending) >= 3:
            out += counter.detect_finish(pending.pop(0))
    for state in pending:
        out += counter.detect_finish(state)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None, help="also write the measurements as JSON here")
    args = ap.parse_args()

    # -- phase 1: the card --------------------------------------------------
    try:
        import torch
    except ImportError as e:
        fail(f"torch is not importable: {e}")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import numpy as np

        from strique_tpu_torch import _build, native
        from strique_tpu_torch.detect.counter import RepeatCounter, signal_bucket
        from strique_tpu_torch.hmm.models import build_flanked_repeat
        from strique_tpu_torch.pore_model import PoreModel
        from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, smoke_workload,
                                                 ultralong_workload, write_mod_model,
                                                 write_pore_model)
    except ImportError as e:
        fail(f"the port is not importable from this directory: {e}")
    if "jax" in sys.modules or "strique_tpu" in sys.modules:
        fail("jax or the JAX package was imported")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "nvidia-smi unavailable"
    print(f"device: {kind} ({torch.cuda.device_count()} visible); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    print(smi.stdout.strip() if smi.returncode == 0 else card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 2: build -----------------------------------------------------
    t0 = time.perf_counter()
    host_prep = threading.Thread(target=native.available)  # g++ beside the nvcc builds
    host_prep.start()
    try:
        _build.build(force=True)
        _build.lib()
    except Exception as e:  # noqa: BLE001 - any build failure is fatal here
        fail(f"kernel build failed: {e}")
    host_prep.join()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s (nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
          f"source; native host prep {'built' if native.available() else 'UNAVAILABLE'})",
          flush=True)
    for line in _build.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or ("spill" in line and not line.strip().startswith("0 bytes")):
            print(f"  ptxas: {line.strip()}", flush=True)

    # -- phase 3: every kernel against its plain twin -----------------------
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, tmp, True)
    model = write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=args.seed)
    pm = PoreModel(model)
    counter = RepeatCounter(model, device="cuda")
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    tc = counter.targets["c9orf72"][0]
    rng = np.random.default_rng(args.seed + 7)
    params = counter.align_params
    # samples=6 templates, as the counter builds them (np.repeat of k-mer levels)
    small = tuple(np.repeat(rng.uniform(60, 120, k), 6).astype(np.float32) for k in (7, 5))
    bench_t = (tc.prefix_ext, tc.suffix_ext)
    results: dict = {}
    ultra = ultralong_workload(pm, args.seed, repeats=ULTRA_REPEATS)
    print("kernels vs plain twins:", flush=True)
    try:
        check_mode_rule(params, rng)
        for shape_name, B, N, tmpls in (("small", 8, 512, small), ("bench", 64, 24576, bench_t)):
            for multi in (False, True):
                # row 2 at the split path's fused width: both flanks of 64 reads
                Bw = 2 * B if multi and shape_name == "bench" else B
                ptr, bot, n_d, m_d = check_wave(tmpls, shape_name, Bw, N, params, multi, rng,
                                                results)
                if multi:
                    j_end = (torch.argmax(bot, dim=1).to(torch.int32) + 1 - m_d).clamp_min(0)
                    check_traceback(ptr, j_end.to(torch.int32), m_d, shape_name, results)
                del ptr, bot
                torch.cuda.empty_cache()
            check_col(tmpls[0], shape_name, B, N, params, rng, results)
            torch.cuda.empty_cache()
        # its own seeds: the draws after it stay as they were
        check_traceback_planes(args.seed + 40, results)
        torch.cuda.empty_cache()
        for shape_name, B, T in (("small", 8, 512), ("bench", 64, 6144)):
            check_viterbi(pm, tc.repeat_hmm, shape_name, B, T, rng, results)
            check_dense(pm, tc.repeat_hmm, shape_name, B, T, rng, results)
        # the ultra-long route's segments: ~9x the bench T (rescale and acc)
        check_viterbi(pm, tc.repeat_hmm, "ultra", 8, ULTRA_T, rng, {}, repeats=ULTRA_REPEATS)
        check_dense(pm, tc.repeat_hmm, "ultra", 8, ULTRA_T, rng, None, repeats=ULTRA_REPEATS)
        # the dense forward's other resident widths at the bench's reads
        # and T: SP 128 (25-base flanks, 116 states: the width of a mod
        # HMM), SP 384 (75-base flanks: clusters of 6 CTAs; its own
        # generator, so the draws after it stay as they were), SP 512
        # (100-base flanks: clusters of 8 CTAs)
        for flank in (25, 75, 100):
            hmm = build_flanked_repeat(REPEAT, PREFIX[-flank:], SUFFIX[:flank], pm)
            check_dense(pm, hmm, f"bench, {flank}-base flanks", 64, 6144,
                        np.random.default_rng(args.seed + 75) if flank == 75 else rng, None,
                        flank=flank)
        check_viterbi_edges(pm, rng)
        # the mod decode's forward layout and the backward at a mod HMM's
        # shapes (GGCCCC: 26 states, SP 128; a 60-base unit: 242, SP 256);
        # their own generator, so the draws after them stay as they were
        mod_pm = PoreModel(write_mod_model(os.path.join(tmp, "twin.model"), seed=args.seed))
        mod_rng = np.random.default_rng(args.seed + 50)
        check_viterbi_mod(pm, mod_pm, REPEAT, "mod", 64, 3072, mod_rng, results)
        unit60 = "".join(mod_rng.choice(list("ACGT"), VNTR_UNIT_BASES))
        check_viterbi_mod(pm, mod_pm, unit60, "mod, 60-base unit", 64, 3072, mod_rng, None)
        # rows 3-4 past SP 1024 (their own generator)
        check_viterbi_wide(pm, mod_pm, args.seed, results)
        check_longread(small[:1], "small", 8, 4096, params, 512, True, rng)
        check_longread(small, "small", 16, 4096, params, 512, True, rng)
        # the bench template's span bound (29,581 steps) exceeds ND: all
        # windows cold.  16 rows of per-row templates: the row stream of
        # phase 4b's two-pass route (both flanks of 8 reads)
        check_longread(bench_t[:1], "bench", 8, 24576, params, 16384, False, rng)
        check_longread(bench_t, "bench", 16, 24576, params, 16384, False, rng, results)
        torch.cuda.empty_cache()
        # row 1 at the shape phase 4b's one-pass route launches it, row 5 at
        # its two-pass route's
        ultra_n = signal_bucket(max(len(r) for r in ultra))
        check_wave_ultra(tc.prefix_ext, 8, ultra_n, params, rng, results)
        torch.cuda.empty_cache()
        check_ckpt_ultra(tc.prefix_ext, ultra_n, params, rng, results)
        # rows 1, 2, 5, 6 and 8 and both tracebacks over the AlignParams sweep
        torch.cuda.empty_cache()
        sweep = check_sweep(args.seed)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"kernel comparison raised {type(e).__name__}: {e}")

    # -- phase 4: the counting path end to end ------------------------------
    warm, plus, minus = smoke_workload(pm, args.seed, n_warm=BATCH, n_plus=128, n_minus=24,
                                       repeats=REPEATS)
    print(f"workload: {len(plus)} '+' reads of {len(plus[0])} samples, {len(minus)} '-' reads "
          f"of {len(minus[0])} samples, {REPEATS} repeat units", flush=True)
    try:
        run_pipeline(counter, warm, "+")  # first use: allocator and host pools
        torch.cuda.synchronize()
        _build.reset_launches()
        t0 = time.perf_counter()
        res_plus = run_pipeline(counter, plus, "+")
        dt_plus = time.perf_counter() - t0
        plus_launches = dict(_build.LAUNCHES)
        t1 = time.perf_counter()
        res_minus = run_pipeline(counter, minus, "-")
        dt_minus = time.perf_counter() - t1
        launches = dict(_build.LAUNCHES)
    except Exception as e:  # noqa: BLE001
        fail(f"counting path raised {type(e).__name__}: {e}")
    ok_plus = sum(int(r[0] == REPEATS) for r in res_plus)
    ok_minus = sum(int(r[0] == REPEATS) for r in res_minus)
    rps = len(plus) / dt_plus
    print(f"counts: {ok_plus}/{len(plus)} (+) and {ok_minus}/{len(minus)} (-) exact", flush=True)
    print(f"throughput: {rps:.2f} reads/s on the '+' pass ({len(plus)} reads in "
          f"{dt_plus:.3f} s); '-' partial batch {dt_minus * 1e3:.1f} ms; card: {card}",
          flush=True)
    print(f"launches in the counting run: {json.dumps(launches)}", flush=True)
    print(f"wave launches on the '+' pass: "
          f"{json.dumps({k: plus_launches[k] for k in TABLE_WAVE + POW_WAVE})} (two flanks of "
          f"{BATCH} reads: {2 * BATCH} rows a call where the card's width allows)", flush=True)
    if ok_plus != len(plus) or ok_minus != len(minus):
        fail("inexact repeat counts: " + str([r[0] for r in res_plus + res_minus
                                               if r[0] != REPEATS][:10]))
    for name in SPLIT_KERNELS:
        if launches[name] <= 0:
            fail(f"kernel {name} was not launched by the counting path")
    if any(launches[k] for k in POW_WAVE):
        fail("a wave launch of the split path ran the POW score mode")
    if not all(np.isfinite(r[1]) and np.isfinite(r[2]) and np.isfinite(r[3])
               for r in res_plus + res_minus):
        fail("non-finite scores or log_p")
    ref_counter = RepeatCounter(model, device="cpu")
    ref_counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    ref = ref_counter.detect_many("c9orf72", plus[:8], "+")
    if [tuple(r) for r in ref] != [tuple(r) for r in res_plus[:8]]:
        fail("the first 8 '+' results differ from the plain CPU path")
    print("first 8 '+' result tuples equal the plain CPU path", flush=True)

    # -- phase 4b: the ultra-long two-pass route -----------------------------
    print(f"ultra-long workload: {len(ultra)} '+' reads of {len(ultra[0])} samples, "
          f"{ULTRA_REPEATS} repeat units", flush=True)
    runs = {}
    try:
        # 2 GiB: the bucket's ~4.7 GB width-8 plane does not fit (two-pass);
        # 8 GiB: it does at 8 rows a call (the one-pass route)
        for route, budget in (("two-pass", "2"), ("one-pass", "8")):
            os.environ["STRIQUE_PTR_BUDGET_GB"] = budget
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            res = counter.detect_many("c9orf72", ultra, "+")
            torch.cuda.synchronize()
            runs[route] = (res, time.perf_counter() - t0, dict(_build.LAUNCHES))
    except Exception as e:  # noqa: BLE001
        fail(f"ultra-long path raised {type(e).__name__}: {e}")
    finally:
        os.environ.pop("STRIQUE_PTR_BUDGET_GB", None)
    for route, (res, dt, lc) in runs.items():
        ok = sum(int(r[0] == ULTRA_REPEATS) for r in res)
        print(f"ultra-long {route}: {ok}/{len(res)} exact in {dt:.3f} s "
              f"(STRIQUE_PTR_BUDGET_GB={'2' if route == 'two-pass' else '8'}); card: {card}; "
              f"launches {json.dumps({k: v for k, v in lc.items() if v})}", flush=True)
        if ok != len(res):
            fail(f"inexact ultra-long counts on the {route} route: {[r[0] for r in res]}")
        if not all(np.isfinite(r[1]) and np.isfinite(r[2]) and np.isfinite(r[3]) for r in res):
            fail(f"non-finite scores or log_p on the {route} route")
    two_launches = runs["two-pass"][2]
    one_launches = runs["one-pass"][2]
    # two-pass: both flanks of the 8 reads in one 16-row group, TABLE mode
    if (two_launches["align_forward_ckpt_table"] != 1
            or two_launches["align_window_from_state_table"] <= 0
            or any(two_launches[k] for k in POW_TWO_PASS + POW_WAVE + TABLE_WAVE)):
        fail("the two-pass run did not go through one TABLE pass-1 launch for both flanks and "
             "the TABLE window kernel alone")
    if any(one_launches[k] for k in POW_TWO_PASS + TABLE_TWO_PASS):
        fail("the one-pass run took the two-pass route")
    # one-pass: 2 x 8 rows exceed the budget as one call, so each flank
    # runs its own 8-row call against one template (row 1, TABLE mode)
    if one_launches["align_forward_wave_table"] <= 0 or any(one_launches[k] for k in POW_WAVE):
        fail("the one-pass run did not align in the TABLE score mode")
    if [tuple(r) for r in runs["two-pass"][0]] != [tuple(r) for r in runs["one-pass"][0]]:
        fail("two-pass result tuples differ from the one-pass route's")
    print("ultra-long two-pass result tuples equal the one-pass route's", flush=True)
    for name in TABLE_TWO_PASS:
        launches[name] = two_launches[name]
    launches["align_forward_wave_table"] = one_launches["align_forward_wave_table"]

    # -- phase 4e: flanks past one CTA's score table (the cluster TABLE mode) -
    launches.update(run_over_cap(pm, model, args.seed, card, results))

    # -- phase 4l: a NaN level table in every alignment kernel, a flat read --
    try:
        check_nan(model, params, np.random.default_rng(args.seed + 60), card)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"the NaN phase raised {type(e).__name__}: {e}")

    # -- phase 4f: a repeat HMM past the dense forward's resident rule -------
    launches.update(run_vntr(pm, model, args.seed, card, results))
    # ... and past SP 1024 (the wide Viterbi variants), and past SP 8192
    try:
        launches.update(run_wide(model, args.seed, card, tmp))
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"the wide targets raised {type(e).__name__}: {e}")

    # -- phase 4c: where the device time goes --------------------------------
    try:
        profile_walks("split path, 128 '+' reads", lambda: run_pipeline(counter, plus, "+"), card,
                      results)
        for route, budget in (("two-pass", "2"), ("one-pass", "8")):
            os.environ["STRIQUE_PTR_BUDGET_GB"] = budget
            profile_walks(f"ultra-long {route}, 8 reads",
                          lambda: counter.detect_many("c9orf72", ultra, "+"), card, results)
    except Exception as e:  # noqa: BLE001
        fail(f"profiled pass raised {type(e).__name__}: {e}")
    finally:
        os.environ.pop("STRIQUE_PTR_BUDGET_GB", None)

    # -- phase 4d: the knob routes (column alignment, dense Viterbi) ---------
    knob_rps = {}
    for route, (var, value) in KNOBS.items():
        os.environ[var] = value
        try:
            kc = RepeatCounter(model, device="cuda")  # a fresh HMM cache sees the knob
            kc.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
            run_pipeline(kc, warm, "+")
            torch.cuda.synchronize()
            _build.reset_launches()
            t0 = time.perf_counter()
            k_plus = run_pipeline(kc, plus, "+")
            dt = time.perf_counter() - t0
            plus_lc = dict(_build.LAUNCHES)
            k_minus = run_pipeline(kc, minus, "-")
            lc = dict(_build.LAUNCHES)
            profile_walks(f"{var}={value}, 128 '+' reads", lambda: run_pipeline(kc, plus, "+"),
                          card, results)
        except Exception as e:  # noqa: BLE001
            fail(f"the {var}={value} route raised {type(e).__name__}: {e}")
        finally:
            os.environ.pop(var, None)
        ok_p = sum(int(r[0] == REPEATS) for r in k_plus)
        ok_m = sum(int(r[0] == REPEATS) for r in k_minus)
        knob_rps[route] = len(plus) / dt
        print(f"{var}={value}: {ok_p}/{len(plus)} (+) and {ok_m}/{len(minus)} (-) exact; "
              f"{knob_rps[route]:.2f} reads/s on the '+' pass ({dt:.3f} s); card: {card}; "
              f"launches {json.dumps({k: v for k, v in lc.items() if v})}", flush=True)
        if ok_p != len(plus) or ok_m != len(minus):
            fail(f"inexact repeat counts on the {var}={value} route")
        if [tuple(r) for r in k_plus + k_minus] != [tuple(r) for r in res_plus + res_minus]:
            fail(f"the {var}={value} route's result tuples differ from the default route's")
        if route == "col":
            minus_multi = (lc["align_forward_wave_multi_table"]
                           - plus_lc["align_forward_wave_multi_table"])
            if (plus_lc["align_forward_col_table"] <= 0 or plus_lc["align_forward_col"] != 0
                    or plus_lc["traceback_pointers_col"] <= 0
                    or any(plus_lc[k] for k in POW_WAVE + TABLE_WAVE) or minus_multi <= 0):
                fail("the column route's '+' pass did not run the TABLE column kernel and the "
                     "column traceback alone, or its '-' partial batch left the fused wave "
                     "kernel")
            for name in ("align_forward_col_table", "traceback_pointers_col"):
                launches[name] = lc[name]
        else:
            if (lc["viterbi_forward_dense_resident"] <= 0 or lc["viterbi_forward_dense"] != 0
                    or lc["viterbi_forward_factored"] != 0):
                fail("the dense route did not decode with the resident dense forward alone")
            launches["viterbi_forward_dense_resident"] = lc["viterbi_forward_dense_resident"]
    print("both knob routes' result tuples equal the default route's", flush=True)

    # -- phase 4g: the count path over a stream of both loci -----------------
    try:
        count = run_count_stream(model, pm, args.seed, card, tmp)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"the count path raised {type(e).__name__}: {e}")

    # -- phase 4h: mod calling ------------------------------------------------
    try:
        mod = run_mod(args.seed, card, tmp)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"the mod path raised {type(e).__name__}: {e}")
    launches["viterbi_forward_factored_diag"] = mod["launches"]["viterbi_forward_factored_diag"]

    # -- phase 4i: several device entries (the one card, twice) --------------
    # -- phase 4j: count as two processes over gloo --------------------------
    try:
        run_devices(model, pm, args.seed, card, tmp, ultra, runs["two-pass"][0])
        hosts_s = run_hosts(model, pm, args.seed, card, tmp)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"the multi-device or multi-host path raised {type(e).__name__}: {e}")

    # -- phase 4k: the fused dispatch and the two-phase host-bounds path -----
    try:
        routes = run_routes(model, args.seed, card, tmp, warm, plus, minus,
                            res_plus + res_minus, rps, mod.pop("detect_many"), counter)
    except SystemExit:
        raise
    except Exception as e:  # noqa: BLE001
        fail(f"the fused or two-phase route raised {type(e).__name__}: {e}")

    # -- phase 5: report ----------------------------------------------------
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (src, rep) in SOURCES.items()]
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": card, "kind": kind, "build_s": build_s, "reads_per_sec": rps,
                       "plus_s": dt_plus, "minus_s": dt_minus,
                       "ultra_s": {k: v[1] for k, v in runs.items()},
                       "knob_reads_per_sec": knob_rps, "count_stream": count, "mod": mod,
                       "hosts_s": hosts_s, "routes": routes, "sweep": sweep,
                       "kernels": kernels},
                      fp, indent=1)
    print(json.dumps({"kernels": [{k: kern[k] for k in KERNEL_KEYS} for kern in kernels]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
