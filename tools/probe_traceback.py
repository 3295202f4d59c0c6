"""Probe: where does a step of the traceback's walk go?

Runs the traceback kernel (csrc/traceback.cu), and its walk through a
counting hook (tools/probe_traceback.cu: clock64 sums per step), on
the planes chip_smoke.py walks: the bench shape's diagonal plane (row 2's TABLE
call, 128 rows) and column plane (row 8's TABLE call, 64 rows), and the
hard planes of ``synthetic.traceback_plane`` (128 rows, both layouts).
Each in three states:

  * ``warm``  the same walk ran just before (its words in L2);
  * ``cold``  L2 flushed (256 MB written) before the walk;
  * ``fresh`` the plane's producer ran just before (the order of a pass:
    the forward kernel writes the plane, the walk reads it).

For each: the device time of 5 launches (CUDA events around each, all
queued behind a sleep so host time stays off the timeline), and from
the counted launch the longest row's setup cycles (entry to the first
step), its steps by kind (fast: the next word in the slot's window;
group: entering the next word group; reload: leaving the window; other:
column 0 or a chunk stored) with their mean cycles, and its walk in
cycles and ns.  Every launch's outputs are held equal to
``_traceback_plain``.  Needs a CUDA card and nvcc.

    python tools/probe_traceback.py [--out f.json] [--sass f.txt]
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from strique_tpu_torch import _build  # noqa: E402
from strique_tpu_torch.detect.counter import RepeatCounter  # noqa: E402
from strique_tpu_torch.ops import align as AL  # noqa: E402
from strique_tpu_torch.ops import align_cuda as AC  # noqa: E402
from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, traceback_plane,  # noqa: E402
                                         write_pore_model)

STATS = ("setup", "n_fast", "c_fast", "n_group", "c_group", "n_reload", "c_reload", "n_other",
         "c_other", "c_walk", "ns_walk")
KINDS = ("fast", "group", "reload", "other")


def build_probe() -> ctypes.CDLL:
    out = os.path.join(_build.build_dir(), "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_traceback.so")
    src = os.path.join(ROOT, "tools", "probe_traceback.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, src], check=True)
    handle = ctypes.CDLL(lib)
    handle.probe_walk_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    handle.probe_walk_launch.restype = ctypes.c_int
    return handle


def probe_walk(lib, ptr, j_end, m_start, m_out, col):
    """One launch of the walk with the counting hook; (outputs, stats)."""
    B = j_end.shape[0]
    dev = ptr.device
    out = {"is_gap": torch.empty((B, m_out), dtype=torch.bool, device=dev),
           "jpos": torch.empty((B, m_out), dtype=torch.int32, device=dev),
           "j_begin": torch.empty((B,), dtype=torch.int32, device=dev)}
    stats = torch.zeros((B, len(STATS)), dtype=torch.int64, device=dev)
    args = [ptr.data_ptr(), j_end.data_ptr(), m_start.data_ptr(), out["is_gap"].data_ptr(),
            out["jpos"].data_ptr(), out["j_begin"].data_ptr(), stats.data_ptr(), B,
            ptr.shape[2], m_out, int(col)]
    stream = torch.cuda.current_stream().cuda_stream
    err = lib.probe_walk_launch(*args, stream)
    if err:
        raise RuntimeError(f"probe launch: CUDA error {err}")
    return out, stats


def bench_planes(seed: int):
    """(name, col, ptr, j_end, m_start, m_out, producer): the bench
    shape's planes as phase 3 makes them and the hard planes;
    ``producer()`` writes the same plane again and returns it."""
    tmp = os.path.join(_build.build_dir(), "probe")
    counter = RepeatCounter(write_pore_model(os.path.join(tmp, "synthetic_6mer.model"),
                                             seed=seed), device="cuda")
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    tc = counter.targets["c9orf72"][0]
    params = counter.align_params
    rng = np.random.default_rng(seed + 7)
    _, dev_in = CS.wave_inputs((tc.prefix_ext, tc.suffix_ext), True, 128, 24576, rng)
    b_d, l_d, n_d, m_d, lv_d, li_d, _ = dev_in
    wave = lambda: CS.morph_call(True, b_d, l_d, n_d, m_d, lv_d, li_d, params)[0]
    _, bot = CS.morph_call(True, b_d, l_d, n_d, m_d, lv_d, li_d, params)
    j_end = (torch.argmax(bot, dim=1).to(torch.int32) + 1 - m_d).clamp_min(0).to(torch.int32)
    yield "diag bench", False, wave(), j_end, m_d, int(m_d.max()), wave
    _, dev_in = CS.wave_inputs((tc.prefix_ext,), False, 64, 24576, rng)
    b_d, l_d, n_d, m_d, lv_d, li_d, _ = dev_in
    m = int(m_d[0])
    col = lambda: AC.align_forward_col_morph(b_d, l_d, n_d, lv_d, li_d, params, m)[0]
    _, bot = AC.align_forward_col_morph(b_d, l_d, n_d, lv_d, li_d, params, m)
    b0 = torch.full((64, 1), float(AL._b0(params, m)), device=bot.device)
    j_end = torch.argmax(torch.cat([b0, bot], dim=1), dim=1).to(torch.int32)
    yield "col bench", True, col(), j_end, m_d, m, col
    for col in (False, True):
        ptr, j_end, m_start, m_out = traceback_plane(128, seed + 168, col)
        src = torch.from_numpy(ptr).cuda()
        ptr_d = src.clone()
        yield (f"{'col' if col else 'diag'} hard", col, ptr_d, torch.from_numpy(j_end).cuda(),
               torch.from_numpy(m_start).cuda(), m_out, lambda p=ptr_d, s=src: p.copy_(s))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sass", default=None, help="write the shipped kernels' SASS here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_traceback: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    lib_path = _build.build()
    lib = build_probe()
    if args.sass:
        sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump"),
                               "-sass", lib_path], capture_output=True, text=True).stdout
        keep, out = False, []
        for line in sass.splitlines():
            if "Function :" in line:
                keep = "traceback_kernel" in line
            if keep:
                out.append(line)
        with open(args.sass, "w") as fp:
            fp.write("\n".join(out) + "\n")
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    results, bad = {}, 0
    for name, col, ptr, j_end, m_start, m_out, producer in bench_planes(args.seed):
        packed = True if col else "diag"
        run = lambda p: AL.traceback_pointers(p, j_end, m_out, packed=packed, m_start=m_start)
        ref = AL._traceback_plain(ptr, j_end, m_start, m_out, col=col)
        outs = [run(ptr), probe_walk(lib, ptr, j_end, m_start, m_out, col)[0]]
        ok = all(torch.equal(o[k], ref[k]) for o in outs for k in ("is_gap", "jpos", "j_begin"))
        bad += not ok
        states = {"warm": lambda: ptr, "cold": lambda: (flush.zero_(), ptr)[1],
                  "fresh": producer}
        entry = {}
        for state, before in states.items():
            times = CS.device_ms(run, 5, before)
            _, stats = probe_walk(lib, before(), j_end, m_start, m_out, col)
            st = stats.cpu().numpy()
            r = int(np.argmax(st[:, STATS.index("c_walk")]))
            row = dict(zip(STATS, (int(x) for x in st[r])))
            per = {k: row[f"c_{k}"] / max(row[f"n_{k}"], 1) for k in KINDS}
            steps = sum(row[f"n_{k}"] for k in KINDS) + 1
            ghz = row["c_walk"] / max(row["ns_walk"], 1)
            mean = {k: float(st[:, STATS.index(f"c_{k}")].sum()
                             / max(st[:, STATS.index(f"n_{k}")].sum(), 1)) for k in KINDS}
            entry[state] = {"device_ms": times, "longest_row": row, "cycles_per": per,
                            "ghz": ghz, "mean_cycles_all_rows": mean}
            print(f"{name} B={j_end.shape[0]} [{state}]: "
                  f"{' '.join(f'{t:.4f}' for t in times)} ms; counted: longest row {steps} "
                  f"steps in {row['ns_walk'] / 1e3:.2f} us ({row['ns_walk'] / steps:.1f} "
                  f"ns/step, {ghz:.3f} GHz), setup {row['setup']} cycles; "
                  + "; ".join(f"{k} {row[f'n_{k}']} x {per[k]:.1f}" for k in KINDS)
                  + " cycles; all rows: "
                  + ", ".join(f"{k} {mean[k]:.1f}" for k in KINDS), flush=True)
        results[name] = entry
        print(f"{name}: outputs {'equal' if ok else 'DIFFER'} (the kernel and the counted "
              f"walk against the plain walk)", flush=True)
        del ptr
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": smi, "planes": results}, fp, indent=1)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
