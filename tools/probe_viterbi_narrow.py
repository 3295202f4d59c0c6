"""Probe: the narrow factored forward (row 3 up to SP 1024) at every W.

Times, by CUDA events in turns, the parent kernel kept in
tools/probe_viterbi_narrow.cu (one CTA of SP threads a read, one state a
thread) beside csrc/viterbi_fwd.cu's ``viterbi_fwd_kernel<NV, L, W>`` on
W warps a read of S = SP / (32 W) states a lane, at every W with S 1, 2,
4 and (where it divides) 8, each held bit-equal to ``_fwd_plain`` (rows
below each read's length, fin, acc):

  * SP 256 chained, the carriers' count HMM (the c9orf72 target as the
    counter stages it), at 64 reads of T 6144 (PERF.md's row-3 shape)
    and of T 49152 (inside the carriers' 18k-89k-sample reads), and at 8
    reads of T 57344 (ultra-long);
  * SP 128 diagonal-only, the GGCCCC mod HMM, at 64 reads of T 3072;
  * for the rule (``viterbi_cuda.fwd_warps``), every other SP / 128 of
    both layouts at 64 reads of T 2048: repeat HMMs of a random unit
    between 50-base flanks (chained: SP 128 with 25-base flanks, 384 to
    1024 at 30 to 130 bases) and mod HMMs (diagonal-only: SP 256 to 1024
    at 60 to 250 bases).

Prints each probed kernel's registers, stack and spills from ``-Xptxas
-v`` (the package's 16 shipped instances and the probe's), then a line a
run, then the rule's pick beside the fastest W at each shape.
``--phases`` first times each W's step by phase in clock64 cycles (a
build with csrc/viterbi_fwd.cu's FWD_HOOK set to a counting hook: read 0,
lane 0 of each warp) at the two quick shapes.  Needs a CUDA card and nvcc:
``python tools/probe_viterbi_narrow.py [--quick] [--phases] [--out
f.json]``; ``--quick`` takes SP 256 chained at T 6144 and the mod shape
only; the whole probe took 155 s on an H100, ``--quick --phases`` 52-58
s, builds included.
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from strique_tpu_torch import _build  # noqa: E402
from strique_tpu_torch.detect.counter import RepeatCounter  # noqa: E402
from strique_tpu_torch.hmm.models import build_flanked_repeat, build_repeat_mod  # noqa: E402
from strique_tpu_torch.ops import viterbi_cuda as VC  # noqa: E402
from strique_tpu_torch.pore_model import PoreModel  # noqa: E402
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, REPEAT, SUFFIX,  # noqa: E402
                                        random_unit, write_mod_model, write_pore_model)

KERNEL_RE = re.compile(r"(parent_fwd_kernel|viterbi_fwd_kernel)")
# the rule's shapes past the claimed ones: (layout code, SP, unit bases)
RULE_SHAPES = ((0, 128, None), (0, 384, 30), (0, 512, 50), (0, 640, 70), (0, 768, 90),
               (0, 896, 110), (0, 1024, 130), (1, 256, 60), (1, 384, 90), (1, 512, 120),
               (1, 640, 150), (1, 768, 180), (1, 896, 210), (1, 1024, 250))


def ptxas(log: str) -> list:
    """(kernel, mangled name, registers, stack, spill stores, spill loads)
    of every narrow forward instance in an -Xptxas -v log."""
    out, cur = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = KERNEL_RE.search(line)
            cur = None if m is None else {"kernel": m.group(1),
                                          "mangled": line.split("'")[1] if "'" in line else line}
        elif cur is not None and "spill stores" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            cur.update(stack=nums[0], spill_stores=nums[1], spill_loads=nums[2])
        elif cur is not None and "Used" in line and "registers" in line:
            cur["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            out.append(cur)
            cur = None
    return out


def build_probe(nvs, hook=False) -> tuple:
    """One library a SP / 128 of tools/probe_viterbi_narrow.cu (all
    compiled together; ``hook``: with the phase hook), and their ptxas
    logs."""
    out = os.path.join(_build.build_dir(), "probe_narrow")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(ROOT, "tools", "probe_viterbi_narrow.cu")
    tag = "hook_" if hook else ""
    libs = {nv: os.path.join(out, f"libprobe_narrow_{tag}{nv}.so") for nv in nvs}
    flags = ["-DPROBE_HOOK"] if hook else []
    procs = {nv: subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", *flags,
                                   f"-DPROBE_NV={nv}", "-shared", "-o", libs[nv], src],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for nv in nvs}
    logs = {nv: p.communicate()[0] for nv, p in procs.items()}
    bad = [nv for nv, p in procs.items() if p.returncode]
    if bad:
        raise RuntimeError("nvcc failed:\n" + "\n".join(logs[nv] for nv in bad))
    handles = {}
    for nv, path in libs.items():
        h = ctypes.CDLL(path)
        h.probe_fwd_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        h.probe_fwd_launch.restype = ctypes.c_int
        if hook:
            h.probe_phase_read.argtypes = [ctypes.c_void_p]
        handles[nv] = h
    return handles, "".join(logs.values())


def ms_of(fn, reps=3) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def sweep(nv: int) -> list:
    """The W the probe times at SP 128 nv: S = 1, 2, 4 and 8 where it divides."""
    return [4 * nv // s for s in (1, 2, 4, 8) if (4 * nv) % s == 0]


def probe_shape(lib, label, ph, o, n, reps, rows) -> int:
    """Parent, every W, parent again, in turns; returns the runs not bit-equal."""
    B, T = o.shape
    steps = int(n.max())
    live = torch.arange(T, device="cuda")[:, None] < n[None, :]
    sc_p, fin_p, acc_p = VC._fwd_plain(o, n, ph)
    src, w, ramp, counts = ph.fwd_tables()
    out = (torch.empty((T, B, ph.sp), device="cuda"), torch.empty((B, ph.sp), device="cuda"),
           torch.empty((B,), device="cuda"))
    code = ph.fwd_layout.code

    def launch(W):
        sc, fin, acc = out
        err = lib.probe_fwd_launch(
            o.data_ptr(), n.data_ptr(), ph.start.data_ptr(), ph.mu.data_ptr(),
            ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(), ph.lsig.data_ptr(),
            src.data_ptr(), w.data_ptr(), ramp.data_ptr(), ctypes.addressof(counts),
            sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, ph.sp, code, W,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err} at launch (W={W})")

    bad = 0
    mine = []
    for W in (0, *sweep(ph.sp // 128), 0):
        for x in out:
            x.fill_(float("nan"))
        launch(W)
        torch.cuda.synchronize()
        sc, fin, acc = out
        eq = bool(torch.equal(sc[live], sc_p[live]) and torch.equal(fin, fin_p)
                  and torch.equal(acc, acc_p))
        ms = ms_of(lambda: launch(W), reps)
        name = "parent" if W == 0 else f"W={W} (S={ph.sp // 32 // W})"
        row = {"shape": label, "sp": ph.sp, "layout": code, "B": B, "T": T, "steps": steps,
               "W": W, "variant": name, "equal": eq, "ms": ms, "us_per_step": ms * 1e3 / steps}
        rows.append(row)
        mine.append(row)
        bad += not eq
        print(f"  [{label}: SP {ph.sp}, layout {code}, B {B}, T {T}] {name}: "
              f"{'bit-equal' if eq else 'DIFFERS'}; {ms:.3f} ms, {ms * 1e3 / steps:.4f} us/step",
              flush=True)
    parent = min(r["ms"] for r in mine if r["W"] == 0)
    best = min((r for r in mine if r["W"]), key=lambda r: r["ms"])
    rule = VC.fwd_warps(ph.sp, code)
    rule_ms = min(r["ms"] for r in mine if r["W"] == rule)
    print(f"  rule: fwd_warps({ph.sp}, {code}) = {rule} ({rule_ms:.3f} ms, "
          f"{100 * (1 - rule_ms / parent):.1f}% under the parent's {parent:.3f}); fastest "
          f"{best['variant']} ({best['ms']:.3f} ms, {100 * (1 - best['ms'] / parent):.1f}%)",
          flush=True)
    rows.append({"kind": "rule", "shape": label, "sp": ph.sp, "layout": code, "rule": rule,
                 "rule_ms": rule_ms, "fastest_W": best["W"], "fastest_ms": best["ms"],
                 "parent_ms": parent})
    del out, sc_p
    torch.cuda.empty_cache()
    return bad


# csrc/viterbi_fwd.cu FWD_HOOK's marks
PHASES = ("start+prefetch", "gathers+scan", "totals barrier", "fold+h rows", "h barrier",
          "exits+publish", "row barrier", "rescale+emission+store")


def probe_phases(lib, label, ph, o, n, rows) -> None:
    """Each W's step phases in cycles a step (read 0, lane 0 of each warp;
    the hooked build), warp 0's and the largest over warps."""
    B, T = o.shape
    src, w, ramp, counts = ph.fwd_tables()
    sc = torch.empty((T, B, ph.sp), device="cuda")
    fin = torch.empty((B, ph.sp), device="cuda")
    acc = torch.empty((B,), device="cuda")
    code = ph.fwd_layout.code
    for W in sweep(ph.sp // 128):
        args = (o.data_ptr(), n.data_ptr(), ph.start.data_ptr(), ph.mu.data_ptr(),
                ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(), ph.lsig.data_ptr(),
                src.data_ptr(), w.data_ptr(), ramp.data_ptr(), ctypes.addressof(counts),
                sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, ph.sp, code, W,
                torch.cuda.current_stream().cuda_stream)
        ms = ms_of(lambda: lib.probe_fwd_launch(*args), 2)
        buf = np.zeros((32, 9), np.int64)
        torch.cuda.synchronize()
        if lib.probe_phase_read(buf.ctypes.data):
            raise RuntimeError("probe_phase_read failed")
        steps = max(int(buf[0, 8]), 1)
        per = buf[:W, :8] / steps
        w0, top = per[0], per.max(axis=0)
        print(f"  phases [{label}: SP {ph.sp}, layout {code}] W={W} (S={ph.sp // 32 // W}), hooked "
              f"{ms * 1e3 / int(n.max()):.4f} us/step, cycles a step, warp 0 / most: "
              + ", ".join(f"{p} {a:.0f}/{b:.0f}" for p, a, b in zip(PHASES, w0, top))
              + f"; total {w0.sum():.0f}", flush=True)
        rows.append({"kind": "phases", "shape": label, "sp": ph.sp, "layout": code, "W": W,
                     "hooked_us_per_step": ms * 1e3 / int(n.max()),
                     "warp0": dict(zip(PHASES, w0.tolist())),
                     "most": dict(zip(PHASES, top.tolist()))})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="SP 256 chained at T 6144 and the mod shape only")
    ap.add_argument("--phases", action="store_true",
                    help="the step's phases in cycles (a hooked build) at the quick shapes")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_viterbi_narrow: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build(force=True)
    nvs = (1, 2) if args.quick else tuple(range(1, 9))
    libs, plog = build_probe(nvs)
    regs = ptxas(_build.BUILD_INFO.get("ptxas", "")) + ptxas(plog)
    for r in regs:
        print(f"ptxas: {r['kernel']} ({r['mangled']}): {r['registers']} registers, stack "
              f"{r.get('stack')} B, spill stores {r.get('spill_stores')} B, loads "
              f"{r.get('spill_loads')} B", flush=True)
    tmp = tempfile.mkdtemp(prefix="probe_narrow_")
    model = write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=0)
    pm = PoreModel(model)
    base = PoreModel(write_pore_model(os.path.join(tmp, "base.model"), seed=MOD_MODEL_SEED))
    twin = PoreModel(write_mod_model(os.path.join(tmp, "twin.model"), seed=MOD_MODEL_SEED))
    dev = torch.device("cuda")
    counter = RepeatCounter(model, device="cuda")
    counter.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
    count_hmm = VC.PaddedHMM(counter.targets["c9orf72"][0].repeat_hmm, dev)
    rng = np.random.default_rng(23)
    rows, bad = [], 0

    shapes = [("count batch", count_hmm, *CS.viterbi_inputs(pm, 64, 6144, rng, CS.REPEATS))]
    mod_hmm = VC.PaddedHMM(build_repeat_mod(REPEAT, base, twin), dev)
    shapes.append(("mod batch", mod_hmm, *CS.mod_inputs(base, twin, REPEAT, 64, 3072, rng)))
    if not args.quick:
        shapes.append(("carrier reads", count_hmm,
                       *CS.viterbi_inputs(pm, 64, 49152, rng, 1000)))
        shapes.append(("ultra-long", count_hmm,
                       *CS.viterbi_inputs(pm, 8, 57344, rng, CS.ULTRA_REPEATS)))
        for code, sp, bases in RULE_SHAPES:
            if code == 0:
                unit = REPEAT if bases is None else random_unit(bases, bases)
                flank = 25 if bases is None else 50
                ph = VC.PaddedHMM(build_flanked_repeat(unit, PREFIX[-flank:], SUFFIX[:flank], pm),
                                  dev)
                o, n = CS.viterbi_inputs(pm, 64, 2048, rng, 2048 // (8 * len(unit)) + 1, flank,
                                         unit)
            else:
                unit = random_unit(bases, bases)
                ph = VC.PaddedHMM(build_repeat_mod(unit, base, twin), dev)
                o, n = CS.wide_path_inputs(base, twin, unit, 2048 // (8 * bases) + 2, 64, 2048,
                                           rng, True)
            if ph.sp != sp or ph.fwd_layout.code != code:
                print(f"probe_viterbi_narrow: the rule shape ({code}, {sp}) staged SP {ph.sp} "
                      f"in layout {ph.fwd_layout.code}", flush=True)
                return 1
            shapes.append((f"rule {'chained' if code == 0 else 'diagonal-only'}", ph, o, n))
    if args.phases:
        hooked, _ = build_probe((1, 2), hook=True)
        for label, ph, o, n in shapes[:2]:
            probe_phases(hooked[ph.sp // 128], label, ph, o, n, rows)
    for label, ph, o, n in shapes:
        bad += probe_shape(libs[ph.sp // 128], label, ph, o, n, args.reps, rows)
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": smi, "ptxas": regs, "rows": rows}, fp, indent=1)
    print(f"probe_viterbi_narrow: {sum(1 for r in rows if 'W' in r)} runs, {bad} not bit-equal",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
