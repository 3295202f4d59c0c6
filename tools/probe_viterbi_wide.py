"""Probe: the Viterbi forwards past their one-CTA widths, parent against cluster.

Times, by CUDA events in turns, the parent kernels kept in
tools/probe_viterbi_wide.cu beside the package's cluster forms at every
cluster size each rule could pick, each held bit-equal to its plain twin
(rows below each read's length, fin, acc):

  * row 3 past SP 1024: the one-CTA wide factored forward (K states a
    thread) against ``viterbi_fwd_cluster_kernel`` on C CTAs a read
    (csrc/viterbi_fwd.cu), at phase 4f's shapes (the 150-base unit's
    repeat HMM, SP 1152, 8 reads of T 7168, chained; the 260-base unit's
    mod HMM, SP 1152, 8 reads of T 6656, diagonal-only; its repeat HMM
    with 50-base flanks, SP 1792) and at ``synthetic.VITERBI_WIDE``'s
    corners (B 8, T 1024: SP 1152, 2048, 4480, 8192, both layouts);
  * row 7 past SP 512: the one-CTA streamed dense forward against
    ``viterbi_dense_cluster_kernel`` on K CTAs a read, streamed from L2
    or with its column slice in shared memory (csrc/viterbi_dense.cu),
    at phase 4f's VNTR shape (SP 640, 8 reads of T 8192) and at SP 768,
    896, 1024, 1152 (B 8, T 1024) and 8192 (B 8, T 64).

Both also run a count batch: 64 reads (``viterbi_cuda.GROUP``) of T
1024 at SP 1152 (chained) and SP 640.  The dense forward's 16-CTA
cluster, non-portable, is the probe's own instance
(tools/probe_viterbi_wide_k16.cu); the package takes 8.  ``--reads``
adds row 3 at 16, 24, 32 and 48 reads of T 1024 (SP 1152 in both
layouts, SP 1792 chained), the call sizes between phase 4f's 8 and a
count batch's 64 that the fused route's ``fused_viterbi_rows`` sends,
with the card's cluster capacity, one CTA an SM, at each C
(``fwd_cluster_capacity``), the rule's pick and the fastest C.

First it prints each probed kernel's registers, stack and spills from
``-Xptxas -v``.  Needs a CUDA card and nvcc (run it through the chip
tool: ``python tools/probe_viterbi_wide.py [--quick] [--reads] [--out
f.json]``; ``--quick`` takes the phase 4f shapes and the count batches
only).
"""
import argparse
import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from strique_tpu_torch import _build  # noqa: E402
from strique_tpu_torch.hmm.models import build_flanked_repeat, build_repeat_mod  # noqa: E402
from strique_tpu_torch.ops import viterbi_cuda as VC  # noqa: E402
from strique_tpu_torch.pore_model import PoreModel  # noqa: E402
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, SUFFIX, VITERBI_WIDE,  # noqa: E402
                                        WIDE_MOD_UNIT_BASES, WIDE_MOD_UNITS, WIDE_UNIT_BASES,
                                        random_unit, viterbi_wide_case, write_mod_model,
                                        write_pore_model)

KERNEL_RE = re.compile(r"(viterbi_fwd_cluster_kernel|viterbi_dense_cluster_kernel|"
                       r"viterbi_fwd_wide_kernel|viterbi_dense_kernel)")
FWD_CTAS = (2, 3, 4, 5, 6, 7, 8)
DENSE_CTAS = (4, 5, 8, 16)  # 16: the probe's non-portable instance
# --reads: the read counts of row 3's call-size sweep
SWEEP_READS = (16, 24, 32, 48)
# the dense shapes past SP 512: (label, unit bases, units, B, T)
DENSE_SHAPES = (("phase 4f VNTR", 60, 12, 8, 8192), ("SP 768", 90, 3, 8, 1024),
                ("SP 896", 110, 3, 8, 1024), ("SP 1024", 130, 3, 8, 1024),
                ("SP 1152", 150, 3, 8, 1024), ("SP 8192", 1330, 1, 8, 64))


def ptxas(log: str) -> list:
    """(kernel, mangled name, registers, stack, spill stores, spill loads)
    of every probed kernel instance in an -Xptxas -v log."""
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


def build_parent():
    """tools/probe_viterbi_wide.cu and tools/probe_viterbi_wide_k16.cu as
    a library, and its ptxas log."""
    out = os.path.join(_build.build_dir(), "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_viterbi_wide.so")
    srcs = [os.path.join(ROOT, "tools", f)
            for f in ("probe_viterbi_wide.cu", "probe_viterbi_wide_k16.cu")]
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                        lib, *srcs], capture_output=True, text=True, check=True)
    handle = ctypes.CDLL(lib)
    handle.parent_fwd_wide_launch.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    handle.parent_dense_launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    handle.probe_dense_stream16_launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    return handle, r.stdout + r.stderr


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


def call(fn, *args):
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"CUDA error {err} at launch")


def outputs(B, T, sp):
    return (torch.empty((T, B, sp), device="cuda"), torch.empty((B, sp), device="cuda"),
            torch.empty((B,), device="cuda"))


class Shape:
    """One shape's inputs, its twin's outputs and the variants' rows."""

    def __init__(self, kind, label, ph, o, n, twin, rows):
        self.kind, self.label, self.ph, self.o, self.n = kind, label, ph, o, n
        self.B, self.T = o.shape
        self.steps = int(n.max())
        self.live = torch.arange(self.T, device="cuda")[:, None] < n[None, :]
        self.want = twin(o, n, ph)
        self.rows = rows

    def run(self, name, launch, reps):
        out = outputs(self.B, self.T, self.ph.sp)
        fn = lambda: launch(out)  # noqa: E731
        fn()
        torch.cuda.synchronize()
        sc, fin, acc = out
        sc_p, fin_p, acc_p = self.want
        eq = bool(torch.equal(sc[self.live], sc_p[self.live]) and torch.equal(fin, fin_p)
                  and torch.equal(acc, acc_p))
        ms = ms_of(fn, reps) if reps else float("nan")
        row = {"kind": self.kind, "shape": self.label, "sp": self.ph.sp, "B": self.B,
               "T": self.T, "variant": name, "equal": eq, "ms": ms,
               "us_per_step": ms * 1e3 / self.steps}
        self.rows.append(row)
        print(f"  {self.kind} [{self.label}: SP {self.ph.sp}, B {self.B}, T {self.T}] {name}: "
              f"{'bit-equal' if eq else 'DIFFERS'}; {ms:.3f} ms, "
              f"{ms * 1e3 / self.steps:.4f} us/step", flush=True)
        return eq


def factored_args(ph, o, n, out):
    src, w, ramp, counts = ph.fwd_tables()
    sc, fin, acc = out
    B, T = o.shape
    return (o.data_ptr(), n.data_ptr(), ph.start.data_ptr(), ph.mu.data_ptr(),
            ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(), ph.lsig.data_ptr(),
            src.data_ptr(), w.data_ptr(), ramp.data_ptr(), ctypes.addressof(counts),
            sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, ph.sp, ph.fwd_layout.code)


def dense_args(ph, o, n, out):
    sc, fin, acc = out
    B, T = o.shape
    return (o.data_ptr(), n.data_ptr(), ph.trans.data_ptr(), ph.start.data_ptr(),
            ph.mu.data_ptr(), ph.sigma.data_ptr(), ph.uni.data_ptr(), ph.luni.data_ptr(),
            ph.lsig.data_ptr(), sc.data_ptr(), fin.data_ptr(), acc.data_ptr(), B, T, ph.sp)


def probe_factored(parent, shape, reps) -> int:
    ph, o, n = shape.ph, shape.o, shape.n
    lib = _build.lib()
    bad = 0
    runs = [("parent (one CTA)", lambda out: call(parent.parent_fwd_wide_launch,
                                                  *factored_args(ph, o, n, out)))]
    for c in FWD_CTAS:
        lanes = VC.fwd_cluster_lanes(ph.sp, c)
        if lanes > 1024 or lanes * (c - 1) >= ph.sp:
            continue
        runs.append((f"cluster C={c} ({lanes} lanes)",
                     lambda out, c=c: call(lib.viterbi_fwd_cluster_launch,
                                           *factored_args(ph, o, n, out), c)))
    runs.append(runs[0])
    for name, launch in runs:
        bad += not shape.run(name, launch, reps)
    code = ph.fwd_layout.code
    caps = {c: VC.fwd_cluster_capacity("cuda", ph.sp, code, c) for c in FWD_CTAS}
    rule = VC.fwd_cluster_ctas(ph.sp, shape.B, "cuda", code)
    mine = [r for r in shape.rows if r["shape"] == shape.label and "cluster" in r["variant"]]
    best = min(mine, key=lambda r: r["ms"])["variant"]
    print(f"  rule: fwd_cluster_ctas({ph.sp}, {shape.B}) = {rule}; fastest {best}; "
          f"clusters at once, one CTA an SM, by C: {caps}", flush=True)
    shape.rows.append({"kind": "rule", "shape": shape.label, "sp": ph.sp, "B": shape.B,
                       "layout": code, "rule": rule, "fastest": best, "capacity": caps})
    return bad


def probe_dense(parent, shape, reps) -> int:
    ph, o, n = shape.ph, shape.o, shape.n
    lib = _build.lib()
    bad = 0
    runs = [("parent (one CTA)", lambda out: call(parent.parent_dense_launch,
                                                  *dense_args(ph, o, n, out)))]
    for k in DENSE_CTAS:
        if ph.sp % (4 * k) or ph.sp // k > 1024:
            continue
        for sl in (0, 1):
            if sl and VC.dense_stream_shmem(ph.sp, k, True) > VC.DENSE_MAX_SHMEM:
                continue
            name = f"{'slice' if sl else 'stream'} K={k} ({ph.sp // k} columns)"
            if k > VC.DENSE_MAX_CLUSTER:
                launch = lambda out, sl=sl: call(parent.probe_dense_stream16_launch,  # noqa: E731
                                                 *dense_args(ph, o, n, out), sl)
            else:
                launch = lambda out, k=k, sl=sl: call(lib.viterbi_dense_stream_launch,  # noqa: E731
                                                      *dense_args(ph, o, n, out), k, sl)
            runs.append((name, launch))
    runs.append(runs[0])
    for name, launch in runs:
        try:
            bad += not shape.run(name, launch, reps)
        except RuntimeError as e:  # a cluster the card does not schedule
            print(f"  {shape.label} {name}: refused ({e})", flush=True)
    print(f"  rule: dense_mode({ph.sp}) = {VC.dense_mode(ph.sp)}", flush=True)
    return bad


def wide_inputs(pm, pm_mod, unit, units, B, T, rng, mod):
    return CS.wide_path_inputs(pm, pm_mod, unit, units, B, T, rng, mod)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="phase 4f's shapes only")
    ap.add_argument("--reads", action="store_true",
                    help="row 3 at 16, 24, 32 and 48 reads as well")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_viterbi_wide: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build(force=True)
    parent, plog = build_parent()
    regs = ptxas(_build.BUILD_INFO.get("ptxas", "") + plog)
    for r in regs:
        print(f"ptxas: {r['kernel']} ({r['mangled']}): {r['registers']} registers, stack "
              f"{r.get('stack')} B, spill stores {r.get('spill_stores')} B, loads "
              f"{r.get('spill_loads')} B", flush=True)
    tmp = os.path.join(_build.build_dir(), "probe")
    pm = PoreModel(write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=0))
    base = PoreModel(write_pore_model(os.path.join(tmp, "base.model"), seed=MOD_MODEL_SEED))
    twin = PoreModel(write_mod_model(os.path.join(tmp, "twin.model"), seed=MOD_MODEL_SEED))
    rng = np.random.default_rng(15)
    rows, bad = [], 0
    dev = torch.device("cuda")

    # row 3 past SP 1024
    unit = random_unit(WIDE_UNIT_BASES, 5)
    ph = VC.PaddedHMM(build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm), dev)
    o, n = wide_inputs(pm, base, unit, 5, 8, 7168, rng, False)
    factored = [("phase 4f chained", ph, o, n)]
    munit = random_unit(WIDE_MOD_UNIT_BASES, WIDE_MOD_UNIT_BASES)
    ph = VC.PaddedHMM(build_repeat_mod(munit, base, twin), dev)
    o, n = wide_inputs(base, twin, munit, WIDE_MOD_UNITS, 8, 6656, rng, True)
    factored.append(("phase 4f diagonal-only", ph, o, n))
    ph = VC.PaddedHMM(build_flanked_repeat(munit, PREFIX[-50:], SUFFIX[:50], base), dev)
    o, n = wide_inputs(base, twin, munit, WIDE_MOD_UNITS, 8, 7168, rng, False)
    factored.append(("260-base repeat HMM", ph, o, n))
    # a count batch: GROUP reads of the 150-base unit's repeat HMM
    ph = factored[0][1]
    o, n = wide_inputs(pm, base, unit, 5, VC.GROUP, 1024, rng, False)
    factored.append((f"{VC.GROUP} reads, chained", ph, o, n))
    if args.reads:
        sweep = (("SP 1152 chained", factored[0][1], pm, base, unit, 5, False),
                 ("SP 1152 diagonal-only", factored[1][1], base, twin, munit, WIDE_MOD_UNITS,
                  True),
                 ("SP 1792 chained", factored[2][1], base, twin, munit, WIDE_MOD_UNITS, False))
        for label, sph, p0, p1, u, units, mod in sweep:
            for B in SWEEP_READS:
                o, n = wide_inputs(p0, p1, u, units, B, 1024, rng, mod)
                factored.append((f"{label}, {B} reads", sph, o, n))
    if not args.quick:
        for label in VITERBI_WIDE:
            if "constant" in label:
                continue
            chm, obs, lens = viterbi_wide_case(pm, twin, label, rng)
            factored.append((label, VC.PaddedHMM(chm, dev), torch.from_numpy(obs).to(dev),
                             torch.from_numpy(lens).to(dev)))
    for label, ph, o, n in factored:
        shape = Shape("factored", label, ph, o, n, VC._fwd_plain, rows)
        bad += probe_factored(parent, shape, args.reps)
        del shape
        torch.cuda.empty_cache()

    # row 7 past SP 512
    shapes = DENSE_SHAPES[:1] if args.quick else DENSE_SHAPES
    for label, bases, units, B, T in (*shapes, (f"{VC.GROUP} reads", 60, 12, VC.GROUP, 1024)):
        unit = random_unit(bases, bases)
        chm = build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm)
        ph = VC.PaddedHMM(chm, dev)
        o, n = CS.viterbi_inputs(pm, B, T, rng, units, 50, unit)
        shape = Shape("dense", label, ph, o, n, VC._fwd_dense_plain, rows)
        bad += probe_dense(parent, shape, args.reps)
        del shape
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": smi, "ptxas": regs, "rows": rows}, fp, indent=1)
    print(f"probe_viterbi_wide: {len(rows)} runs, {bad} not bit-equal", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
