"""Probe: the wide Viterbi backward (SP past 1024), parent against its forms.

Times, by CUDA events in turns (parent, candidates, parent), the parent
kernel kept in tools/probe_viterbi_bwd_wide.cu (the first
``viterbi_bwd_wide_kernel``: a warp per 1024 states) beside the
package's wide kernel (csrc/viterbi_bwd.cu) at 4, 8 and 16 states a
thread (the package takes ``viterbi_cuda.BWD_WIDE_SPT``) and, for a mod
HMM, the LIST candidate the probe keeps in its .cu (:func:`bwd_lists`
stages its lists).  Every run's paths are held equal to
``viterbi_cuda._bwd_plain`` on the same rows (the cluster forward's).
Shapes:

  * phase 4f's: the 150-base unit's repeat HMM (SP 1152, chained), 8
    reads of T 7168; the 260-base unit's mod HMM (SP 1152,
    diagonal-only), 8 reads of T 6656; its repeat HMM (SP 1792), the wide
    mod target's 4 reads padded to 8, T 7168;
  * ``synthetic.VITERBI_WIDE``'s SP 2048, 4096 and 8192 in both layouts
    (8 reads of T 1024);
  * a count batch: 64 reads (``viterbi_cuda.GROUP``) of the 150-base
    unit's repeat HMM, T 7168.

Then, from the probe build's clock64 hook (thread 0 of each read), a
step's cycles split into its candidates (the ring wait, the transT row
or LIST's list and gather), the warp's first max, the cross-warp
exchange (LIST: its dense scans, and the share of steps that took one).  First it
prints each probed kernel's registers and spills from ``-Xptxas -v``.
Needs a CUDA card and nvcc (``python tools/probe_viterbi_bwd_wide.py
[--quick] [--out f.json]`` on one H100; ``--quick`` takes phase 4f's
shapes only).
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
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, SUFFIX,  # noqa: E402
                                        WIDE_MOD_UNIT_BASES, WIDE_MOD_UNITS, WIDE_UNIT_BASES,
                                        random_unit, viterbi_wide_case, write_mod_model,
                                        write_pore_model)

KERNEL_RE = re.compile(r"(parent_bwd_wide_kernel|viterbi_bwd_wide_kernel|viterbi_bwd_list_kernel)")
WIDE_LABELS = ("flanked 300", "flanked 650", "flanked 1330", "mod 500", "mod 1000", "mod 2030")
NCOL = 6
LIST_MAX = 8  # the LIST candidate's listed predecessors a state (the .cu's LIST_MAX)


def bwd_lists(transT: np.ndarray):
    """The LIST candidate's lists of an HMM's (SP, SP) transT: (pu, pw)
    (SP, LIST_MAX) int32 and f32, row s the states u with transT[s, u]
    above NEG in ascending order and those transitions, -1 and 0.0 past
    the list; None when a state has more than LIST_MAX such predecessors
    (every flanked-repeat HMM past the narrow widths: up to 391 at SP
    1152)."""
    transT = np.asarray(transT, np.float32)
    live = transT > VC.NEG
    counts = live.sum(axis=1)
    if counts.max(initial=0) > LIST_MAX:
        return None
    sp = transT.shape[0]
    pu = np.full((sp, LIST_MAX), -1, np.int32)
    pw = np.zeros((sp, LIST_MAX), np.float32)
    s_idx, u_idx = np.nonzero(live)  # row-major: ascending u within each s
    slot = np.arange(s_idx.size) - np.repeat(np.cumsum(counts) - counts, counts)
    pu[s_idx, slot] = u_idx
    pw[s_idx, slot] = transT[s_idx, u_idx]
    return pu, pw


def ptxas(log: str) -> list:
    """(kernel, mangled name, registers, spill stores, spill loads) of every
    probed kernel instance in an -Xptxas -v log."""
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


def build_probe():
    """tools/probe_viterbi_bwd_wide.cu as a library, and its ptxas log."""
    out = os.path.join(_build.build_dir(), "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_viterbi_bwd_wide.so")
    src = os.path.join(ROOT, "tools", "probe_viterbi_bwd_wide.cu")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                        lib, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the probe:\n{r.stdout}\n{r.stderr}")
    h = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    h.parent_bwd_wide_launch.argtypes = [P] * 5 + [I] * 3 + [P]
    h.probe_bwd_wide_launch.argtypes = [P] * 5 + [I] * 5 + [P]
    h.probe_bwd_list_launch.argtypes = [P] * 7 + [I] * 4 + [P]
    h.probe_bwd_hook_buffer.argtypes = [P]
    return h, r.stdout + r.stderr


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


def probe_shape(probe, label, ph, o, n, reps, rows) -> int:
    """One shape: the rows, the twin's paths, every variant in turns, and
    the hooked runs' phase split.  Returns the variants not equal."""
    B, T = o.shape
    sc, fin, _acc = VC.viterbi_forward_factored(o, n, ph)
    last = torch.argmax(fin + ph.end, dim=1).to(torch.int32)
    tact = n.to(torch.int32)
    want = VC._bwd_plain(sc, last, n, ph.transT)
    steps = int(n.max()) - 1
    path = torch.empty((B, T), dtype=torch.int32, device="cuda")
    io = (last.data_ptr(), tact.data_ptr(), path.data_ptr(), B, T, ph.sp)
    st = (sc.data_ptr(), ph.transT.data_ptr())
    lists = bwd_lists(ph.transT.cpu().numpy())
    if lists is not None:
        lists = tuple(torch.from_numpy(x).cuda() for x in lists)
    variants = [("parent", lambda h=0: call(probe.parent_bwd_wide_launch, *st, *io))]
    for spt in (4, 8, 16):
        if ph.sp // spt <= 1024:
            rule = " (the package's)" if spt == VC.BWD_WIDE_SPT else ""
            variants.append((f"wide {spt}/thread{rule}",
                             lambda h=0, spt=spt: call(probe.probe_bwd_wide_launch, *st, *io,
                                                       spt, h)))
    if lists is not None:
        variants.append(("list",
                         lambda h=0: call(probe.probe_bwd_list_launch, *st,
                                          lists[0].data_ptr(), lists[1].data_ptr(), *io, h)))
    bad = 0
    order = variants + [variants[0]]
    for name, run in order:
        path.zero_()
        run()
        torch.cuda.synchronize()
        eq = bool(torch.equal(path, want))
        bad += not eq
        ms = ms_of(run, reps)
        row = {"shape": label, "sp": ph.sp, "B": B, "T": T, "steps": steps, "variant": name,
               "equal": eq, "ms": ms, "us_per_step": ms * 1e3 / steps}
        rows.append(row)
        print(f"  [{label}: SP {ph.sp}, B {B}, T {T}] {name}: "
              f"{'equal' if eq else 'DIFFERS'}; {ms:.3f} ms, {ms * 1e3 / steps:.4f} us/step",
              flush=True)
    hook = torch.zeros((B, NCOL), dtype=torch.int64, device="cuda")
    if probe.probe_bwd_hook_buffer(hook.data_ptr()):
        raise RuntimeError("probe_bwd_hook_buffer failed")
    for name, run in variants[1:]:
        hook.zero_()
        run(1)
        torch.cuda.synchronize()
        h = hook.double().cpu().numpy()
        walked = h[:, 5].sum()
        split = {k: float(h[:, i].sum() / walked)
                 for i, k in ((0, "cycles"), (1, "candidates"), (2, "first_max"),
                              (3, "exchange_or_scan"))}
        split["scan_share"] = float(h[:, 4].sum() / walked)
        rows.append({"shape": label, "sp": ph.sp, "B": B, "variant": name, "hook": split})
        print(f"  [{label}] {name} hooked, cycles a step: " + ", ".join(
            f"{k} {v:.1f}" if k != "scan_share" else f"{k} {v:.4f}" for k, v in split.items()),
            flush=True)
    return bad


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true", help="phase 4f's shapes only")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_viterbi_bwd_wide: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build(force=True)
    probe, plog = build_probe()
    regs = ptxas(_build.BUILD_INFO.get("ptxas", "") + plog)
    for r in regs:
        print(f"ptxas: {r['kernel']} ({r['mangled']}): {r['registers']} registers, stack "
              f"{r.get('stack')} B, spill stores {r.get('spill_stores')} B, loads "
              f"{r.get('spill_loads')} B", flush=True)
    tmp = os.path.join(_build.build_dir(), "probe")
    pm = PoreModel(write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=0))
    base = PoreModel(write_pore_model(os.path.join(tmp, "base.model"), seed=MOD_MODEL_SEED))
    twin = PoreModel(write_mod_model(os.path.join(tmp, "twin.model"), seed=MOD_MODEL_SEED))
    rng = np.random.default_rng(16)
    dev = torch.device("cuda")
    rows, bad = [], 0

    def run(label, chm, o, n):
        nonlocal bad
        ph = VC.PaddedHMM(chm, dev)
        bad += probe_shape(probe, label, ph, o, n, args.reps, rows)
        torch.cuda.empty_cache()

    unit = random_unit(WIDE_UNIT_BASES, 5)
    chm = build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm)
    run("phase 4f chained", chm, *CS.wide_path_inputs(pm, base, unit, CS.WIDE_UNITS, 8, 7168,
                                                      rng, False))
    munit = random_unit(WIDE_MOD_UNIT_BASES, WIDE_MOD_UNIT_BASES)
    run("phase 4f diagonal-only", build_repeat_mod(munit, base, twin),
        *CS.wide_path_inputs(base, twin, munit, WIDE_MOD_UNITS, 8, 6656, rng, True))
    o, n = CS.wide_path_inputs(base, twin, munit, WIDE_MOD_UNITS, 4, 7168, rng, False)
    o = torch.cat([o, o.new_zeros((4, o.shape[1]))])
    n = torch.cat([n, n.new_ones(4)])
    run("wide mod target's repeat HMM",
        build_flanked_repeat(munit, PREFIX[-50:], SUFFIX[:50], base), o, n)
    if not args.quick:
        for label in WIDE_LABELS:
            chm, obs, lens = viterbi_wide_case(base, twin, label, rng)
            run(label, chm, torch.from_numpy(obs).to(dev), torch.from_numpy(lens).to(dev))
        chm = build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm)
        run(f"{VC.GROUP} reads, chained", chm,
            *CS.wide_path_inputs(pm, base, unit, CS.WIDE_UNITS, VC.GROUP, 7168, rng, False))
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": smi, "ptxas": regs, "rows": rows}, fp, indent=1)
    print(f"probe_viterbi_bwd_wide: {sum('equal' in r for r in rows)} runs, {bad} not equal",
          flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
