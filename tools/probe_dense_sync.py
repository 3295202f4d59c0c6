"""Probe: how should the dense Viterbi forward's resident mode move a step's row?

Times the shipped resident kernel (csrc/viterbi_dense.cu: transitions in
registers, the val row crossing the cluster by st.async into mbarriers)
beside the layout it does not ship, the transitions' column slice in
shared memory (tools/probe_dense_sync.cu), with the row crossing

  * ``smem + cluster barrier``: by DSMEM stores and one cluster barrier a
    step (the design first written for the dense forward's redesign);
  * ``smem + st.async``: as the shipped kernel's does.

Every variant is held bit-equal to ``_fwd_dense_plain`` (rows below each
read's length, fin, acc).  64 reads of T 6144 (the bench's Viterbi
call) at SP 128, 256 and 512.  Needs a CUDA card and nvcc.

    python tools/probe_dense_sync.py
"""
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as CS  # noqa: E402
from strique_tpu_torch import _build  # noqa: E402
from strique_tpu_torch.hmm.models import build_flanked_repeat  # noqa: E402
from strique_tpu_torch.ops import viterbi_cuda as VC  # noqa: E402
from strique_tpu_torch.pore_model import PoreModel  # noqa: E402
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, write_pore_model  # noqa: E402

VARIANTS = {"smem + cluster barrier": 0, "smem + st.async": 1}  # name -> sa flag


def build_probe() -> ctypes.CDLL:
    out = os.path.join(_build.build_dir(), "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_dense_sync.so")
    src = os.path.join(ROOT, "tools", "probe_dense_sync.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", lib, src], check=True)
    handle = ctypes.CDLL(lib)
    handle.probe_slice_launch.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    handle.probe_slice_launch.restype = ctypes.c_int
    return handle


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


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_dense_sync: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}")
    lib = build_probe()
    dev = torch.device("cuda")
    tmp = os.path.join(_build.build_dir(), "probe")
    pm = PoreModel(write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=0))
    rng = np.random.default_rng(7)
    B, T = 64, 6144
    bad = 0
    for flank in (25, 50, 100):
        ph = VC.PaddedHMM(build_flanked_repeat(REPEAT, PREFIX[-flank:], SUFFIX[:flank], pm), dev)
        o, n = CS.viterbi_inputs(pm, B, T, rng, CS.REPEATS, flank)
        sc_p, fin_p, acc_p = VC._fwd_dense_plain(o, n, ph)
        live = torch.arange(T, device=dev)[:, None] < n[None, :]
        steps = int(n.max())

        def report(name, run, out):
            nonlocal bad
            run()
            torch.cuda.synchronize()
            sc, fin, acc = out
            eq = bool(torch.equal(sc[live], sc_p[live]) and torch.equal(fin, fin_p)
                      and torch.equal(acc, acc_p))
            bad += not eq
            ms = ms_of(run)
            print(f"  SP {ph.sp} {name}: {'bit-equal' if eq else 'DIFFERS'}; {ms:.3f} ms, "
                  f"{ms * 1e3 / steps:.4f} us/step", flush=True)

        shipped = VC.viterbi_forward_dense(o, n, ph)
        report(f"shipped registers + st.async (K={VC.dense_mode(ph.sp)})",
               lambda: VC.viterbi_forward_dense(o, n, ph), shipped)
        for name, sa in VARIANTS.items():
            out = (torch.empty((T, B, ph.sp), device=dev), torch.empty((B, ph.sp), device=dev),
                   torch.empty((B,), device=dev))
            args = (o.data_ptr(), n.data_ptr(), ph.trans.data_ptr(), ph.start.data_ptr(),
                    ph.mu.data_ptr(), ph.sigma.data_ptr(), ph.uni.data_ptr(),
                    ph.luni.data_ptr(), ph.lsig.data_ptr(), *(x.data_ptr() for x in out), B, T,
                    ph.sp, VC.dense_mode(ph.sp), sa)

            def run(args=args):
                err = lib.probe_slice_launch(*args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"probe_slice_launch: CUDA error {err}")
            report(f"{name} (K={VC.dense_mode(ph.sp)})", run, out)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
