"""Probe: what the NaN-propagating max costs the column kernel's TABLE step.

``col_align_kernel`` (csrc/col_align.cu) runs a TABLE row in one of two
instances, both launched over a call's rows, each leaving the other's
rows at once: the fmaxf one when the row's level table and template
levels are all finite (no NaN can arise), else the max_nan one (PTX
max.NaN.f32 in every DP max).  This probe runs the bench shape (64
rows, N 24576, MP 896, a samples=6 template of 148 values) twice on the
same bins: with finite level tables, and with +inf written into level
255 of every table, a level no bin holds, which sends every row to the
max_nan instance without changing a value the DP reads.  The two runs'
outputs must be equal; each is timed by CUDA events (5 launches after a
warm-up) in turns (finite, inf, inf, finite).  The wave kernel's TABLE
mode (one instance, max_nan) on the same inputs is timed beside them.
Needs a CUDA card and nvcc.

    python tools/probe_col_max.py
"""
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from strique_tpu_torch.ops import align_cuda as TC  # noqa: E402
from strique_tpu_torch.ops.reference import AlignParams  # noqa: E402


def ms(fn, reps: int = 5) -> float:
    fn()
    torch.cuda.synchronize()
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def main() -> int:
    if not torch.cuda.is_available():
        sys.exit("probe_col_max: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip() or torch.cuda.get_device_name(0), flush=True)
    rng = np.random.default_rng(5)
    B, N = 64, 24576
    tp, m = TC.pad_template(np.repeat(rng.uniform(60, 120, 148), 6).astype(np.float32))
    levels, lidx = TC.template_levels(tp)
    bins = rng.integers(0, 255, (B, N)).astype(np.uint8)  # no bin 255
    lut = np.sort(rng.uniform(40, 150, (B, 256)), axis=1).astype(np.float32)
    dev = torch.device("cuda")
    b, l, n, lv, li = (torch.from_numpy(x).to(dev)
                       for x in (bins, lut, np.full(B, N, np.int32), levels, lidx))
    l_inf = l.clone()
    l_inf[:, 255] = float("inf")
    p = AlignParams()
    runs = {"fmaxf": lambda: TC.align_forward_col_morph(b, l, n, lv, li, p, m),
            "max_nan": lambda: TC.align_forward_col_morph(b, l_inf, n, lv, li, p, m)}
    outs = {k: run() for k, run in runs.items()}
    same = all(torch.equal(x, y) for x, y in zip(outs["fmaxf"], outs["max_nan"]))
    t = {k: [] for k in runs}
    for k in ("fmaxf", "max_nan", "max_nan", "fmaxf"):
        t[k].append(ms(runs[k]))
    wave = ms(lambda: TC.align_forward_wave_morph(b, l, n, lv, li, p, m))
    cols = TC._cols_to_run(n, N)
    print(f"column TABLE, B={B} N={N} MP={tp.shape[1]} U={levels.shape[1]}: outputs "
          f"{'equal' if same else 'DIFFER'}; "
          + "; ".join(f"{k} instance {v[0]:.3f} / {v[1]:.3f} ms "
                      f"({sum(v) / 2 * 1e3 / cols:.4f} us/column)" for k, v in t.items())
          + f", in turns; wave TABLE on the same inputs {wave:.3f} ms", flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
