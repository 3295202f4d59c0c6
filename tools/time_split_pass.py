"""Time the split path's '+' pass alone: 128 synthetic c9orf72 reads.

Builds a counter on the card, warms it up (64 reads, then one pass), and
times 8 more passes of ``chip_smoke.run_pipeline`` over the same 128
reads, each ended by ``torch.cuda.synchronize()``; prints the median,
least and most ms.  Run it from the root of the tree whose package it
times, in turns with another tree to compare the two on one card:

    python tools/time_split_pass.py ROOT LABEL [parent-rule] [profile]

``parent-rule`` (a tree with ``align_cuda.wave_launch_plan``): every
wave call takes the CTAs a row and rows of the rule the launch plan
replaced (``wave_table_ctas``'s CTAs at ``kernel_batch``'s or
``two_pass_group``'s width), to bisect the plan's host cost.  Where the
tree has the plan, it also prints the host us of one call (the median
of 200) of ``wave_launch_plan`` at the split path's calls (128 rows of
one flank, 48 fused rows of both) and at an ultra-long 8-row call, of
``wave_table_ctas``, and of ``template_levels`` in the one-CTA form
and the split form of 7 CTAs.  ``profile`` profiles 3 more passes
(cProfile, cumulative, top 25).
"""
import cProfile
import os
import pstats
import sys
import tempfile
import time

root = os.path.abspath(sys.argv[1])
sys.path.insert(0, root)
os.chdir(root)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402
from strique_tpu_torch.detect.counter import RepeatCounter  # noqa: E402
from strique_tpu_torch.ops import align as AL  # noqa: E402
from strique_tpu_torch.ops import align_cuda as AC  # noqa: E402
from strique_tpu_torch.pore_model import PoreModel  # noqa: E402
from strique_tpu_torch.synthetic import (PREFIX, REPEAT, SUFFIX, smoke_workload,  # noqa: E402
                                         write_pore_model)


def parent_rule(rows, tmpl, n_cols, device=None, sms=None, ctas=None, pass1_steps=None):
    """The rule before the launch plan: the fewest CTAs whose tables fit,
    and the widest call those CTAs a row fit the SMs with."""
    c = AC.wave_table_ctas(tmpl) if ctas is None else int(ctas)
    mp = np.shape(tmpl)[1]
    if pass1_steps is not None:
        return c, AC.two_pass_group(rows, mp, n_cols, device, sms, max(c, 1))
    return c, AC.kernel_batch(rows, n_cols=n_cols, mp=mp, device=device, sms=sms,
                              ctas=max(c, 1))


def host_us(fn, reps: int = 200) -> float:
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[reps // 2] * 1e6


args = sys.argv[3:]
has_plan = hasattr(AC, "wave_launch_plan")
if "parent-rule" in args:
    AC.wave_launch_plan = AL.wave_launch_plan = parent_rule

tmp = tempfile.mkdtemp()
model = write_pore_model(os.path.join(tmp, "m.model"), seed=0)
pm = PoreModel(model)
c = RepeatCounter(model, device="cuda")
c.add_target("c9orf72", REPEAT, PREFIX, SUFFIX)
warm, plus, minus = smoke_workload(pm, 0, n_warm=64, n_plus=128, n_minus=24, repeats=100)
CS.run_pipeline(c, warm, "+")
CS.run_pipeline(c, plus, "+")
torch.cuda.synchronize()
ts = []
for _ in range(8):
    t0 = time.perf_counter()
    CS.run_pipeline(c, plus, "+")
    torch.cuda.synchronize()
    ts.append(time.perf_counter() - t0)
ts.sort()
print(f"{sys.argv[2]}: '+' pass of 128 reads, 8 runs: median {ts[4]*1e3:.1f} ms, "
      f"min {ts[0]*1e3:.1f}, max {ts[-1]*1e3:.1f}", flush=True)
if has_plan:
    tc = c.targets["c9orf72"][0]
    flank = AC.pad_template(tc.prefix_ext)[0]
    rows = AC.pad_template_rows([tc.prefix_ext, tc.suffix_ext])[0]
    mp, n = flank.shape[1], 24576
    dev = torch.device("cuda")
    sms = AC.sm_count(dev)
    timed = {
        "wave_launch_plan, 128 rows": lambda: AC.wave_launch_plan(128, flank, n + mp, dev, sms,
                                                                  ctas=1),
        "wave_launch_plan, 48 fused rows": lambda: AC.wave_launch_plan(48, rows, n + mp, dev,
                                                                       sms, ctas=1),
        "wave_launch_plan, 8 ultra rows": lambda: AC.wave_launch_plan(8, flank, 1310720 + mp,
                                                                      dev, sms, ctas=1),
        "wave_table_ctas, 2 rows": lambda: AC.wave_table_ctas(rows),
        "template_levels, one CTA": lambda: AC.template_levels(rows),
        "template_levels, 7 CTAs": lambda: AC.template_levels(rows, 7),
    }
    print(f"{sys.argv[2]}: host us a call (median of 200): "
          + ", ".join(f"{k} {host_us(f):.1f}" for k, f in timed.items()), flush=True)
if "profile" in args:
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(3):
        CS.run_pipeline(c, plus, "+")
    torch.cuda.synchronize()
    pr.disable()
    pstats.Stats(pr).sort_stats("cumulative").print_stats(25)
