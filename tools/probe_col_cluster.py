"""Probe: the column kernel's cluster TABLE form, parent against the package.

Times, by CUDA events in turns (parent, package, package, parent at each
CTA count), the parent kept in tools/probe_col_cluster.cu (the first
cluster form: one barrier a column, the CTA's shared memory as needed)
beside the package's ``col_cluster_kernel`` (csrc/col_align.cu: warps
chained by rings, one CTA an SM) at every CTA count K = 2-8 whose split
the kernel takes and whose per-CTA tables fit, on phase 4e's over-the-cap
template (its prefix flank, 200 backbone bases longer: MP 2176) and
reads of N 28672 at 64 rows (the column route's call), 32, 16 and 8.
Every run's pointer words and bottom taps are held equal to the POW
kernel's on the decoded f32 (which chip_smoke.py holds to the twin).
Prints us a column by K and rows, the card's clusters at once at each K
(``cluster_capacity(..., "col")``) and ``col_launch_plan``'s call set at
each row count, with its predicted wall.  Needs a CUDA card
and nvcc (``python tools/probe_col_cluster.py [--rows 8,16,32,64]
[--out f.json]`` on one H100).  ``align_cuda.COL_STEP_US`` takes
its 8-row column (one CTA an SM, every cluster at once).
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
from strique_tpu_torch.ops import align_cuda as AC  # noqa: E402
from strique_tpu_torch.synthetic import PREFIX, REPEAT, SUFFIX, write_pore_model  # noqa: E402

N = 28672


def build_parent():
    out = os.path.join(_build.build_dir(), "probe")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_col_cluster.so")
    src = os.path.join(ROOT, "tools", "probe_col_cluster.cu")
    r = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o",
                        lib, src], capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc failed on the probe:\n{r.stdout}\n{r.stderr}")
    h = ctypes.CDLL(lib)
    h.parent_col_table_launch.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                                          + [ctypes.c_float] * 7 + [ctypes.c_void_p])
    return h


def over_cap_template(model: str, seed: int):
    """Phase 4e's prefix flank (200 random bases before the c9orf72
    prefix; chip_smoke.run_over_cap's rng), padded: (tmpl (1, MP), m,
    the counter's align params)."""
    rng = np.random.default_rng(seed + 3)
    prefix = "".join(rng.choice(list("ACGT"), 200)) + PREFIX
    suffix = SUFFIX + "".join(rng.choice(list("ACGT"), 200))
    c = RepeatCounter(model, device="cuda")
    c.add_target("long", REPEAT, prefix, suffix)
    tc = c.targets["long"][0]
    tmpl, m = AC.pad_template(tc.prefix_ext)
    return tc.prefix_ext, tmpl, m, c.align_params


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", default="64,32,16,8")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_col_cluster: needs a CUDA card")
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    _build.build(force=True)
    parent = build_parent()
    tmp = os.path.join(_build.build_dir(), "probe")
    model = write_pore_model(os.path.join(tmp, "synthetic_6mer.model"), seed=0)
    flank, tmpl, m, params = over_cap_template(model, 0)
    mp = tmpl.shape[1]
    c_min = AC.col_table_ctas(tmpl)
    ks = [c for c in range(c_min, AC.MAX_CTAS + 1)
          if AC._split_ok(mp, c) and AC.col_score_mode(AC._cta_level_counts(tmpl, c), mp, c)
          == "table"]
    caps = {c: AC.cluster_capacity("cuda", c, AC.cta_lanes(mp, c), "col") for c in ks}
    print(f"template: MP {mp}, m {m}, rule {c_min} CTAs; splits {ks}; clusters at once, one "
          f"CTA an SM: {caps}", flush=True)
    rng = np.random.default_rng(16)
    rows, bad = [], 0
    pargs = AC._param_args(params)
    for B in (int(x) for x in args.rows.split(",")):
        (levels, _, _, bins, lut), dev_in = CS.wave_inputs((flank,), False, B, N, rng)
        b_d, l_d, n_d, _m_d, _lv, _li, t_d = dev_in
        cols = AC._cols_to_run(n_d, N)
        ptr_k, bot_k = AC.align_forward_col(AC.morph_decode(b_d, l_d), n_d, t_d, params, m)
        mask = CS.valid_ptr_mask(n_d, torch.zeros_like(n_d), ptr_k.shape[0])
        for c in ks:
            lv, li = (torch.from_numpy(x).cuda() for x in AC.template_levels(tmpl, c))
            up, _, ctas, mpc = AC._split_args(lv, mp)
            ptr = torch.empty_like(ptr_k)
            bot = torch.empty_like(bot_k)
            na = n_d.to(torch.int32)
            call_args = (b_d.data_ptr(), l_d.data_ptr(), lv.data_ptr(), li.data_ptr(),
                         na.data_ptr(), ptr.data_ptr(), bot.data_ptr(), B, N, mp, up, ctas, mpc,
                         m, *pargs)

            def run(fn):
                err = fn(*call_args, torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")

            def run_parent():
                run(parent.parent_col_table_launch)

            def run_new():
                run(_build.lib().col_table_launch)

            for name, fn in (("parent", run_parent), ("package", run_new)):
                ptr.zero_()
                fn()
                torch.cuda.synchronize()
                eq = bool(torch.equal(ptr[mask], ptr_k[mask]) and torch.equal(bot, bot_k))
                bad += not eq
                if not eq:
                    print(f"  B {B} K {c} {name}: DIFFERS from POW", flush=True)
            (p1, p2), (k1, k2) = CS.turns_ms(run_parent, run_new, args.reps)
            for name, ms in (("parent", (p1 + p2) / 2), ("package", (k1 + k2) / 2)):
                rows.append({"B": B, "K": c, "lanes": mpc, "variant": name, "ms": ms,
                             "us_per_column": ms * 1e3 / cols, "cols": cols})
            print(f"  B {B:2d} K {c} ({mpc} lanes a CTA): parent {p1:.3f} / {p2:.3f} ms "
                  f"({(p1 + p2) / 2 * 1e3 / cols:.4f} us/column); package {k1:.3f} / {k2:.3f} ms "
                  f"({(k1 + k2) / 2 * 1e3 / cols:.4f} us/column)", flush=True)
        plan = CS.col_plan_calls(B, tmpl, N)
        pred = sum(N * AC.col_step_us(mp, c) for c, _ in plan) / 1e3
        print(f"  B {B}: col_launch_plan's calls {plan}, predicted {pred:.3f} ms", flush=True)
        rows.append({"B": B, "plan": plan, "predicted_ms": pred})
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as fp:
            json.dump({"card": smi, "mp": mp, "capacity": caps, "rows": rows}, fp, indent=1)
    print(f"probe_col_cluster: {bad} runs not equal to POW", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
