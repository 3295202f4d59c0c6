#!/usr/bin/env python3
"""The control of the check: the plain reference, put in the program's
place and computed in a lower float type, against itself in float32.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--dtype bfloat16]

For each seed it builds the cell's pore model (and, where the
configuration has ``mod_model``, its 5mC twin) and pool as a run does,
draws the sample a run's check draws (from the whole pool), counts it
with the reference in float32 and in ``--dtype`` on the card, both
calling methylation with the twin where there is one, and prints the
check's five numbers (``harness/check.py``) one JSON line a seed.  A
control that reads no worse than the cell's limits would show the
check blind to that precision.  It imports nothing of the package
under test, and the benchmark's runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

from harness import check, spec  # noqa: E402


def readings(cell: dict, seed: int, device: str, dtype) -> dict:
    import torch

    from reference.pipeline import Reference

    cfg = cell["config_spec"]
    traffic = spec.module("traffic", cell["generator"])
    tmp = tempfile.mkdtemp(prefix="strique-control-")
    try:
        k = cfg["model"]["k"]
        model = traffic.write_model(os.path.join(tmp, "model.txt"), seed, k)
        mod = (traffic.write_mod_model(os.path.join(tmp, "mod_model.txt"), seed, k,
                                       float(cfg["mod_model"]["shift_pA"]))
               if "mod_model" in cfg else None)
        pool = traffic.make_pool(model, cfg["locus"], cell["params"], seed, mod)
        picked = check.sample(set(range(len(pool))), pool, seed, int(cell["check_reads"]))
        raws = [pool[i][2] for i in picked]
        strands = [pool[i][1] for i in picked]
        t0 = time.perf_counter()
        ref = Reference(cfg["locus"], model, cfg["align"], device, hmm_config=cfg["hmm"],
                        mod_model_file=mod)
        want = ref.rows(raws, strands)
        t1 = time.perf_counter()
        low = Reference(cfg["locus"], model, cfg["align"], device, dtype=dtype,
                        hmm_config=cfg["hmm"], mod_model_file=mod)
        got = low.rows(raws, strands)
        t2 = time.perf_counter()
        if device == "cuda":
            torch.cuda.synchronize()
        numbers = check.compare(list(zip(picked, got)), picked, dict(zip(picked, want)))
        return {"seed": seed, "reads": len(picked), "numbers": numbers,
                "reference_s": t1 - t0, "control_s": t2 - t1}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--dtype", default="bfloat16")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 3
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        r = readings(cell, seed, "cuda", getattr(torch, args.dtype))
        r["workload"] = args.workload
        r["dtype"] = args.dtype
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
