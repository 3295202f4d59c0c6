#!/usr/bin/env python3
"""The JAX package's mod calls on the synthetic base/twin model pair, on the CPU.

    JAX_PLATFORMS=cpu python tools/probe_mod_twin.py --seed 7 --shift -4 [--shape workload]

A reference-side probe, like the tests that hold the port to the JAX
package: it runs ``strique_tpu``'s ``RepeatCounter(mod_model_file=twin)``
on reads from ``strique_tpu_torch.synthetic`` (NumPy only), to choose
the twin's shift and model seed by the reference's result.  Per model
seed and shift it writes ``write_pore_model(seed)`` and
``write_mod_model(seed, shift)`` and counts c9orf72 reads of 50 units,
even reads from the base model and odd ones from the twin:

  * ``--shape short`` (default): 80-base flanks, 200 backbone bases a
    side, 4 reads from each of ``default_rng(5)`` and ``default_rng(6)``
    a strand (the shape of tests/test_torch_mod.py); one line a strand
    and generator: (count, '1's, units) a read;
  * ``--shape workload``: chip_smoke.py phase 4h's reads
    (``synthetic.mod_workload(pm, pm_mod, 0)``: 96 '+' and 32 '-' reads,
    full flanks), in batches of 16; one line a strand with the reads
    counted off 50 and the separated share.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, nargs="+", default=[0])
    ap.add_argument("--shift", type=float, nargs="+", default=[-4.0])
    ap.add_argument("--shape", choices=["short", "workload"], default="short")
    args = ap.parse_args()
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from strique_tpu.detect.counter import RepeatCounter
    from strique_tpu.pore_model import PoreModel
    from strique_tpu_torch.synthetic import (MOD_REPEATS, PREFIX, REPEAT, SUFFIX,
                                             make_mod_reads, mod_workload, write_mod_model,
                                             write_pore_model)

    tmp = tempfile.mkdtemp(prefix="probe_mod_twin_")
    for seed in args.seed:
        base = write_pore_model(os.path.join(tmp, f"base{seed}.model"), seed=seed)
        pm = PoreModel(base)
        for shift in args.shift:
            twin = write_mod_model(os.path.join(tmp, f"twin{seed}_{shift}.model"), seed=seed,
                                   shift=shift)
            pm_mod = PoreModel(twin)
            full = args.shape == "workload"
            prefix, suffix = (PREFIX, SUFFIX) if full else (PREFIX[-80:], SUFFIX[:80])
            rc = RepeatCounter(base, mod_model_file=twin)
            rc.add_target("c9orf72", REPEAT, prefix, suffix)
            if full:
                plus, minus = mod_workload(pm, pm_mod, 0)
                for strand, reads in (("+", plus), ("-", minus)):
                    res = []
                    for i in range(0, len(reads), 16):
                        res += rc.detect_many("c9orf72", reads[i : i + 16], strand)
                    off = [(i, r[0]) for i, r in enumerate(res) if r[0] != MOD_REPEATS]
                    sep = sum(int(bool(r[6].strip("-")) and (r[6].count("1") / len(r[6]) > 0.5)
                                  == bool(i % 2)) for i, r in enumerate(res))
                    print(f"seed {seed} shift {shift:+} {strand}: {len(res)} reads, counted "
                          f"off {MOD_REPEATS} (index, count) {off}, separated {sep}/{len(res)}; "
                          f"'1's a read {[r[6].count('1') for r in res]}", flush=True)
                continue
            for strand in "+-":
                for rs in (5, 6):
                    reads = make_mod_reads(pm, pm_mod, 4, MOD_REPEATS, np.random.default_rng(rs),
                                           strand, flank_bases=200, prefix=prefix,
                                           suffix=suffix)
                    res = rc.detect_many("c9orf72", reads, strand)
                    print(f"seed {seed} shift {shift:+} {strand} rng {rs}: (count, '1's, units) "
                          f"{[(r[0], r[6].count('1'), len(r[6])) for r in res]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
