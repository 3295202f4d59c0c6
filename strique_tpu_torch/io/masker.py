"""fast5 masker: cut detected repeat signal out of raw reads.

Port of the reference post-processing tool (reference
scripts/fast5Masker.py:45-92): given a count TSV, extract the counted
reads into a new fast5 store and delete the ``[offset, offset+ticks)``
sample range from each raw signal in place, so repeat-blind downstream
tools can process the masked reads.

The port's copy of ``strique_tpu/io/masker.py`` (tests/test_torch_extract.py
pins the two equal); it needs h5py, which ``io.fast5`` imports where it
opens a container.  Run it as ``python -m strique_tpu_torch.io.masker
reads.fofn counts.tsv out_dir``.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .fast5 import Fast5Index, index as f5_index


def mask_counts(f5_index_file: str, counts_file: str, output_dir: str,
                format: str = "single", tmp_prefix: str | None = None) -> int:
    records = []
    with open(counts_file, "r") as fp:
        for line in fp:
            if line.startswith("ID"):
                continue
            cols = line.rstrip().split("\t")
            if len(cols) >= 9:
                records.append((cols[0], int(cols[7]), int(cols[8])))
    if not records:
        return 0
    os.makedirs(output_dir, exist_ok=True)
    ids_file = os.path.join(output_dir, "reads.txt")
    with open(ids_file, "w") as fp:
        fp.write("\n".join(rid for rid, _, _ in records) + "\n")
    src = Fast5Index(f5_index_file, tmp_prefix=tmp_prefix)
    src.extract(ids_file, output_dir, format=format)
    # re-index the extracted store
    out_fofn = os.path.join(output_dir, "reads.fofn")
    with open(out_fofn, "w") as fp:
        for line in f5_index(output_dir, recursive=False):
            fp.write(line + "\n")
    dst = Fast5Index(out_fofn, tmp_prefix=tmp_prefix)
    n = 0
    for rid, offset, ticks in records:
        if rid not in dst:
            continue
        sig = dst.get_raw(rid)
        mask = np.ones(len(sig), dtype=bool)
        mask[offset : offset + ticks] = False
        dst.set_raw(rid, sig[mask])
        n += 1
    return n


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Mask detected repeat signal out of fast5 reads")
    parser.add_argument("f5Index", help="Fast5 index of the source run")
    parser.add_argument("counts", help="Repeat count TSV from 'strique count'")
    parser.add_argument("output", help="Output directory for masked reads")
    parser.add_argument("--format", default="single", choices=["single", "bulk"])
    parser.add_argument("--tmp_prefix", default=None)
    args = parser.parse_args(argv)
    n = mask_counts(args.f5Index, args.counts, args.output, format=args.format,
                    tmp_prefix=args.tmp_prefix)
    print(f"masked {n} reads", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
