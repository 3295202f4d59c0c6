"""TSV output writer (reference scripts/STRique.py:711-727).

The port's own copy of ``strique_tpu/detect/writer.py``;
tests/test_torch_copies.py pins the two byte for byte.  A row is
``"\t".join(str(x) ...)`` of a result tuple, so the counter's tuples
keep Python ``int``, ``float`` and ``str`` (a NumPy float32 prints
otherwise).
"""
from __future__ import annotations

import os

HEADER = ["ID", "target", "strand", "count", "score_prefix", "score_suffix",
          "log_p", "offset", "ticks", "mod"]


def processed_ids(path: str | None) -> set:
    """Read IDs already present in a count TSV (for resumable runs)."""
    if not path or not os.path.isfile(path):
        return set()
    out = set()
    with open(path, "r") as fp:
        for line in fp:
            if line.startswith("ID\t"):
                continue
            cols = line.split("\t", 1)
            if cols and cols[0]:
                out.add(cols[0])
    return out


def merge_shards(out_path: str, world: int) -> int:
    """Concatenate per-host ``<out>.partN`` shards into ``out_path``.

    Rank 0 calls this after the cross-host barrier at the end of a
    multi-host count; the single merged file reproduces the reference's
    one-collector-stream contract (reference scripts/STRique.py:778-802
    — unordered rows, one header).  Shards merge in rank order and are
    removed afterwards.  Hosts without a shared filesystem leave their
    parts un-merged; missing parts are skipped with the count returned
    so the caller can warn.  Appends to ``out_path`` when it already has
    rows (a resumed run's prior merge output is never truncated).
    """
    exists = os.path.isfile(out_path) and os.path.getsize(out_path) > 0
    merged = 0
    with open(out_path, "a" if exists else "w") as out:
        if not exists:
            print("\t".join(HEADER), file=out)
        for rank in range(world):
            part = f"{out_path}.part{rank}"
            if not os.path.isfile(part):
                continue
            with open(part, "r") as fp:
                for line in fp:
                    if line.startswith("ID\t") or not line.strip():
                        continue
                    out.write(line if line.endswith("\n") else line + "\n")
            os.remove(part)
            merged += 1
    return merged


class OutputWriter:
    def __init__(self, output_file: str | None = None, append: bool = False):
        self.output_file = output_file
        line = "\t".join(HEADER)
        if self.output_file:
            exists = os.path.isfile(output_file) and os.path.getsize(output_file) > 0
            if append and exists:
                pass  # never truncate prior results in resume mode
            else:
                with open(self.output_file, "w") as fp:
                    print(line, file=fp)
        else:
            print(line)

    def write_line(self, target_counts=()):
        if self.output_file:
            with open(self.output_file, "a") as fp:
                for tc in target_counts:
                    print("\t".join(str(x) for x in tc), file=fp)
        else:
            for tc in target_counts:
                print("\t".join(str(x) for x in tc), flush=True)
