"""SAM alignment-line decoding and repeat-locus intersection.

Replicates reference ``repeatDetector.__decode_sam__`` /
``__intersect_target__`` (reference scripts/STRique.py:648-679).

The port's own copy of ``strique_tpu/io/sam.py``;
tests/test_torch_copies.py pins the two equal.
"""
from __future__ import annotations

import re
from dataclasses import dataclass

_CIGAR_RE = re.compile(r"(\d*\D)")


@dataclass
class SamRecord:
    QNAME: str = ""
    FLAG: int = 0
    RNAME: str = ""
    POS: int = 0
    TLEN: int = 0
    CLIP_BEGIN: int = 0
    CLIP_END: int = 0

    @property
    def strand(self) -> str:
        return "-" if self.FLAG & 0x10 else "+"


def decode_cigar(cigar: str) -> list[tuple[int, str]]:
    """CIGAR string -> [(length, op)] (reference STRique.py:648-650)."""
    return [(int(op[:-1]), op[-1]) for op in _CIGAR_RE.findall(cigar)]


def ops_length(ops, rec_ops: str = "MIS=X") -> int:
    return sum(n for n, op in ops if op in rec_ops)


def decode_sam(sam_line: str) -> SamRecord:
    """Parse one SAM line; malformed lines give an empty record
    (reference STRique.py:656-671)."""
    cols = sam_line.rstrip().split("\t")
    sr = SamRecord()
    if len(cols) >= 11:
        try:
            sr.QNAME = cols[0]
            sr.FLAG = int(cols[1])
            sr.RNAME = cols[2]
            sr.POS = int(cols[3])
            cigar_ops = decode_cigar(cols[5])
            sr.TLEN = ops_length(cigar_ops, rec_ops="MDN=X")
            sr.CLIP_BEGIN = sum(n for n, op in cigar_ops[:2] if op in "SH")
            sr.CLIP_END = sum(n for n, op in cigar_ops[-2:] if op in "SH")
        except Exception:
            return SamRecord()
    return sr


def intersect_targets(sr: SamRecord, repeat_loci: dict) -> list[str]:
    """Targets fully covered by the (clip-extended) read span
    (reference STRique.py:673-679).

    ``repeat_loci``: chromosome -> [(target_name, begin, end), ...].
    """
    names = []
    loci = repeat_loci.get(sr.RNAME)
    if loci:
        for target_name, begin, end in loci:
            if begin > sr.POS - sr.CLIP_BEGIN and end < sr.POS + sr.TLEN + sr.CLIP_END:
                names.append(target_name)
    return names
