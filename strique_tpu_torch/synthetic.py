"""Deterministic synthetic inputs: a 6-mer pore model and c9orf72 reads.

Tests and ``chip_smoke.py`` need a pore model and reads with a known
repeat count without any downloaded data: the model is a full 4096-row
6-mer table of seeded random levels in the tab format ``PoreModel``
parses (``kmer<TAB>level_mean<TAB>level_stdv``), and reads are the
c9orf72 locus (flanks as in bench.py) around a backbone, synthesised by
``PoreModel.generate_signal`` with per-sample model noise.
"""
from __future__ import annotations

import itertools

import numpy as np

REPEAT = "GGCCCC"
PREFIX = ("CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACTCACCCACTCGCCACCGCCTGCGCC"
          "TCCGCCGCCGCGGGCGCAGGCACCGCAACCGCAGCCCCGCCCCGGGCCCGCCCCCGGGCCCGCCCCGACCACGCCCC")
SUFFIX = ("TAGCGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTTCCCTCCTTGTTTTCTTCTGGTTAA"
          "TCTTTATCAGGTCTTTTCTTGTTCACCCTCAGCGAGTACTGTGAGAGCAAGTAGTGGGGAGAGAGGGTGGGAAAAAC")


def write_pore_model(path: str, seed: int = 0, k: int = 6) -> str:
    """Write a deterministic 4**k-row k-mer model (levels 60-130 pA, stdv 1-3)."""
    rng = np.random.default_rng(seed)
    kmers = ["".join(p) for p in itertools.product("ACGT", repeat=k)]
    means = rng.uniform(60.0, 130.0, len(kmers))
    stdvs = rng.uniform(1.0, 3.0, len(kmers))
    with open(path, "w") as fp:
        for km, mu, sd in zip(kmers, means, stdvs):
            fp.write(f"{km}\t{mu:.4f}\t{sd:.4f}\n")
    return path


def make_reads(pm, n_reads: int, repeats: int, rng, strand: str = "+",
               flank_bases: int = 1000, prefix: str = PREFIX, suffix: str = SUFFIX,
               equal_length: bool = True) -> list:
    """``n_reads`` noisy raw signals of one locus with ``repeats`` units.

    A '-' read is synthesised from the reverse complement.  With
    ``equal_length`` the reads are edge-padded to one length (one
    signal bucket), as bench.py does.
    """
    backbone = "".join(rng.choice(list("ACTG"), 2 * flank_bases))
    seq = (backbone[:flank_bases] + prefix + REPEAT * repeats + suffix
           + backbone[-flank_bases:])
    if strand == "-":
        seq = seq.upper().translate(str.maketrans("ACGT", "TGCA"))[::-1]
    sigs = [pm.generate_signal(seq, samples=8, noise=True, rng=rng) for _ in range(n_reads)]
    if equal_length:
        n = max(len(s) for s in sigs)
        sigs = [np.pad(s, (0, n - len(s)), mode="edge") for s in sigs]
    return sigs


def smoke_workload(pm, seed: int, n_warm: int = 64, n_plus: int = 128,
                   n_minus: int = 24, repeats: int = 100):
    """chip_smoke.py's reads: (warm-up '+', timed '+', '-') signal lists.

    All three sets carry ``repeats`` units; the '+' reads share one
    length (one bucket), like bench.py's uniform pass.
    """
    rng = np.random.default_rng(seed + 1)
    plus = make_reads(pm, n_warm + n_plus, repeats, rng, "+")
    minus = make_reads(pm, n_minus, repeats, rng, "-")
    return plus[:n_warm], plus[n_warm:], minus


def ultralong_workload(pm, seed: int, n_reads: int = 8, repeats: int = 1200,
                       flank_bases: int = 70000) -> list:
    """chip_smoke.py's ultra-long reads: ``n_reads`` noisy '+' reads of
    ~1.1M samples with ``repeats`` units, one length (one bucket).

    The "ultra" regime of tools/bench_ultralong.py (70,000 backbone
    bases on each side of the locus, 1200 GGCCCC units): its bucket's
    width-8 pointer plane is ~4.7 GB at the bench flanks.
    """
    rng = np.random.default_rng(seed + 2)
    return make_reads(pm, n_reads, repeats, rng, "+", flank_bases=flank_bases)
