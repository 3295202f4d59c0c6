"""A seeded pool of noisy reads of one locus, replayed by the window.

The generator every cell of this benchmark names.  Its parameters, from
the cell's file:

  * ``reads``: the pool's size;
  * ``plus_share``: the share of '+' reads (the rest are '-');
  * ``alleles``: a list of ``{"share", "units": [lo, hi], "draw"}``,
    each allele on its share of the reads, a read's repeat units drawn
    from [lo, hi] ``uniform`` (integers) or ``log_uniform``;
  * ``flank_bases``: [lo, hi], the backbone bases on each side of the
    locus, drawn uniformly per read (one draw for both sides).

A read is its locus sequence -- backbone, the 150-base prefix, the
repeat, the 150-base suffix, backbone -- synthesised by the pore model
with 6-9 samples a k-mer and Gaussian noise at each k-mer's level
stdv, read from the reverse complement on the '-' strand, and stored
as int16 of ten times the level in pA, as a fast5 holds it.  The
reads' sizes (units, strand, flanks) are one fixed draw a cell; read k
draws its backbone and signal from ``default_rng([seed, 1, k])``.  The
synthesis is STRique's ``generate_signal`` (reference
scripts/STRique.py:182-195) with the k-mer lookup done on code arrays;
it draws the same numbers as a per-k-mer lookup would.
"""
from __future__ import annotations

import itertools

import numpy as np

BASES = "ACGT"
_CODE = np.full(256, -1, np.int64)
for _i, _b in enumerate(BASES):
    _CODE[ord(_b)] = _i
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def write_model(path: str, seed: int, k: int = 6) -> str:
    """A 4**k-row k-mer table of seeded levels: means uniform in 60-130 pA,
    stdvs in 1-3, written as ``kmer<TAB>mean<TAB>stdv``."""
    rng = np.random.default_rng([seed, 0])
    kmers = ["".join(p) for p in itertools.product(BASES, repeat=k)]
    means = rng.uniform(60.0, 130.0, len(kmers))
    stdvs = rng.uniform(1.0, 3.0, len(kmers))
    with open(path, "w") as fp:
        fp.writelines(f"{km}\t{mu:.4f}\t{sd:.4f}\n" for km, mu, sd in zip(kmers, means, stdvs))
    return path


def read_model(path: str) -> tuple[np.ndarray, np.ndarray, int]:
    """(means, stdvs) indexed by the k-mer's base-4 code, and k."""
    rows = [line.rstrip("\n").split("\t")[:3] for line in open(path) if line.strip()]
    k = len(rows[0][0])
    means = np.zeros(4 ** k)
    stdvs = np.zeros(4 ** k)
    for km, mu, sd in rows:
        code = 0
        for ch in km:
            code = code * 4 + BASES.index(ch)
        means[code], stdvs[code] = float(mu), float(sd)
    return means, stdvs, k


def _kmer_codes(seq: str, k: int) -> np.ndarray:
    c = _CODE[np.frombuffer(seq.encode(), np.uint8)]
    n = len(c) - k + 1
    code = np.zeros(n, np.int64)
    for j in range(k):
        code = code * 4 + c[j : j + n]
    return code


def synthesise(model, seq: str, rng) -> np.ndarray:
    """Noisy signal of a sequence: each k-mer 6-9 samples at its level,
    with its stdv as Gaussian noise."""
    means, stdvs, k = model
    code = _kmer_codes(seq, k)
    reps = rng.uniform(6, 10, len(code)).astype(int)
    return rng.normal(np.repeat(means[code], reps), np.repeat(stdvs[code], reps))


def read(model, locus: dict, units: int, strand: str, flank: int, rng) -> np.ndarray:
    """One read's int16 raw signal."""
    backbone = "".join(rng.choice(list("ACTG"), 2 * flank))
    seq = (backbone[:flank] + locus["prefix"] + locus["repeat"] * units + locus["suffix"]
           + backbone[-flank:])
    if strand == "-":
        seq = seq.upper().translate(_COMPLEMENT)[::-1]
    return (synthesise(model, seq, rng) * 10).astype(np.int16)


def _units(rng, allele: dict) -> int:
    lo, hi = allele["units"]
    if allele.get("draw", "uniform") == "log_uniform":
        return int(round(float(np.exp(rng.uniform(np.log(lo), np.log(hi))))))
    return int(rng.integers(lo, hi + 1))


def _exact(n: int, shares) -> np.ndarray:
    """n labels in the given shares (largest remainder), in label order."""
    shares = np.asarray(shares, np.float64) / np.sum(shares)
    counts = np.floor(shares * n).astype(int)
    for i in np.argsort(-(shares * n - counts), kind="stable")[: n - counts.sum()]:
        counts[i] += 1
    return np.repeat(np.arange(len(shares)), counts)


def specs(params: dict) -> list:
    """The pool's (units, strand, flank bases) a read: alleles and strands
    in their exact shares, one set for every seed (drawn from a fixed
    stream), so seeds change the reads' content and order but not the
    work they ask for."""
    rng = np.random.default_rng([0, 2])
    n = int(params["reads"])
    alleles = rng.permutation(_exact(n, [a["share"] for a in params["alleles"]]))
    plus = rng.permutation(_exact(n, [params["plus_share"], 1.0 - params["plus_share"]]))
    lo, hi = params["flank_bases"]
    return [(_units(rng, params["alleles"][int(a)]), "+" if p == 0 else "-",
             int(rng.integers(lo, hi + 1))) for a, p in zip(alleles, plus)]


def make_pool(model_file: str, locus: dict, params: dict, seed: int) -> list:
    """The pool: a list of (units, strand, int16 raw signal)."""
    model = read_model(model_file)
    return [(u, s, read(model, locus, u, s, f, np.random.default_rng([seed, 1, k])))
            for k, (u, s, f) in enumerate(specs(params))]
