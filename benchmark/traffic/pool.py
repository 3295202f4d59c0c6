"""A seeded pool of noisy reads of one locus, replayed by the window.

The generator every cell of this benchmark names.  Its parameters, from
the cell's file:

  * ``reads``: the pool's size;
  * ``plus_share``: the share of '+' reads (the rest are '-');
  * ``alleles``: a list of ``{"share", "units": [lo, hi], "draw"}``,
    each allele on its share of the reads, a read's repeat units drawn
    from [lo, hi] ``uniform`` (integers) or ``log_uniform``;
  * ``flank_bases``: [lo, hi], the backbone bases on each side of the
    locus, drawn uniformly per read (one draw for both sides);
  * an allele's optional ``"methylation": {"reads": r, "units": u}``: a
    share r of its reads are methylated, and in a methylated read each
    repeat unit is methylated with probability u (it needs the
    configuration's 5mC twin, ``mod_model_file``).

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

In a methylated unit each k-mer that starts there takes the twin's level
and stdv (``write_mod_model``: the base model with a shift on every
k-mer holding ``CG``); on the '-' strand the per-base flags are reversed
with the sequence.  Which reads and units are methylated is one fixed
draw a cell (``methylation``, from a stream of its own), and a read's
rng draws the same numbers whether it is methylated or not, so without
``methylation`` the pool is the one it was before the key existed.
"""
from __future__ import annotations

import itertools

import numpy as np

BASES = "ACGT"
_CODE = np.full(256, -1, np.int64)
for _i, _b in enumerate(BASES):
    _CODE[ord(_b)] = _i
_COMPLEMENT = str.maketrans("ACGT", "TGCA")


def _model_rows(seed: int, k: int) -> list:
    """(k-mer, mean, stdv) of the seeded model, the numbers as written."""
    rng = np.random.default_rng([seed, 0])
    kmers = ["".join(p) for p in itertools.product(BASES, repeat=k)]
    means = rng.uniform(60.0, 130.0, len(kmers))
    stdvs = rng.uniform(1.0, 3.0, len(kmers))
    return [(km, f"{mu:.4f}", f"{sd:.4f}") for km, mu, sd in zip(kmers, means, stdvs)]


def _write_rows(path: str, rows) -> str:
    with open(path, "w") as fp:
        fp.writelines(f"{km}\t{mu}\t{sd}\n" for km, mu, sd in rows)
    return path


def write_model(path: str, seed: int, k: int = 6) -> str:
    """A 4**k-row k-mer table of seeded levels: means uniform in 60-130 pA,
    stdvs in 1-3, written as ``kmer<TAB>mean<TAB>stdv``."""
    return _write_rows(path, _model_rows(seed, k))


def write_mod_model(path: str, seed: int, k: int, shift_pA: float) -> str:
    """The 5mC twin of ``write_model(path, seed, k)``: the same k-mers and
    stdvs, with ``shift_pA`` added to the written level of every k-mer
    that contains ``CG`` (the port's own synthetic twin,
    ``strique_tpu_torch.synthetic.write_mod_model``, does the same)."""
    return _write_rows(path, [(km, f"{float(mu) + shift_pA:.4f}" if "CG" in km else mu, sd)
                              for km, mu, sd in _model_rows(seed, k)])


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


def synthesise(model, seq: str, rng, twin=None, methylated=None) -> np.ndarray:
    """Noisy signal of a sequence: each k-mer 6-9 samples at its level,
    with its stdv as Gaussian noise.  A k-mer whose first base is flagged
    in ``methylated`` (per base) takes ``twin``'s level and stdv."""
    means, stdvs, k = model
    code = _kmer_codes(seq, k)
    mu, sd = means[code], stdvs[code]
    if methylated is not None:
        on = methylated[: len(code)]
        mu = np.where(on, twin[0][code], mu)
        sd = np.where(on, twin[1][code], sd)
    reps = rng.uniform(6, 10, len(code)).astype(int)
    return rng.normal(np.repeat(mu, reps), np.repeat(sd, reps))


def read(model, locus: dict, units: int, strand: str, flank: int, rng, twin=None,
         unit_flags=None) -> np.ndarray:
    """One read's int16 raw signal; ``unit_flags`` (one bool a repeat unit,
    in the '+' strand's order) marks its methylated units."""
    backbone = "".join(rng.choice(list("ACTG"), 2 * flank))
    seq = (backbone[:flank] + locus["prefix"] + locus["repeat"] * units + locus["suffix"]
           + backbone[-flank:])
    methylated = None
    if unit_flags is not None:
        methylated = np.zeros(len(seq), bool)
        start = flank + len(locus["prefix"])
        methylated[start : start + units * len(locus["repeat"])] = np.repeat(
            np.asarray(unit_flags, bool), len(locus["repeat"]))
    if strand == "-":
        seq = seq.upper().translate(_COMPLEMENT)[::-1]
        methylated = None if methylated is None else methylated[::-1]
    return (synthesise(model, seq, rng, twin, methylated) * 10).astype(np.int16)


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


def _plan(params: dict) -> tuple:
    """(each read's allele index, ``specs``), from the fixed stream."""
    rng = np.random.default_rng([0, 2])
    n = int(params["reads"])
    alleles = rng.permutation(_exact(n, [a["share"] for a in params["alleles"]]))
    plus = rng.permutation(_exact(n, [params["plus_share"], 1.0 - params["plus_share"]]))
    lo, hi = params["flank_bases"]
    return alleles, [(_units(rng, params["alleles"][int(a)]), "+" if p == 0 else "-",
                      int(rng.integers(lo, hi + 1))) for a, p in zip(alleles, plus)]


def specs(params: dict) -> list:
    """The pool's (units, strand, flank bases) a read: alleles and strands
    in their exact shares, one set for every seed (drawn from a fixed
    stream), so seeds change the reads' content and order but not the
    work they ask for."""
    return _plan(params)[1]


def methylation(params: dict) -> list:
    """Each read's methylated-unit flags (a bool array of its units, in
    the '+' strand's order), or None for a read with none drawn: of each
    allele with ``methylation``, its exact share ``reads`` of reads, in
    them each unit with probability ``units``.  One fixed draw a cell
    (its own stream), like ``specs``."""
    alleles, sp = _plan(params)
    rng = np.random.default_rng([0, 5])
    flags = [None] * len(sp)
    for a, allele in enumerate(params["alleles"]):
        m = allele.get("methylation")
        if m is None:
            continue
        idx = np.flatnonzero(alleles == a)
        pick = rng.permutation(_exact(len(idx), [m["reads"], 1.0 - m["reads"]])) == 0
        for k in idx[pick]:
            flags[k] = rng.random(sp[k][0]) < m["units"]
    return flags


def make_pool(model_file: str, locus: dict, params: dict, seed: int,
              mod_model_file: str | None = None) -> list:
    """The pool: a list of (units, strand, int16 raw signal).  Methylated
    alleles take their flagged units' levels from ``mod_model_file``."""
    model = read_model(model_file)
    flags = methylation(params)
    if mod_model_file is None and any(f is not None for f in flags):
        raise ValueError("methylated alleles need the configuration's mod model")
    twin = read_model(mod_model_file) if mod_model_file else None
    return [(u, s, read(model, locus, u, s, f, np.random.default_rng([seed, 1, k]), twin,
                        flags[k]))
            for k, (u, s, f) in enumerate(specs(params))]
