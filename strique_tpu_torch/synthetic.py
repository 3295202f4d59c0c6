"""Deterministic synthetic inputs: a 6-mer pore model and c9orf72 reads.

Tests and ``chip_smoke.py`` need a pore model and reads with a known
repeat count without any downloaded data: the model is a full 4096-row
6-mer table of seeded random levels in the tab format ``PoreModel``
parses (``kmer<TAB>level_mean<TAB>level_stdv``), and reads are the
c9orf72 locus (flanks as in bench.py) around a backbone, synthesised by
``PoreModel.generate_signal`` with per-sample model noise.  Mod
calling has a twin model (``write_mod_model``: CpG k-mers shifted) and
reads from both (``make_mod_reads``, ``mod_workload``).  ``quantise``
turns f32 reads into the counter's morph form (u8 bins and a 256-level
table per read) for the tests of the TABLE score mode.  The Viterbi
kernels' edge inputs (``viterbi_edge_case``) and their wide inputs past
SP 1024 (``viterbi_wide_case``) are tables shared by the ``gpu`` tests
and ``chip_smoke.py``, and so are the traceback's
hard pointer planes (``traceback_plane``).  ``write_repeat_config``,
``write_single_fast5`` and ``sam_line`` write the inputs of a ``count``
run (a repeat TSV over ``LOCI``, single-read fast5 files, SAM lines
that span a locus), ``write_count_run`` a whole small run;
``count_workload`` is ``chip_smoke.py``'s stream of reads over both
loci.
"""
from __future__ import annotations

import itertools
import os

import numpy as np

REPEAT = "GGCCCC"
PREFIX = ("CGGCAGCCGAACCCCAAACAGCCACCCGCCAGGATGCCGCCTCCTCACTCACCCACTCGCCACCGCCTGCGCC"
          "TCCGCCGCCGCGGGCGCAGGCACCGCAACCGCAGCCCCGCCCCGGGCCCGCCCCCGGGCCCGCCCCGACCACGCCCC")
SUFFIX = ("TAGCGCGCGACTCCTGAGTTCCAGAGCTTGCTACAGGCTGCGGTTGTTTCCCTCCTTGTTTTCTTCTGGTTAA"
          "TCTTTATCAGGTCTTTTCTTGTTCACCCTCAGCGAGTACTGTGAGAGCAAGTAGTGGGGAGAGAGGGTGGGAAAAAC")

# FMR1's locus with the flanks and the repeat unit of tests/test_detection.py
FMR1_REPEAT = "GCG"
FMR1_PREFIX = ("AGCGGGCCGGGGGTTCGGCCTCAGTCAGGCGCTCAGCTCCGTTTCGGTTTCACTTCCGGTGGAGGGCCGCC"
               "TCTGAGCGGGCGGCGGGCCGACGGCGAGCGCGGGCGGCGGCGGTGACGGAGGCGCCGCTGCCAGGGGGCGTGCGGCAGC")
FMR1_SUFFIX = ("GAGGCGGCGGCGGCGGCGGCGGCGGCGGCGGCTGGGCCTCGAGCGCCCGCAGCCCACCTCTCGGGGGCGGG"
               "CTCCCGGCGCTAGCAGGGCTGAAGAGAAGATGGAGGAGCTGGTGGTGGAAGTGCGGGGCTCCAATGGCGCTTTCTACAA")
# target -> (chromosome, begin, end, repeat, prefix, suffix), a repeat
# TSV's columns (hg19 coordinates of the two loci)
LOCI = {
    "c9orf72": ("chr9", 27573527, 27573544, REPEAT, PREFIX, SUFFIX),
    "fmr1": ("chrX", 146993569, 146993628, FMR1_REPEAT, FMR1_PREFIX, FMR1_SUFFIX),
}


def write_repeat_config(path: str, loci: dict) -> str:
    """A repeat TSV (``chr begin end name repeat prefix suffix``, with its
    header) of ``loci``: name -> a ``LOCI`` tuple."""
    with open(path, "w") as fp:
        fp.write("chr\tbegin\tend\tname\trepeat\tprefix\tsuffix\n")
        for name, (chrom, begin, end, repeat, prefix, suffix) in loci.items():
            fp.write(f"{chrom}\t{begin}\t{end}\t{name}\t{repeat}\t{prefix}\t{suffix}\n")
    return path


def write_single_fast5(path: str, read_id: str, signal) -> None:
    """A single-read fast5 holding ``signal`` as int16 under
    ``Raw/Reads/Read_1`` (needs h5py)."""
    import h5py

    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_1")
        g.attrs["read_id"] = np.bytes_(read_id.encode())
        g.create_dataset("Signal", data=np.asarray(signal, np.int16))


def sam_line(read_id: str, strand: str, chrom: str, begin: int) -> str:
    """A mapped SAM line whose span covers a locus starting at ``begin``."""
    flag = 16 if strand == "-" else 0
    return f"{read_id}\t{flag}\t{chrom}\t{begin - 20000}\t60\t41000M\t*\t0\t0\t*\t*\n"


def write_count_run(directory, pm, specs, seed: int, loci=None) -> dict:
    """A small ``count`` run in ``directory`` (needs h5py): per spec
    (target, units, strand, backbone bases on each side) one noisy read
    from ``default_rng((seed, k))`` as a single-read fast5, a fofn from
    ``io.fast5.index``, a SAM file and a repeat TSV of the targets.
    Returns the paths and ``reads``: read id -> (target, strand, units)."""
    from .io import fast5

    loci = LOCI if loci is None else loci
    sam = ["@HD\tVN:1.6\n"]
    reads = {}
    for k, (name, units, strand, flank) in enumerate(specs):
        chrom, begin, _end, repeat, prefix, suffix = loci[name]
        sig = make_reads(pm, 1, units, np.random.default_rng((seed, k)), strand=strand,
                         flank_bases=flank, prefix=prefix, suffix=suffix, repeat=repeat)[0]
        rid = f"read-{k}-{name}{strand}"
        write_single_fast5(os.path.join(directory, f"{rid}.fast5"), rid,
                           (sig * 10).astype(np.int16))
        sam.append(sam_line(rid, strand, chrom, begin))
        reads[rid] = (name, strand, units)
    run = {"dir": str(directory), "reads": reads}
    for key, name, text in (
            ("fofn", "reads.fofn", "\n".join(fast5.index(str(directory))) + "\n"),
            ("sam", "algn.sam", "".join(sam))):
        run[key] = os.path.join(directory, name)
        with open(run[key], "w") as fp:
            fp.write(text)
    run["repeat"] = write_repeat_config(os.path.join(directory, "repeats.tsv"),
                                        {name: loci[name] for name, *_ in specs})
    return run


def _write_model(path: str, seed: int, k: int, cpg_shift: float) -> str:
    rng = np.random.default_rng(seed)
    kmers = ["".join(p) for p in itertools.product("ACGT", repeat=k)]
    means = rng.uniform(60.0, 130.0, len(kmers))
    stdvs = rng.uniform(1.0, 3.0, len(kmers))
    with open(path, "w") as fp:
        for km, mu, sd in zip(kmers, means, stdvs):
            fp.write(f"{km}\t{mu + (cpg_shift if 'CG' in km else 0.0):.4f}\t{sd:.4f}\n")
    return path


def write_pore_model(path: str, seed: int = 0, k: int = 6) -> str:
    """Write a deterministic 4**k-row k-mer model (levels 60-130 pA, stdv 1-3)."""
    return _write_model(path, seed, k, 0.0)


# the mod twin's CpG level shift (pA); on the pair at MOD_MODEL_SEED (below)
# the JAX package separates base and twin reads on both strands at it
# (tools/probe_mod_twin.py)
MOD_SHIFT = -4.0


def write_mod_model(path: str, seed: int = 0, shift: float = MOD_SHIFT, k: int = 6) -> str:
    """Write the 5mC twin of ``write_pore_model(path, seed, k)``: the same
    4**k k-mers, levels and stdvs, with ``shift`` added to the level of
    every k-mer that contains ``CG``."""
    return _write_model(path, seed, k, shift)


def make_reads(pm, n_reads: int, repeats: int, rng, strand: str = "+",
               flank_bases: int = 1000, prefix: str = PREFIX, suffix: str = SUFFIX,
               equal_length: bool = True, repeat: str = REPEAT) -> list:
    """``n_reads`` noisy raw signals of one locus with ``repeats`` units
    of ``repeat``.

    A '-' read is synthesised from the reverse complement.  With
    ``equal_length`` the reads are edge-padded to one length (one
    signal bucket), as bench.py does.
    """
    backbone = "".join(rng.choice(list("ACTG"), 2 * flank_bases))
    seq = (backbone[:flank_bases] + prefix + repeat * repeats + suffix
           + backbone[-flank_bases:])
    if strand == "-":
        seq = seq.upper().translate(str.maketrans("ACGT", "TGCA"))[::-1]
    sigs = [pm.generate_signal(seq, samples=8, noise=True, rng=rng) for _ in range(n_reads)]
    if equal_length:
        n = max(len(s) for s in sigs)
        sigs = [np.pad(s, (0, n - len(s)), mode="edge") for s in sigs]
    return sigs


def make_mod_reads(pm, pm_mod, n_reads: int, repeats: int, rng, strand: str = "+",
                   flank_bases: int = 1000, prefix: str = PREFIX, suffix: str = SUFFIX,
                   repeat: str = REPEAT) -> list:
    """``n_reads`` noisy raw signals of one locus sequence, as bench.py's
    mod pass makes them: even reads from the base model ``pm``, odd ones
    from its twin ``pm_mod``, edge-padded to one length."""
    backbone = "".join(rng.choice(list("ACTG"), 2 * flank_bases))
    seq = (backbone[:flank_bases] + prefix + repeat * repeats + suffix
           + backbone[-flank_bases:])
    if strand == "-":
        seq = seq.upper().translate(str.maketrans("ACGT", "TGCA"))[::-1]
    sigs = [(pm_mod if i % 2 else pm).generate_signal(seq, samples=8, noise=True, rng=rng)
            for i in range(n_reads)]
    n = max(len(s) for s in sigs)
    return [np.pad(s, (0, n - len(s)), mode="edge") for s in sigs]


# the base model's seed of the mod pair (``write_pore_model`` and
# ``write_mod_model`` at MOD_MODEL_SEED): on it the JAX package calls
# twin reads '1' and base reads '0' on both strands at MOD_SHIFT.  Which
# sign of shift separates depends on the model and the strand: the
# read's minmax normalisation moves with its CpG levels (on seed 0, -4
# separates '+' reads only and +4 '-' reads only)
MOD_MODEL_SEED = 7
MOD_REPEATS = 50
# the reads of mod_workload(pm, pm_mod, 0) on the MOD_MODEL_SEED pair that
# the JAX package counts off MOD_REPEATS on the CPU: (strand, index) ->
# its count.  Two twin '-' reads of 128; every other read counts exact
MOD_WORKLOAD_MISCOUNTS = {("-", 21): 51, ("-", 27): 51}


def mod_workload(pm, pm_mod, seed: int, n_plus: int = 96, n_minus: int = 32,
                 repeats: int = MOD_REPEATS):
    """chip_smoke.py phase 4h's reads: (n_plus '+' reads, n_minus '-'
    reads) of c9orf72 with ``repeats`` units, each list alternating base
    and twin reads (``make_mod_reads``) from ``default_rng(seed + 3)``."""
    rng = np.random.default_rng(seed + 3)
    return (make_mod_reads(pm, pm_mod, n_plus, repeats, rng, "+"),
            make_mod_reads(pm, pm_mod, n_minus, repeats, rng, "-"))


# chip_smoke.py phase 4g's stream: (target, strand, reads) groups, units
# drawn from COUNT_UNITS, read lengths drawn from COUNT_BASES bases (8
# samples a base: ~16k-40k samples, six signal buckets)
COUNT_GROUPS = (("c9orf72", "+", 192), ("c9orf72", "-", 64), ("fmr1", "+", 64),
                ("fmr1", "-", 64))
COUNT_UNITS = (20, 150)
COUNT_BASES = (2000, 4900)


def count_workload(pm, seed: int):
    """A shuffled stream of noisy reads of ``COUNT_GROUPS`` over ``LOCI``:
    a list of (read_id, target, strand, units, int16 signal).

    Each read draws its units from ``COUNT_UNITS`` and its length in
    bases from ``COUNT_BASES`` (the backbone on each side of the locus
    makes up the rest), from ``default_rng(seed)``; the signal is stored
    as int16 of 10x the model's pA, as a fast5 holds it."""
    rng = np.random.default_rng(seed)
    reads = []
    for target, strand, n in COUNT_GROUPS:
        _chrom, _b, _e, repeat, prefix, suffix = LOCI[target]
        for _ in range(n):
            units = int(rng.integers(COUNT_UNITS[0], COUNT_UNITS[1] + 1))
            bases = int(rng.integers(*COUNT_BASES))
            flank = max((bases - len(prefix) - len(suffix) - len(repeat) * units) // 2, 50)
            sig = make_reads(pm, 1, units, rng, strand, flank_bases=flank, prefix=prefix,
                             suffix=suffix, repeat=repeat)[0]
            rid = f"{target}-{strand}-{len(reads):04d}"
            reads.append((rid, target, strand, units, (sig * 10).astype(np.int16)))
    order = rng.permutation(len(reads))
    return [reads[i] for i in order]


def quantise(sig, rng, lo=None, hi=None):
    """Morph form of (B, N) reads: u8 bins and a (B, 256) f32 table per
    read of 256 affine levels from ``lo`` to ``hi`` (as the counter's prep
    builds one), each sample at its nearest level.  By default a read's
    span is its own range widened by up to 5 on each side (from ``rng``)."""
    B = sig.shape[0]
    if lo is None:
        lo = sig.min(axis=1) - rng.uniform(0, 5, B)
        hi = sig.max(axis=1) + rng.uniform(0, 5, B)
    lut = (lo[:, None] + (hi - lo)[:, None] * np.arange(256) / 255.0).astype(np.float32)
    bins = np.clip(np.rint((sig - lo[:, None]) / (hi - lo)[:, None] * 255.0), 0, 255)
    return bins.astype(np.uint8), lut


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


# the Viterbi kernels' edge inputs, 8 reads of T VITERBI_EDGE_T: label ->
# (flank bases on each side of the repeat HMM, read lengths, constant obs).
# Lengths below the backward's 16-row score ring and around the forward's
# 32-step obs chunks; constant obs ties every row; flank 100 gives SP 512
VITERBI_EDGE_T = 1024
VITERBI_EDGES = {
    "short": (50, [1, 2, 3, 5, 9, 15, 16, 17], False),
    "obs chunks": (50, [31, 32, 33, 64, 65, 100, 129, 1000], False),
    "constant obs": (50, [1024, 700, 65, 33, 2, 1, 500, 1023], True),
    "SP 512": (100, [1024, 800, 129, 65, 9, 2, 1, 300], False),
}


def viterbi_edge_case(pm, label: str, rng):
    """(CompiledHMM, obs (8, VITERBI_EDGE_T) f32, lengths (8,) int32) of
    the edge case ``label``: noisy reads of 20 units between the HMM's
    flanks, cut to each length and zero-padded (or 100.0 throughout)."""
    from .hmm.models import build_flanked_repeat

    flank, lens, constant = VITERBI_EDGES[label]
    chm = build_flanked_repeat(REPEAT, PREFIX[-flank:], SUFFIX[:flank], pm)
    obs = np.zeros((len(lens), VITERBI_EDGE_T), np.float32)
    for i, k in enumerate(lens):
        x = pm.generate_signal(PREFIX[-flank:] + REPEAT * 20 + SUFFIX[:flank], samples=8,
                               noise=True, rng=rng).astype(np.float32)[:k]
        obs[i, :k] = 100.0 if constant else x
    return chm, obs, np.array(lens, np.int32)


# the wide Viterbi kernels' inputs (SP past 1024), 8 reads of T
# VITERBI_WIDE_T: label -> (HMM, unit bases, read lengths, constant obs).
# "flanked": the repeat HMM of a random unit between 50-base flanks (the
# chained slot layout; 6 states a base and 180 more: SP 1152 at 150
# bases, the unit of WIDE_UNIT_BASES, 1792 at 260, 2048 at 300, 4096 at
# 650, 4480 at 700, 8192 at 1330); "mod": the mod HMM of a random unit
# (the diagonal-only layout; SP 1152 at 260 bases, 1792 at 430, 2048 at
# 500, 4096 at 1000, 8192 at 2030).  Lengths below the backward's score
# ring and around a warp's 32 steps; constant obs ties candidates across
# the backward's warps.  SP 1792 and 4480 leave the cluster forward's
# last CTA part of its lanes, and SP 4480 the backward's last warp a part
# of its lanes
VITERBI_WIDE_T = 1024
VITERBI_WIDE = {
    "flanked 150": ("flanked", 150, [1024, 700, 129, 65, 33, 17, 2, 1], False),
    "flanked 150, constant obs": ("flanked", 150, [1024, 1000, 300, 64, 32, 16, 3, 1], True),
    "flanked 260": ("flanked", 260, [1024, 900, 257, 96, 33, 31, 2, 1], False),
    "flanked 300": ("flanked", 300, [1024, 513, 400, 100, 31, 5, 2, 1], False),
    "flanked 650": ("flanked", 650, [1024, 777, 300, 64, 32, 12, 2, 1], False),
    "flanked 700": ("flanked", 700, [1024, 900, 256, 97, 40, 9, 4, 1], False),
    "flanked 1330": ("flanked", 1330, [1024, 600, 200, 77, 33, 8, 2, 1], False),
    "mod 260": ("mod", 260, [1024, 800, 129, 65, 33, 17, 2, 1], False),
    "mod 260, constant obs": ("mod", 260, [1024, 1000, 300, 64, 32, 16, 3, 1], True),
    "mod 430": ("mod", 430, [1024, 640, 200, 65, 34, 15, 3, 1], False),
    "mod 500": ("mod", 500, [1024, 1000, 300, 64, 32, 16, 3, 1], False),
    "mod 1000": ("mod", 1000, [1024, 999, 333, 63, 33, 7, 2, 1], False),
    "mod 2030": ("mod", 2030, [1024, 513, 400, 100, 31, 5, 2, 1], False),
}
# the 150-base VNTR unit past SP 1024 (the repeat HMM of 1080 states, SP
# 1152, on PREFIX and SUFFIX): default_rng(5)'s first draw
WIDE_UNIT_BASES = 150
# the mod target past SP 1024: a 260-base unit, whose repeat HMM (SP
# 1792) and mod HMM (SP 1152) both take the cluster forward
WIDE_MOD_UNIT_BASES = 260
WIDE_MOD_UNITS = 3


def random_unit(bases: int, seed: int) -> str:
    """A random repeat unit: ``default_rng(seed)``'s first ``bases`` draws."""
    return "".join(np.random.default_rng(seed).choice(list("ACGT"), bases))


def wide_mod_reads(base_model: str, twin_model: str, n_reads: int):
    """The wide mod target's unit (``random_unit(WIDE_MOD_UNIT_BASES,
    WIDE_MOD_UNIT_BASES)``) and ``n_reads`` '+' reads of WIDE_MOD_UNITS
    units, alternately from the base and the twin model
    (``make_mod_reads`` from ``default_rng(6)``)."""
    from .pore_model import PoreModel

    unit = random_unit(WIDE_MOD_UNIT_BASES, WIDE_MOD_UNIT_BASES)
    reads = make_mod_reads(PoreModel(base_model), PoreModel(twin_model), n_reads,
                           WIDE_MOD_UNITS, np.random.default_rng(6), "+", repeat=unit)
    return unit, reads


def viterbi_wide_case(pm, pm_mod, label: str, rng):
    """(CompiledHMM, obs (8, VITERBI_WIDE_T) f32, lengths (8,) int32) of
    the wide case ``label``: the HMM of a random unit (``random_unit(bases,
    bases)``), noisy reads of 3 units (between the flanks for a flanked
    HMM; the mod model's odd reads from ``pm_mod``, clipped to the mod
    HMM's level range) cut to each length, or 100.0 throughout."""
    from .hmm.models import build_flanked_repeat, build_repeat_mod

    kind, bases, lens, constant = VITERBI_WIDE[label]
    unit = random_unit(bases, bases)
    if kind == "flanked":
        chm = build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], pm)
        seq = PREFIX[-50:] + unit * 3 + SUFFIX[:50]
    else:
        chm = build_repeat_mod(unit, pm, pm_mod)
        seq = unit * 3
    obs = np.zeros((len(lens), VITERBI_WIDE_T), np.float32)
    for i, k in enumerate(lens):
        x = (pm_mod if kind == "mod" and i % 2 else pm).generate_signal(
            seq, samples=8, noise=True, rng=rng)
        if kind == "mod":
            x = np.clip(x, chm.meta["model_min"], chm.meta["model_max"])
        obs[i, :k] = 100.0 if constant else x.astype(np.float32)[:k]
    return chm, obs, np.array(lens, np.int32)


# the wide backward's edge inputs (label -> SP): score rows and a sparse
# transT built directly, each state's predecessors s, s-1, s-2 and s-5
# (mod SP) and every 7th state none (its candidates all fl(sc + NEG):
# NEG itself for every moderate score, a tie across the CTA's warps that
# the least state wins).  "signed zeros": every score and transition is
# -0.0 or +0.0, so a step's best candidates tie at zero in both signs
# (the first of them wins under >=); "ties at NEG": transitions of
# -9.9e29 and 3 scores in 10 at -5e29; "random ties": scores from 4
# values, transitions from 3
BWD_EDGE_T = 256
BWD_EDGES = {"signed zeros": 1152, "ties at NEG": 1152, "random ties": 4480,
             "ties at NEG, SP 8192": 8192}


def bwd_edge_case(label: str, rng):
    """(sc (T, 8, SP) f32, transT (SP, SP) f32, last (8,) int64, lengths
    (8,) int32) of the wide backward's edge case ``label``
    (``BWD_EDGES``), T = BWD_EDGE_T."""
    sp = BWD_EDGES[label]
    neg = np.float32(-1e30)
    transT = np.full((sp, sp), neg, np.float32)
    s = np.arange(sp)
    has = s % 7 != 3
    for d in (0, 1, 2, 5):
        u = (s - d) % sp
        if label == "signed zeros":
            w = rng.choice(np.array([-0.0, 0.0], np.float32), sp)
        elif label.startswith("ties at NEG"):
            w = np.full(sp, -9.9e29, np.float32)
        else:
            w = rng.choice(np.array([-1.5, -0.25, 0.0], np.float32), sp)
        transT[s[has], u[has]] = w[has]
    T, B = BWD_EDGE_T, 8
    if label == "signed zeros":
        sc = rng.choice(np.array([-0.0, 0.0], np.float32), (T, B, sp))
    elif label.startswith("ties at NEG"):
        sc = rng.uniform(-10.0, 0.0, (T, B, sp)).astype(np.float32)
        sc[rng.random((T, B, sp)) < 0.3] = -5e29
    else:
        sc = rng.choice(np.array([-3.0, -1.0, -0.5, 0.0], np.float32), (T, B, sp))
    lens = np.array([T, T - 1, 129, 65, 33, 17, 2, 1], np.int32)
    last = rng.integers(0, sp, B).astype(np.int64)
    return sc, transT, last, lens


# the traceback's hard planes: each row's codes (a dominant nibble and the
# share of uniform random ones, code 3 included; None: uniform throughout)
# and where its walk starts.  V runs longer than a 128-lane window, H runs
# across more than 16 word groups, j_end 0 (column 0's "V, extend" walk)
# and below, m_start 0 (the column layout's row-0 lane wraps) and at the
# top row MP - 1, the others between m_out / 2 and m_out
TRACEBACK_ROWS = (
    ("random", None, 1.0, "deep"),
    ("V runs", 2 | 8, 0.003, "top"),
    ("H runs", 1 | 4, 0.005, "deep"),
    ("mostly M", 0, 0.1, "deep"),
    ("random", None, 1.0, "j_end 0"),
    ("mostly M", 0, 0.1, "j_end < 0"),
    ("V runs", 2 | 8, 0.003, "m_start 0"),
    ("random", None, 1.0, "top"),
)


def traceback_plane(rows: int, seed: int, col: bool, n: int = 1024, mp: int = 384):
    """A pointer plane of ``rows`` rows whose walks a lane window can miss.

    Row r takes ``TRACEBACK_ROWS[r % 8]``.  ``col``: the column kernel's
    layout, (n/8, rows, mp) words; else the wave kernel's diagonal one,
    ((n + mp)/8, rows, mp).  Returns numpy (ptr int32, j_end (rows,)
    int32, m_start (rows,) int32, m_out = mp - 1).
    """
    rng = np.random.default_rng(seed)
    m_out = mp - 1
    nt = n if col else n + mp  # columns or diagonals
    words = np.zeros((nt // 8, rows, mp), np.uint32)
    j_end = rng.integers(n // 2, n + 1, rows).astype(np.int32)
    m_start = rng.integers(m_out // 2, m_out, rows).astype(np.int32)
    for r in range(rows):
        _, code, noise, start = TRACEBACK_ROWS[r % len(TRACEBACK_ROWS)]
        nib = rng.integers(0, 16, (nt, mp), dtype=np.uint32)
        if code is not None:
            nib = np.where(rng.random((nt, mp)) < noise, nib, np.uint32(code))
        for k in range(8):
            words[:, r, :] |= nib[k::8] << np.uint32(4 * k)
        if start == "top":
            m_start[r] = m_out
        elif start == "m_start 0":
            m_start[r] = 0
        elif start == "j_end 0":
            j_end[r] = 0
        elif start == "j_end < 0":
            j_end[r] = -int(rng.integers(1, 40))
    return words.view(np.int32), j_end, m_start, m_out


# The AlignParams sweep of the reference's tests/test_fuzz_params.py:33-76
# (its corner values a parameter, 14 explicit corners, then seeded draws),
# for the port's tests and chip_smoke.py's phase 3; positive gap "costs"
# (rewards) are legal inputs and must stay kernel-consistent.
SWEEP_GAPS_H = (-16.0, -1.0, -0.25, 0.0, 0.5)
SWEEP_GAPS_V = (-16.0, -4.0, -0.5, 0.0, 1.0)
SWEEP_OFFSETS = (0.0, 4.0, 16.0, 32.0)
SWEEP_DMINS = (0.0, 2.0, 8.0, -4.0)
SWEEP_SHAPE = (8, 256, 20)  # B, N, M of the kernel sweep
SWEEP_SEED = 1005


def sweep_params(rng, n_random: int = 12) -> list:
    """The sweep's AlignParams: the explicit corners, then ``n_random``
    draws from ``rng``, duplicates dropped (order kept)."""
    from .ops.reference import AlignParams

    out = [
        AlignParams(),
        AlignParams(dist_min=8.0),
        AlignParams(dist_min=8.0, dist_offset=0.0),
        AlignParams(dist_min=-4.0),
        AlignParams(gap_open_v=-4.0, gap_extension_v=-16.0),
        AlignParams(gap_open_h=-0.25, gap_extension_h=-16.0),
        AlignParams(gap_open_h=0.5, gap_extension_h=0.5),
        AlignParams(gap_open_v=1.0, gap_extension_v=0.0),
        AlignParams(gap_open_h=0.0, gap_extension_h=0.0),
        AlignParams(gap_open_v=0.0, gap_extension_v=0.0),
        AlignParams(dist_offset=32.0, gap_open_v=-32.0, gap_extension_v=-32.0),
        AlignParams(gap_open_h=-16.0, gap_extension_h=-16.0,
                    gap_open_v=-0.5, gap_extension_v=-0.5),
        AlignParams(dist_offset=0.0),
        AlignParams(gap_open_v=-16.0, gap_extension_v=-0.5),
    ]
    for _ in range(n_random):
        out.append(AlignParams(
            dist_offset=float(rng.choice(SWEEP_OFFSETS)),
            dist_min=float(rng.choice(SWEEP_DMINS)),
            gap_open_h=float(rng.choice(SWEEP_GAPS_H)),
            gap_extension_h=float(rng.choice(SWEEP_GAPS_H)),
            gap_open_v=float(rng.choice(SWEEP_GAPS_V)),
            gap_extension_v=float(rng.choice(SWEEP_GAPS_V)),
        ))
    seen, uniq = set(), []
    for p in out:
        if p not in seen:
            seen.add(p)
            uniq.append(p)
    return uniq


def sweep_reads(rng, B: int, N: int, M: int):
    """One sweep corner's inputs: (B, N) f32 signals, half of them
    carrying a noisy copy of the (M,) template, and lengths in [N/2, N-4)."""
    template = rng.uniform(60, 120, M).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for i in range(B // 2):
        st = int(rng.integers(0, N - 2 * M))
        signals[i, st : st + M] = template + rng.normal(0, 0.5, M).astype(np.float32)
    na = rng.integers(N // 2, N - 4, B).astype(np.int32)
    return signals, na, template


def sweep_cases(seed: int = SWEEP_SEED, shape=SWEEP_SHAPE, n_random: int = 12) -> list:
    """(params, signals, lengths, template) of each sweep corner, drawn as
    the reference's sweep draws them (the params first, then each
    corner's reads from the same generator)."""
    rng = np.random.default_rng(seed)
    return [(p, *sweep_reads(rng, *shape)) for p in sweep_params(rng, n_random)]
