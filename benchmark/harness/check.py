"""The comparison that decides ``correct``.

The rows the window wrote are read back from the TSV.  Five numbers,
each with a limit from the cell's file (``check``):

  * ``missing``: reads fed that got no row (an answer that never came);
  * ``replay_mismatch``: rows that differ from the first row written
    for the same pool read (every replay of a read is the same input);
  * ``int_mismatch``: rows of the sampled reads whose count, offset,
    ticks or mod differ from the plain reference's;
  * ``score_err``: the largest relative gap of score_prefix or
    score_suffix to the reference's, over the sampled reads' rows
    (infinite where one side is NaN or infinite and the other is not);
  * ``logp_err``: the same for log_p.

The sample is drawn from the seed among the pool reads the window
wrote, with the longest of them in it.
"""
from __future__ import annotations

import math

import numpy as np

NUMBERS = ("missing", "replay_mismatch", "int_mismatch", "score_err", "logp_err")


def read_rows(path: str) -> list:
    """(pool index, (count, score_prefix, score_suffix, log_p, offset,
    ticks, mod)) for each row of a count TSV."""
    out = []
    with open(path) as fp:
        for line in fp:
            if line.startswith("ID\t") or not line.strip():
                continue
            c = line.rstrip("\n").split("\t")
            k = int(c[0][1:].split(".", 1)[0])
            out.append((k, (int(c[3]), float(c[4]), float(c[5]), float(c[6]), int(c[7]),
                            int(c[8]), c[9])))
    return out


def sample(written: set, pool, seed: int, k: int) -> list:
    """Up to k pool indices among ``written``: the longest read, then a
    seeded draw of the rest."""
    if not written:
        return []
    cand = sorted(written)
    longest = max(cand, key=lambda i: len(pool[i][2]))
    rest = [i for i in cand if i != longest]
    rng = np.random.default_rng([seed, 3])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[int(i)] for i in pick)


def _rel(a: float, b: float) -> float:
    """The relative gap of ``a`` to ``b``; infinite where either is not
    finite and the two differ (a NaN differs from everything)."""
    if a == b:
        return 0.0
    if not (math.isfinite(a) and math.isfinite(b)):
        return math.inf
    return abs(a - b) / max(abs(b), 1e-30)


def compare(rows, fed, ref: dict) -> dict:
    """The five numbers: ``rows`` as :func:`read_rows` gives them, ``fed``
    the pool index of every read fed, ``ref`` pool index -> the
    reference's row."""
    first: dict = {}
    replay = 0
    for k, r in rows:
        if first.setdefault(k, r) != r:
            replay += 1
    ints = 0
    score = logp = 0.0
    for k, r in rows:
        if k not in ref:
            continue
        e = ref[k]
        if (r[0], r[4], r[5], r[6]) != (e[0], e[4], e[5], e[6]):
            ints += 1
        score = max(score, _rel(r[1], e[1]), _rel(r[2], e[2]))
        logp = max(logp, _rel(r[3], e[3]))
    return {"missing": max(len(fed) - len(rows), 0), "replay_mismatch": replay,
            "int_mismatch": ints, "score_err": score, "logp_err": logp}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[n] <= limits[n] for n in NUMBERS)
