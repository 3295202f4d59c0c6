"""Compile-time structure factorization of silent-eliminated HMMs.

The port's own copy of ``strique_tpu/hmm/factor.py`` (NumPy only);
tests/test_torch_copies.py pins the factor spec equal.

The dense log-transition matrix produced by silent-state elimination
(:mod:`strique_tpu_torch.hmm.graph`) is S x S but low-structure: direct edges
between emitting states form a handful of constant-offset diagonals in
the name-sorted lane order, and the closure mass routed through silent
delete chains is a max-plus *staircase* — for any entry into the chain
and any later exit out of it, the weight decomposes into

    entry_weight + (C(exit) - C(entry)) + exit_weight

with C the cumulative chain cost.  One Viterbi step against this form
costs O(S log S) — a few lane-shifted adds plus one prefix-max per
chain — instead of the dense O(S^2) broadcast-add + max-reduce, and
every op is a row op.

``factorize`` is mechanical: it infers chains from the silent
subgraph's shape, computes entry/exit taps by max-plus closure over the
remaining "free" silent states, groups all edges by lane offset, and
then *verifies* the factored semantics against the dense matrix by
basis-vector simulation in float64.  Any structural surprise declines
(returns ``None``), so correctness never depends on the inference
being right (the port's Viterbi then raises: the dense forward is not
ported yet).

Reference note: pomegranate's baked graph (reference
scripts/STRique.py:431) keeps silent states and propagates them per
Viterbi step; round 1's dense elimination removed the runtime
propagation at the cost of O(S^2) mass per step; this module removes
that cost too, without reintroducing data-dependent silent hops.

Runtime semantics (shared by the f64 verifier and the forward kernel
csrc/viterbi_fwd.cu; ``apply_factored`` below is the reference):

    out[v] = max( max_d  (score + diag_w_d)[v - d],
                  max_chain max_x (h_chain + exit_w_x)[v - x] )
    where per chain:
      inj[l] = max_e (score + entry_w_e)[l - e]
      h      = cummax(inj - ramp) + ramp          # prefix-max over lanes
"""
from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass, field

import numpy as np

NEG_INF = -np.inf

MIN_CHAIN = 4   # shorter silent runs are handled as free-closure edges
MAX_ROLLS = 28  # total lane-shift ops allowed before declining
VERIFY_ATOL = 1e-9
VERIFY_RTOL = 1e-9


class _Decline(Exception):
    """Raised internally when the graph does not fit the factored form."""


@dataclass
class Chain:
    """One silent delete-chain flow, fully lane-mapped.

    entries: list of (offset, w) — w indexed by *source* lane; the
      injection row is ``inj[l] = max_e (score + w_e)[l - e]``.
    ramp: (S,) cumulative chain cost, valid at slot lanes (step function
      elsewhere; non-slot lanes never carry finite injections).
    exits: list of (offset, w) — w indexed by *slot* lane; contributions
      are ``(h + w_x)[v - x]``.
    slots: (n_taps,) int lanes, strictly increasing (diagnostic).
    """

    entries: list
    ramp: np.ndarray
    exits: list
    slots: np.ndarray


@dataclass
class FactoredHMM:
    """Structure-factored form of a CompiledHMM's log_trans."""

    n_states: int
    diags: list  # [(offset, (S,) f64 w indexed by source lane)]
    chains: list  # [Chain]
    stats: dict = field(default_factory=dict)

    @property
    def n_rolls(self) -> int:
        return len(self.diags) + sum(len(c.entries) + len(c.exits) for c in self.chains)


def _np_shift(x: np.ndarray, o: int, fill: float) -> np.ndarray:
    """Shift along the last axis by o lanes (non-circular), filling with ``fill``."""
    if o == 0:
        return x
    out = np.full_like(x, fill)
    if o > 0:
        out[..., o:] = x[..., :-o]
    else:
        out[..., :o] = x[..., -o:]
    return out


def apply_factored(F: FactoredHMM, score: np.ndarray) -> np.ndarray:
    """Float64 reference evaluation of one max-plus transition step.

    score: (..., S) previous scores; returns (..., S) pre-emission
    scores ``out[v] = max_u score[u] + log_trans[u, v]`` under the
    factored semantics.  This is the contract the device kernels
    replicate (in f32, with -inf replaced by a finite sentinel).
    """
    out = np.full_like(score, NEG_INF)
    for o, w in F.diags:
        out = np.maximum(out, _np_shift(score + w, o, NEG_INF))
    for ch in F.chains:
        inj = np.full_like(score, NEG_INF)
        for o, w in ch.entries:
            inj = np.maximum(inj, _np_shift(score + w, o, NEG_INF))
        h = np.maximum.accumulate(inj - ch.ramp, axis=-1) + ch.ramp
        for o, w in ch.exits:
            out = np.maximum(out, _np_shift(h + w, o, NEG_INF))
    return out


def factorize(graph, chm) -> FactoredHMM | None:
    """Factor ``chm.log_trans`` into diagonals + chain flows, or ``None``.

    Mechanical and self-verifying: the returned object's
    ``apply_factored`` semantics reproduce the dense matrix to float64
    round-off (checked entry-by-entry before returning).
    """
    try:
        return _factorize(graph, chm)
    except _Decline:
        return None


def _factorize(graph, chm) -> FactoredHMM:
    logw, adj, silent, silent_set, topo, emitting, e_pos = graph.prepare()
    S = len(emitting)
    start, end = graph.start, graph.end

    # ---- graph relations ---------------------------------------------------
    sil_succ: dict[int, list] = {s: [] for s in silent}
    sil_pred: dict[int, list] = {s: [] for s in silent}
    emit_in: dict[int, list] = {s: [] for s in silent}   # (src lane, w)
    emit_out: dict[int, list] = {s: [] for s in silent}  # (dest lane, w)
    diag_edges: dict[int, dict[int, float]] = defaultdict(dict)  # offset -> {src lane: w}

    def _add_edge(store: dict, off: int, lane: int, w: float) -> None:
        cur = store[off].get(lane, NEG_INF)
        store[off][lane] = max(cur, w)

    for (u, v), w in logw.items():
        if w == NEG_INF:
            continue
        u_sil, v_sil = u in silent_set, v in silent_set
        if u_sil and v_sil:
            sil_succ[u].append((v, w))
            sil_pred[v].append((u, w))
        elif u_sil:
            if v != end and v != start:
                emit_out[u].append((e_pos[v], w))
        elif v_sil:
            if u != start and u != end:
                emit_in[v].append((e_pos[u], w))
        elif u != start and u != end and v != start and v != end:
            _add_edge(diag_edges, e_pos[v] - e_pos[u], e_pos[u], w)

    # ---- chain inference: maximal unique-pred/unique-succ silent runs ------
    nxt = {}
    for s in silent:
        if len(sil_succ[s]) == 1:
            t, _ = sil_succ[s][0]
            if len(sil_pred[t]) == 1:
                nxt[s] = t
    is_linked_target = {nxt[s] for s in nxt}
    runs = []
    for s in topo:
        if s in is_linked_target:
            continue
        run = [s]
        while run[-1] in nxt:
            run.append(nxt[run[-1]])
        if len(run) > 1:
            runs.append(run)
    chain_runs = [r for r in runs if len(r) >= MIN_CHAIN]
    chain_nodes = {n for r in chain_runs for n in r}
    free = [s for s in topo if s not in chain_nodes]  # topo-ordered
    free_set = set(free)

    # ---- closures through free silents -------------------------------------
    # from_emit[s][u-lane]: best weight of an emitting->...->s path whose
    # silent intermediates are all free.  Chain nodes absorb (no propagation
    # through them — their onward mass is the chain's own).
    from_emit = {s: np.full(S, NEG_INF) for s in silent}
    for s in topo:
        vec = from_emit[s]
        for lane, w in emit_in[s]:
            vec[lane] = max(vec[lane], w)
        for p, w in sil_pred[s]:
            if p in free_set:
                np.maximum(vec, from_emit[p] + w, out=vec)
    # to_emit[f][v-lane]: best weight of an f->...->emitting path through
    # free silents only (defined for free nodes; used for chain exits and
    # free-only closure).
    to_emit = {s: np.full(S, NEG_INF) for s in silent}
    for s in reversed(topo):
        vec = to_emit[s]
        for lane, w in emit_out[s]:
            vec[lane] = max(vec[lane], w)
        for t, w in sil_succ[s]:
            if t in free_set:
                np.maximum(vec, to_emit[t] + w, out=vec)

    # chain mass must never re-enter a chain: any free node fed (directly or
    # transitively) by a chain node with a chain-node successor breaks the
    # single-chain-per-path assumption.
    fed_by_chain = {s: False for s in silent}
    for s in topo:
        if s in free_set:
            fed = any(p in chain_nodes or (p in free_set and fed_by_chain[p])
                      for p, _ in sil_pred[s])
            fed_by_chain[s] = fed
            if fed and any(t in chain_nodes for t, _ in sil_succ[s]):
                raise _Decline("chain-to-chain mass through free silents")
    for r in chain_runs:
        for t, _ in sil_succ[r[-1]]:
            if t in chain_nodes:
                raise _Decline("direct chain-to-chain edge")

    # free-only closure: extra emitting->emitting edges routed through free
    # silents exclusively; grouped into the diagonal store.
    for f in free:
        src = from_emit[f]
        if not emit_out[f]:
            continue
        fin = np.nonzero(src > NEG_INF)[0]
        for dest, w in emit_out[f]:
            for lane in fin:
                _add_edge(diag_edges, dest - int(lane), int(lane), float(src[lane] + w))

    # ---- chain assembly -----------------------------------------------------
    chains = []
    for run in chain_runs:
        k = len(run)
        cum = np.zeros(k)
        for i in range(1, k):
            w_edge = next((w for t, w in sil_succ[run[i - 1]] if t == run[i]), None)
            if w_edge is None:
                raise _Decline("broken chain linkage")
            cum[i] = cum[i - 1] + w_edge
        # exits per node: direct emitting outs + free-silent-routed outs
        node_exits = []
        for i, c in enumerate(run):
            outs: dict[int, float] = {}
            for dest, w in emit_out[c]:
                outs[dest] = max(outs.get(dest, NEG_INF), w)
            for t, w in sil_succ[c]:
                if t in free_set:
                    reach = to_emit[t]
                    for dest in np.nonzero(reach > NEG_INF)[0]:
                        dest = int(dest)
                        outs[dest] = max(outs.get(dest, NEG_INF), w + float(reach[dest]))
            node_exits.append(outs)
        tap_idx = [i for i in range(k) if node_exits[i]]
        if not tap_idx:
            continue  # chain only reaches __end__: log_end already has it
        # shift each entry forward to the next exit-bearing node
        tap_entries: dict[int, dict[int, float]] = {i: {} for i in tap_idx}
        for i, c in enumerate(run):
            vec = from_emit[c]
            fin = np.nonzero(vec > NEG_INF)[0]
            if fin.size == 0:
                continue
            j = next((e for e in tap_idx if e >= i), None)
            if j is None:
                continue  # enters after the last exit: only reaches __end__
            adj_w = cum[j] - cum[i]
            dst = tap_entries[j]
            for lane in fin:
                lane = int(lane)
                dst[lane] = max(dst.get(lane, NEG_INF), float(vec[lane] + adj_w))
        # slot per tap node: the smallest exit destination lane
        slots = np.array([min(node_exits[i]) for i in tap_idx], dtype=np.int64)
        if not np.all(np.diff(slots) > 0):
            raise _Decline("chain slots not strictly increasing")
        ramp = np.zeros(S)
        prev = cum[tap_idx[0]]
        pos = 0
        for i, sl in zip(tap_idx, slots):
            ramp[pos:sl] = prev
            prev = cum[i]
            pos = sl
        ramp[pos:] = prev
        entry_rolls: dict[int, dict[int, float]] = defaultdict(dict)
        exit_rolls: dict[int, dict[int, float]] = defaultdict(dict)
        for i, sl in zip(tap_idx, slots):
            sl = int(sl)
            for lane, w in tap_entries[i].items():
                _add_edge(entry_rolls, sl - lane, lane, w)
            for dest, w in node_exits[i].items():
                _add_edge(exit_rolls, dest - sl, sl, w)
        chains.append(Chain(
            entries=_rolls_to_arrays(entry_rolls, S),
            ramp=ramp,
            exits=_rolls_to_arrays(exit_rolls, S),
            slots=slots,
        ))

    diags = _rolls_to_arrays(diag_edges, S)
    F = FactoredHMM(n_states=S, diags=diags, chains=chains)
    if F.n_rolls > MAX_ROLLS:
        raise _Decline(f"{F.n_rolls} rolls exceeds cap {MAX_ROLLS}")

    # ---- verification: basis-vector simulation vs the dense matrix ---------
    basis = np.full((S, S), NEG_INF)
    np.fill_diagonal(basis, 0.0)
    recon = apply_factored(F, basis)  # recon[u, v] == log_trans[u, v]
    dense = chm.log_trans
    fin_r, fin_d = np.isfinite(recon), np.isfinite(dense)
    if not np.array_equal(fin_r, fin_d):
        raise _Decline("factored sparsity pattern mismatch")
    if fin_d.any():
        a, b = recon[fin_d], dense[fin_d]
        err = np.abs(a - b) / np.maximum(1.0, np.abs(b))
        if float(err.max(initial=0.0)) > max(VERIFY_ATOL, VERIFY_RTOL):
            raise _Decline(f"factored values diverge (max rel err {err.max():.3e})")
        max_err = float(err.max(initial=0.0))
    else:
        max_err = 0.0
    dense_cells = int(fin_d.sum())
    F.stats = {
        "n_diags": len(diags),
        "n_chains": len(chains),
        "n_rolls": F.n_rolls,
        "dense_finite": dense_cells,
        "chain_covered": dense_cells - int(sum((np.isfinite(w)).sum() for _, w in diags)),
        "max_rel_err": max_err,
    }
    return F


def _rolls_to_arrays(rolls: dict[int, dict[int, float]], S: int) -> list:
    out = []
    for off in sorted(rolls):
        w = np.full(S, NEG_INF)
        for lane, val in rolls[off].items():
            dest = lane + off
            if not (0 <= dest < S):
                raise _Decline("edge destination outside the lane range")
            w[lane] = val
        out.append((off, w))
    return out
