"""The counting HMM: state graph, compiler and the flanked-repeat model.

A frozen copy of STRique's HMM construction as the package states it:
the state graphs of the reference's pomegranate models -- ``profileHMM``
(reference scripts/STRique.py:201-307), ``repeatHMM`` (:313-378),
``flankedRepeatHMM`` (:384-441) and the methylation caller
``repeatModHMM`` (:447-490) -- as plain data, compiled to a dense
log-transition matrix over the emitting states by eliminating the silent
states exactly under max-product (which keeps the optimal emitting path
and its log-probability).  NumPy only.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

NEG_INF = -np.inf


@dataclass
class State:
    name: str
    kind: str  # 'normal' | 'uniform' | 'silent'
    p0: float = 0.0  # mu or lo
    p1: float = 0.0  # sigma or hi


@dataclass
class CompiledHMM:
    """Dense emitting-states-only HMM ready for the Viterbi kernel."""

    names: list
    log_start: np.ndarray  # (S,)
    log_trans: np.ndarray  # (S, S)
    log_end: np.ndarray  # (S,)
    mu: np.ndarray  # (S,)
    sigma: np.ndarray  # (S,)
    is_uniform: np.ndarray  # (S,) bool
    log_uni: np.ndarray  # (S,)
    meta: dict = field(default_factory=dict)

    @property
    def n_states(self) -> int:
        return len(self.names)

    def emission_logp(self, x: np.ndarray) -> np.ndarray:
        """(T,) observations -> (T, S) emission log-probs (float64 host path)."""
        x = np.asarray(x, dtype=np.float64)[:, None]
        norm = -0.5 * np.log(2 * np.pi * self.sigma**2) - 0.5 * ((x - self.mu) / self.sigma) ** 2
        return np.where(self.is_uniform, self.log_uni, norm)


class HmmGraph:
    """Mutable HMM graph with a dedicated start and end node."""

    def __init__(self):
        self.states: list[State] = []
        self.edges: list[tuple[int, int, float]] = []
        self.start = self.add_silent("__start__")
        self.end = self.add_silent("__end__")

    # -- construction ------------------------------------------------------
    def add_normal(self, name: str, mu: float, sigma: float) -> int:
        self.states.append(State(name, "normal", float(mu), float(sigma)))
        return len(self.states) - 1

    def add_uniform(self, name: str, lo: float, hi: float) -> int:
        self.states.append(State(name, "uniform", float(lo), float(hi)))
        return len(self.states) - 1

    def add_silent(self, name: str) -> int:
        self.states.append(State(name, "silent"))
        return len(self.states) - 1

    def add_edge(self, u: int, v: int, p: float) -> None:
        self.edges.append((u, v, float(p)))

    # -- compilation -------------------------------------------------------
    def prepare(self):
        """Normalized edge weights + graph orderings of :meth:`compile`.

        Returns (logw, adj, silent, silent_set, topo, emitting, e_pos):
        normalized log edge weights, adjacency, silent states (list/set),
        their topological order, and the name-sorted emitting order.
        """
        n = len(self.states)
        # out-edge normalization (pomegranate bake normalizes each state's
        # outgoing transition probabilities to sum to 1)
        out_sum = np.zeros(n)
        for u, v, p in self.edges:
            out_sum[u] += p
        logw: dict[tuple[int, int], float] = {}
        for u, v, p in self.edges:
            w = np.log(p / out_sum[u]) if p > 0 else NEG_INF
            key = (u, v)
            # parallel edges: keep max (should not occur in these models)
            logw[key] = max(logw.get(key, NEG_INF), w)

        silent = [i for i, s in enumerate(self.states) if s.kind == "silent" and i not in (self.start, self.end)]
        emitting = [i for i, s in enumerate(self.states) if s.kind != "silent"]
        # deterministic emitting order: sort by state name (the reference's
        # zero-padded state names make this the positional order, mirroring
        # pomegranate's name-sorted state table)
        emitting.sort(key=lambda i: self.states[i].name)
        e_pos = {s: k for k, s in enumerate(emitting)}

        # adjacency
        adj: dict[int, list[tuple[int, float]]] = {}
        for (u, v), w in logw.items():
            if w == NEG_INF:
                continue
            adj.setdefault(u, []).append((v, w))

        # topological order of the silent-only subgraph
        silent_set = set(silent)
        indeg = {s: 0 for s in silent}
        for (u, v), w in logw.items():
            if u in silent_set and v in silent_set and w != NEG_INF:
                indeg[v] += 1
        from collections import deque

        dq = deque([s for s in silent if indeg[s] == 0])
        topo = []
        while dq:
            s = dq.popleft()
            topo.append(s)
            for v, w in adj.get(s, []):
                if v in silent_set:
                    indeg[v] -= 1
                    if indeg[v] == 0:
                        dq.append(v)
        if len(topo) != len(silent):
            raise ValueError("silent-state subgraph contains a cycle")
        return logw, adj, silent, silent_set, topo, emitting, e_pos

    def compile(self, meta: dict | None = None) -> CompiledHMM:
        logw, adj, silent, silent_set, topo, emitting, e_pos = self.prepare()
        S = len(emitting)

        log_trans = np.full((S, S), NEG_INF)
        log_start = np.full(S, NEG_INF)
        log_end = np.full(S, NEG_INF)

        def closure_from(src: int):
            """Max-product reach of emitting states / end from ``src``."""
            best = {s: NEG_INF for s in silent}
            direct_e = np.full(S, NEG_INF)
            direct_end = NEG_INF
            for v, w in adj.get(src, []):
                if v in silent_set:
                    best[v] = max(best[v], w)
                elif v == self.end:
                    direct_end = max(direct_end, w)
                elif v != self.start:
                    direct_e[e_pos[v]] = max(direct_e[e_pos[v]], w)
            for s in topo:
                if best[s] == NEG_INF:
                    continue
                for v, w in adj.get(s, []):
                    if v in silent_set:
                        best[v] = max(best[v], best[s] + w)
                    elif v == self.end:
                        direct_end = max(direct_end, best[s] + w)
                    elif v != self.start:
                        k = e_pos[v]
                        direct_e[k] = max(direct_e[k], best[s] + w)
            return direct_e, direct_end

        row, end_w = closure_from(self.start)
        log_start = row
        # start->silent->end contributes nothing for non-empty observations
        for u in emitting:
            row, end_w = closure_from(u)
            log_trans[e_pos[u], :] = row
            log_end[e_pos[u]] = end_w

        mu = np.zeros(S)
        sigma = np.ones(S)
        is_uniform = np.zeros(S, dtype=bool)
        log_uni = np.zeros(S)
        names = []
        for i in emitting:
            st = self.states[i]
            k = e_pos[i]
            names.append(st.name)
            if st.kind == "normal":
                mu[k], sigma[k] = st.p0, st.p1
            else:
                is_uniform[k] = True
                log_uni[k] = -np.log(st.p1 - st.p0)
                mu[k], sigma[k] = 0.5 * (st.p0 + st.p1), 1.0
        chm = CompiledHMM(
            names=names,
            log_start=log_start,
            log_trans=log_trans,
            log_end=log_end,
            mu=mu,
            sigma=sigma,
            is_uniform=is_uniform,
            log_uni=log_uni,
            meta=dict(meta or {}),
        )
        return chm


PROFILE_DEFAULTS = {
    # reference scripts/STRique.py:214-227
    "match_loop": 0.75,
    "match_match": 0.15,
    "match_insert": 0.09,
    "match_delete": 0.01,
    "insert_loop": 0.15,
    "insert_match_0": 0.40,
    "insert_match_1": 0.40,
    "insert_delete": 0.05,
    "delete_delete": 0.005,
    "delete_insert": 0.05,
    "delete_match": 0.945,
}

REPEAT_DEFAULTS = {"skip": 0.999, "leave_repeat": 0.002}  # reference :318-320

FLANKED_DEFAULTS = {
    # reference :389-394
    "skip": 1 - 1e-4,
    "seq_std_scale": 1.0,
    "rep_std_scale": 1.0,
    "seq_std_offset": 0.0,
    "rep_std_offset": 0.0,
    "e1_ratio": 0.1,
}

MOD_DEFAULTS = {"rep_std_scale": 1.5, "rep_std_offset": 0.0, "leave_repeat": 0.002}  # reference :450-452

def _merged(defaults: dict, config: dict | None) -> dict:
    tp = dict(defaults)
    if config:
        for k, v in config.items():
            tp[k] = v
    return tp


@dataclass
class Ports:
    """Entry/exit silent ports of a sub-model (s1/s2/e1/e2 of the reference)."""

    s1: int
    s2: int
    e1: int
    e2: int


def build_profile(g: HmmGraph, sequence: str, pm, transition_probs: dict | None = None,
                  state_prefix: str = "", no_silent: bool = False,
                  std_scale: float = 1.0, std_offset: float = 0.0) -> Ports:
    """Linear profile HMM over ``sequence`` (reference STRique.py:232-300)."""
    tp = _merged(PROFILE_DEFAULTS, transition_probs)
    k = pm.kmer
    n = len(sequence) - k + 1
    if n < 1:
        raise ValueError("sequence shorter than pore-model k-mer")
    digits = int(np.ceil(np.log10(n)))
    match, insert, delete = [], [], []
    for idx in range(n):
        kmer = sequence[idx : idx + k]
        mean, std = pm.model_dict[kmer]
        name = state_prefix + str(idx).rjust(digits, "0")
        match.append(g.add_normal(name + "m", mean, std * std_scale + std_offset))
        if not no_silent:
            delete.append(g.add_silent(name + "d"))
        insert.append(g.add_uniform(name + "i", pm.model_min, pm.model_max))
    s1 = g.add_silent(state_prefix + "s1")
    s2 = g.add_silent(state_prefix + "s2")
    e1 = g.add_silent(state_prefix + "e1")
    e2 = g.add_silent(state_prefix + "e2")
    # matches (reference :264-267)
    for i in range(n):
        g.add_edge(match[i], match[i], tp["match_loop"])
        if i < n - 1:
            g.add_edge(match[i], match[i + 1], tp["match_match"])
    # insertions (reference :269-276)
    for i in range(n):
        g.add_edge(insert[i], insert[i], tp["insert_loop"])
        g.add_edge(match[i], insert[i], tp["match_insert"])
        g.add_edge(insert[i], match[i], tp["insert_match_1"])
        if i < len(delete) - 1 and not no_silent:
            g.add_edge(insert[i], delete[i + 1], tp["insert_delete"])
        if i < n - 1:
            g.add_edge(insert[i], match[i + 1], tp["insert_match_0"])
    # deletions (reference :278-290) / no-silent skips (reference :291-296)
    if not no_silent:
        for i in range(n):
            g.add_edge(delete[i], insert[i], tp["delete_insert"])
            if i > 0:
                g.add_edge(match[i - 1], delete[i], tp["match_delete"])
            if i < n - 1:
                g.add_edge(delete[i], match[i + 1], tp["delete_match"])
            if i < n - 1:
                g.add_edge(delete[i], delete[i + 1], tp["delete_delete"])
        g.add_edge(s1, delete[0], 1)
        g.add_edge(s2, match[0], 1)
        g.add_edge(delete[-1], e1, tp["delete_delete"])
        g.add_edge(delete[-1], e2, tp["delete_match"])
    else:
        for i in range(n):
            if i < n - 2:
                g.add_edge(match[i], match[i + 2], tp["match_delete"])
        g.add_edge(s1, insert[0], 1)
        g.add_edge(s2, match[0], 1)
    # exits (reference :297-300)
    g.add_edge(insert[-1], e1, tp["insert_delete"])
    g.add_edge(insert[-1], e2, tp["insert_match_0"])
    g.add_edge(match[-1], e2, tp["match_match"])
    g.add_edge(match[-1], e1, tp["match_delete"])
    return Ports(s1, s2, e1, e2)


def _extend_repeat(repeat: str, k: int) -> tuple[str, int]:
    """Wrap-around extension of the repeat unit (reference STRique.py:329-335).

    Returns (extended sequence, repeat_offset correction).
    """
    if len(repeat) >= k:
        return repeat + repeat[: k - 1], 0
    ext = k - 1 + (len(repeat) - 1) - ((k - 1) % len(repeat))
    seq = repeat + ("".join([repeat] * k))[:ext]
    return seq, int(len(seq) / len(repeat)) - 1


def build_repeat(g: HmmGraph, repeat: str, pm, transition_probs: dict | None = None,
                 state_prefix: str = "", std_scale: float = 1.0, std_offset: float = 0.0):
    """Cyclic repeat-counting HMM (reference STRique.py:328-354).

    Returns (Ports, d1_name, d2_name, repeat_offset); d1/d2 are the
    emitting dummy states whose Viterbi visits count repeat units.
    """
    tp = _merged(REPEAT_DEFAULTS, transition_probs)
    seq, repeat_offset = _extend_repeat(repeat, pm.kmer)
    inner = build_profile(g, seq, pm, transition_probs=tp, state_prefix=state_prefix,
                          no_silent=True, std_scale=std_scale, std_offset=std_offset)
    d1 = g.add_uniform(state_prefix + "dummy1", pm.model_min, pm.model_max)
    d2 = g.add_uniform(state_prefix + "dummy2", pm.model_min, pm.model_max)
    e1 = g.add_silent(state_prefix + "e1#loop")
    e2 = g.add_silent(state_prefix + "e2#loop")
    g.add_edge(inner.e1, d1, 1)
    g.add_edge(inner.e2, d2, 1)
    g.add_edge(d1, e1, tp["leave_repeat"])
    g.add_edge(d2, e2, tp["leave_repeat"])
    g.add_edge(d1, inner.s1, 1 - tp["leave_repeat"])
    g.add_edge(d2, inner.s2, 1 - tp["leave_repeat"])
    ports = Ports(inner.s1, inner.s2, e1, e2)
    return ports, state_prefix + "dummy1", state_prefix + "dummy2", repeat_offset


def build_flanked_repeat(repeat: str, prefix: str, suffix: str, pm,
                         config: dict | None = None) -> CompiledHMM:
    """Full detection HMM: prefix profile -> repeat loop -> suffix profile
    (reference STRique.py:408-431)."""
    tp = _merged(FLANKED_DEFAULTS, config)
    k = pm.kmer
    reps = int(np.ceil(k / len(repeat)))
    prefix_seq = prefix + ("".join([repeat] * reps))[:-1]
    suffix_seq = "".join([repeat] * reps) + suffix
    flanking_count = reps * 2 - 1
    g = HmmGraph()
    p_ports = build_profile(g, prefix_seq, pm, tp, state_prefix="prefix",
                            std_scale=tp["seq_std_scale"], std_offset=tp["seq_std_offset"])
    s_ports = build_profile(g, suffix_seq, pm, tp, state_prefix="suffix",
                            std_scale=tp["seq_std_scale"], std_offset=tp["seq_std_offset"])
    r_ports, d1, d2, repeat_offset = build_repeat(g, repeat, pm, tp, state_prefix="repeat",
                                                  std_scale=tp["rep_std_scale"], std_offset=tp["rep_std_offset"])
    g.add_edge(g.start, p_ports.s1, tp["e1_ratio"])
    g.add_edge(g.start, p_ports.s2, 1 - tp["e1_ratio"])
    g.add_edge(p_ports.e1, r_ports.s1, 1)
    g.add_edge(p_ports.e2, r_ports.s2, 1)
    g.add_edge(r_ports.e1, s_ports.s1, 1)
    g.add_edge(r_ports.e2, s_ports.s2, 1)
    g.add_edge(s_ports.e1, g.end, 1)
    g.add_edge(s_ports.e2, g.end, 1)
    chm = g.compile(meta={"kind": "flanked_repeat", "repeat": repeat,
                          "flanking_count": flanking_count, "repeat_offset": repeat_offset})
    names = chm.names
    chm.meta["count_states"] = np.array([n in (d1, d2) for n in names], dtype=bool)
    chm.meta["repeat_states"] = np.array(["repeat" in n for n in names], dtype=bool)
    if tp.get("pomegranate_compat"):
        # Empirically derived pomegranate-0.10 bake artifact: the baked
        # reference model awards each dummy-state (d1/d2) visit exactly
        # ln(10) more log-probability than the literal source graph
        # (reference STRique.py:339-354).  On the reference's published
        # golden read this one round constant explains 1685.9 of the
        # 1690.0 log-unit gap (99.76%; neighboring values are 8-90x
        # worse fits) and moves the count from 733 to 734 of 735 — the
        # residual has the same provenance as the +-0.8% alignment-score
        # deltas (2019-era scipy/skimage preprocessing).  Opt-in via HMM
        # config {"pomegranate_compat": true}; see PARITY.md.
        chm.log_uni = np.where(chm.meta["count_states"],
                               chm.log_uni + np.log(10.0), chm.log_uni)
    return chm


def build_repeat_mod(repeat: str, pm_base, pm_mod, config: dict | None = None) -> CompiledHMM:
    """The methylation HMM of a repeat unit (reference STRique.py:447-490):
    two no-silent profiles of the unit, on the base and on the mod model
    (its stdvs scaled by ``scale2stdv``), entered from the uniform anchor
    ``s0`` and left to the anchor ``e0``, which loops back to ``s0`` once a
    unit.  Meta ``anchor_states`` (s0, e0) and ``mod_states`` (the mod
    profile's) name what ``viterbi.mod_pattern`` reads; ``model_min`` and
    ``model_max`` are the two models' joint range."""
    tp = _merged(MOD_DEFAULTS, config)
    seq, _ = _extend_repeat(repeat, pm_base.kmer)
    model_min = min(pm_base.model_min, pm_mod.model_min)
    model_max = max(pm_base.model_max, pm_mod.model_max)
    g = HmmGraph()
    s0 = g.add_uniform("s0", model_min, model_max)
    e0 = g.add_uniform("e0", model_min, model_max)
    base = build_profile(g, seq, pm_base, tp, state_prefix="base", no_silent=True,
                         std_scale=tp["rep_std_scale"], std_offset=tp["rep_std_offset"])
    mod = build_profile(g, seq, pm_mod, tp, state_prefix="mod", no_silent=True,
                        std_scale=tp["rep_std_scale"] * pm_mod.scale2stdv(pm_base),
                        std_offset=tp["rep_std_offset"])
    g.add_edge(g.start, s0, 1)
    for port in (base.s1, base.s2, mod.s1, mod.s2):
        g.add_edge(s0, port, 0.25)
    for port in (base.e1, base.e2, mod.e1, mod.e2):
        g.add_edge(port, e0, 1)
    g.add_edge(e0, g.end, tp["leave_repeat"])
    g.add_edge(e0, s0, 1 - tp["leave_repeat"])
    chm = g.compile(meta={"kind": "repeat_mod", "repeat": repeat,
                          "model_min": model_min, "model_max": model_max})
    chm.meta["anchor_states"] = np.array([n in ("s0", "e0") for n in chm.names], dtype=bool)
    chm.meta["mod_states"] = np.array([n.startswith("mod") for n in chm.names], dtype=bool)
    if tp.get("pomegranate_compat"):
        # the same bake artifact as the counting HMM's dummies (above), on
        # the uniform anchors
        chm.log_uni = np.where(chm.meta["anchor_states"],
                               chm.log_uni + np.log(10.0), chm.log_uni)
    return chm
