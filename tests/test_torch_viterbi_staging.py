"""Host-side staging of the Viterbi kernels, held to their plain twins.

The kernels of csrc/viterbi_fwd.cu and csrc/viterbi_bwd.cu run only on a
card; what they compute is pinned here in plain tensor code on the CPU:

  * the forward's per-thread gather tables (``fwd_gather_tables``: a
    source lane and a weight per roll slot) with one step written over
    them, bit-equal to ``_transition_plain``; and the kernel's whole
    step loop in that form (rows published before the rescale, a gather
    reading ``(val[u] - m) + w``), bit-equal to ``_fwd_plain``;
  * the emission's quotient by a double reciprocal, bit-equal to the IEEE
    f32 division;
  * the narrow kernel's split of a read over W warps of S states a lane
    at every W the probe sweeps (each chain's cummax from a lane's own
    states, its warp's lanes below and the warps below; the row max from
    the warps' maxima), bit-equal to ``_fwd_plain``, and its row layout
    (``row_word``): a warp's 32 lanes, S states apart, in 32 distinct
    banks;
  * the backward's selection (an order-preserving int key of the f32
    sums, its max converted back and compared ``>=`` in f32, the first
    lane holding a hit and its first hit) and its walk (the register ring of score
    rows, path entries stored 32 at a time), equal to ``_bwd_plain`` on
    rows full of ties, -0.0/+0.0, NEG and padded lanes;
  * the wrapper rules: the forward's slot limits (every repeat HMM the
    tests build fits them; a wider spec takes the dense forward), and the
    card as the default device of the staged HMM.

All comparisons are exact: the same f32 operations in the same order.
"""
import numpy as np
import pytest
import torch

from strique_tpu_torch.convert import padded_hmm_from_jax
from strique_tpu_torch.hmm.models import build_flanked_repeat, build_repeat_mod
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, REPEAT, SUFFIX, write_mod_model,
                                        write_pore_model)

# the port's CPU test files run torch on one thread (six pytest workers
# share the machine's cores)
torch.set_num_threads(1)

NEG = np.float32(TVC.NEG)


@pytest.fixture(scope="module")
def pm(tmp_path_factory):
    return PoreModel(write_pore_model(str(tmp_path_factory.mktemp("model") / "m.model"), seed=3))


def _hmm(pm, flank):
    chm = build_flanked_repeat(REPEAT, PREFIX[-flank:], SUFFIX[:flank], pm)
    return chm, TVC.PaddedHMM(chm, "cpu")


def _tables(ph):
    src, w, ramp, counts = TVC.fwd_gather_tables(ph.fspec, ph.fweights.numpy(), ph.sp)
    return torch.from_numpy(src).long(), torch.from_numpy(w), torch.from_numpy(ramp), counts


def _transition_tables(tables, st):
    """One factored step over the gather tables as a kernel thread
    computes it from its registers: every slot, live or not (an empty
    slot's weight is -inf), for every lane at once."""
    src, w, ramp, _ = tables
    gather = lambda row, k: row[:, src[k]] + w[k]  # noqa: E731
    out = torch.full_like(st, float(NEG))
    for d in range(TVC.FWD_MAX_DIAG):
        out = torch.maximum(out, gather(st, d))
    for c in range(TVC.FWD_MAX_CHAIN):
        base = TVC.FWD_MAX_DIAG + c * TVC.FWD_CHAIN_SLOTS
        inj = torch.full_like(st, float(NEG))
        for e in range(TVC.FWD_MAX_ENTRY):
            inj = torch.maximum(inj, gather(st, base + e))
        h = torch.cummax(inj - ramp[c], dim=1).values + ramp[c]
        for e in range(TVC.FWD_MAX_EXIT):
            out = torch.maximum(out, gather(h, base + TVC.FWD_MAX_ENTRY + e))
    return out


def _tie_rows(rng, shape):
    """Score-like f32 rows drawn from a few values: ties everywhere,
    -0.0 beside +0.0, NEG."""
    vals = np.array([0.0, -0.0, -1.0, -2.5, NEG], np.float32)
    return vals[rng.integers(0, len(vals), shape)]


# every flanked-repeat HMM shape the tests build (repeat, prefix, suffix,
# config): the bench flanks cut to 25 and 50 bases (SP 128 and 256),
# test_factor's short repeat, test_hmm's homopolymer flanks, the
# reference's fmr1 repeat, the configs of test_fuzz_params and
# test_torch_copies, and a one-base repeat between 100-base flanks
REPEAT_HMMS = [
    (REPEAT, PREFIX[-25:], SUFFIX[:25], None),
    (REPEAT, PREFIX[-50:], SUFFIX[:50], None),
    (REPEAT, PREFIX, SUFFIX, None),
    ("CGG", PREFIX[:16], SUFFIX[:16], None),
    ("GCG", PREFIX[-30:], SUFFIX[:30], None),
    (REPEAT, "A" * 50, "C" * 49 + "T", None),
    ("CGG", "A" * 50, "T" * 50, None),
    (REPEAT, "CCAGGATGCCGCCTCCTCACTCACC", "TAGCGCGACTCCTGAGTTCCAGAGC", None),
    (REPEAT, PREFIX[-30:], SUFFIX[:30], {"pomegranate_compat": True}),
    (REPEAT, PREFIX[-30:], SUFFIX[:30], {"e1_ratio": 0.0, "skip": 0.9}),
    (REPEAT, PREFIX[-30:], SUFFIX[:30], {"leave_repeat": 1e-5, "match_loop": 0.5,
                                          "match_match": 0.3, "match_insert": 0.15,
                                          "match_delete": 0.05}),
    ("A", PREFIX[-100:], SUFFIX[:100], None),
]


@pytest.mark.parametrize("case", range(len(REPEAT_HMMS)))
def test_gather_tables_step_matches_transition_plain(pm, case):
    """Each repeat HMM factors into a spec that fits the forward kernel's
    slots (so it decodes on the factored kernel), and one step over its
    gather tables equals the plain transition on noisy and tie-heavy
    rows."""
    repeat, prefix, suffix, config = REPEAT_HMMS[case]
    chm = build_flanked_repeat(repeat, prefix, suffix, pm, config)
    assert chm.factored is not None
    ph = TVC.PaddedHMM(chm, "cpu")
    assert ph.fspec is not None and TVC.fwd_spec_fits(ph.fspec)
    rng = np.random.default_rng(100 + case)
    st = np.concatenate([rng.normal(-30, 20, (6, ph.sp)).astype(np.float32),
                         _tie_rows(rng, (6, ph.sp))])
    st = torch.from_numpy(st)
    want = TVC._transition_plain(ph.fspec, list(ph.fweights), st)
    assert torch.equal(_transition_tables(_tables(ph), st), want)


@pytest.mark.parametrize("flank,sp", [(25, 128), (50, 256)])
def test_kernel_form_forward_matches_plain(pm, flank, sp):
    """The forward as the kernel runs it: each step publishes val (not
    st), every warp takes the row max, and a gather reads (val[u] - m) +
    w, every slot applied."""
    _, ph = _hmm(pm, flank)
    assert ph.sp == sp
    src, w, ramp, _ = _tables(ph)
    rng = np.random.default_rng(7 + sp)
    T = 200
    lens = np.array([1, 2, 33, 32, 65, 200], np.int32)
    obs = np.zeros((len(lens), T), np.float32)
    for i, n in enumerate(lens):
        x = pm.generate_signal(PREFIX[-flank:] + REPEAT * 3 + SUFFIX[:flank], samples=8,
                               noise=True, rng=rng).astype(np.float32)[:n]
        obs[i, : len(x)] = x
    obs[3, :] = 100.0  # constant obs: ties in every row
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)

    B = len(lens)
    tact = n.long()
    sc = torch.zeros((T, B, sp))
    fin = torch.zeros((B, sp))
    acc = torch.zeros(B)
    val = m = None
    for t in range(T):
        z = (o[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            new = ph.start + emit
        else:
            gather = lambda k: (val[:, src[k]] - m) + w[k]  # noqa: E731
            out = torch.full((B, sp), float(NEG))
            for d in range(TVC.FWD_MAX_DIAG):
                out = torch.maximum(out, gather(d))
            for c in range(TVC.FWD_MAX_CHAIN):
                base = TVC.FWD_MAX_DIAG + c * TVC.FWD_CHAIN_SLOTS
                inj = torch.full((B, sp), float(NEG))
                for e in range(TVC.FWD_MAX_ENTRY):
                    inj = torch.maximum(inj, gather(base + e))
                h = torch.cummax(inj - ramp[c], dim=1).values + ramp[c]
                for e in range(TVC.FWD_MAX_EXIT):
                    k = base + TVC.FWD_MAX_ENTRY + e
                    out = torch.maximum(out, h[:, src[k]] + w[k])
            new = out + emit
        live = (t < tact)[:, None]
        val = torch.where(live, new, val) if t else new  # a read stops at its length
        m = val.max(dim=1, keepdim=True).values
        stn = val - m
        acc = acc + torch.where(live[:, 0], m[:, 0], 0.0)
        fin = torch.where((tact - 1 == t)[:, None], stn, fin)
        sc[t] = stn
    rows = torch.arange(T)[:, None] < n[None, :]
    assert torch.equal(sc[rows], sc_p[rows])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)


def row_word(u, s):
    """Twin of csrc/viterbi_fwd.cu ``row_word<S>``: state u's word in a
    row of the narrow kernel at S states a lane."""
    return u ^ ((u >> 5) & (s - 1))


@pytest.mark.parametrize("sp", [128, 256, 384, 1024])
def test_row_word_puts_a_warp_in_distinct_banks(sp):
    """At S = 1, 2, 4 (and 8 where 32 S divides SP): row_word permutes each
    32-word block, keeps a lane's S states in its aligned group of S
    words, and puts a warp's 32 lanes, S states apart from any first
    state (a gather's u = (v - o) mod SP, wrapping past SP), in 32
    distinct banks."""
    u = np.arange(sp)
    lanes = np.arange(32)
    for s in (1, 2, 4, 8):
        if sp % (32 * s):
            continue
        words = row_word(u, s)
        assert (np.sort(words.reshape(-1, 32), axis=1) == u.reshape(-1, 32)).all()
        assert (words // s == u // s).all()
        banks = row_word((u[:, None] + s * lanes[None, :]) % sp, s) % 32
        assert (np.sort(banks, axis=1) == lanes).all()


def test_quotient_by_double_reciprocal_is_ieee_division():
    """csrc/viterbi_fwd.cu ``quotient``: a / b in f32 as the product of a
    and b's double reciprocal, rounded to f32, is the IEEE f32 quotient
    bit for bit: over random bit patterns (subnormals, infinities and
    NaNs among them), the emission's domain, and integer operands whose
    quotients come closest to a midpoint of two floats."""
    rng = np.random.default_rng(17)
    n = 400_000
    def bits():
        return rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)

    cases = [(bits(), bits()),
             (rng.uniform(-200, 200, n).astype(np.float32),
              rng.uniform(0.5, 5, n).astype(np.float32)),
             (rng.integers(1, 2**24, n).astype(np.float32),
              (rng.integers(2**23, 2**24, n) | 1).astype(np.float32))]
    with np.errstate(all="ignore"):
        for a, b in cases:
            want = a / b
            got = (a.astype(np.float64) * (1.0 / b.astype(np.float64))).astype(np.float32)
            same = (want.view(np.uint32) == got.view(np.uint32)) | (np.isnan(want) & np.isnan(got))
            assert same.all()


def _narrow_emulation(obs, t_actual, ph, warps):
    """csrc/viterbi_fwd.cu ``viterbi_fwd_kernel<NV, L, W>`` in plain ops:
    lane l of the read's 32 W holds states l S ... l S + S - 1.  A chain's
    h = max(the lane's inclusive cummax, its warp's lanes below, the warps
    below) + ramp; m from the warps' maxima; a gather reads (val[u] - m) +
    w from the published row."""
    B, T = obs.shape
    sp = ph.sp
    nt = 32 * warps
    s = sp // nt
    src, w, ramp, _ = _tables(ph)
    lay = ph.fwd_layout
    tact = t_actual.long()
    sc = torch.zeros((T, B, sp))
    fin = torch.zeros((B, sp))
    acc = torch.zeros(B)
    ninf = lambda *shape: torch.full(shape, -np.inf)  # noqa: E731
    val = m = None
    for t in range(int(tact.max())):
        z = (obs[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            new = ph.start + emit
        else:
            st = val - m  # the same f32 ops a gather does
            gather = lambda k: st[:, src[k]] + w[k]  # noqa: E731
            out = torch.full((B, sp), float(NEG))
            for d in range(lay.diag):
                out = torch.maximum(out, gather(d))
            for c in range(lay.chain):
                base = lay.diag + c * TVC.FWD_CHAIN_SLOTS
                inj = torch.full((B, sp), float(NEG))
                for e in range(TVC.FWD_MAX_ENTRY):
                    inj = torch.maximum(inj, gather(base + e))
                p = torch.cummax((inj - ramp[c]).view(B, nt, s), dim=2).values
                tot = p[:, :, -1].reshape(B, warps, 32)
                below_lane = torch.cat([ninf(B, warps, 1), tot[:, :, :-1]], 2).cummax(2).values
                wtot = torch.maximum(below_lane[:, :, -1], tot[:, :, -1])
                below_warp = torch.cat([ninf(B, 1), wtot[:, :-1]], 1).cummax(1).values
                cy = torch.maximum(below_lane, below_warp[:, :, None]).reshape(B, nt, 1)
                h = torch.maximum(p, cy).reshape(B, sp) + ramp[c]
                for e in range(TVC.FWD_MAX_EXIT):
                    k = base + TVC.FWD_MAX_ENTRY + e
                    out = torch.maximum(out, h[:, src[k]] + w[k])
            new = out + emit
        live = (t < tact)[:, None]
        val = torch.where(live, new, val) if t else new  # a read stops at its length
        m = val.view(B, warps, 32 * s).amax(dim=2).amax(dim=1, keepdim=True)
        stn = val - m
        acc = acc + torch.where(live[:, 0], m[:, 0], 0.0)
        fin = torch.where((tact - 1 == t)[:, None], stn, fin)
        sc[t] = stn
    return sc, fin, acc


# the narrow kernel's split cases: (HMM, SP); W at every S the probe sweeps
NARROW_SPLITS = [(kind, sp, 4 * sp // 128 // s) for kind, sp in
                 (("repeat", 128), ("repeat", 256), ("mod", 128), ("mod", 256))
                 for s in (1, 2, 4, 8) if (4 * sp // 128) % s == 0]


@pytest.mark.parametrize("kind,sp,warps", NARROW_SPLITS)
def test_narrow_split_matches_plain(pm, tmp_path_factory, kind, sp, warps):
    """The narrow kernel's step on W warps of S states a lane, emulated,
    is bit-equal to ``_fwd_plain`` in both slot layouts (repeat HMMs of
    25- and 50-base flanks, chained; mod HMMs of GGCCCC and a 60-base
    unit, diagonal-only) at lengths 1, 2, around the obs chunks and
    full, and on constant obs (ties in every row)."""
    rng = np.random.default_rng(31 + sp + warps)
    if kind == "repeat":
        flank = 25 if sp == 128 else 50
        unit = REPEAT
        _, ph = _hmm(pm, flank)
        seq = PREFIX[-flank:] + REPEAT * 3 + SUFFIX[:flank]
    else:
        twin = PoreModel(write_mod_model(str(tmp_path_factory.mktemp("mod") / "t.model"),
                                         seed=MOD_MODEL_SEED))
        unit = REPEAT if sp == 128 else "".join(rng.choice(list("ACGT"), 60))
        ph = TVC.PaddedHMM(build_repeat_mod(unit, pm, twin), "cpu")
        seq = unit * (200 // len(unit) + 2)
    assert ph.sp == sp and ph.fwd_layout.code == (kind == "mod")
    T = 100
    lens = np.array([1, 2, 31, 33, 64, 100], np.int32)
    obs = np.zeros((len(lens), T), np.float32)
    for i, n in enumerate(lens):
        x = pm.generate_signal(seq, samples=8, noise=True, rng=rng).astype(np.float32)[:n]
        obs[i, : len(x)] = x
    obs[4, :] = 100.0
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    sc, fin, acc = _narrow_emulation(o, n, ph, warps)
    rows = torch.arange(T)[:, None] < n[None, :]
    assert torch.equal(sc[rows], sc_p[rows])
    assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p)


def order_key(x):
    """Twin of the kernels' order_key: f32 -> int32 in the float order."""
    i = np.asarray(x, np.float32).view(np.int32)
    return np.where(i >= 0, i, i ^ np.int32(0x7FFFFFFF)).astype(np.int32)


def key_value(k):
    """Twin of key_value: the inverse of order_key."""
    k = np.asarray(k, np.int32)
    return np.where(k >= 0, k, k ^ np.int32(0x7FFFFFFF)).astype(np.int32).view(np.float32)


def warp_first_max(cand):
    """The backward kernel's selection over one (SP,) f32 row: lane l
    holds u = PER l + j (PER = SP / 32); each lane's max, the warp max by
    the key, each lane's first u with cand >= max, and the first lane
    holding one (the ballot) with its first hit."""
    sp = cand.size
    lanes = cand.reshape(32, sp // 32)
    mx = key_value(order_key(lanes.max(axis=1)).max())
    hit = lanes >= mx
    owner = int(np.flatnonzero(hit.any(axis=1))[0])
    return owner * (sp // 32) + int(np.flatnonzero(hit[owner])[0])


def kernel_walk(sc, last, tact, transT):
    """viterbi_bwd.cu's walk: the shared ring of BWD_RING score rows
    (step i refills the slot step i-1 read with the row of step
    i-1+RING, and never a row at or past t_actual - 1), the keyed
    selection, path entries held one a lane and stored 32 at a time;
    every path entry must be written exactly once."""
    T, B, sp = sc.shape
    D = TVC.BWD_RING
    path = np.full((B, T), -1, np.int64)
    for b in range(B):
        ta = min(int(tact[b]), T)
        n = max(ta - 1, 0)
        st = int(last[b])
        path[b, n:] = st
        ring = [(r, sc[r, b]) if r >= 0 else None for r in (n - 1 - j for j in range(D))]
        held = np.zeros(32, np.int64)
        for i in range(n):
            if i > 0 and n - i - D >= 0:
                ring[(i - 1) % D] = (n - i - D, sc[n - i - D, b])
            r = n - 1 - i
            assert ring[i % D][0] == r
            st = warp_first_max(ring[i % D][1] + transT[st])
            held[i & 31] = st
            if (i & 31) == 31:
                pos = n - 1 - (i - 31) - np.arange(32)
                assert (path[b, pos] == -1).all()
                path[b, pos] = held
        rem = n & 31
        assert (path[b, rem - 1 - np.arange(rem)] == -1).all()
        path[b, rem - 1 - np.arange(rem)] = held[:rem]
    assert (path >= 0).all()
    return path


def test_order_key_twin_orders_floats():
    x = np.array([NEG, -2.5, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1.0, 3e38], np.float32)
    k = order_key(x)
    assert (np.diff(k[:4]) > 0).all() and (np.diff(k[5:]) > 0).all()
    assert k[4] == -1 and k[5] == 0  # -0.0 just below +0.0: both compare equal as f32
    np.testing.assert_array_equal(key_value(k).view(np.int32), x.view(np.int32))


@pytest.mark.parametrize("sp,n_states", [(128, 116), (256, 216)])
def test_keyed_walk_matches_bwd_plain(sp, n_states):
    """Tie-heavy rows (0.0, -0.0, -1, -2.5, NEG) and NEG-padded lanes,
    at lengths 1, 2, below and at the ring depth, 33, 64 and full."""
    rng = np.random.default_rng(sp)
    T = 100
    tact = np.array([1, 2, 5, 16, 17, 33, 64, 100], np.int32)
    sc = _tie_rows(rng, (T, len(tact), sp))
    trans = np.full((sp, sp), NEG, np.float32)
    trans[:n_states, :n_states] = _tie_rows(rng, (n_states, n_states))
    transT = np.ascontiguousarray(trans.T)
    last = rng.integers(0, n_states, len(tact)).astype(np.int32)
    want = TVC._bwd_plain(torch.from_numpy(sc), torch.from_numpy(last), torch.from_numpy(tact),
                          torch.from_numpy(transT))
    got = kernel_walk(sc, last, tact, transT)
    np.testing.assert_array_equal(got, want.numpy())


def _spec_weights(ph):
    return ph.fspec, ph.fweights.numpy(), ph.sp


def test_forward_slot_limits(pm, monkeypatch):
    """A spec at the slot limits stages; one diagonal, chain, entry or
    exit more raises in the staging, and PaddedHMM declines such a form:
    its decodes take the dense forward, as under STRIQUE_DENSE_VITERBI=1."""
    _, ph = _hmm(pm, 25)
    sp = ph.sp
    full = (tuple(range(TVC.FWD_MAX_DIAG)),
            ((tuple(range(TVC.FWD_MAX_ENTRY)), tuple(range(TVC.FWD_MAX_EXIT))),) * 2)
    src, w, _, _ = TVC.fwd_gather_tables(*_spec_weights(ph))
    # the c9orf72-like spec leaves slots empty: lane v, weight -inf
    empty = ~np.isfinite(w)
    assert empty.any() and (w[empty] == -np.inf).all()
    assert (src[empty.all(axis=1)] == np.arange(sp)).all()

    def weights(spec):
        n = len(spec[0]) + sum(len(a) + 1 + len(x) for a, x in spec[1])
        return [np.full(sp, -1.0, np.float32)] * n

    src, w, ramp, counts = TVC.fwd_gather_tables(full, weights(full), sp)
    assert src.shape == w.shape == (TVC.FWD_SLOTS, sp) and ramp.shape == (2, sp)
    np.testing.assert_array_equal(counts, [TVC.FWD_MAX_DIAG, 2] + [TVC.FWD_MAX_ENTRY,
                                                                   TVC.FWD_MAX_EXIT] * 2)
    assert np.isfinite(w).all()
    chains = full[1]
    over = [(full[0] + (9,), chains),
            (full[0], chains + chains[:1]),
            (full[0], ((chains[0][0] + (9,), chains[0][1]), chains[1])),
            (full[0], (chains[0], (chains[1][0], chains[1][1] + (9,))))]
    for spec in over:
        assert not TVC.fwd_spec_fits(spec)
        with pytest.raises(ValueError, match="exceeds the forward kernel's slots"):
            TVC.fwd_gather_tables(spec, weights(spec), sp)

    # ph widened past the diagonal slots by diagonals of weight NEG (the
    # same transitions): declined, decoded by the dense forward
    diag_offs, chain_spec = ph.fspec
    n_d = len(diag_offs)
    extra = TVC.FWD_MAX_DIAG + 1 - n_d
    fw = list(ph.fweights.numpy())
    spec = (tuple(diag_offs) + tuple(range(20, 20 + extra)), chain_spec)
    arrays = [x.numpy() for x in (ph.trans, ph.start, ph.end, ph.mu, ph.sigma, ph.uni, ph.luni)]
    wide = TVC.PaddedHMM.from_arrays(ph.n_states, *arrays, spec,
                                     fw[:n_d] + [np.full(sp, NEG)] * extra + fw[n_d:],
                                     device="cpu")
    assert wide.fspec is None and wide.fweights is None
    monkeypatch.setenv("STRIQUE_DENSE_VITERBI", "1")
    dense = TVC.PaddedHMM(_hmm(pm, 25)[0], "cpu")
    assert dense.fspec is None
    rng = np.random.default_rng(9)
    x = pm.generate_signal(PREFIX[-25:] + REPEAT * 3 + SUFFIX[:25], samples=8, noise=True,
                           rng=rng).astype(np.float32)
    obs = torch.from_numpy(np.stack([x, x[::-1].copy()]))
    n = torch.tensor([len(x), len(x) - 7], dtype=torch.int32)
    for got, want in zip(TVC.viterbi_batch(obs, n, wide), TVC.viterbi_batch(obs, n, dense)):
        assert torch.equal(got, want)


def test_staged_hmm_defaults_to_the_card(pm):
    """PaddedHMM and padded_hmm_from_jax stage on the card by default and
    raise without one, as RepeatCounter does."""
    chm, ph = _hmm(pm, 25)
    duck = type("RefPadded", (), {})()
    for k in ("n_states", "fspec"):
        setattr(duck, k, getattr(ph, k))
    for k in ("trans", "start", "end", "mu", "sigma", "uni", "luni"):
        setattr(duck, k, getattr(ph, k).numpy())
    duck.fweights = tuple(ph.fweights.numpy())
    if torch.cuda.is_available():
        assert TVC.PaddedHMM(chm).trans.device.type == "cuda"
        assert padded_hmm_from_jax(duck).trans.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            TVC.PaddedHMM(chm)
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            padded_hmm_from_jax(duck)
    cpu = padded_hmm_from_jax(duck, "cpu")
    assert torch.equal(cpu.fweights, ph.fweights) and cpu.trans.device.type == "cpu"
