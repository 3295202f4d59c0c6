"""strique_tpu_torch's Viterbi decode past 1024 padded states vs the JAX
reference, on the CPU.

The card's narrow kernels stop at SP 1024; past it row 3's cluster
form (``csrc/viterbi_fwd.cu`` ``viterbi_fwd_cluster_kernel``) and row
4's wide variant (``csrc/viterbi_bwd.cu`` ``viterbi_bwd_wide_kernel``)
take SP up to ``viterbi_cuda.MAX_SP`` = 8192 and give their plain
twins' bits (the
``gpu`` tests and ``chip_smoke.py`` hold that on the card).  Here:

* the plain twins at SP 1152 and 2048 (``synthetic.VITERBI_WIDE``'s
  flanked and mod HMMs: both slot layouts) against
  ``strique_tpu.ops.viterbi_pallas`` in Pallas interpret mode, at T 256;
* ``add_target`` refusing an HMM past ``MAX_SP`` on the card before
  any launch (with the card's presence faked, since the CPU tests run
  without one; and the check's function directly), while the CPU
  takes it;
* the forward's cluster form (``viterbi_fwd_cluster_kernel``: C CTAs a
  read, each chain scanned within a CTA and joined through the CTAs'
  totals, m from the warp maxima) in plain ops, bit-equal to the plain
  twin at SP 1152, 1792 and 2048 in both layouts at the C its rule
  picks and at the fewest and most CTAs the kernel takes, and to the
  reference at SP 1152; and the rule ``fwd_cluster_ctas``.

The 150-base-unit target's counts through the port's counter against
the JAX counter are in tests/test_torch_wide_counter.py.

Tolerances, as tests/test_torch_viterbi.py states them (ROADMAP Queue
3): paths exact; acc and log_p 1e-5 relative (the port's emission
constant is float64 rounded to f32, the reference's XLA's f32 log: an
ulp apart on some sigmas); score rows and the final row 2e-3 absolute
plus 1e-6 relative.  That ulp moves a row entry by a few ulp of its
magnitude: up to ~1e3 at the narrow widths, but ~1.3e4 at SP 2048,
where 14 of 1.86M live entries part by up to 4 ulp (0.0039).
"""
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.hmm.models import build_flanked_repeat as jax_build_flanked_repeat
from strique_tpu.hmm.models import build_repeat_mod as jax_build_repeat_mod
from strique_tpu.ops.viterbi_pallas import PaddedHMM as JaxPaddedHMM
from strique_tpu.ops.viterbi_pallas import (viterbi_backward_batch, viterbi_forward_pallas_factored,
                                            viterbi_pallas_batch)
from strique_tpu.pore_model import PoreModel as JaxPoreModel
from strique_tpu_torch import _build
from strique_tpu_torch.convert import padded_hmm_from_jax
from strique_tpu_torch.detect import counter as counter_mod
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.ops import viterbi_cuda as TVC
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (MOD_MODEL_SEED, PREFIX, REPEAT, SUFFIX, VITERBI_WIDE,
                                        random_unit, viterbi_wide_case, write_mod_model,
                                        write_pore_model)

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

T = 256
CASES = {"flanked 150": (1152, "viterbi_forward_factored"),
         "flanked 300": (2048, "viterbi_forward_factored"),
         "mod 260": (1152, "viterbi_forward_factored_diag"),
         "mod 500": (2048, "viterbi_forward_factored_diag")}


# the cluster form's cases: label of synthetic.VITERBI_WIDE -> (SP, layout)
SPLIT_CASES = {"flanked 150": (1152, "viterbi_forward_factored"),
               "flanked 260": (1792, "viterbi_forward_factored"),
               "flanked 300": (2048, "viterbi_forward_factored"),
               "mod 260": (1152, "viterbi_forward_factored_diag"),
               "mod 430": (1792, "viterbi_forward_factored_diag"),
               "mod 500": (2048, "viterbi_forward_factored_diag")}


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("models")
    return (write_pore_model(str(d / "base.model"), seed=MOD_MODEL_SEED),
            write_mod_model(str(d / "twin.model"), seed=MOD_MODEL_SEED))


@pytest.mark.parametrize("case", list(CASES))
def test_wide_twins_match_jax_interpret(models, case):
    """The plain forward's rows, final row and acc, the backward's paths
    on the reference's rows, and viterbi_batch's paths and log_p against
    the reference's Pallas kernels at SP past 1024."""
    base, twin = models
    pm, pm_mod = PoreModel(base), PoreModel(twin)
    chm, obs, lens = viterbi_wide_case(pm, pm_mod, case, np.random.default_rng(30 + len(case)))
    obs, lens = np.ascontiguousarray(obs[:, :T]), np.minimum(lens, T)
    kind, bases, _lens, _constant = VITERBI_WIDE[case]
    jpm = JaxPoreModel(base)
    unit = random_unit(bases, bases)
    jchm = (jax_build_flanked_repeat(unit, PREFIX[-50:], SUFFIX[:50], jpm) if kind == "flanked"
            else jax_build_repeat_mod(unit, jpm, JaxPoreModel(twin)))
    assert jchm.n_states == chm.n_states
    jph = JaxPaddedHMM(jchm)
    ph = padded_hmm_from_jax(jph, "cpu")
    sp, layout = CASES[case]
    assert ph.sp == jph.sp == sp and ph.fwd_layout.name == layout
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)

    jsc, jfin, jacc = viterbi_forward_pallas_factored(
        jnp.asarray(obs), jnp.asarray(lens), jph.start, jph.mu, jph.sigma, jph.uni, jph.luni,
        jph.fspec, *jph.fweights)
    jsc, jfin, jacc = np.asarray(jsc), np.asarray(jfin), np.asarray(jacc)[:, 0]
    sc, fin, acc = TVC.viterbi_forward_factored(o, n, ph)
    live = np.arange(T)[:, None] < lens[None, :]
    np.testing.assert_allclose(sc.numpy()[live], jsc[live], rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), jfin, rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(acc.numpy(), jacc, rtol=1e-5)
    last = np.argmax(jfin + np.asarray(jph.end), axis=1).astype(np.int32)
    jpath = np.asarray(viterbi_backward_batch(jnp.asarray(jsc), jnp.asarray(last),
                                              jnp.asarray(lens), int(lens.max()), jph.transT,
                                              time_major=True))
    path = TVC.viterbi_backward_batch(torch.from_numpy(np.array(jsc)), torch.from_numpy(last),
                                      n, ph.transT)
    np.testing.assert_array_equal(path.numpy(), jpath)

    jl, jp = viterbi_pallas_batch(jnp.asarray(obs), jnp.asarray(lens), jph)
    tl, tp = TVC.viterbi_batch(o, n, ph)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5)


def test_check_card_sp_limit():
    """Up to MAX_SP padded states the card takes an HMM; past it only the
    CPU does, and the refusal names the limit and the reference's own
    chip reach (its backward's (SP, SP) block in VMEM)."""
    assert TVC.padded_sp(1) == 128 and TVC.padded_sp(1080) == 1152
    assert TVC.padded_sp(TVC.MAX_SP) == TVC.MAX_SP == 8192
    TVC.check_card_sp(TVC.MAX_SP, "cuda")
    TVC.check_card_sp(TVC.MAX_SP + 1, "cpu")
    with pytest.raises(ValueError, match="8192 padded states.*VMEM.*device='cpu'"):
        TVC.check_card_sp(TVC.MAX_SP + 1, torch.device("cuda"))
    assert TVC.NARROW_MAX_SP == 1024


class _WideHMM:
    """A stand-in for a compiled repeat HMM of ``n_states`` (its dense
    build past 8192 states takes ~25 s and ~5 GB)."""

    def __init__(self, n_states):
        self.n_states = n_states


@pytest.mark.parametrize("device, refused", [("cuda", True), ("cpu", False)])
def test_add_target_refuses_past_max_sp_on_the_card(models, monkeypatch, device, refused):
    """On the card ``add_target`` refuses a repeat HMM past MAX_SP as soon
    as its first strand's HMM is built: no launch, no second build, no
    target.  The CPU counter keeps it."""
    base, _twin = models
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    built = []

    def build(unit, *a, **k):
        built.append(unit)
        return _WideHMM(TVC.MAX_SP + 1)

    monkeypatch.setattr(counter_mod, "build_flanked_repeat", build)
    c = RepeatCounter(base, device=device)
    before = dict(_build.LAUNCHES)
    if refused:
        with pytest.raises(ValueError, match="8192 padded states"):
            c.add_target("wide", REPEAT, PREFIX, SUFFIX)
        assert built == [REPEAT] and "wide" not in c.targets
    else:
        c.add_target("wide", REPEAT, PREFIX, SUFFIX)
        assert len(built) == 2 and "wide" in c.targets
    assert dict(_build.LAUNCHES) == before


def _fwd_cluster_emulation(obs, t_actual, ph, ctas):
    """The cluster form's step (csrc/viterbi_fwd.cu
    ``viterbi_fwd_cluster_kernel``) in plain ops: C CTAs of VC =
    ``fwd_cluster_lanes`` lanes, the last one's lanes past SP dead.
    Every lane gathers its diagonals and chain entries from the whole
    previous row through the staged slot tables (``fwd_gather_tables``);
    a chain's xs = inj - ramp is cummaxed within each CTA (lp), a CTA's
    total is lp at its top live lane, and an exit reads max(lp[u], the
    totals of the CTAs below u's) + ramp[u] plus its weight; m is the max
    of the 32-lane warp maxima, and the next step reads val[u] - m."""
    B, T = obs.shape
    sp = ph.sp
    vc = TVC.fwd_cluster_lanes(sp, ctas)
    assert vc <= 1024 and vc * (ctas - 1) < sp
    src, w, ramp, counts = TVC.fwd_gather_tables(ph.fspec, ph.fweights.numpy(), sp)
    src, w, ramp = torch.from_numpy(src).long(), torch.from_numpy(w), torch.from_numpy(ramp)
    layout = ph.fwd_layout
    cta = torch.arange(sp) // vc
    tops = [min(k * vc + vc - 1, sp - 1) for k in range(ctas)]
    tact = t_actual.to(torch.int64).clamp_max(T)
    sc = torch.zeros((T, B, sp))
    fin = torch.zeros((B, sp))
    acc = torch.zeros((B,))
    val = m = None
    for t in range(int(tact.max())):
        z = (obs[:, t : t + 1] - ph.mu) / ph.sigma
        emit = torch.where(ph.uni != 0, ph.luni, ph.lsig - 0.5 * z * z)
        if t == 0:
            val = ph.start + emit
        else:
            prev = val

            def gather(slot, prev=prev, m=m):
                return (prev[:, src[slot]] - m[:, None]) + w[slot]

            out = torch.full((B, sp), TVC.NEG)
            for d in range(layout.diag):
                out = torch.maximum(out, gather(d))
            for c in range(layout.chain if int(counts[1]) else 0):
                base = layout.diag + c * TVC.FWD_CHAIN_SLOTS
                inj = torch.full((B, sp), TVC.NEG)
                for e in range(TVC.FWD_MAX_ENTRY):
                    inj = torch.maximum(inj, gather(base + e))
                xs = inj - ramp[c]
                lp = torch.cat([torch.cummax(xs[:, k * vc : (k + 1) * vc], dim=1).values
                                for k in range(ctas)], dim=1)
                tot = lp[:, tops]
                below = torch.cat([torch.full((B, 1), -torch.inf),
                                   torch.cummax(tot, dim=1).values[:, :-1]], dim=1)
                for e in range(TVC.FWD_MAX_EXIT):
                    slot = base + TVC.FWD_MAX_ENTRY + e
                    u = src[slot]
                    cm = torch.maximum(lp[:, u], below[:, cta[u]])
                    out = torch.maximum(out, (cm + ramp[c][u]) + w[slot])
            val = out + emit
        m = val.reshape(B, sp // 32, 32).amax(dim=2).amax(dim=1)
        st = val - m[:, None]
        sc[t] = st
        acc = acc + torch.where(t < tact, m, 0.0)
        fin = torch.where((tact - 1 == t)[:, None], st, fin)
    return sc, fin, acc


def _split_inputs(models, case):
    base, twin = models
    chm, obs, lens = viterbi_wide_case(PoreModel(base), PoreModel(twin), case,
                                       np.random.default_rng(50 + len(case)))
    obs, lens = np.ascontiguousarray(obs[:, :T]), np.minimum(lens, T)
    return chm, obs, lens


@pytest.mark.parametrize("case", list(SPLIT_CASES))
def test_cluster_split_matches_plain(models, case):
    """The emulated cluster step is bit-equal to ``_fwd_plain`` in every
    row below each read's length, fin and acc, at the CTAs
    ``fwd_cluster_ctas`` picks for 64 reads, at 2 and at the most the
    kernel takes (every CTA holding a live lane, at most 8: the rule's
    pick for 8 reads)."""
    chm, obs, lens = _split_inputs(models, case)
    ph = TVC.PaddedHMM(chm, "cpu")
    sp, layout = SPLIT_CASES[case]
    assert ph.sp == sp and ph.fwd_layout.name == layout
    o, n = torch.from_numpy(obs), torch.from_numpy(lens)
    sc_p, fin_p, acc_p = TVC._fwd_plain(o, n, ph)
    live = torch.arange(T)[:, None] < n[None, :]
    most = max(c for c in range(2, TVC.FWD_MAX_CLUSTER + 1)
               if TVC.fwd_cluster_lanes(sp, c) * (c - 1) < sp)
    for ctas in sorted({TVC.fwd_cluster_ctas(sp, 64), 2, most}):
        sc, fin, acc = _fwd_cluster_emulation(o, n, ph, ctas)
        assert torch.equal(sc[live], sc_p[live]), ctas
        assert torch.equal(fin, fin_p) and torch.equal(acc, acc_p), ctas


def test_cluster_split_matches_jax_interpret(models):
    """At SP 1152 (the 150-base unit's repeat HMM, chained) the emulated
    cluster step at the rule's CTAs against the reference's
    ``viterbi_forward_pallas_factored`` in interpret mode, to the
    tolerance of test_wide_twins_match_jax_interpret."""
    base, _twin = models
    chm, obs, lens = _split_inputs(models, "flanked 150")
    jchm = jax_build_flanked_repeat(random_unit(150, 150), PREFIX[-50:], SUFFIX[:50],
                                    JaxPoreModel(base))
    jph = JaxPaddedHMM(jchm)
    ph = padded_hmm_from_jax(jph, "cpu")
    assert ph.sp == 1152 and jchm.n_states == chm.n_states
    jsc, jfin, jacc = viterbi_forward_pallas_factored(
        jnp.asarray(obs), jnp.asarray(lens), jph.start, jph.mu, jph.sigma, jph.uni, jph.luni,
        jph.fspec, *jph.fweights)
    sc, fin, acc = _fwd_cluster_emulation(torch.from_numpy(obs), torch.from_numpy(lens), ph,
                                          TVC.fwd_cluster_ctas(ph.sp, len(lens)))
    live = np.arange(T)[:, None] < lens[None, :]
    np.testing.assert_allclose(sc.numpy()[live], np.asarray(jsc)[live], rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(fin.numpy(), np.asarray(jfin), rtol=1e-6, atol=2e-3)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc)[:, 0], rtol=1e-5)


def test_fwd_warps_rule():
    """The narrow forward's warps a read, at every SP / 128 from 1 to 8 in
    both layouts: W divides SP / 32, its S = SP / (32 W) states a lane is
    a power of two within the register cap the instances were built for
    (``FWD_MAX_STATES``: S = 8 spilled), and at SP 128 and 256 W is
    tools/probe_viterbi_narrow.py's fastest on an H100 at 64 reads (4
    warps in both layouts: one state a lane at SP 128, two at SP 256)."""
    for layout in (0, 1):
        for sp in range(TVC.LANE, TVC.NARROW_MAX_SP + 1, TVC.LANE):
            w = TVC.fwd_warps(sp, layout)
            s = sp // (32 * w)
            assert (sp // 32) % w == 0 and s * 32 * w == sp
            assert s & (s - 1) == 0 and 1 <= s <= TVC.FWD_MAX_STATES
    assert [TVC.fwd_warps(sp, layout) for layout in (0, 1) for sp in (128, 256)] == [4] * 4
    assert [TVC.fwd_warps(sp, 0) for sp in (384, 512, 1024)] == [3, 4, 8]


def test_fwd_states_table_matches_kernel():
    """``FWD_STATES`` is the kernel's own table (csrc/viterbi_fwd.cu
    FWD_STATES), so the rule names the W the library's instances run."""
    src = open(os.path.join(os.path.dirname(TVC.__file__), "..", "csrc", "viterbi_fwd.cu")).read()
    body = re.search(r"constexpr int FWD_STATES\[2\]\[8\] = \{(.*?)\};", src, re.S).group(1)
    rows = [tuple(int(v) for v in r.split(",")) for r in re.findall(r"\{([^{}]*)\}", body)]
    assert rows == [TVC.FWD_STATES[0], TVC.FWD_STATES[1]]


def test_fwd_cluster_ctas_rule():
    """The cluster form's CTAs a read: the most, up to 8, whose clusters
    all run at once with one CTA an SM (the H100's counts where no card
    is asked: 8 at phase 4f's 8 reads, then 6, 4, 3 and 2 at 16, 24, 32
    and 48-64 reads of SP 1152, the picks tools/probe_viterbi_wide.py
    measured within 9% of the fastest C), each CTA of at most 1024 lanes
    with a live one; where no count fits, the fewest that hold the lanes
    (4 at 64 reads of SP 4096, 8 at SP 8192)."""
    for sp in range(TVC.NARROW_MAX_SP + TVC.LANE, TVC.MAX_SP + 1, TVC.LANE):
        for rows in (8, 16, 24, 32, 48, 64):
            c = TVC.fwd_cluster_ctas(sp, rows)
            lanes = TVC.fwd_cluster_lanes(sp, c)
            assert 1 <= c <= TVC.FWD_MAX_CLUSTER and lanes <= 1024 and lanes % 32 == 0
            assert lanes * (c - 1) < sp <= lanes * c
            fits = rows <= TVC.H100_CLUSTERS[c]
            assert fits or TVC.fwd_cluster_lanes(sp, c - 1) > 1024
            if fits and c < TVC.FWD_MAX_CLUSTER:
                assert all(rows > TVC.H100_CLUSTERS[m] for m in range(c + 1, 9))
    assert [TVC.fwd_cluster_ctas(sp, 8) for sp in (1152, 1792, 2048, 4096, 8192)] == [8] * 5
    assert [TVC.fwd_cluster_ctas(sp, 64) for sp in (1152, 2048, 4096, 8192)] == [2, 2, 4, 8]
    assert [TVC.fwd_cluster_ctas(1152, r) for r in (16, 24, 32, 48)] == [6, 4, 3, 2]
    assert TVC.fwd_cluster_ctas(1792, 32) == 3 and TVC.fwd_cluster_ctas(1152, 8, layout=1) == 8
    assert TVC.fwd_cluster_lanes(1152, 8) == 160 and TVC.fwd_cluster_lanes(8192, 8) == 1024
