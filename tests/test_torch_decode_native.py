"""The native batch decode (``native.decode_paths``) against the NumPy
helpers it replaces on the main path, and against the JAX package's
(``strique_tpu.ops.viterbi``, the reference), on the CPU.

``decode_paths`` gives each row's count-state visits and float64 log_p in
one call; ``count_repeats`` and ``path_logp_f64`` give them a read at a
time, in the port's ``ops.viterbi`` and in the reference's.  Paths are drawn from the repeat HMMs themselves (start,
transitions and end by their probabilities, seeded), so every log_p is
finite, and observations from the states' normals:

  * over the c9orf72 and FMR1 repeat HMMs with uint8 paths (as the copy
    to the host leaves them), and as int32 (the fused route's rows): the
    counts equal both packages' ``count_repeats`` exactly, log_p both
    packages' ``path_logp_f64`` to 1e-12 relative; rows of one step, of 8192 and past it (NumPy sums in
    blocks of 8192) included, cut from a drawn path and decoded with the
    HMM's ends opened;
  * over an HMM of 1080 states (int32 paths) the same;
  * a state outside the HMM raises, as NumPy's indexing does;
  * ``detect_finish`` on the split, fused and two-phase routes gives the
    same rows with the native library and, from the same submitted
    batch, with ``native.available`` patched to False (the NumPy decode):
    every int equal, log_p to 1e-12 relative, and each gated-in row's
    count and log_p equal the reference's on the same path and segment;
    the batch holds reads the gate drops (n 0, log_p 0.0);
  * the ``decode.native`` and ``decode.numpy`` counters add up to the
    gated-in reads;
  * the split route's paths reach the decode in their host dtype (uint8
    up to 256 states), not as an int32 copy.
"""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from strique_tpu.ops import viterbi as JV
from strique_tpu_torch import native
from strique_tpu_torch.detect.counter import RepeatCounter
from strique_tpu_torch.hmm.models import build_flanked_repeat
from strique_tpu_torch.ops import viterbi as viterbi_ops
from strique_tpu_torch.pore_model import PoreModel
from strique_tpu_torch.synthetic import (LOCI, PREFIX, REPEAT, SUFFIX, WIDE_UNIT_BASES,
                                        make_reads, random_unit, write_pore_model)
from strique_tpu_torch.utils import trace

# one torch thread: the tier-1 run puts six workers on the machine's cores
torch.set_num_threads(1)

RTOL = 1e-12
LENGTHS = (1, 2, 8, 129, 8192, 8193)  # rows cut from drawn paths; 1 is a one-step row
T_PREFIX = PREFIX[-80:]  # the counter's flanks, as tests/test_torch_fused.py's
T_SUFFIX = SUFFIX[:80]


@pytest.fixture(scope="module")
def model_file(tmp_path_factory):
    return write_pore_model(str(tmp_path_factory.mktemp("model") / "synthetic_6mer.model"),
                            seed=0)


@pytest.fixture(autouse=True)
def _native_library():
    if not native.available():
        pytest.skip("a C++ compiler is needed to build the native host library")


def _locus_hmm(pm, name):
    _chrom, _b, _e, repeat, prefix, suffix = LOCI[name]
    # the counter's HMM: 50 bases of each flank
    return build_flanked_repeat(repeat, prefix[-50:], suffix[:50], pm)


def _sampler(chm):
    """``draw(rng, min_len, max_len=None)``: a path drawn from ``chm`` (a
    start state, transitions and the end by their probabilities), at
    least ``min_len`` steps long (it draws again), cut at ``max_len``."""
    step = np.exp(np.concatenate([chm.log_trans, chm.log_end[:, None]], axis=1))
    cum = np.cumsum(step / step.sum(axis=1, keepdims=True), axis=1)
    start = np.cumsum(np.exp(chm.log_start) / np.exp(chm.log_start).sum())

    def draw(rng, min_len, max_len=None):
        while True:
            s = min(int(np.searchsorted(start, rng.random(), side="right")), chm.n_states - 1)
            path = [s]
            while max_len is None or len(path) < max_len:
                s = int(np.searchsorted(cum[s], rng.random(), side="right"))
                if s >= chm.n_states:
                    break
                path.append(s)
            if len(path) >= min_len:
                return np.array(path)

    return draw


def _observe(chm, path, rng):
    return chm.mu[path] + chm.sigma[path] * rng.standard_normal(len(path))


def _rows(chm, rng, dtype):
    """Drawn rows (path, segment): whole paths, one of them past 8192
    steps (NumPy sums in blocks of 8192)."""
    draw = _sampler(chm)
    paths, segs = [], []
    for min_len in (1, 1, 1, 8193):
        path = draw(rng, min_len)
        paths.append(path.astype(dtype))
        segs.append(_observe(chm, path, rng))
    return paths, segs


def _cut_rows(chm, rng, dtype):
    """Rows of ``LENGTHS`` steps from one drawn path, each path running
    past its segment as a padded path matrix's rows do, and the HMM with
    its ends opened (log_start and log_end 0) so that a cut row's log_p
    stays finite."""
    open_ends = dataclasses.replace(chm, log_start=np.zeros(chm.n_states),
                                    log_end=np.zeros(chm.n_states))
    long = _sampler(chm)(rng, max(LENGTHS) + 64, max(LENGTHS) + 64)
    obs = _observe(chm, long, rng)
    return open_ends, [long.astype(dtype)] * len(LENGTHS), [obs[:n] for n in LENGTHS]


def _assert_row_matches(n, log_p, path, seg, chm, why):
    """A row's count and log_p against the port's NumPy helpers and the
    reference's: counts exact, log_p to ``RTOL``."""
    for ops in (viterbi_ops, JV):
        assert n == ops.count_repeats(path, len(seg), chm), (ops.__name__, why)
        want = ops.path_logp_f64(seg, path, chm)
        assert np.isfinite(want)
        assert abs(log_p - want) <= RTOL * abs(want), (ops.__name__, why, log_p, want)


def _assert_matches_reference(chm, paths, segs):
    visits, log_p = native.decode_paths(paths, segs, native.DecodeTables(chm))
    assert visits.dtype == np.int64 and log_p.dtype == np.float64
    for k, (path, seg) in enumerate(zip(paths, segs)):
        n = int(visits[k]) - chm.meta["repeat_offset"] + chm.meta["flanking_count"]
        _assert_row_matches(n, log_p[k], path, seg, chm, (k, len(seg)))


@pytest.mark.parametrize("dtype", [np.uint8, np.int32])
@pytest.mark.parametrize("locus", ["c9orf72", "fmr1"])
def test_decode_matches_numpy_helpers(model_file, locus, dtype):
    chm = _locus_hmm(PoreModel(model_file), locus)
    assert chm.n_states <= 256
    rng = np.random.default_rng(20 + len(locus))
    _assert_matches_reference(chm, *_rows(chm, rng, dtype))
    _assert_matches_reference(*_cut_rows(chm, rng, dtype))


def test_decode_past_256_states_int32(model_file):
    pm = PoreModel(model_file)
    chm = build_flanked_repeat(random_unit(WIDE_UNIT_BASES, 5), PREFIX[-50:], SUFFIX[:50], pm)
    assert chm.n_states > 256
    # its whole paths run to hundreds of thousands of steps: cut rows only
    _assert_matches_reference(*_cut_rows(chm, np.random.default_rng(7), np.int32))


def test_decode_rejects_a_state_outside_the_hmm(model_file):
    chm = _locus_hmm(PoreModel(model_file), "c9orf72")
    tables = native.DecodeTables(chm)
    good = np.zeros(4, np.int32)
    bad = np.array([0, chm.n_states, 0, 0], np.int32)
    seg = np.full(4, 90.0)
    with pytest.raises(IndexError, match="row 1"):
        native.decode_paths([good, bad], [seg, seg], tables)
    with pytest.raises(IndexError):
        native.decode_paths([np.array([-1], np.int32)], [seg[:1]], tables)
    with pytest.raises(ValueError):
        native.decode_paths([good[:2]], [seg], tables)  # a path shorter than its segment
    visits, log_p = native.decode_paths([], [], tables)
    assert visits.shape == log_p.shape == (0,)


def _read_batch(pm):
    """Three noisy reads of 10 c9orf72 units between the counter's flanks
    and 80 backbone bases a side, a read of backbone only and a flat dead
    read (the gate drops the last two), edge-padded to one length."""
    rng = np.random.default_rng(3)
    reads = make_reads(pm, 3, 10, rng, "+", flank_bases=80, prefix=T_PREFIX, suffix=T_SUFFIX)
    reads.append(pm.generate_signal("".join(rng.choice(list("ACTG"), 460)), samples=8))
    reads.append(np.full(2000, 90.0))
    mx = max(len(r) for r in reads)
    return [np.pad(r, (0, mx - len(r)), mode="edge") for r in reads]


def _route(counter, route):
    counter.split = route == "split"
    counter.fused = route != "two_phase"


@pytest.fixture(scope="module")
def counter(model_file):
    c = RepeatCounter(model_file, device="cpu")
    c.add_target("c9orf72", REPEAT, T_PREFIX, T_SUFFIX)
    return c


@pytest.mark.parametrize("route", ["split", "fused", "two_phase"])
def test_detect_finish_native_equals_numpy(counter, monkeypatch, route):
    reads = _read_batch(counter.pm)
    _route(counter, route)
    try:
        got = {}
        for way in ("native", "numpy"):
            # the same prep and device work both ways: only the decode differs
            state = got[way + ".state"] = counter.detect_submit("c9orf72", reads, "+")
            with monkeypatch.context() as m:
                if way == "numpy":
                    m.setattr(native, "available", lambda: False)
                trace.reset()
                with profile(activities=[ProfilerActivity.CPU]):
                    got[way] = counter.detect_finish(state)
                got[way + ".counts"] = trace.counts()
            live = sum(b[0] for b in counter.decode_bounds(state)[0])
            assert got[way + ".counts"].get("decode." + way) == live
            assert ("decode.numpy" if way == "native" else "decode.native") \
                not in got[way + ".counts"]
    finally:
        _route(counter, "split")
    assert 0 < live < len(reads)
    for a, b in zip(got["native"], got["numpy"], strict=True):
        assert a[:3] == b[:3] and a[4:] == b[4:]
        assert abs(a[3] - b[3]) <= RTOL * abs(b[3])
    gated_out = [r for r in got["native"] if r[0] == 0]
    assert gated_out and all(r[3] == 0.0 for r in gated_out)
    assert all(type(a) is type(b) for ra, rb in zip(got["native"], got["numpy"])
               for a, b in zip(ra, rb))
    # the gated-in rows against the reference's helpers on their own paths and segments
    state = got["native.state"]
    bounds, paths, _seg_lens = counter.decode_bounds(state)
    chm = state["tc"].repeat_hmm
    for i, row in enumerate(got["native"]):
        if bounds[i][0]:
            seg = state["flts"][i][bounds[i][3]:bounds[i][6]]
            _assert_row_matches(row[0], row[3], paths[i], seg, chm, (route, i))


def test_split_route_paths_keep_their_host_dtype(counter):
    state = counter.detect_middle(counter.detect_submit("c9orf72", _read_batch(counter.pm), "+"))
    mat = counter._viterbi_collect(state["vit"])
    assert mat.dtype == np.uint8
    assert np.shares_memory(mat, state["vit"]["paths"].numpy())
    assert len(counter.detect_finish(state)) == len(state["raws"])
