"""The traceback on pointer planes a lane window can miss, against the JAX walk.

``synthetic.traceback_plane`` builds int32 pointer planes in the wave
kernel's diagonal layout and the column kernel's layout whose walks run
V runs past 128 lanes, H runs across more than 16 word groups, start at
j_end 0 or below, at m_start 0 or at the top row MP - 1, and read random
codes, code 3 included.  On each plane the port's plain walk
(``_traceback_plain``, the CPU twin of csrc/traceback.cu) must equal the
reference's ``strique_tpu.ops.align.traceback_pointers`` (its XLA
while_loop, run on the CPU) row by row, exactly.

A scalar model of the CUDA kernel's schedule (``_ring_walk``: a ring of
16 word groups, each a 128-lane window requested 15 groups ahead, a
reload where the walk leaves a window, outputs stored 32 entries at a
time) must equal the plain walk too, write every entry once, and never
reload on a diagonal-layout plane, as the kernel's geometry claims.
The ``gpu`` tier holds the kernel itself to the plain walk on the same
planes (tests/test_torch_gpu.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from strique_tpu.ops import align as JA
from strique_tpu_torch.ops import align as TA
from strique_tpu_torch.ops import align_cuda as TC
from strique_tpu_torch.ops.reference import AlignParams
from strique_tpu_torch.synthetic import TRACEBACK_ROWS, traceback_plane

# one thread for torch under the tier-1 run's six workers (see test_torch_align.py)
torch.set_num_threads(1)

RING, WIN = 16, 128  # csrc/traceback.cu's ring depth and window width
ROWS = 16  # every row kind of TRACEBACK_ROWS twice
LAYOUTS = {"diag": False, "col": True}


def _jax_walk(ptr, j_end, m_start, m_out, col):
    walk = jax.vmap(lambda p, je, ms: JA.traceback_pointers(
        p, je, m_out, packed=True if col else "diag", m_start=ms), in_axes=(1, 0, 0))
    out = jax.jit(walk)(jnp.asarray(ptr), jnp.asarray(j_end), jnp.asarray(m_start))
    return {k: np.asarray(v) for k, v in out.items()}


def _plain_walk(ptr, j_end, m_start, m_out, col):
    out = TA.traceback_pointers(torch.from_numpy(ptr), torch.from_numpy(j_end), m_out,
                                packed=True if col else "diag",
                                m_start=torch.from_numpy(m_start))
    return {k: v.numpy() for k, v in out.items()}


def _ring_walk(plane, j_end: int, m_start: int, m_out: int, col: bool):
    """csrc/traceback.cu's schedule for one row's (NW, MP) plane, scalar.

    Returns (is_gap, jpos, j_begin, reloads, codes, words): the outputs,
    the window reloads, the code of every step walked and the set of
    (group, lane) words read."""
    mp = plane.shape[1]
    ring = {}  # slot -> (group, first lane of its window)
    writes = np.zeros(m_out, np.int64)
    gap = np.zeros(m_out, bool)
    pos = np.zeros(m_out, np.int32)
    gap0 = j_end < 0
    state = {"g": 0, "reloads": 0, "words": set()}

    def request(g, lane):
        ring[g % RING] = (g, max(0, lane - (WIN - 1)))

    def lookup(jc, ic):
        if jc <= 0:
            return 2 | 8
        t = jc - 1 if col else ic + jc - 1
        lane = ic - 1 if col else ic
        g = t >> 3
        while state["g"] > g:  # entering the next group: request the one RING-1 past it
            state["g"] -= 1
            request(state["g"] - (RING - 1), lane)
        held, lo = ring[g % RING]
        assert held == g and 0 <= lane < mp
        if not lo <= lane < lo + WIN:  # outside the window: reload it ending at the lane
            state["reloads"] += 1
            request(g, lane)
        state["words"].add((g, lane))
        return (int(plane[g, lane]) >> (4 * (t & 7))) & 15

    def store(e, g_, p_):
        if e < m_out:
            gap[e], pos[e] = g_, p_
            writes[e] += 1

    i, j = int(m_start), int(j_end)
    for e in range((i + 31) // 32 * 32, m_out):
        store(e, gap0, 0)
    reads = i > 0 and j > 0
    if reads:
        state["g"] = (j - 1 if col else i + j - 1) >> 3
        for k in range(RING):
            request(state["g"] - k, i - 1 if col else i)
    byte = lookup(j, i) if reads else 2 | 8
    cur, staged, codes = byte & 3, {}, []
    while i > 0:
        codes.append(cur)
        is_m, is_h, is_v = cur == 0, cur == 1, cur == 2
        if is_m or is_v:
            staged[i - 1] = (is_v, j - 1)
        ni = i if is_h else i - 1
        nj = j if is_v else j - 1
        if ni != i and (i - 1) % 32 == 0:  # the chunk's lowest element passed
            for e in range(i - 1, i + 31):
                store(e, *staged.get(e, (gap0, 0)))
            staged = {}
        j = nj
        if ni == 0:
            break
        nbyte = lookup(nj, ni)
        ext = (byte >> 2) & 1 if is_h else ((byte if col else nbyte) >> 3) & 1
        cur = cur if (not is_m and ext == 1) else nbyte & 3
        i, byte = ni, nbyte
    assert (writes == 1).all(), "an entry written twice or not at all"
    return gap, pos, j, state["reloads"], codes, state["words"]


def _runs(codes, code):
    best = run = 0
    for c in codes:
        run = run + 1 if c == code else 0
        best = max(best, run)
    return best


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_plain_matches_jax_on_hard_planes(layout, seed):
    col = LAYOUTS[layout]
    ptr, j_end, m_start, m_out = traceback_plane(ROWS, seed, col)
    ref = _jax_walk(ptr, j_end, m_start, m_out, col)
    got = _plain_walk(ptr, j_end, m_start, m_out, col)
    for k in ("is_gap", "jpos", "j_begin"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_hard_planes_reach_the_hard_cases(layout):
    """The walks do what the planes are for: a V run past 128 lanes, an H
    run across more than 16 word groups, code 3 read, and every start."""
    col = LAYOUTS[layout]
    ptr, j_end, m_start, m_out = traceback_plane(ROWS, 0, col)
    assert m_out == ptr.shape[2] - 1
    codes = [_ring_walk(ptr[:, r], j_end[r], m_start[r], m_out, col)[4] for r in range(ROWS)]
    assert max(_runs(c, 2) for c in codes) > WIN
    assert max(_runs(c, 1) for c in codes) > 8 * RING
    assert any(3 in c for c in codes)
    starts = {TRACEBACK_ROWS[r % len(TRACEBACK_ROWS)][3] for r in range(ROWS)}
    assert starts == {"deep", "top", "j_end 0", "j_end < 0", "m_start 0"}
    assert (j_end == 0).any() and (j_end < 0).any()
    assert (m_start == 0).any() and (m_start == m_out).any() and (m_start < m_out).any()


def _wave_plane():
    """A plane the port's plain wave recurrence writes, with its walk's starts."""
    rng = np.random.default_rng(77)
    B, N = 8, 512
    template = rng.uniform(60, 120, 40).astype(np.float32)
    signals = rng.uniform(60, 120, (B, N)).astype(np.float32)
    for r in range(B):
        st = 30 + 40 * r
        signals[r, st : st + 40] = template + rng.normal(0, 0.5, 40)
    tp, m = TC.pad_template(template)
    na = rng.integers(400, 512, B).astype(np.int32)
    ptr, bot = TC.align_forward_wave(torch.from_numpy(signals), torch.from_numpy(na),
                                     torch.from_numpy(tp), AlignParams(), m)
    j_end = (torch.argmax(bot, dim=1) + 1 - m).clamp_min(0).to(torch.int32).numpy()
    return ptr.numpy(), j_end, np.full(B, m, np.int32), m


@pytest.mark.parametrize("source", ["diag", "col", "wave"])
def test_ring_model_matches_plain(source):
    """The kernel's schedule, modelled: outputs equal the plain walk's,
    every entry written once, no reload in the diagonal layout."""
    col = source == "col"
    if source == "wave":
        ptr, j_end, m_start, m_out = _wave_plane()
    else:
        ptr, j_end, m_start, m_out = traceback_plane(ROWS, 2, col)
    ref = _plain_walk(ptr, j_end, m_start, m_out, col)
    reloads = 0
    for r in range(len(j_end)):
        gap, pos, jb, n, _, _ = _ring_walk(ptr[:, r], j_end[r], m_start[r], m_out, col)
        np.testing.assert_array_equal(gap, ref["is_gap"][r], err_msg=f"row {r}")
        np.testing.assert_array_equal(pos, ref["jpos"][r], err_msg=f"row {r}")
        assert jb == ref["j_begin"][r], f"row {r}"
        reloads += n
    if col:
        assert reloads > 0  # the V runs leave their windows
    else:
        assert reloads == 0


@pytest.mark.parametrize("source", ["diag", "col", "wave"])
def test_smoke_walk_counts_match_scalar_walk(source):
    """chip_smoke.py's walk counts equal the scalar walk's: the steps read
    from the outputs (its us a step on the main path) and replayed, and
    the distinct words read (its byte bound)."""
    import chip_smoke as CS

    col = source == "col"
    if source == "wave":
        ptr, j_end, m_start, m_out = _wave_plane()
    else:
        ptr, j_end, m_start, m_out = traceback_plane(ROWS, 3, col)
    p_t, je_t, ms_t = (torch.from_numpy(x) for x in (ptr, j_end, m_start))
    out = TA.traceback_pointers(p_t, je_t, m_out, packed=True if col else "diag", m_start=ms_t)
    steps, words = CS.walk_words(p_t, je_t, ms_t, col)
    assert torch.equal(CS.walk_steps(out, je_t, ms_t), steps)
    for r in range(len(j_end)):
        *_, codes, seen = _ring_walk(ptr[:, r], j_end[r], m_start[r], m_out, col)
        assert (int(steps[r]), int(words[r])) == (len(codes), len(seen)), f"row {r}"
    assert int(words.sum()) <= int(steps.sum())  # a word read serves one step or more
