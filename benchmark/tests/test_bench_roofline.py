"""The per-layer readers on a hand-made trace: cells and steps counted by
hand, device time as a union, a layer with no kernels reads null."""
import pytest

from harness import roofline, spec
from harness.trace import Timeline, union


class _Probe:
    def __init__(self, submits, segments, spans):
        self.submits, self.segments, self.spans = submits, segments, spans


def _ctx(device, host=(), submits=(), segments=(), spans=()):
    return {"timeline": Timeline(list(device), list(host)), "batch_size": 64,
            "template_samples": 2 * 870,
            "probe": _Probe(list(submits), list(segments), list(spans))}


def test_counts_by_hand():
    # 2 reads of 1000 and 3000 samples against two 870-sample flanks
    cells = (1000 + 3000) * 1740
    assert roofline.align_bound_s(cells) == pytest.approx(19 * cells / 67e12)
    # 46 + 3 operations, 4 + 4 bytes a pair: the bytes bound both kernels
    pairs = 500 * 230
    assert roofline.viterbi_bound_s(pairs) == pytest.approx(8 * pairs / 3.35e12)


def test_roofline_readers():
    wave = "void (anonymous namespace)::wave_align_kernel<1, 0, 1>(float const*)"
    fwd = "void (anonymous namespace)::viterbi_fwd_kernel<2>(float const*)"
    dev = [(0.0, 100.0, wave, "kernel"), (50.0, 150.0, wave, "kernel"),
           (200.0, 260.0, fwd, "kernel"), (300.0, 310.0, "Memcpy HtoD", "gpu_memcpy")]
    ctx = _ctx(dev, submits=[[1000, 3000]], segments=[(500, 230)],
               spans=[("submit", 0.0, 0.004), ("submit", 1.0, 1.002)])
    align = spec.module("metrics", "align_roofline").read(ctx)
    assert align == pytest.approx(100 * roofline.align_bound_s(4000 * 1740) / 200e-6)
    vit = spec.module("metrics", "viterbi_roofline").read(ctx)
    assert vit == pytest.approx(100 * roofline.viterbi_bound_s(500 * 230) / 60e-6)
    assert spec.module("metrics", "batch_fill").read(ctx) == pytest.approx(100 * 2 / 64)
    assert spec.module("metrics", "submit_host_ms").read(ctx) == pytest.approx(3.0)
    # busy: [0, 150] + [200, 260] + [300, 310] of [0, 310]
    idle = spec.module("metrics", "device_idle_pct").read(ctx)
    assert idle == pytest.approx(100 * (1 - 220 / 310))


def test_no_kernels_reads_null():
    ctx = _ctx([(0.0, 10.0, "Memcpy HtoD", "gpu_memcpy")], submits=[[100]],
               segments=[(10, 10)])
    for name in ("align_roofline", "viterbi_roofline"):
        assert spec.module("metrics", name).read(ctx) is None
    empty = _ctx([])
    for name in ("batch_fill", "submit_host_ms", "device_idle_pct"):
        assert spec.module("metrics", name).read(empty) is None


def test_idle_ends_at_feed_end_and_gaps_are_named():
    dev = [(0.0, 10.0, "k", "kernel"), (20.0, 30.0, "k", "kernel"), (90.0, 100.0, "k", "kernel")]
    host = [(12.0, 18.0, "finish"), (40.0, 40.0, "feed_end")]
    tl = Timeline(dev, host)
    assert tl.steady() == (0.0, 40.0)
    assert tl.idle_gaps(0.0, 40.0) == [(10.0, 20.0), (30.0, 40.0)]
    gaps = tl.breakdown()["idle_gaps"]
    assert gaps[0][0] == "finish" or gaps[1][0] == "finish"
    assert union([(0, 2), (1, 3), (5, 6)]) == [[0, 3], [5, 6]]


def test_card_family_reads_as_its_base():
    """Each ``<m>.card`` is ``<m>``'s reader moving ``card_us_per_read``;
    ``reads_per_s.card`` reads the window's rate."""
    bench = spec.benchmark()
    card = [m["name"] for m in bench["per_layer"] if m["name"].endswith(".card")]
    assert "reads_per_s.card" in card and len(card) >= 2
    wave = "void (anonymous namespace)::wave_align_kernel<1, 0, 1>(float const*)"
    ctx = _ctx([(0.0, 100.0, wave, "kernel"), (300.0, 310.0, "Memcpy HtoD", "gpu_memcpy")],
               submits=[[1000, 3000]], segments=[(500, 230)],
               spans=[("submit", 0.0, 0.004), ("submit", 1.0, 1.002)])
    ctx["reads_per_s"] = 812.5
    for name in card:
        mod = spec.module("metrics", name)
        assert mod.MOVES == "card_us_per_read", name
        base = name[: -len(".card")]
        if base == "reads_per_s":
            assert mod.read(ctx) == 812.5 and mod.read({}) is None
            continue
        ref = spec.module("metrics", base)
        assert (mod.LAYER, mod.UNIT, mod.SOURCE, tuple(mod.KERNELS)) == (
            ref.LAYER, ref.UNIT, ref.SOURCE, tuple(getattr(ref, "KERNELS", ()))), name
        assert mod.read(ctx) == ref.read(ctx), name


def test_card_time_a_row(monkeypatch):
    """The card's busy time is a union over the window; per row written."""
    import run

    dev = [(0.0, 100.0, "k", "kernel"), (50.0, 150.0, "k", "kernel"),
           (300.0, 310.0, "Memcpy HtoD", "gpu_memcpy")]
    monkeypatch.setattr(Timeline, "from_profile", classmethod(lambda cls, prof: Timeline(dev, [])))
    assert run._card(None, 4) == {"card_busy_s": pytest.approx(160e-6),
                                  "card_us_per_read": pytest.approx(40.0)}
    assert run._card(None, 0) == {}
    monkeypatch.setattr(Timeline, "from_profile", classmethod(lambda cls, prof: Timeline([], [])))
    assert run._card(None, 4) == {}
    bench = spec.benchmark()
    asks = {w["name"]: run.card_metrics(bench, w["name"]) for w in bench["workloads"]}
    assert asks == {w: any(m["source"] == "device_trace"
                           for m in spec.cell_metrics(bench, w, "end_to_end")) for w in asks}
    assert asks["fmr1-cas9-carrier"] and not asks["c9orf72-cas9-carrier"]
