"""The port's stream scheduler against the reference's, on a fake counter.

The scheduler queues reads by (target, strand, signal bucket), flushes
full batches, caps the queued reads and merges the close-time tails with
the reference's cost formula on every device.  A counter on the card
(``device`` cuda) must therefore see the same batches, in the same
order, as the reference's scheduler submits, inline or through the
submit thread, and its results surface in the same order.
"""
import numpy as np
import pytest
import torch

from strique_tpu_torch.detect import stream


class _Counter:
    """A counter of the scheduler's protocol that records its batches: a
    read's result is a function of its signal."""

    device = torch.device("cuda")

    def __init__(self):
        self.batches = []

    def detect_submit(self, target_name, raws, strand, preps=None):
        self.batches.append((target_name, strand, [int(r[0]) for r in raws]))
        return {"raws": raws}

    def detect_middle(self, state):
        return state

    def detect_mod_submit(self, state):
        return state

    def detect_finish(self, state):
        return [(len(r) % 97, float(r[0])) for r in state["raws"]]

    def detect(self, target_name, raw, strand):
        raise AssertionError("no batch failed, so no read is retried")


def _stream(seed, n=150):
    """(ctx, target, strand, raw) of a ragged two-target stream; a read's
    first sample is its index."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        raw = np.full(int(rng.integers(1000, 60000)), float(k))
        out.append((k, ("c9orf72", "fmr1")[int(rng.integers(2))], "+-"[int(rng.integers(2))],
                    raw))
    return out


def _run(cls, reads, batch_size, max_queued):
    counter, results = _Counter(), []
    sched = cls(counter, lambda ctx, out: results.append((ctx, out)), batch_size=batch_size,
                max_queued=max_queued)
    for ctx, target, strand, raw in reads:
        sched.add(ctx, target, strand, raw)
    sched.close()
    return counter.batches, results


@pytest.mark.parametrize("async_submit", ["1", "0"])
@pytest.mark.parametrize("batch_size, max_queued", [(4, None), (16, None), (64, 40)])
def test_scheduler_matches_reference(monkeypatch, async_submit, batch_size, max_queued):
    from strique_tpu.detect.stream import StreamScheduler as JaxStreamScheduler

    monkeypatch.setenv("STRIQUE_ASYNC_SUBMIT", async_submit)
    monkeypatch.delenv("STRIQUE_ALIGN_KERNEL", raising=False)
    reads = _stream(batch_size)
    batches, results = _run(stream.StreamScheduler, reads, batch_size, max_queued)
    assert (batches, results) == _run(JaxStreamScheduler, reads, batch_size, max_queued)
    assert sorted(ctx for ctx, _ in results) == list(range(len(reads)))
    # the tail merge ran: some close-time batch spans two signal buckets
    assert any(len({stream.signal_bucket(len(reads[k][3])) for k in b[2]}) > 1 for b in batches)


def test_mod_phase_is_a_no_op(tmp_path):
    from strique_tpu_torch.detect.counter import RepeatCounter
    from strique_tpu_torch.synthetic import write_pore_model

    counter = RepeatCounter(write_pore_model(str(tmp_path / "m.model"), seed=2), device="cpu")
    state = {"B": 0}
    assert counter.detect_mod_submit(state) is state
