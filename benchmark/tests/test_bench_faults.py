"""A run, driven on the CPU past the harness's look for a card, sees
``correct`` come out false when the timed path is broken underneath,
and true when it is not."""
import numpy as np
import pytest

import run
from harness import spec
from small import small_cell

CELL = "c9orf72-cas9-carrier"


def _run(tmp_path):
    return run.run_cell(small_cell(CELL), spec.benchmark(), 2**31 + 77, 0.5, False, "cpu",
                        tmp_root=str(tmp_path))


def _altered(orig):
    """A count altered where it is produced: the batch's first row + 1."""
    def detect_finish(self, state):
        outs = orig(self, state)
        return [(o[0] + 1, *o[1:]) if i == 0 else o for i, o in enumerate(outs)]
    return detect_finish


def _half(orig):
    """Half of the batch left out: its second half's answers never come."""
    def detect_finish(self, state):
        outs = orig(self, state)
        keep = (len(outs) + 1) // 2
        return [o if i < keep else None for i, o in enumerate(outs)]
    return detect_finish


def _nan_score(orig):
    """A NaN written where a score is produced: every row's score_suffix."""
    def detect_finish(self, state):
        return [None if o is None else (*o[:2], float("nan"), *o[3:])
                for o in orig(self, state)]
    return detect_finish


def _late(orig):
    """The Viterbi's paths come back one step late."""
    def collect(self, handle):
        return np.roll(orig(self, handle), 1, axis=1)
    return collect


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["numbers"]
    assert len(out["rows"]) == len(out["fed"]) > 0


@pytest.mark.parametrize("fault,method", [(_altered, "detect_finish"),
                                          (_half, "detect_finish"),
                                          (_late, "_viterbi_collect")])
def test_broken_run_is_not_correct(tmp_path, monkeypatch, fault, method):
    from strique_tpu_torch.detect.counter import RepeatCounter

    monkeypatch.setattr(RepeatCounter, method, fault(getattr(RepeatCounter, method)))
    out = _run(tmp_path)
    assert not out["correct"], out["numbers"]


def test_nan_score_fails_score_err(tmp_path, monkeypatch):
    """``score_err`` itself sees a NaN score, not only the replay's look."""
    from strique_tpu_torch.detect.counter import RepeatCounter

    monkeypatch.setattr(RepeatCounter, "detect_finish",
                        _nan_score(RepeatCounter.detect_finish))
    out = _run(tmp_path)
    assert out["numbers"]["score_err"] > out["limits"]["score_err"], out["numbers"]
    assert not out["correct"]
