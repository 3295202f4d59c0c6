"""A run, driven on the CPU past the harness's look for a card, sees
``correct`` come out false when the timed path is broken underneath,
and true when it is not."""
import numpy as np
import pytest

import run
from harness import spec
from small import small_cell, small_mod_cell

CELL = "c9orf72-cas9-carrier"


def _mod_cell():
    """A small cell with a 5mC twin, every read in the check's sample."""
    cell = small_mod_cell(CELL)
    cell["check_reads"] = cell["params"]["reads"]
    return cell


def _run(tmp_path, mod=False):
    return run.run_cell(_mod_cell() if mod else small_cell(CELL), spec.benchmark(), 2**31 + 77,
                        0.5, False, "cpu", tmp_root=str(tmp_path))


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


def _mod_flipped(orig):
    """A mod string altered where it is produced: the first character of
    the batch's first row that carries one, flipped."""
    def detect_finish(self, state):
        outs = list(orig(self, state))
        i = next((i for i, o in enumerate(outs) if o is not None and o[6] != "-"), None)
        if i is not None:
            mod = outs[i][6]
            outs[i] = (*outs[i][:6], "10"[int(mod[0])] + mod[1:])
        return outs
    detect_finish.mod_cell = True
    return detect_finish


def _mod_skipped(_orig):
    """The mod phase skipped: every row's mod stays '-'."""
    def detect_mod_submit(self, state):
        return state
    detect_mod_submit.mod_cell = True
    return detect_mod_submit


def test_sound_run_is_correct(tmp_path):
    out = _run(tmp_path)
    assert out["correct"], out["numbers"]
    assert len(out["rows"]) == len(out["fed"]) > 0


def test_sound_mod_run_is_correct(tmp_path):
    """With a twin the sampled gated-in rows carry '0'/'1' strings, equal
    to the reference's (``int_mismatch`` holds the mod column)."""
    out = _run(tmp_path, mod=True)
    assert out["correct"], out["numbers"]
    mods = [r[6] for _k, r in out["rows"] if r[3] != 0.0]
    assert mods and all(m and set(m) <= {"0", "1"} for m in mods), mods
    assert any(n.startswith("mod: '1' on methylated units") for n in out["notes"])


@pytest.mark.parametrize("fault,method", [(_altered, "detect_finish"),
                                          (_half, "detect_finish"),
                                          (_late, "_viterbi_collect"),
                                          (_mod_flipped, "detect_finish"),
                                          (_mod_skipped, "detect_mod_submit")])
def test_broken_run_is_not_correct(tmp_path, monkeypatch, fault, method):
    from strique_tpu_torch.detect.counter import RepeatCounter

    broken = fault(getattr(RepeatCounter, method))
    monkeypatch.setattr(RepeatCounter, method, broken)
    mod = getattr(broken, "mod_cell", False)
    out = _run(tmp_path, mod)
    assert not out["correct"], out["numbers"]
    if mod:
        assert out["numbers"]["int_mismatch"] > out["limits"]["int_mismatch"], out["numbers"]


def test_nan_score_fails_score_err(tmp_path, monkeypatch):
    """``score_err`` itself sees a NaN score, not only the replay's look."""
    from strique_tpu_torch.detect.counter import RepeatCounter

    monkeypatch.setattr(RepeatCounter, "detect_finish",
                        _nan_score(RepeatCounter.detect_finish))
    out = _run(tmp_path)
    assert out["numbers"]["score_err"] > out["limits"]["score_err"], out["numbers"]
    assert not out["correct"]
