"""The control -- the plain reference in bfloat16 in the program's place --
fails the cells' limits (here at a size a CPU test holds; on the card at
each cell's own size: ``benchmark/control.py``)."""
import pytest
import torch

import control
from harness import check
from small import small_cell


@pytest.mark.parametrize("name", ["c9orf72-cas9-carrier", "fmr1-cas9-carrier"])
def test_control_fails_the_limits(name):
    cell = small_cell(name, reads=3)
    cell["check_reads"] = 3
    r = control.readings(cell, 2**31 + 5, "cpu", torch.bfloat16)
    limits = {n: cell["check"][n] for n in check.NUMBERS}
    assert not check.verdict(r["numbers"], limits), r["numbers"]


@pytest.mark.gpu
def test_control_fails_at_cell_size(card):
    for name in ("c9orf72-cas9-carrier", "fmr1-cas9-carrier"):
        from harness import spec

        cell = spec.cell(name)
        r = control.readings(cell, 3, "cuda", torch.bfloat16)
        assert not check.verdict(r["numbers"], cell["check"]), r["numbers"]
