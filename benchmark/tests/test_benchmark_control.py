"""The control: the reference computed in float8, a step below the
configuration's bfloat16, put in the program's place, must come out not
correct, at the cell's own size on the card, with a short window at the
cell's load. The readings that set each limit, the control's, and those
of the program's own int8 frozen prefix, are in PERF.md."""
from __future__ import annotations

import time

import pytest

from benchmark.harness import session
from benchmark.harness.manifest import load_cell

CELLS = ["vitb16-offline", "vitl14-offline", "vitb16-serve"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_fp8_control_is_not_correct(cell, card, tmp_path):
    res = session.execute(load_cell(cell), 2 ** 31 + 4321, 4.0, False, card,
                          time.time(), str(tmp_path), control="fp8")
    assert not res["correct"], res["checks"]
