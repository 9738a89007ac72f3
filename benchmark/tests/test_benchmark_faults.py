"""The check catches a broken program (`harness/faults.py`): the rest of a
run, with the timed path broken underneath, comes out not correct under
the cell's own limits. On the CPU at `test-tiny` sizes, without the look
for a card; marked `cuda`, at the cell's own size on the card with a short
window."""
from __future__ import annotations

import time

import pytest

from conftest import run_cpu, tiny_cell

from benchmark.harness import faults, session
from benchmark.harness.manifest import load_cell

CELLS = ["vitb16-offline", "vitl14-offline", "vitb16-serve"]
CASES = [(cell, fault) for cell in CELLS for fault in faults.FAULTS]


def limited(cell):
    assert any(v is not None for v in cell.check["limits"].values())
    return cell


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct(cell, fault, monkeypatch, tmp_path):
    tiny = limited(tiny_cell(cell))
    faults.plant(monkeypatch.setattr, fault)
    res = run_cpu(tiny, tmp_path=tmp_path)
    assert not res["correct"], res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_not_correct_on_the_card(cell, fault, card, monkeypatch,
                                          tmp_path):
    full = limited(load_cell(cell))
    faults.plant(monkeypatch.setattr, fault)
    res = session.execute(full, 2 ** 31 + 1234, 4.0, False, card,
                          time.time(), str(tmp_path))
    assert not res["correct"], res["checks"]
