"""The correctness check fails what it must: the control (the reference in the next
precision below the configuration's, in the program's place), and the program with its
timed path broken underneath in each way a cell can be broken (``tools/faults.py``); a
sound run passes. Each run goes through ``run.run_cell`` as a chip run does, on the CPU at
small widths, with the cell's own limits."""
import time

import pytest

import run
from conftest import tiny_cell
from tools.faults import FAULTS

SEED = 2**31 + 12345


def judged(cell_name, program="port"):
    out = run.run_cell(tiny_cell(cell_name), SEED, 0.0, False, time.time(), device="cpu",
                       program=program)
    return out["line"]["correct"], {k: c["value"] for k, c in out["checks"].items()}


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_sound_run_passes(cell):
    correct, numbers = judged(cell)
    assert correct, numbers


@pytest.mark.parametrize("cell", sorted(FAULTS))
def test_control_fails(cell):
    correct, numbers = judged(cell, "control")
    assert not correct, numbers


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(FAULTS) for f in FAULTS[c]])
def test_fault_fails(cell, fault, monkeypatch):
    FAULTS[cell][fault](monkeypatch.setattr)
    correct, numbers = judged(cell)
    assert not correct, numbers
