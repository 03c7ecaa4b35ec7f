"""The control at a test size on the CPU: the reference in float32 with
TF32 products, put in the program's place, reads above the program's own
float32 answers on every compared number that separates them at the
cell's size, and its rows fail the cell's limits."""
from __future__ import annotations

import pytest
import torch

from sosbench import calibrate, check
from sosbench.reference import precision
from sosbench.tests.helpers import small_cell


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, -3.0 - 2 ** -10],
                     dtype=torch.float32)
    got = precision.to_tf32(x).tolist()
    assert got == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0 - 2 ** -9]


@pytest.mark.parametrize("name", ["canonical.stream", "fwc.sweep", "canonical.red"])
def test_control_fails_program_passes(tmp_path, name):
    cell = small_cell(tmp_path, name, columns=16)
    r = calibrate.readings(cell, 2 ** 31 + 99, 2, True, torch.device("cpu"))
    limits = cell.workload["check"]["limits"]
    assert check.judge(r["program"], limits)[0], r
    assert not check.judge(r["control"], limits)[0], r
    for k in limits:
        assert r["control"][k] >= r["program"][k], (k, r)
