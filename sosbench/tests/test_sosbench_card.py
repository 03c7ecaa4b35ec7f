"""On the card, at each one-card cell's own size: a sound run's numbers
are within the cell's limits and the control's (the reference in float32
with TF32 products in the program's place) are not.  Skips without a
card; ``sosbench/calibrate.py`` reads the same numbers on a dozen seeds."""
from __future__ import annotations

import pytest
import torch

from sosbench import calibrate, check, spec
from sosbench.tests.helpers import ROOT

BENCH = spec.benchmark(ROOT)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"] if w["chips"] == 1])
def test_program_within_limits_control_not(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell = spec.Cell(name, BENCH)
    r = calibrate.readings(cell, 4_000_000_123, int(cell.workload["trace"]["requests"]),
                           True, torch.device("cuda"))
    limits = cell.workload["check"]["limits"]
    assert check.judge(r["program"], limits)[0], r
    assert not check.judge(r["control"], limits)[0], r
