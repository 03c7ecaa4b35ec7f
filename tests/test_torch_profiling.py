"""The solver's profiler scopes and the port's trace tool.

Counterpart of ``tests/test_profiling.py``: the reference engine and the
fused engine run their stages inside ``torch.profiler.record_function``
ranges of the JAX package's named scopes (``sos.first_order``,
``sos.source_jn``, ``sos.down_sweep``, ``sos.up_sweep_bc``; the fused
engine, as the JAX one, has no ``sos.first_order``).  A CPU trace of a
solve at GridSpec(24, 32), float64, holds them, and the results with the
profiler on equal those with it off to the bit.  The tools
``tools/profile.py``, ``tools/ablate.py`` and ``tools/trace_windows.py``
run at a small ``--device cpu`` size and print their tables.
"""
import os

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from sos_rt_tpu_torch.config import GridSpec, SolverOptions
from sos_rt_tpu_torch.fused import solve_batch_fused
from sos_rt_tpu_torch.parallel import broadcast_scene
from sos_rt_tpu_torch.config import Scene
from sos_rt_tpu_torch.solver import PhaseTables, solve_batch_reference
from sos_rt_tpu_torch.tools import ablate as ablate_tool
from sos_rt_tpu_torch.tools import profile as profile_tool
from sos_rt_tpu_torch.tools import trace_windows

GRID = GridSpec(24, 32)
SCOPES = profile_tool.SCOPES
# the scopes of each engine, as the JAX package names them
ENGINES = {"reference": (solve_batch_reference, SCOPES),
           "fused": (solve_batch_fused, SCOPES[1:])}


@pytest.fixture(scope="module")
def inputs():
    tables = PhaseTables.from_models(GRID, 0.5, atm=("rayleigh", {}),
                                     aer=("hg", {"g": 0.7}), device="cpu")
    scenes = broadcast_scene(Scene(), 2, device="cpu")
    scenes = scenes.map(lambda x: x.clone())
    scenes.grd_alb[1] = 0.3
    opts = SolverOptions(surface="lambertian", dtype="float64", max_orders=10)
    return scenes, tables, opts


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_trace_holds_the_scopes_and_changes_nothing(inputs, engine):
    solve, scopes = ENGINES[engine]
    scenes, tables, opts = inputs
    off = solve(scenes, tables, GRID, opts, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = solve(scenes, tables, GRID, opts, device="cpu")
    names = {e.name for e in prof.events()}
    for scope in scopes:
        assert scope in names, scope
    if engine == "fused":
        assert "sos.first_order" not in names
    table = profile_tool.read_trace(prof.events(), 0.0, torch.device("cpu"))
    n_orders = int(on.n_orders.max())
    assert table["scopes"]["sos.source_jn"]["calls"] == n_orders - 1
    for f in ("i_total", "i1", "n_orders", "converged"):
        assert torch.equal(getattr(on, f), getattr(off, f)), f


def test_profile_tool_on_the_cpu(tmp_path, capsys):
    t = profile_tool.main(["--canonical", "--device", "cpu", "--grid", "24", "32",
                           "--out", str(tmp_path)])
    out = capsys.readouterr().out
    for scope in SCOPES:
        assert scope in out and t["scopes"][scope]["device_ms"] is None
    assert t["busy_share"] is None and t["busy_ms"] == 0.0
    assert os.path.getsize(t["trace"]) > 0


def test_busy_is_the_union_of_intervals():
    assert profile_tool.busy_us([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4.0
    assert profile_tool.kernel_name(
        "void sos::pb::pass_b_up<float, 1, 0>(sos::PassBArgs<float>)") == "sos::pb::pass_b_up"


def test_scope_device_time_counts_what_it_launched():
    """A kernel counts in the scope whose host interval holds its launch
    call (matched by correlation id), also where no PyTorch op launched
    it, as ctypes launches the port's kernels."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, start, end, dev=DeviceType.CPU, id=0):
        return NS(name=name, id=id, device_type=dev, time_range=NS(start=start, end=end),
                  is_user_annotation=False, device_time_total=0.0)

    events = [ev("sos.down_sweep", 0, 10), ev("cudaLaunchKernel", 2, 3, id=7),
              ev("sos.up_sweep_bc", 10, 20), ev("cudaLaunchKernel", 12, 13, id=8),
              ev("cudaLaunchKernel", 25, 26, id=9),
              ev("down_sweep", 4, 9, DeviceType.CUDA, 7),
              ev("up_walk", 14, 30, DeviceType.CUDA, 8),
              ev("other", 27, 29, DeviceType.CUDA, 9)]
    t = profile_tool.read_trace(events, 30.0, torch.device("cuda"))
    assert t["scopes"]["sos.down_sweep"]["device_ms"] == 5 / 1e3
    assert t["scopes"]["sos.up_sweep_bc"]["device_ms"] == 16 / 1e3
    assert t["busy_ms"] == 21 / 1e3 and t["window_ms"] == 30 / 1e3
    assert t["kernels"]["up_walk"] == {"calls": 1, "ms": 16 / 1e3}
    assert t["lost_launches"] == 0


def test_trace_window_is_the_recorded_call():
    """What the host starts before the recorded call's span (the recorded
    step's opening launch) is left out of the table, and kept is the device
    work launched inside it, also where the trace's device clock puts it
    before the span; a launch call without its device record is counted
    as lost."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    def ev(name, start, end, dev=DeviceType.CPU, id=0):
        return NS(name=name, id=id, device_type=dev, time_range=NS(start=start, end=end),
                  is_user_annotation=False, device_time_total=0.0)

    events = [ev("cudaLaunchKernel", 0, 1, id=1), ev("fill", 1, 2, DeviceType.CUDA, 1),
              ev(profile_tool.RECORDED, 100, 140),
              ev("sos.source_jn", 101, 110), ev("cudaLaunchKernel", 102, 103, id=7),
              ev("cudaLaunchKernel", 104, 105, id=8),
              ev("quad", 99, 120, DeviceType.CUDA, 7)]
    t = profile_tool.read_trace(events, 40.0, torch.device("cuda"))
    assert t["window_ms"] == 41 / 1e3 and t["busy_ms"] == 21 / 1e3
    assert set(t["kernels"]) == {"quad"} and t["lost_launches"] == 1
    assert t["scopes"]["sos.source_jn"]["kernels"] == {"quad": {"calls": 1, "ms": 21 / 1e3}}


def test_ablate_tool_on_the_cpu(capsys):
    rows = ablate_tool.main(["16", "--batch", "4", "--device", "cpu", "--grid", "24", "32"])
    out = capsys.readouterr().out
    assert [(r["block_b"], r["sort"]) for r in rows] == [(16, False), (16, True)]
    assert out.count("col/s") == 2
    # a torch.Generator seeded 0 draws the batch: the same on every call
    a, b = ablate_tool.make_batch(4, "cpu"), ablate_tool.make_batch(4, "cpu")
    assert torch.equal(a.grd_alb, b.grd_alb) and float(a.grd_alb.max()) < 0.9


def test_trace_windows_tool_on_the_cpu(capsys):
    res = trace_windows.main(["1", "--opening", "0", "--device", "cpu",
                              "--grid", "24", "32"])
    assert res == {0.0: {"windows": 2, "lost": 0, "short": 0, "busy_share": [None]}}
    assert "opening 0.000 s: 2 windows" in capsys.readouterr().out
