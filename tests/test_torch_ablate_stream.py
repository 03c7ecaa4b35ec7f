"""The streamed execution's ablation flags against the JAX package's.

``sos_rt_tpu_torch.fused.solve_batch_mega(stream=True, ablate=...)`` — on
the CPU ``passA_plain`` / ``passB_plain`` with the same flags and the order
loop of ``ops/megastream.py::solve_block`` — against
``sos_rt_tpu.fused.solve_batch_mega(stream=True, interpret=True,
ablate=...)`` (the Pallas ``_passA_kernel`` / ``_passB_kernel`` in
interpreter mode) at GridSpec(24, 32), B=2, float64, for every variant of
``tools/ablate_stream.py`` and each loop flag: equal order counts and rtol
1e-9.  The ablated results are not physics; they only show that both
packages cut the same stages.
"""
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.fused import solve_batch_mega
from sos_rt_tpu_torch.ops import megastream as ms
from sos_rt_tpu_torch.tools import ablate_stream as tool

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(24, 32)
MAX_ORDERS = 5
# the tool's base and variants, then the loop flags the tool does not run
VARIANTS = list(tool.variants()) + ["sccond", "notiles", "noratio"]


@pytest.fixture(scope="module")
def case():
    tables = jax_tables(GRID)
    scenes = jax_scenes(2)
    opts = JOpts(surface="lambertian", dtype="float64", max_orders=MAX_ORDERS)
    return scenes, tables, opts


@pytest.mark.parametrize("ablate", VARIANTS)
def test_ablated_stream_matches_jax(case, ablate):
    scenes, tables, opts = case
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=2, interpret=True,
                       stream=True, outputs="summary", sort=False, ablate=ablate)
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts), cols_per_block=2,
                           outputs="summary", stream=True, sort=False, device="cpu",
                           ablate=ablate)
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    if "noconv" in ablate:
        assert (got.n_orders == MAX_ORDERS).all()
    for g, r in ((got.i_toa, ref.i_toa), (got.i_surface, ref.i_surface)):
        assert_close_scaled(g.numpy(), r, rtol=1e-9, atol_scale=1e-12)


@pytest.mark.parametrize("outputs", ["summary", "full"])
def test_no_flag_is_the_streamed_solve(case, outputs):
    scenes, tables, opts = case
    args = port_inputs(scenes, tables, GRID, opts)
    kw = dict(cols_per_block=2, outputs=outputs, stream=True, device="cpu")
    a = solve_batch_mega(*args, **kw)
    b = solve_batch_mega(*args, ablate="", **kw)
    for f in ("n_orders", "converged") + (("i_toa", "i_surface") if outputs == "summary"
                                          else ("i_total",)):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_streamed_route_rejects_what_it_cannot_cut(case):
    scenes, tables, opts = case
    args = port_inputs(scenes, tables, GRID, opts)
    for ablate in ("noconv,noi1", "nobc", "nothing"):
        with pytest.raises(ValueError, match="streamed execution"):
            solve_batch_mega(*args, stream=True, device="cpu", ablate=ablate)
    # the loop's flags are not the resident kernel's
    with pytest.raises(ValueError, match="unknown ablate"):
        solve_batch_mega(*args, stream=False, device="cpu", ablate="noconv,notiles")
    # a pass takes its own kernel flags only
    with pytest.raises(ValueError, match="passA takes"):
        ms.passA(None, None, None, None, ab={"nopoly"})
    with pytest.raises(ValueError, match="passB takes"):
        ms.passB(None, None, None, None, None, ab={"nosrc"})


def test_nofin_equals_nosmooth(case):
    """'nosmooth' keeps the join chain's multiplies, but with no smoothing
    its corrections are zero: the rows equal 'nofin''s value for value."""
    scenes, tables, opts = case
    args = port_inputs(scenes, tables, GRID, opts)
    kw = dict(cols_per_block=2, outputs="summary", stream=True, sort=False, device="cpu")
    a = solve_batch_mega(*args, ablate="noconv,nofin", **kw)
    b = solve_batch_mega(*args, ablate="noconv,nosmooth", **kw)
    assert torch.equal(a.i_toa, b.i_toa) and torch.equal(a.i_surface, b.i_surface)


def test_tool_runs_on_the_cpu(capsys):
    res = tool.main(["3", "2", "--device", "cpu", "--grid", "24", "32"])
    out = capsys.readouterr().out
    for name in tool.variants():
        assert name in out
        assert name in res["ms"]
    assert set(res["share"]) == set(tool.variants()[1:])
