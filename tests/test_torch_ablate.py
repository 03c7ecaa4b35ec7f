"""The resident kernel's ablation flags against the JAX package's.

``sos_rt_tpu_torch.fused.solve_batch_mega(stream=False, ablate=...)`` — on
the CPU ``mega_plain`` with the same flags — against
``sos_rt_tpu.fused.solve_batch_mega(stream=False, interpret=True,
ablate=...)`` (the Pallas ``_mega_kernel`` in interpreter mode) at
GridSpec(24, 32), B=2, float64, for the flags the attribution tool's
variants are made of: equal order counts (every column runs max_orders
orders under 'noconv') and rtol 1e-9.  ``ablate=""`` is the solve itself,
equal to the default path to the bit.  The ablated results are not
physics; they only show that both packages cut the same stages.
"""
import numpy as np
import pytest
import torch

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.fused import solve_batch_mega
from sos_rt_tpu_torch.ops import megakernel as mk

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(24, 32)
MAX_ORDERS = 5
VARIANTS = ["noconv", "noconv,nosrc", "noconv,nosmooth", "noconv,nopassB"]


@pytest.fixture(scope="module")
def case():
    tables = jax_tables(GRID)
    scenes = jax_scenes(2)
    opts = JOpts(surface="lambertian", dtype="float64", max_orders=MAX_ORDERS)
    return scenes, tables, opts


@pytest.mark.parametrize("ablate", VARIANTS)
def test_ablated_plain_matches_jax(case, ablate):
    scenes, tables, opts = case
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=2, interpret=True,
                       stream=False, outputs="summary", sort=False, ablate=ablate)
    got = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts), cols_per_block=2,
                           outputs="summary", stream=False, sort=False, device="cpu",
                           ablate=ablate)
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    assert (got.n_orders == MAX_ORDERS).all()
    for g, r in ((got.i_toa, ref.i_toa), (got.i_surface, ref.i_surface)):
        assert_close_scaled(g.numpy(), r, rtol=1e-9, atol_scale=1e-12)


@pytest.mark.parametrize("outputs", ["summary", "full"])
def test_no_flags_is_the_solve(case, outputs):
    scenes, tables, opts = case
    args = port_inputs(scenes, tables, GRID, opts)
    kw = dict(cols_per_block=2, outputs=outputs, stream=False, device="cpu")
    a = solve_batch_mega(*args, **kw)
    b = solve_batch_mega(*args, ablate="", **kw)
    for f in ("n_orders", "converged") + (("i_toa", "i_surface") if outputs == "summary"
                                          else ("i_total",)):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_every_variant_runs_its_fixed_order_count(case):
    """All thirteen variants of the attribution tool run on the plain
    version, each to max_orders, with finite rows."""
    scenes, tables, opts = case
    args = port_inputs(scenes, tables, GRID, opts)
    for ablate in mk.ABLATE_VARIANTS:
        sol = solve_batch_mega(*args, cols_per_block=2, outputs="summary",
                               stream=False, sort=False, device="cpu", ablate=ablate)
        assert (sol.n_orders == MAX_ORDERS).all(), ablate
        assert torch.isfinite(sol.i_toa).all() and torch.isfinite(sol.i_surface).all()


def test_ablate_rejects_what_it_cannot_cut(case):
    scenes, tables, opts = case
    args = port_inputs(scenes, tables, GRID, opts)
    # the streamed execution takes its own flags (tests/test_torch_ablate_stream.py),
    # not the resident kernel's 'noi1' and 'nobc'
    with pytest.raises(ValueError, match="streamed execution"):
        solve_batch_mega(*args, stream=True, device="cpu", ablate="noconv,nobc")
    with pytest.raises(ValueError, match="unknown ablate"):
        solve_batch_mega(*args, stream=False, device="cpu", ablate="nothing")
    assert mk.ablate_mask("noconv,noratio") == 1 | 1 << 10
