"""Active-column compaction in the streamed order loop, on the CPU.

``ops/megastream.py::solve_block`` gathers a block's running columns into
narrower planes as its columns converge.  A block whose columns' order
counts spread widely (ρ, τ*_aer and ω_aer varied: 7 to 48 orders at
GridSpec(17, 24)) is solved whole (``cols_per_block`` = the batch), in
float64, on both surfaces and both output modes, and held against the same
columns solved one a block (``cols_per_block=1``, which never gathers):
equal order counts and flags, rows and fields at rtol 1e-12.  A six-column
spread block is held against the JAX streamed engine (Pallas in
interpreter mode), whose loop runs every column to the block's slowest.  The counters: the
spread block gathers (``solve_block.compactions`` > 0) and launches
between Σ(n − 1) and C·(max n − 1) column-orders; a block of identical
columns never gathers and launches C·(n − 1).  (The span of each gather,
``sos.order.compact``, is checked in tests/test_torch_spans.py.)
"""
import numpy as np
import pytest

from sos_rt_tpu.config import GridSpec as JGrid, SolverOptions as JOpts
from sos_rt_tpu.fused import solve_batch_mega as j_solve_mega
from sos_rt_tpu_torch.fused import solve_batch_mega
from sos_rt_tpu_torch.ops import megastream as ms

from torch_cases import assert_close_scaled, jax_scenes, jax_tables, port_inputs

GRID = JGrid(17, 24)
BATCH = 8
SURFACES = ("lambertian", "specular")
ROWS = {"summary": ("i_toa", "i_surface"), "full": ("i_total",)}


def spread_scenes(batch=BATCH):
    return jax_scenes(batch, grd_alb=np.linspace(0.0, 0.9, batch),
                      tau_star_aer=np.linspace(0.01, 1.0, batch),
                      alb_aer=np.linspace(0.8, 0.98, batch))


@pytest.fixture(scope="module")
def tables():
    return jax_tables(GRID)


def solve(scenes, tables, surface, cols_per_block, outputs="summary"):
    """The port's streamed solve and its counters (compactions, column_orders)."""
    opts = JOpts(surface=surface, dtype="float64", max_orders=100)
    ms.reset_launches()
    sol = solve_batch_mega(*port_inputs(scenes, tables, GRID, opts),
                           cols_per_block=cols_per_block, sort=False, stream=True,
                           outputs=outputs, device="cpu")
    return sol, (ms.solve_block.compactions, ms.solve_block.column_orders)


@pytest.mark.parametrize("outputs", ["summary", "full"])
@pytest.mark.parametrize("surface", SURFACES)
def test_compacted_block_equals_one_column_blocks(tables, surface, outputs):
    scenes = spread_scenes()
    got, (compactions, _) = solve(scenes, tables, surface, BATCH, outputs)
    want, (alone, _) = solve(scenes, tables, surface, 1, outputs)
    n = got.n_orders
    assert int(n.max()) >= 3 * int(n.min()) and bool(got.converged.all())
    assert compactions > 0 and alone == 0
    np.testing.assert_array_equal(n.numpy(), want.n_orders.numpy())
    np.testing.assert_array_equal(got.converged.numpy(), want.converged.numpy())
    for f in ROWS[outputs]:
        assert_close_scaled(getattr(got, f).numpy(), getattr(want, f).numpy(),
                            rtol=1e-12, atol_scale=1e-14)


@pytest.mark.parametrize("surface", SURFACES)
def test_compacted_block_matches_jax_stream(tables, surface):
    scenes = spread_scenes(6)
    opts = JOpts(surface=surface, dtype="float64", max_orders=100)
    ref = j_solve_mega(scenes, tables, GRID, opts, cols_per_block=6, interpret=True,
                       stream=True, outputs="summary", sort=False)
    got, (compactions, _) = solve(scenes, tables, surface, 6)
    assert compactions > 0
    np.testing.assert_array_equal(got.n_orders.numpy(), np.asarray(ref.n_orders))
    np.testing.assert_array_equal(got.converged.numpy(), np.asarray(ref.converged))
    for f in ROWS["summary"]:
        assert_close_scaled(getattr(got, f).numpy(), getattr(ref, f), rtol=1e-12,
                            atol_scale=1e-14)


@pytest.mark.parametrize("batch", [BATCH, 2 * BATCH])
@pytest.mark.parametrize("surface", SURFACES)
def test_spread_block_counters(tables, surface, batch):
    """The block gathers, and launches fewer column-orders than running
    every column to the slowest, never fewer than its columns need.  At
    16 columns a gather waits for two converged columns (an eighth)."""
    sol, (compactions, column_orders) = solve(spread_scenes(batch), tables, surface, batch)
    need = int((sol.n_orders - 1).sum())
    assert compactions > 0
    assert need <= column_orders < batch * (int(sol.n_orders.max()) - 1)
    if batch == BATCH:              # a gather at every convergence: exact
        assert column_orders == need
    ms.reset_launches()
    assert (ms.solve_block.compactions, ms.solve_block.column_orders) == (0, 0)


@pytest.mark.parametrize("surface", SURFACES)
def test_identical_columns_never_compact(tables, surface):
    sol, (compactions, column_orders) = solve(jax_scenes(4, grd_alb=0.3, tau_star_aer=0.2,
                                                         alb_aer=0.9), tables, surface, 4)
    n = int(sol.n_orders[0])
    assert bool((sol.n_orders == n).all()) and n > 2
    assert compactions == 0
    assert column_orders == 4 * (n - 1)
